"""The CUDA kernels (K2, K5, the backward kernels K3, K6 and the one-pass
training kernels K4, K7) against their plain versions, on the card, and the
kernel launches of each training path.

These need a GPU with ``nvcc``: on a host without CUDA each test skips
(decided in the fixture, not at import).  On the card, whose machine has no
JAX (``tests/conftest.py`` imports it, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Full width (default NeRFConfig, 8x256, bf16).  Tolerances: the kernels and
the plain versions round to bf16 at the same places and sum in f32 in
another order, so an activation next to a bf16 rounding boundary can round
apart by one bf16 ulp.  The limits are ``fused_render.PLAIN_TOL``, the ones
chip_smoke.py holds the kernels to (the comment there gives their reasons);
gradients are compared by relative Frobenius error per parameter.
"""

import pytest
import torch

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import pack_params
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.ops.sampling import sample_pdf, sample_stratified

TOL = fr.PLAIN_TOL


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n=333, seed=0):
    cfg = NeRFConfig(density_bias_init=0.5)
    model = NeRF(cfg, torch.Generator().manual_seed(seed)).to(dev).requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn(n, 3, generator=g, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(n, cfg.appearance_dim, generator=g, device=dev)
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, cfg.num_samples, True, g)
    return cfg, model, o, d, emb, z, g


def _close(got, want, keys):
    for k in keys:
        if k == "field":
            # rgb absolute; sigma is unbounded, so relative to max(1, |sigma|)
            a, b = got[k], want[k]
            pairs = {"field_rgb": ((a - b)[:, :3]),
                     "field_sigma": (a - b)[:, 3] / b[:, 3].abs().clamp_min(1.0)}
        else:
            pairs = {k: got[k] - want[k]}
        for name, diff in pairs.items():
            err = float(diff.abs().max())
            assert err <= TOL[name], f"{name}: {err}"


@pytest.mark.parametrize("want_field", [True, False])
def test_march_kernel_matches_plain(dev, want_field):
    cfg, model, o, d, emb, z, _ = _inputs(dev)
    packed = pack_params(model, cfg)
    got = fr.march_cuda(packed, cfg, o, d, emb, z, want_field)
    want = fr.march_plain(packed, cfg, o, d, emb, z, want_field=want_field)
    _close(got, want, ["rgb", "depth", "acc", "weights"] + (["field"] if want_field else []))


def test_march_kernel_preview_samples(dev):
    """32 samples per ray: four rays per 128-row tile."""
    cfg, model, o, d, emb, z, _ = _inputs(dev)
    packed = pack_params(model, cfg)
    z32 = z[:, ::2].contiguous()
    _close(fr.march_cuda(packed, cfg, o, d, emb, z32),
           fr.march_plain(packed, cfg, o, d, emb, z32), ["rgb", "depth", "acc", "weights"])


def test_merged_kernel_matches_plain(dev):
    cfg, model, o, d, emb, z, g = _inputs(dev)
    packed = pack_params(model, cfg, appearance=False)
    emb0 = torch.zeros_like(emb)
    coarse = fr.march_plain(packed, cfg, o, d, emb0, z, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
    got = fr.merged_cuda(packed, cfg, o, d, emb0, z, coarse["field"], z_f)
    want = fr.merged_plain(packed, cfg, o, d, emb0, z, coarse["field"], z_f)
    _close(got, want, ["rgb", "depth", "acc", "weights", "z_vals"])


def test_kernel_route_counts_launches(dev):
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    cfg, model, *_ = _inputs(dev)
    fr.reset_launch_counts()
    rgb, depth, _ = render_frame(model, cfg, camera_path("circle", 2, "lego")[0], 40, 30,
                                 40.0, chunk=500, device=dev)
    # 1200 rays in chunks of 500; rendering launches no backward kernel
    assert fr.LAUNCHES == {"march": 3, "merged": 3, "march_bwd": 0, "merged_train": 0,
                           "march_train": 0, "merged_bwd": 0}
    assert bool(torch.isfinite(depth).all()) and rgb.shape == (40, 30, 3)


def _cotangents(g, n, s, dev):
    return (torch.randn(n, 3, generator=g, device=dev), torch.randn(n, generator=g, device=dev),
            torch.randn(n, generator=g, device=dev),
            0.1 * torch.randn(n, s, generator=g, device=dev),
            0.1 * torch.randn(n, 4, s, generator=g, device=dev))


def _close_grads(got, want, model):
    errs = fr.grad_rel_errors(got, want, model)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL["grad_rel"], f"{worst}: {errs[worst]}"


@pytest.mark.parametrize("want_field", [True, False])
def test_march_bwd_kernel_matches_plain(dev, want_field):
    """K3 at 37 rays (19 blocks: a lost or doubled block moves every summed
    gradient by several percent), every cotangent non-zero."""
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    packed = pack_params(model, cfg)
    *cot, g_field = _cotangents(g, 37, cfg.num_samples, dev)
    g_field = g_field if want_field else None
    gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field)
    gk2, _ = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field)
    gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    assert torch.equal(gk.mats, gk2.mats) and torch.equal(gk.vecs, gk2.vecs)   # deterministic


def test_merged_train_kernel_matches_plain(dev):
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    packed = pack_params(model, cfg)
    coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
    target = torch.rand(37, 3, generator=g, device=dev)
    lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f, target)
    lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f, target)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert float((fk - fp).abs().max()) <= TOL["g_field"]


@pytest.mark.parametrize("over,want", [
    ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
    ({"num_importance": 0}, {"march_train": 1}),
    ({"white_background": True}, {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1})],
    ids=["hier", "coarse_only", "white_background"])
def test_train_step_launches_each_kernel_once(dev, over, want):
    """One step of each training path launches exactly its kernels."""
    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step

    cfg = NeRFConfig(density_bias_init=0.5, **over)
    rng = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (2, 16, 16, 3), generator=rng, dtype=torch.uint8).numpy()
    c2w = torch.eye(4)
    c2w[2, 3] = 4.0
    ds = RayDataset(imgs, imgs[..., 0], torch.stack([c2w, c2w]).numpy(), 20.0, 2.0, 6.0)
    model, table = init_model(cfg, 2, 0, dev)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    fr.reset_launch_counts()
    m = train_step(model, table, opt, sched, ds.device_arrays(cfg.white_background, device=dev),
                   cfg, 16, 16, 20.0, 256, torch.Generator(device=dev).manual_seed(0))
    assert fr.LAUNCHES == {k: want.get(k, 0) for k in fr.LAUNCHES}
    assert bool(torch.isfinite(m["loss"])) and table.grad is not None


def test_march_train_kernel_matches_plain(dev):
    """K7 at 37 rays: the loss, every gradient and demb; two runs agree bit
    for bit."""
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    packed = pack_params(model, cfg)
    target = torch.rand(37, 3, generator=g, device=dev)
    lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
    lk2, gk2, dk2 = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
    lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert torch.equal(gk.mats, gk2.mats) and torch.equal(gk.vecs, gk2.vecs)
    assert torch.equal(lk, lk2) and torch.equal(dk, dk2)


@pytest.mark.parametrize("all_cot", [True, False], ids=["every_cotangent", "rgb_acc_only"])
def test_merged_bwd_kernel_matches_plain(dev, all_cot):
    """K6 at 37 rays with a coarse/fine tie in z: every cotangent non-zero,
    or only rgb and acc (the others None, read as zeros, as autograd hands
    them on the white-background path)."""
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    packed = pack_params(model, cfg)
    coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
    z_f[:, 5] = z[:, 7]
    z_f = torch.sort(z_f, dim=-1).values
    sa = cfg.num_samples + cfg.num_importance
    cot = [torch.randn(37, 3, generator=g, device=dev), torch.randn(37, generator=g, device=dev),
           torch.randn(37, generator=g, device=dev),
           0.1 * torch.randn(37, sa, generator=g, device=dev)]
    if not all_cot:
        cot[1] = cot[3] = None
    gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f, *cot)
    gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f, *cot)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    assert float((fk - fp).abs().max()) <= TOL["g_field_k6"]


@pytest.mark.parametrize("sc,sf", [(48, 32), (64, 48)])
def test_backward_kernels_at_other_sample_counts(dev, sc, sf):
    """Tile layouts beside 2 x 64: K3 at S = 48 (two rays fill 96 of 128 rows,
    the second across the row halves that demb's sums split at) and K4 at
    Sf = 32 (four rays a tile) or 48."""
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    cfg = cfg.replace(num_samples=sc, num_importance=sf)
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, sc, True, g)
    packed = pack_params(model, cfg)
    *cot, g_field = _cotangents(g, 37, sc, dev)
    gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field)
    gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
    target = torch.rand(37, 3, generator=g, device=dev)
    lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f, target)
    lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f, target)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert float((fk - fp).abs().max()) <= TOL["g_field"]
