"""The CUDA kernels (K2, K5, the backward kernels K3, K6, the one-pass
training kernels K4, K7, the per-sample field K1 with its backward K8, and
the one-kernel hierarchical training step K9), and their has_time variants
(use_time), against their plain versions, on the card, and the kernel
launches of each training path; and the depth-aware effects on the card
against the CPU under PyTorch's default TF32 flags, and ``render --effect``
with its video.

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
from danerf_tpu_torch.kernels import fused_mlp as fm
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


def _inputs(dev, n=333, seed=0, **over):
    cfg = NeRFConfig(density_bias_init=0.5, **over)
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


def _ray_inputs(dev, n, s, seed, use_time):
    """_inputs at s samples a ray, with each ray's time under use_time."""
    cfg, model, o, d, emb, _, g = _inputs(dev, n=n, seed=seed, use_time=use_time)
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, s, True, g)
    t = torch.rand(n, 1, generator=g, device=dev) if use_time else None
    return cfg, model, o, d, emb, z, t, g


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("want_field", [True, False])
@pytest.mark.parametrize("s", [32, 48, 64, 100, 128])
def test_march_kernel_matches_plain(dev, s, want_field, use_time):
    """K2 (csrc/field_sm90.cuh's tile) at 1 to 4 rays a 128-row tile, rays
    that straddle its two warpgroups (48, 100) or fill both (128), 333 rays
    (a ragged last tile); two calls agree bit for bit."""
    cfg, model, o, d, emb, z, t, _ = _ray_inputs(dev, 333, s, 0, use_time)
    packed = pack_params(model, cfg)
    got = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=want_field)
    again = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=want_field)
    want = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=want_field)
    _close(got, want, ["rgb", "depth", "acc", "weights"] + (["field"] if want_field else []))
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_march_kernel_preview_samples(dev):
    """32 samples per ray: four rays per 128-row tile."""
    cfg, model, o, d, emb, z, _ = _inputs(dev)
    packed = pack_params(model, cfg)
    z32 = z[:, ::2].contiguous()
    _close(fr.march_cuda(packed, cfg, o, d, emb, z32),
           fr.march_plain(packed, cfg, o, d, emb, z32), ["rgb", "depth", "acc", "weights"])


@pytest.mark.parametrize("appearance", [False, True], ids=["emb_none", "emb"])
@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("sc,sf", [(64, 64), (64, 16), (128, 128)])
def test_merged_kernel_matches_plain(dev, sc, sf, use_time, appearance):
    """K5 at 2, 8 and 1 rays a tile (the merge arrays in the activation
    buffer), with and without time and the appearance projection (packed as
    zeros without it), at 333 rays; two calls agree bit for bit."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 333, sc, 0, use_time)
    packed = pack_params(model, cfg, appearance=appearance)
    if not appearance:
        emb = torch.zeros_like(emb)
    coarse = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
    args = (packed, cfg, o, d, emb, z, coarse["field"], z_f, t)
    got, again = fr.merged_cuda(*args), fr.merged_cuda(*args)
    _close(got, fr.merged_plain(*args), ["rgb", "depth", "acc", "weights", "z_vals"])
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_merged_kernel_refuses_what_it_always_refused(dev):
    """The shapes K5 refuses stay refused with the same error: Sf past a
    tile, Sc + Sf past 1024, merge arrays past their limit (8 rays of Sf =
    16 at Sc = 400)."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, 64, 9, False)
    packed = pack_params(model, cfg)
    field = fr.march_plain(packed, cfg, o, d, emb, z, want_field=True)["field"]
    for sc, sf in ((64, 129), (960, 128), (400, 16)):
        zc = torch.sort(torch.rand(37, sc, generator=g, device=dev) * 4 + 2, dim=-1)[0]
        fc = field[:, :, :1].expand(-1, -1, sc).contiguous()
        zf = torch.sort(torch.rand(37, sf, generator=g, device=dev) * 4 + 2, dim=-1)[0]
        with pytest.raises(RuntimeError, match="a width this kernel does not take"):
            fr.merged_cuda(packed, cfg, o, d, emb, zc, fc, zf)
    ok = fr.merged_cuda(packed, cfg, o, d, emb, zc[:, :273], fc[:, :, :273], zf)
    assert ok["rgb"].shape == (37, 3)


def test_kernel_route_counts_launches(dev):
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    cfg, model, *_ = _inputs(dev)
    fr.reset_launch_counts()
    rgb, depth, _ = render_frame(model, cfg, camera_path("circle", 2, "lego")[0], 40, 30,
                                 40.0, chunk=500, device=dev)
    # 1200 rays in chunks of 500; rendering launches no backward kernel
    assert fr.LAUNCHES == {"march": 3, "merged": 3, "march_bwd": 0, "merged_train": 0,
                           "march_train": 0, "merged_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0,
                           "hier_onepass": 0}
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


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("cot", ["field", "no_field", "rgb_only"])
@pytest.mark.parametrize("s", [32, 48, 64, 100, 128])
def test_march_bwd_kernel_at_every_tile_shape(dev, s, cot, use_time):
    """K3 (csrc/field_bwd_sm90.cuh) at the sample counts its tile takes (1 to
    4 rays a 128-row tile), with every cotangent and g_field, without
    g_field, and with only g_rgb (null cotangents read as zeros); two calls
    bit for bit."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, s, 20 + s, use_time)
    packed = pack_params(model, cfg)
    g_rgb, g_depth, g_acc, g_w, g_field = _cotangents(g, 37, s, dev)
    cots = {"field": (g_rgb, g_depth, g_acc, g_w, g_field),
            "no_field": (g_rgb, g_depth, g_acc, g_w, None),
            "rgb_only": (g_rgb, None, None, None, None)}[cot]
    gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cots, t=t)
    gk2, dk2 = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cots, t=t)
    gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cots, t=t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    assert torch.equal(gk.mats, gk2.mats) and torch.equal(gk.vecs, gk2.vecs)
    assert torch.equal(dk, dk2)


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("s,appearance", [(32, True), (48, True), (64, True), (64, False),
                                          (100, True), (128, True)],
                         ids=["32", "48", "64", "64-emb_none", "100", "128"])
def test_march_train_kernel_at_every_tile_shape(dev, s, appearance, use_time):
    """K7 (csrc/field_bwd_sm90.cuh's tile with the MSE's cotangents) at the
    sample counts its tile takes, seeded targets, at 64 samples also with
    the appearance projection packed as zeros; two calls bit for bit."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, s, 40 + s, use_time)
    packed = pack_params(model, cfg, appearance=appearance)
    emb = emb if appearance else torch.zeros_like(emb)
    target = torch.rand(37, 3, generator=g, device=dev)
    args = (packed, cfg, o, d, emb, z, target, t)
    lk, gk, dk = fr.march_train_cuda(*args)
    lk2, gk2, dk2 = fr.march_train_cuda(*args)
    lp, gp, dp = fr.march_train_plain(*args)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert all(torch.equal(a, b) for a, b in ((lk, lk2), (gk.mats, gk2.mats),
                                              (gk.vecs, gk2.vecs), (dk, dk2)))


def test_march_bwd_kernel_null_cotangents_give_zeros(dev):
    cfg, model, o, d, emb, z, g = _inputs(dev, n=37)
    gk, dk = fr.march_bwd_cuda(pack_params(model, cfg), cfg, o, d, emb, z, None, None, None,
                               None)
    assert not gk.mats.any() and not gk.vecs.any() and not dk.any()


@pytest.mark.parametrize("appearance", [True, False], ids=["emb", "emb_none"])
@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("sc,sf", [(64, 64), (64, 16), (64, 48), (128, 128)])
def test_merged_train_kernel_at_every_tile_shape(dev, sc, sf, use_time, appearance):
    """K4 at the Sc + Sf its tile takes (2, 8, 2 and 1 rays a tile), with
    the appearance projection and packed as zeros; two calls bit for bit."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, sc, 30 + sf, use_time)
    packed = pack_params(model, cfg, appearance=appearance)
    emb = emb if appearance else torch.zeros_like(emb)
    coarse = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
    target = torch.rand(37, 3, generator=g, device=dev)
    args = (packed, cfg, o, d, emb, z, coarse["field"], z_f, target, t)
    lk, gk, dk, fk = fr.merged_train_cuda(*args)
    lk2, gk2, dk2, fk2 = fr.merged_train_cuda(*args)
    lp, gp, dp, fp = fr.merged_train_plain(*args)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert float((fk - fp).abs().max()) <= TOL["g_field"]
    assert all(torch.equal(a, b) for a, b in ((lk, lk2), (gk.mats, gk2.mats),
                                              (gk.vecs, gk2.vecs), (dk, dk2), (fk, fk2)))


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("cot", ["all", "white", "rgb_only", "null"])
@pytest.mark.parametrize("sc,sf,appearance", [(64, 64, True), (64, 64, False), (64, 16, True),
                                              (64, 48, True), (128, 128, True)],
                         ids=["64-64", "64-64-emb_none", "64-16", "64-48", "128-128"])
def test_merged_bwd_kernel_at_every_tile_shape(dev, sc, sf, appearance, cot, use_time):
    """K6 (csrc/field_bwd_sm90.cuh's tile with the caller's cotangents) at
    the Sc + Sf its tile takes, with a coarse/fine tie, under every
    cotangent, the white-background pattern (g_rgb and g_acc, the rest
    null), only g_rgb, and none (all outputs exactly zero); at 64 + 64 also
    with the appearance projection packed as zeros; two calls bit for
    bit."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, sc, 50 + sf, use_time)
    packed = pack_params(model, cfg, appearance=appearance)
    emb = emb if appearance else torch.zeros_like(emb)
    field = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
    z_f = sample_pdf(z, field["weights"], sf, True, rand=g)
    z_f[:, 5] = z[:, 7]   # a coarse/fine tie: the merge puts the coarse sample first
    z_f = torch.sort(z_f, dim=-1).values
    g_rgb, g_depth, g_acc, _, _ = _cotangents(g, 37, sc, dev)
    g_w = 0.1 * torch.randn(37, sc + sf, generator=g, device=dev)
    cots = {"all": (g_rgb, g_depth, g_acc, g_w), "white": (g_rgb, None, g_acc, None),
            "rgb_only": (g_rgb, None, None, None), "null": (None,) * 4}[cot]
    args = (packed, cfg, o, d, emb, z, field["field"], z_f, *cots)
    gk, dk, fk = fr.merged_bwd_cuda(*args, t=t)
    gk2, dk2, fk2 = fr.merged_bwd_cuda(*args, t=t)
    assert all(torch.equal(a, b) for a, b in ((gk.mats, gk2.mats), (gk.vecs, gk2.vecs),
                                              (dk, dk2), (fk, fk2)))
    if cot == "null":
        assert not (gk.mats.any() or gk.vecs.any() or dk.any() or fk.any())
        return
    gp, dp, fp = fr.merged_bwd_plain(*args, t=t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    assert float((fk - fp).abs().max()) <= TOL["g_field_k6"]


def test_backward_tile_refuses_what_it_always_refused(dev):
    """The shapes K3, K7, K4 and K6 refuse stay refused: S or Sf past a tile
    or below one sample, Sc + Sf past 256, and the merge arrays of K4 and
    K6 past their limit (8 rays of Sf = 16 at Sc = 126; Sc = 125 is
    taken)."""
    cfg, model, o, d, emb, z, t, g = _ray_inputs(dev, 37, 129, 9, False)
    packed = pack_params(model, cfg)
    target = torch.rand(37, 3, generator=g, device=dev)
    for zs in (z, z[:, :0]):
        with pytest.raises(RuntimeError, match="a width this kernel does not take"):
            fr.march_bwd_cuda(packed, cfg, o, d, emb, zs, None, None, None, None)
        with pytest.raises(RuntimeError, match="a width this kernel does not take"):
            fr.march_train_cuda(packed, cfg, o, d, emb, zs, target)
    field = fr.march_plain(packed, cfg, o, d, emb, z[:, :64], want_field=True)["field"]
    g_rgb = torch.randn(37, 3, generator=g, device=dev)
    kernels = {"K4": lambda *a: fr.merged_train_cuda(*a, target)[3],
               "K6": lambda *a: fr.merged_bwd_cuda(*a, g_rgb, None, None, None)[2]}

    def merged(kern, sc, sf):
        zc = torch.sort(torch.rand(37, sc, generator=g, device=dev) * 4 + 2, dim=-1)[0]
        fc = field[:, :, :1].expand(-1, -1, sc).contiguous()
        zf = torch.sort(torch.rand(37, sf, generator=g, device=dev) * 4 + 2, dim=-1)[0]
        return kernels[kern](packed, cfg, o, d, emb, zc, fc, zf)

    for kern in kernels:
        for sc, sf in ((64, 129), (200, 64), (126, 16), (64, 0)):
            with pytest.raises(RuntimeError, match="a width this kernel does not take"):
                merged(kern, sc, sf)
        assert merged(kern, 125, 16).shape == (37, 4, 125)


@pytest.mark.parametrize("over,want", [
    ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
    ({"num_importance": 0}, {"march_train": 1}),
    ({"white_background": True}, {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    ({"use_fused_train": False}, {"mlp_fwd": 2, "mlp_bwd": 2}),
    ({"use_time": True}, {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    ({"use_hier_onepass": True}, {"hier_onepass": 1})],
    ids=["hier", "coarse_only", "white_background", "per_sample", "use_time", "hier_onepass"])
def test_train_step_launches_each_kernel_once(dev, over, want):
    """One step of each training path launches exactly its kernels."""
    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step

    cfg = NeRFConfig(density_bias_init=0.5, **over)
    rng = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (2, 16, 16, 3), generator=rng, dtype=torch.uint8).numpy()
    c2w = torch.eye(4)
    c2w[2, 3] = 4.0
    ds = RayDataset(imgs, imgs[..., 0], torch.stack([c2w, c2w]).numpy(), 20.0, 2.0, 6.0,
                    times=torch.tensor([0.0, 1.0]).numpy() if cfg.use_time else None)
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


def _rows(n, cfg, dev, seed=0):
    """Flat points along seeded rays (their stratified samples), per-row
    directions and embeddings: the rows the per-sample route feeds K1."""
    _, _, o, d, emb, z, g = _inputs(dev, n=-(-n // cfg.num_samples), seed=seed)
    pts = (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3)[:n]
    rep = lambda t: t[:, None, :].expand(-1, cfg.num_samples, -1).reshape(-1, t.shape[-1])[:n]
    return pts.contiguous(), rep(d).contiguous(), rep(emb).contiguous(), g


def _close_rows(got, want):
    (rk, sk), (rp, sp) = got, want
    assert float((rk - rp).abs().max()) <= TOL["field_rgb"]
    assert float(((sk - sp) / sp.abs().clamp_min(1.0)).abs().max()) <= TOL["field_sigma"]


@pytest.mark.parametrize("appearance", [True, False], ids=["emb", "emb_none"])
def test_mlp_fwd_kernel_matches_plain(dev, appearance):
    """K1 (csrc/field_sm90.cuh's row tile) at 4,093 rows (a ragged last
    tile), with and without the appearance projection (packed as zeros, a
    zero embedding); two calls agree bit for bit."""
    cfg, model, *_ = _inputs(dev)
    x, d, emb, _ = _rows(4093, cfg, dev)
    packed = pack_params(model, cfg, appearance=appearance)
    emb = emb if appearance else torch.zeros_like(emb)
    got = fm.fused_fwd_cuda(packed, cfg, x, d, emb)
    again = fm.fused_fwd_cuda(packed, cfg, x, d, emb)
    _close_rows(got, fm.fused_fwd_plain(packed, cfg, x, d, emb))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("n", [37, 129, 65536, 131072])
def test_mlp_fwd_kernel_at_every_row_count(dev, n, use_time):
    """K1 below one tile (37), at one tile and a row (129), and at the
    65,536 and 131,072 rows of a 1024-ray batch's coarse and fine
    evaluations (4 and 8 tiles a CTA of the persistent grid), with and
    without each row's time."""
    cfg, model, *_ = _inputs(dev, use_time=use_time)
    x, d, emb, g = _rows(n, cfg, dev, seed=1)
    t = torch.rand(n, 1, generator=g, device=dev) if use_time else None
    packed = pack_params(model, cfg)
    _close_rows(fm.fused_fwd_cuda(packed, cfg, x, d, emb, t),
                fm.fused_fwd_plain(packed, cfg, x, d, emb, t))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5", "K3", "K8"])
def test_kernels_at_softplus_match_plain(dev, kernel):
    """density_activation="softplus" (the softplus branches of
    field_sm90.cuh's and field_bwd_sm90.cuh's tiles: sigma, and its sigmoid
    in the backward) through K1 (the row tile), K2 with its field, K5, K3
    with every cotangent and K8, against their plain versions at 333 rays
    (K1 4,093 rows, K8 2,400)."""
    cfg, model, o, d, emb, z, g = _inputs(dev, density_activation="softplus")
    packed = pack_params(model, cfg)
    if kernel == "K1":
        x, dr, er, _ = _rows(4093, cfg, dev)
        _close_rows(fm.fused_fwd_cuda(packed, cfg, x, dr, er),
                    fm.fused_fwd_plain(packed, cfg, x, dr, er))
    elif kernel == "K2":
        _close(fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True),
               fr.march_plain(packed, cfg, o, d, emb, z, want_field=True),
               ["rgb", "depth", "acc", "weights", "field"])
    elif kernel == "K5":
        coarse = fr.march_plain(packed, cfg, o, d, emb, z, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
        args = (packed, cfg, o, d, emb, z, coarse["field"], z_f)
        _close(fr.merged_cuda(*args), fr.merged_plain(*args),
               ["rgb", "depth", "acc", "weights", "z_vals"])
    elif kernel == "K3":
        *cot, g_field = _cotangents(g, o.shape[0], cfg.num_samples, dev)
        gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field)
        gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field)
        _close_grads(gk, gp, model)
        assert float((dk - dp).abs().max()) <= TOL["demb"]
    else:
        x, dr, er, g = _rows(2400, cfg, dev)
        g_rgb = torch.randn(2400, 3, generator=g, device=dev)
        g_sig = torch.randn(2400, 1, generator=g, device=dev)
        gk, dk = fm.fused_bwd_cuda(packed, cfg, x, dr, er, g_rgb, g_sig)
        gp, dp = fm.fused_bwd_plain(packed, cfg, x, dr, er, g_rgb, g_sig)
        _close_grads(gk, gp, model)
        assert float((dk - dp).abs().max()) <= TOL["demb_k8"]


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("appearance", [True, False], ids=["emb", "emb_none"])
@pytest.mark.parametrize("n", [37, 129, 2400, 65536, 131072])
def test_mlp_bwd_kernel_matches_plain(dev, n, appearance, use_time):
    """K8 at 37 and 129 rows (below one tile; one tile and a row), 2,400
    (19 tiles, the last ragged: a lost or doubled tile moves every summed
    gradient by several percent), and the 65,536 and 131,072 rows of a
    1024-ray batch's coarse and fine evaluations; with and without the
    appearance projection (packed as zeros, a zero embedding), with and
    without each row's time; seeded cotangents; two calls agree bit for
    bit."""
    cfg, model, *_ = _inputs(dev, use_time=use_time)
    x, d, emb, g = _rows(n, cfg, dev)
    packed = pack_params(model, cfg, appearance=appearance)
    emb = emb if appearance else torch.zeros_like(emb)
    g_rgb = torch.randn(n, 3, generator=g, device=dev)
    g_sig = torch.randn(n, 1, generator=g, device=dev)
    t = torch.rand(n, 1, generator=g, device=dev) if use_time else None
    gk, dk = fm.fused_bwd_cuda(packed, cfg, x, d, emb, g_rgb, g_sig, t)
    gk2, dk2 = fm.fused_bwd_cuda(packed, cfg, x, d, emb, g_rgb, g_sig, t)
    gp, dp = fm.fused_bwd_plain(packed, cfg, x, d, emb, g_rgb, g_sig, t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k8"]
    assert torch.equal(gk.mats, gk2.mats) and torch.equal(gk.vecs, gk2.vecs)
    assert torch.equal(dk, dk2)


def test_per_sample_step_matches_plain(dev, monkeypatch):
    """One step of the per-sample route at 256 rays: through K1/K8 and
    through their plain versions (the route's dispatch pointed at them),
    same module, table, batch and draws."""
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    cfg = NeRFConfig(density_bias_init=0.5, use_fused_train=False)
    n = 256
    _, _, o, d, _, _, g = _inputs(dev, n=n, seed=3)
    batch = {"rays_o": o, "rays_d": d, "rgb": torch.rand(n, 3, generator=g, device=dev),
             "img_idx": torch.randint(0, 4, (n,), generator=g, device=dev)}
    draws = (torch.rand(n, cfg.num_samples, generator=g, device=dev),
             torch.rand(n, cfg.num_importance, generator=g, device=dev))
    table0 = torch.randn(4, cfg.appearance_dim, generator=g, device=dev)
    runs = []
    for plain in (False, True):
        model = NeRF(cfg, torch.Generator().manual_seed(0)).to(dev)
        table = torch.nn.Parameter(table0.clone())
        if plain:
            monkeypatch.setattr(fm, "_field_fwd", lambda pk, c, x, d, e, t:
                                fm.fused_fwd_plain(pk, c, x, d, e))
            monkeypatch.setattr(fm, "_field_bwd", lambda pk, c, x, d, e, t, gr, gs:
                                fm.fused_bwd_plain(pk, c, x, d, e, gr, gs))
        fr.reset_launch_counts()
        loss, _ = compute_loss_and_grads(model, table, cfg, batch, draws=draws)
        runs.append((float(loss), [p.grad for p in model.parameters()] + [table.grad],
                     dict(fr.LAUNCHES)))
    (lk, gk, nk), (lp, gp, np_) = runs
    assert nk == {k: {"mlp_fwd": 2, "mlp_bwd": 2}.get(k, 0) for k in nk}
    assert not any(np_.values())
    assert abs(lk - lp) <= TOL["loss"]
    for a, b in zip(gk, gp):
        assert float((a - b).norm() / b.norm()) <= TOL["grad_rel"]


def _time_inputs(dev, n, seed=0):
    """_inputs for the time-conditioned model (use_time, kx = 80), with
    each ray's time uniform in [0, 1]."""
    cfg, model, o, d, emb, z, g = _inputs(dev, n=n, seed=seed, use_time=True)
    return cfg, model, o, d, emb, z, torch.rand(n, 1, generator=g, device=dev), g


def test_time_march_and_merged_kernels_match_plain(dev):
    """The has_time K2 (with its field) and K5 at 333 rays."""
    cfg, model, o, d, emb, z, t, g = _time_inputs(dev, 333)
    packed = pack_params(model, cfg)
    got = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
    want = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
    _close(got, want, ["rgb", "depth", "acc", "weights", "field"])
    z_f = sample_pdf(z, want["weights"], cfg.num_importance, True, rand=g)
    _close(fr.merged_cuda(packed, cfg, o, d, emb, z, want["field"], z_f, t),
           fr.merged_plain(packed, cfg, o, d, emb, z, want["field"], z_f, t),
           ["rgb", "depth", "acc", "weights", "z_vals"])


def test_time_backward_kernels_match_plain(dev):
    """The has_time K3 (every cotangent, g_field), K6 (every cotangent, a
    coarse/fine tie), K4 and K7 at 37 rays."""
    cfg, model, o, d, emb, z, t, g = _time_inputs(dev, 37)
    packed = pack_params(model, cfg)
    *cot, g_field = _cotangents(g, 37, cfg.num_samples, dev)
    gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
    gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    coarse = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
    z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
    z_f[:, 5] = z[:, 7]
    z_f = torch.sort(z_f, dim=-1).values
    c6 = (cot[0], cot[1], cot[2],
          0.1 * torch.randn(37, cfg.num_samples + cfg.num_importance, generator=g, device=dev))
    gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f, *c6, t=t)
    gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f, *c6, t=t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb"]
    assert float((fk - fp).abs().max()) <= TOL["g_field_k6"]
    target = torch.rand(37, 3, generator=g, device=dev)
    lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                          target, t)
    lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                           target, t)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]
    assert float((fk - fp).abs().max()) <= TOL["g_field"]
    lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target, t)
    lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target, t)
    assert abs(float(lk) - float(lp)) <= TOL["loss"]
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k4"]


def test_time_mlp_kernels_match_plain(dev):
    """The has_time K1 at 4,093 rows (a ragged tile) and K8 at 2,400 rows
    (19 tiles), each row with its own time."""
    cfg, model, *_ = _time_inputs(dev, 8)
    packed = pack_params(model, cfg)
    for n in (4093, 2400):
        x, d, emb, g = _rows(n, NeRFConfig(), dev)
        t = torch.rand(n, 1, generator=g, device=dev)
        rk, sk = fm.fused_fwd_cuda(packed, cfg, x, d, emb, t)
        rp, sp = fm.fused_fwd_plain(packed, cfg, x, d, emb, t)
        assert float((rk - rp).abs().max()) <= TOL["field_rgb"]
        assert float(((sk - sp) / sp.abs().clamp_min(1.0)).abs().max()) <= TOL["field_sigma"]
    g_rgb = torch.randn(n, 3, generator=g, device=dev)
    g_sig = torch.randn(n, 1, generator=g, device=dev)
    gk, dk = fm.fused_bwd_cuda(packed, cfg, x, d, emb, g_rgb, g_sig, t)
    gp, dp = fm.fused_bwd_plain(packed, cfg, x, d, emb, g_rgb, g_sig, t)
    _close_grads(gk, gp, model)
    assert float((dk - dp).abs().max()) <= TOL["demb_k8"]


def _hier_inputs(dev, n, use_time=False, seed=0, **over):
    """K9's inputs: _inputs' rays and depths, uniforms from
    importance_uniforms, a seeded target and, with use_time, each ray's
    time."""
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    cfg, model, o, d, emb, z, g = _inputs(dev, n=n, seed=seed, use_time=use_time, **over)
    u = importance_uniforms((n,), cfg.num_importance, True, rand=g, device=dev)
    target = torch.rand(n, 3, generator=g, device=dev)
    t = torch.rand(n, 1, generator=g, device=dev) if use_time else None
    return cfg, model, (pack_params(model, cfg), cfg, o, d, emb, z, u, target, t)


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("n", [37, 1024])
@pytest.mark.parametrize("sc,sf", [(64, 64), (64, 16), (128, 128), (48, 32), (32, 64)])
def test_hier_onepass_kernel_matches_plain(dev, sc, sf, n, use_time):
    """K9 and its has_time variant at 37 rays (19 CTAs at 64 + 64: a lost
    or doubled CTA moves every summed gradient by several percent) and at
    the 1024-ray batch, at Sc + Sf = 64 + 64, 64 + 16, 128 + 128, 48 + 32
    and 32 + 64 (the fine rows fewer than, as many as and more than the
    coarse ones): both MSEs, every gradient and demb; two calls agree bit
    for bit."""
    cfg, model, args = _hier_inputs(dev, n, use_time, num_samples=sc, num_importance=sf)
    k, k2 = fr.hier_onepass_cuda(*args), fr.hier_onepass_cuda(*args)
    p = fr.hier_onepass_plain(*args)
    assert abs(float(k[0]) - float(p[0])) <= TOL["loss_k9"]
    assert abs(float(k[1]) - float(p[1])) <= TOL["loss_k9"]
    _close_grads(k[2], p[2], model)
    assert float((k[3] - p[3]).abs().max()) <= TOL["demb_k9"]
    for a, b in zip((k[0], k[1], k[2].mats, k[2].vecs, k[3]), (k2[0], k2[1], k2[2].mats,
                                                               k2[2].vecs, k2[3])):
        assert torch.equal(a, b)


def test_mlp_bwd_and_hier_onepass_refuse_what_they_always_refused(dev):
    """K8 refuses an embedding width that is not a multiple of 16 (its
    appearance product steps K by 16); K9 refuses Sc or Sf past a tile or
    below one sample."""
    cfg, model, *_ = _inputs(dev, appearance_dim=24)
    x, d, _, g = _rows(37, cfg, dev)
    emb = torch.randn(37, 24, generator=g, device=dev)
    g_rgb = torch.randn(37, 3, generator=g, device=dev)
    with pytest.raises(RuntimeError, match="a width this kernel does not take"):
        fm.fused_bwd_cuda(pack_params(model, cfg), cfg, x, d, emb, g_rgb, g_rgb[:, :1])
    cfg, model, args = _hier_inputs(dev, 37, num_samples=129, num_importance=129)
    packed, _, o, d, emb, z, u, target, _ = args
    for sc, sf in ((129, 64), (64, 129), (0, 64), (64, 0)):
        with pytest.raises(RuntimeError, match="a width this kernel does not take"):
            fr.hier_onepass_cuda(packed, cfg, o, d, emb, z[:, :sc].contiguous(),
                                 u[:, :sf].contiguous(), target)


def test_hier_onepass_step_matches_plain_and_two_kernel_step(dev, monkeypatch):
    """One use_hier_onepass step at 256 rays through K9, through its plain
    version (the route's dispatch pointed at it), and the two-kernel step
    through K2, K4 and K3, same module, table, batch and draws."""
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    cfg = NeRFConfig(density_bias_init=0.5, use_hier_onepass=True)
    n = 256
    _, _, o, d, _, _, g = _inputs(dev, n=n, seed=3)
    batch = {"rays_o": o, "rays_d": d, "rgb": torch.rand(n, 3, generator=g, device=dev),
             "img_idx": torch.randint(0, 4, (n,), generator=g, device=dev)}
    draws = (torch.rand(n, cfg.num_samples, generator=g, device=dev),
             torch.rand(n, cfg.num_importance, generator=g, device=dev))
    table0 = torch.randn(4, cfg.appearance_dim, generator=g, device=dev)
    runs = {}
    for route in ("kernel", "two_kernel", "plain"):
        model = NeRF(cfg, torch.Generator().manual_seed(0)).to(dev)
        table = torch.nn.Parameter(table0.clone())
        rcfg = cfg.replace(use_hier_onepass=route != "two_kernel")
        if route == "plain":
            monkeypatch.setattr(fr, "_hier_onepass",
                                lambda pk, c, *a: fr.hier_onepass_plain(pk, c, *a))
        fr.reset_launch_counts()
        loss, _ = compute_loss_and_grads(model, table, rcfg, batch, draws=draws)
        runs[route] = (float(loss), [p.grad for p in model.parameters()] + [table.grad],
                       dict(fr.LAUNCHES))
    lk, gk, nk = runs["kernel"]
    assert nk == {k: int(k == "hier_onepass") for k in nk}
    assert not any(runs["plain"][2].values())
    for other in ("two_kernel", "plain"):
        lp, gp, _ = runs[other]
        assert abs(lk - lp) <= TOL["loss_k9"], other
        for a, b in zip(gk, gp):
            assert float((a - b).norm() / b.norm()) <= TOL["grad_rel"], other


# ---------------------------------------------------------------- chained steps

_PATHS = {"hier": ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
          "coarse_only": ({"num_importance": 0}, {"march_train": 1}),
          "white_background": ({"white_background": True},
                               {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
          "per_sample": ({"use_fused_train": False}, {"mlp_fwd": 2, "mlp_bwd": 2}),
          "use_time": ({"use_time": True},
                       {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
          "hier_onepass": ({"use_hier_onepass": True}, {"hier_onepass": 1})}


def _chain_scene(cfg):
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(3, 16, 16, 3), dtype=np.uint8)
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * 3)
    c2ws[:, 2, 3] = 4.0
    c2ws[1, 0, 3], c2ws[2, 1, 3] = 0.5, -0.5
    return RayDataset(imgs, imgs[..., 0], c2ws, 20.0, 2.0, 6.0,
                      times=np.array([0.0, 0.5, 1.0], np.float32) if cfg.use_time else None)


def _chain_run(dev, cfg, per_call, calls, batch=256, mesh=None):
    """A fresh seeded state, 2 warm-up steps of 64 rays, then ``calls``
    calls of make_train_step(steps_per_call=per_call) (with ``mesh``,
    make_sharded_train_step over it); returns the state, each call's
    launches and the metrics."""
    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, make_train_step

    ds = _chain_scene(cfg)
    model, table = init_model(cfg, ds.n_images, 0, dev)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = ds.device_arrays(cfg.white_background, device=dev)

    def make(b, k):
        if mesh is None:
            return make_train_step(model, table, opt, sched, pool, cfg, 16, 16, 20.0, b, gen, k)
        return make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, 16, 16, 20.0,
                                       b, gen, k)

    warm = make(64, 1)
    for _ in range(2):
        warm()
    step = make(batch, per_call)
    launches, out = [], []
    for _ in range(calls):
        fr.reset_launch_counts()
        out.append(step())
        launches.append(dict(fr.LAUNCHES))
    torch.cuda.synchronize()
    metrics = {n: torch.cat([m[n] for m in out]) for n in out[0]}
    return (model, table, opt, sched, gen), launches, metrics, step


def _assert_same(a, b):
    (ma, ta, oa, sa, ga), (mb, tb, ob, sb, gb) = a, b
    pa, pb = list(ma.parameters()) + [ta], list(mb.parameters()) + [tb]
    for i, (p, q) in enumerate(zip(pa, pb)):
        assert torch.equal(p, q), i
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa.state[p][k], ob.state[q][k]), (i, k)
    assert torch.equal(oa.param_groups[0]["lr"], ob.param_groups[0]["lr"])
    assert sa.last_epoch == sb.last_epoch
    assert torch.equal(torch.rand(16, generator=ga, device=ga.device),
                       torch.rand(16, generator=gb, device=gb.device))


@pytest.mark.parametrize("path", list(_PATHS))
def test_chained_steps_equal_eager_steps(dev, path):
    """10 steps as one graph replay equal 10 eager steps bit for bit: the
    parameters, table, Adam's moments and counts, the rate, StepLR, each
    step's metrics and the generator's next draw; each of two replays counts
    exactly the path's launches of 10 steps."""
    over, per_step = _PATHS[path]
    cfg = NeRFConfig(density_bias_init=0.5, **over)
    chained, launches, m_c, step = _chain_run(dev, cfg, 10, 2)
    eager, _, m_e, _ = _chain_run(dev, cfg, 1, 20)
    _assert_same(chained, eager)
    for n in m_e:
        assert torch.equal(m_c[n], m_e[n]), n
    assert launches == [{k: 10 * per_step.get(k, 0) for k in fr.LAUNCHES}] * 2
    assert step.pool_bytes > 0 and bool(torch.isfinite(m_c["loss"]).all())


def test_chained_steps_cross_rate_changes(dev):
    """With scheduler_step_size=7 the rate changes inside replays: 3 replays
    of 10 steps equal 30 eager steps bit for bit."""
    cfg = NeRFConfig(density_bias_init=0.5, scheduler_step_size=7)
    chained, _, m_c, _ = _chain_run(dev, cfg, 10, 3)
    eager, _, m_e, _ = _chain_run(dev, cfg, 1, 30)
    _assert_same(chained, eager)
    assert torch.equal(m_c["loss"], m_e["loss"])
    lr = float(chained[2].param_groups[0]["lr"])
    assert lr == pytest.approx(cfg.learning_rate * cfg.scheduler_gamma ** (32 // 7))


def test_chained_resume_equals_straight_run(dev, tmp_path):
    """train() on the card, 10 steps a call: 24 steps with a checkpoint every
    12 equal 12 steps, a resume and 12 more, bit for bit."""
    import json
    import os

    from danerf_tpu_torch.train.trainer import train

    cfg = NeRFConfig(density_bias_init=0.5, batch_size=256)
    ds = _chain_scene(cfg)

    def run(d, n, resume=False):
        train(cfg, ds, save_dir=str(d), num_iterations=n, checkpoint_every=12, device=dev,
              progress=False, resume=resume, log_path=os.path.join(d, "metrics.jsonl"))

    run(tmp_path / "a", 24)
    run(tmp_path / "b", 12)
    run(tmp_path / "b", 24, resume=True)
    a, b = (torch.load(tmp_path / d / "checkpoint_final.pt", map_location="cpu",
                       weights_only=False) for d in ("a", "b"))
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    for key in ("appearance_embeddings", "generator_state"):
        assert torch.equal(a[key], b[key]), key
    for i, st in a["optimizer_state_dict"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer_state_dict"]["state"][i][k]), (i, k)
    assert a["scheduler_state_dict"] == b["scheduler_state_dict"]

    def rows(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]

    assert [r["step"] for r in rows("b")] == list(range(1, 25))
    assert rows("a")[12:] == rows("b")[12:]


@pytest.fixture
def tf32_defaults(dev):
    """PyTorch's own TF32 flags (cuDNN on, matmul off), which ``dev`` turns
    off: the effects must hold whatever the global flags say."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield dev
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _effect_inputs(h=240, w=320, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    depth = 0.45 + 0.25 * torch.sin(xx / 7.0) * torch.cos(yy / 5.0)
    depth = (depth + 0.05 * torch.rand(h, w, generator=g) + 0.2 * (xx >= w // 3)).clamp(0, 1)
    return img, depth


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
@pytest.mark.parametrize("name", ["Original", "Toon Shader", "Color Boost", "Sepia", "Bloom",
                                  "Vignette", "Night Vision", "Film Grain", "Pencil Sketch",
                                  "Cross Processing", "Posterize", "Neon Glow", "Hologram",
                                  "Fog"])
def test_effect_on_card_matches_cpu(tf32_defaults, name, with_depth):
    """Each effect on the card against the port on the CPU with the same
    draws, within effects.levels_apart's tolerance, under PyTorch's default
    TF32 flags."""
    from danerf_tpu_torch.fx.effects import apply_effect, draw_noise, levels_apart

    img, depth = _effect_inputs()
    dep = depth if with_depth else None
    draws = draw_noise(name, img.shape, torch.Generator().manual_seed(1), "cpu")
    want = apply_effect(name, img, dep, draws=draws, device="cpu")
    got = apply_effect(name, img.to(tf32_defaults), None if dep is None else dep.to(tf32_defaults),
                       draws=draws)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    apart = levels_apart(name, got, want)
    assert apart["ok"], apart


def test_cli_render_effect_on_card(tf32_defaults, tmp_path):
    """render --effect Hologram --create_video on the card: K2 and K5 a
    chunk, the video's frames the PNGs."""
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.video import read_avi

    model = NeRF(NeRFConfig(density_bias_init=0.5), torch.Generator().manual_seed(0))
    ckpt = tmp_path / "m.pt"
    torch.save({"model_state_dict": model.state_dict(), "iteration": 0}, ckpt)
    fr.reset_launch_counts()
    written = main(["render", "--checkpoint", str(ckpt), "--output_dir", str(tmp_path / "out"),
                    "--frames", "2", "--width", "64", "--height", "64", "--quality", "medium",
                    "--effect", "Hologram", "--create_video", "--dataset_path",
                    str(tmp_path / "none")])
    assert fr.LAUNCHES["march"] == 2 and fr.LAUNCHES["merged"] == 2
    frames, _ = read_avi(str(tmp_path / "out" / "hotdog_render.avi"))
    assert frames.shape == (2, 64, 64, 3)
    for frame, path in zip(frames, written):
        assert (frame == read_png(path)).all()


# ---------------------------------------------------------------- evaluation

def _eval_scene(side=64, views=2, use_time=False):
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene, make_time_varying_scene

    make = make_time_varying_scene if use_time else make_synthetic_scene
    ref = make(split="val", n_images=views, height=side, width=side, n_samples=32)
    return RayDataset(ref.images, ref.alphas, ref.c2ws, ref.focal, ref.near, ref.far, "val",
                      ref.times)


@pytest.mark.parametrize("over", [{}, {"white_background": True}, {"use_time": True},
                                  {"num_importance": 0}],
                         ids=["hier", "white", "use_time", "coarse_only"])
def test_eval_kernel_route_matches_plain_route(dev, over):
    """``evaluate`` with the fit (10 steps) through the kernels against the
    same through the plain route (the module's forward, autograd) on the
    card: per view within 0.1 dB PSNR and 0.005 SSIM, with exactly the
    fit's and the frame's launches."""
    from danerf_tpu_torch.train.evaluate import evaluate

    cfg, model, *_ = _inputs(dev, **over)
    ds = _eval_scene(use_time=cfg.use_time)
    fr.reset_launch_counts()
    got = evaluate(model, cfg, ds, optimize_embeddings=True, opt_steps=10, device=dev)
    coarse = cfg.num_importance == 0
    step = {"march": 1, "march_bwd": 1} if coarse else {"march": 1, "merged": 1,
                                                         "merged_bwd": 1, "march_bwd": 1}
    frame = {"march": 1} if coarse else {"march": 1, "merged": 1}
    assert fr.LAUNCHES == {k: 2 * (10 * step.get(k, 0) + frame.get(k, 0)) for k in fr.LAUNCHES}
    plain = evaluate(model, cfg.replace(use_kernels=False), ds, optimize_embeddings=True,
                     opt_steps=10, device=dev)
    for g, p in zip(got["per_view"], plain["per_view"]):
        assert abs(g["psnr"] - p["psnr"]) <= 0.1 and abs(g["ssim"] - p["ssim"]) <= 0.005, (g, p)


@pytest.mark.parametrize("over", [{}, {"use_time": True}, {"num_importance": 0}],
                         ids=["hier", "use_time", "coarse_only"])
def test_graph_fit_equals_eager_fit(dev, over):
    from danerf_tpu_torch.train.evaluate import EmbeddingFit, left_half_rays

    cfg, model, *_ = _inputs(dev, **over)
    ds = _eval_scene(use_time=cfg.use_time)
    rays_o, rays_d = left_half_rays(ds.c2ws[0], 64, 64, ds.focal, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    target = torch.rand(rays_o.shape[0], 3, generator=g, device=dev)
    idx = torch.randint(0, rays_o.shape[0], (20, 1024), generator=g, device=dev)
    fits = [EmbeddingFit(model, cfg, rays_o.shape[0], 20, device=dev, graph=graph)
            for graph in (True, False)]
    t = 0.4 if cfg.use_time else None
    graph, eager = (f(rays_o, rays_d, target, idx, t) for f in fits)
    assert torch.equal(graph, eager) and float(graph.abs().max()) > 0
    assert torch.equal(fits[0](rays_o, rays_d, target, idx, t), graph)   # a second replay


def test_evaluate_defaults_to_the_card(dev):
    from danerf_tpu_torch.train.evaluate import evaluate

    cfg, model, *_ = _inputs(dev)
    res = evaluate(model.cpu(), cfg, _eval_scene(views=1), optimize_embeddings=True,
                   opt_steps=2)
    assert next(model.parameters()).device.type == "cuda" and res["n_views"] == 1


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world-size-1 NCCL group on the card and its 1 x 1 mesh (decided
    here, not at import: the CPU host skips)."""
    import socket

    import torch.distributed as dist

    from danerf_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    yield make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("path", ["hier", "coarse_only", "per_sample"])
def test_sharded_chained_step_equals_make_train_step(dev, nccl_mesh, path):
    """parallel/mesh.py at world size 1: 10 sharded steps as one graph
    replay (the flat all-reduce captured with them) equal 10 chained
    make_train_step steps bit for bit, with the path's launches."""
    over, per_step = _PATHS[path]
    cfg = NeRFConfig(density_bias_init=0.5, **over)
    sharded, launches, m_s, step = _chain_run(dev, cfg, 10, 2, mesh=nccl_mesh)
    single, _, m_1, _ = _chain_run(dev, cfg, 10, 2)
    _assert_same(sharded, single)
    for n in m_1:
        assert torch.equal(m_s[n], m_1[n]), n
    assert launches == [{k: 10 * per_step.get(k, 0) for k in fr.LAUNCHES}] * 2


def test_sharded_frame_equals_render_frame(dev, nccl_mesh):
    """render_frame(mesh=) of a jittered 200x200 medium frame at world size
    1 equals render_frame bit for bit (K2, K5 a chunk); make_sharded_render
    equals render_rays' per-sample route (K1)."""
    from danerf_tpu_torch.parallel.mesh import make_sharded_render
    from danerf_tpu_torch.render.renderer import render_frame, render_rays

    cfg, model, o, d, emb, _, _ = _inputs(dev, n=4093)
    c2w = torch.eye(4)
    c2w[2, 3] = 4.0
    frames = [render_frame(model, cfg, c2w, 200, 200, 240.0, appearance_embedding=emb[0],
                           perturb=True, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev, mesh=m) for m in (nccl_mesh, None)]
    assert all(torch.equal(a, b) for a, b in zip(*frames))
    fr.reset_launch_counts()
    with torch.no_grad():
        got = make_sharded_render(cfg, nccl_mesh, 0, 0, 64, 64)(model, o, d, emb)
    assert fr.LAUNCHES["mlp_fwd"] == 2 and sum(fr.LAUNCHES.values()) == 2
    out = render_rays(model, cfg, o, d, emb, perturb=False, fused_composite=False)
    assert all(torch.equal(a, out[k]) for a, k in zip(got, ("rgb", "depth", "acc")))


def test_gloo_group_on_the_card_refuses_a_captured_step(dev, nccl_mesh):
    """A gloo collective cannot join a CUDA graph: make_sharded_train_step
    with steps_per_call > 1 over a gloo data group on the card raises."""
    import copy

    import torch.distributed as dist

    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer

    cfg = NeRFConfig()
    mesh = copy.copy(nccl_mesh)
    mesh.data_group = dist.new_group([0], backend="gloo")
    ds = _chain_scene(cfg)
    model, table = init_model(cfg, ds.n_images, 0, dev)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    with pytest.raises(ValueError, match="gloo backend cannot join"):
        make_sharded_train_step(model, table, opt, sched, ds.device_arrays(device=dev), cfg,
                                mesh, 16, 16, 20.0, None, None, 10)
