"""The CUDA kernels against their plain versions, on the card.

These need a GPU with ``nvcc``: on a host without CUDA each test skips
(decided in the fixture, not at import).  On the card, whose machine has no
JAX (``tests/conftest.py`` imports it, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Full width (default NeRFConfig, 8x256, bf16).  Tolerances: the kernels and
the plain versions round to bf16 at the same places and sum in f32 in
another order, so an activation next to a bf16 rounding boundary can round
apart by one bf16 ulp.  The limits are ``fused_render.PLAIN_TOL``, the ones
chip_smoke.py holds the kernels to (the comment there gives their reasons).
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
    assert fr.LAUNCHES == {"march": 3, "merged": 3}   # 1200 rays in chunks of 500
    assert bool(torch.isfinite(depth).all()) and rgb.shape == (40, 30, 3)
