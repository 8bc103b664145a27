"""The kernels' plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them):
march_plain vs fused_render_rays_coarse_field / fused_render_rays_eval (K2),
merged_plain vs fused_render_rays_merged (K5).

R = 20 rays pads the Pallas ray tile.  Params come from the JAX package's
init, converted with params_from_jax; rays, depths and embeddings from a
seeded numpy generator.  The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels.fused_render import (fused_render_rays_coarse_field,
                                             fused_render_rays_eval,
                                             fused_render_rays_merged)
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import (enc_widths, kernel_meta,
                                                pack_params,
                                                params_from_jax_module)

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5)
R, SC, SF = 20, 16, 8

# f32: the plain version repeats the Pallas kernel's arithmetic (matmul-form
# encoding, f32 density head) in another summation order, and composites
# with a cumprod where the kernel takes exp(log @ triu): f32 rounding only.
# bf16: additionally one bf16 ulp where an activation sits on a rounding
# boundary and the two sum orders round it apart.
TOL = {False: 5e-5, True: 5e-3}


def _setup(use_bf16, with_emb=True, seed=0):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg)
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(R, cfg.appearance_dim)).astype(np.float32) if with_emb else None
    edges = np.linspace(2.0, 6.0, SC + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((R, SC)) * (edges[1] - edges[0])).astype(np.float32)
    zf = np.sort(rng.uniform(2.0, 6.0, size=(R, SF)).astype(np.float32), axis=-1)
    zf[:, 0] = z[:, 3]   # a tie between coarse and fine depths: coarse goes first
    zf = np.sort(zf, axis=-1)
    return jcfg, cfg, params, model, o, d, emb, z, zf


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


def _close(got, want, keys, atol):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol,
                                   rtol=atol, err_msg=k)


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_emb", [True, False], ids=["emb", "emb_none"])
def test_march_plain_matches_coarse_field_kernel(use_bf16, with_emb):
    jcfg, cfg, params, model, o, d, emb, z, _ = _setup(use_bf16, with_emb)
    want = fused_render_rays_coarse_field(params, jcfg, _j(o), _j(d), _j(z), _j(emb))
    with torch.no_grad():
        got = fr.fused_render_rays_coarse_field(model, cfg, _t(o), _t(d), _t(z), _t(emb))
    assert got["field"].shape == (R, 4, SC) and got["weights"].shape == (R, SC)
    assert float(got["acc"].mean()) > 0.1   # the composite is not vacuous
    _close(got, want, ("rgb", "depth", "acc", "weights", "field"), TOL[use_bf16])


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_march_plain_matches_eval_kernel(use_bf16):
    jcfg, cfg, params, model, o, d, emb, z, _ = _setup(use_bf16)
    want = fused_render_rays_eval(params, jcfg, _j(o), _j(d), _j(z), _j(emb))
    with torch.no_grad():
        got = fr.fused_render_rays_eval(model, cfg, _t(o), _t(d), _t(z), _t(emb))
    assert "field" not in got
    _close(got, want, ("rgb", "depth", "acc", "weights"), TOL[use_bf16])


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_merged_plain_matches_merged_kernel(use_bf16):
    jcfg, cfg, params, model, o, d, emb, z, zf = _setup(use_bf16)
    coarse = fused_render_rays_coarse_field(params, jcfg, _j(o), _j(d), _j(z), _j(emb))
    field = np.asarray(coarse["field"])
    want = fused_render_rays_merged(params, jcfg, _j(o), _j(d), _j(z), _j(field), _j(zf),
                                    _j(emb))
    with torch.no_grad():
        got = fr.fused_render_rays_merged(model, cfg, _t(o), _t(d), _t(z), _t(field),
                                          _t(zf), _t(emb))
    assert got["weights"].shape == (R, SC + SF)
    np.testing.assert_array_equal(got["z_vals"].numpy(), np.asarray(want["z_vals"]))
    _close(got, want, ("rgb", "depth", "acc", "weights"), TOL[use_bf16])


def test_pack_layout():
    """K padded to 16 at the end of the last input segment, offsets aligned
    for the kernels' 32-bit B-fragment loads, weights as (out, K)."""
    from danerf_tpu_torch.models.nerf import NeRF

    cfg = NeRFConfig()
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    packed = pack_params(model, cfg)
    assert packed.mats.dtype == torch.bfloat16 and packed.vecs.dtype == torch.float32
    kx, kd = enc_widths(cfg)
    assert (kx, kd) == (64, 32)
    assert packed.mat("w0").shape == (256, 64)
    assert packed.mat("w4").shape == (256, 256 + 64)
    assert packed.mat("wdir").shape == (128, 256 + 32)
    assert packed.mat("wrgb").shape == (3, 128)
    w4 = model.pts_linears[4].weight.detach()
    np.testing.assert_array_equal(packed.mat("w4")[:, :319].float().numpy(),
                                  w4.to(torch.bfloat16).float().numpy())
    assert not packed.mat("w4")[:, 319:].any()
    assert not packed.mat("w0")[:, 63:].any() and not packed.mat("wdir")[:, 283:].any()
    for off, _ in packed.mat_at.values():
        assert off % 64 == 0
    meta = kernel_meta(packed, cfg)
    # a head of ten values (the last, the time levels: -1 without use_time)
    assert len(meta) == 10 + 2 * 8 + 8 and meta[1] == 1 << 4 and meta[6] == 256
    assert meta[9] == -1

    no_app = pack_params(model, cfg, appearance=False)
    assert not no_app.has_appearance
    assert not no_app.mat("wapp").any() and not no_app.vec("bapp").any()


def test_kernel_route_is_inference_only():
    """Through a packed copy of the weights the kernel route is inference
    only: the march and the merged composite are differentiable (K3, K6)
    but need the module for gradients to reach the parameters."""
    _, cfg, _, model, o, d, emb, z, zf = _setup(False)
    field = fr.fused_render_rays_coarse_field(model, cfg, _t(o), _t(d), _t(z), _t(emb))["field"]
    assert field.requires_grad
    packed = pack_params(model, cfg)
    with pytest.raises(ValueError, match="module"):
        fr.fused_render_rays_eval(packed, cfg, _t(o), _t(d), _t(z),
                                  _t(emb).requires_grad_(True))
    with torch.no_grad(), pytest.raises(ValueError, match="appearance"):
        fr.fused_render_rays_eval(packed, cfg, _t(o), _t(d), _t(z), None)
