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
    model = params_from_jax_module(params, cfg, device="cpu")
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


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_check_kernel_cfg_forward_backward_split(use_bf16, backward):
    """The forward kernels (K1, K2, K5) and the backward kernels K3, K4, K6
    and K7 take both configurations, each on its own library and weights:
    without use_bf16 the f32 backward kernels read the weights transposed
    for the forward and as packed, (out, K) f32, for the transposed chain,
    with each chain block's own offset.  K8 and K9 refuse f32, naming their
    item of ROADMAP.md."""
    from danerf_tpu_torch.kernels.fused_mlp import (_check_bwd_cfg, bwd_weights, fwd_weights,
                                                    transposed_mats)
    from danerf_tpu_torch.models.nerf import NeRF

    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16)
    torch.manual_seed(0)
    packed = pack_params(NeRF(cfg), cfg)
    if not backward:
        for name in ("march", "merged", "mlp_fwd"):
            lib, mats = fwd_weights(packed, cfg, name)
            assert lib == (name if use_bf16 else f"{name}_f32")
            assert mats is (packed.mats if use_bf16 else packed.mats_kn)
        return
    for name in ("march_bwd", "merged_train", "merged_bwd", "march_train"):
        _check_bwd_cfg(cfg, name)
        lib, mats, mats_t, offs = bwd_weights(packed, cfg, name)
        assert lib == (name if use_bf16 else f"{name}_f32")
        if use_bf16:
            want_t, want_offs = transposed_mats(packed, cfg)
            assert mats is packed.mats and torch.equal(mats_t, want_t) and offs == want_offs
        else:
            assert mats is packed.mats_kn and mats_t is packed.mats
            assert mats_t.dtype == torch.float32
            assert offs == (-1, *(packed.mat_at[f"w{i}"][0] for i in range(1, cfg.num_layers)),
                            packed.mat_at["wdir"][0], packed.mat_at["wapp"][0])
    for name, kern in (("mlp_bwd", "K8"), ("hier_onepass", "K9")):
        if use_bf16:
            _check_bwd_cfg(cfg, name)
        else:
            with pytest.raises(NotImplementedError, match=f"{kern} .*the f32 K8 and K9"):
                _check_bwd_cfg(cfg, name)


@pytest.mark.parametrize("kernel", ["K3", "K4", "K6", "K7", "K8", "K9"])
def test_backward_wrappers_refuse_f32_before_anything(kernel, monkeypatch):
    """With use_bf16=False, K8's and K9's wrappers refuse first thing, before
    they look at the device or build a kernel (here, on the CPU), naming the
    f32 K8 and K9 of ROADMAP.md; K3's, K4's, K6's and K7's go for their f32
    library (the build is stopped here)."""
    from danerf_tpu_torch.kernels import _build
    from danerf_tpu_torch.kernels import fused_mlp as fm

    _, cfg, _, model, o, d, emb, z, zf = _setup(False)
    packed = pack_params(model, cfg)
    o, d, emb, z, zf = (torch.tensor(x) for x in (o, d, emb, z, zf))
    field = fr.march_plain(packed, cfg, o, d, emb, z, want_field=True)["field"]
    target = torch.zeros(R, 3)
    call = {"K3": lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, target, None, None, None),
            "K4": lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, zf, target),
            "K6": lambda: fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, field, zf, target, None,
                                             None, None),
            "K7": lambda: fr.march_train_cuda(packed, cfg, o, d, emb, z, target),
            "K8": lambda: fm.fused_bwd_cuda(packed, cfg, o, d, emb, target, target[:, :1]),
            "K9": lambda: fr.hier_onepass_cuda(packed, cfg, o, d, emb, z, zf, target)}[kernel]
    loaded = []

    class Stop(Exception):
        pass

    def load(name):
        loaded.append(name)
        raise Stop(name)

    monkeypatch.setattr(_build, "load", load)
    fr.reset_launch_counts()
    if kernel in ("K8", "K9"):
        with pytest.raises(NotImplementedError, match=f"use_bf16=False is not yet ported to "
                                                      f"{kernel} .*the f32 K8 and K9"):
            call()
        assert loaded == []
    else:
        with pytest.raises(Stop):
            call()
        lib = {"K3": "march_bwd", "K4": "merged_train", "K6": "merged_bwd",
               "K7": "march_train"}[kernel]
        assert loaded == [f"{lib}_f32"]
    assert not any(fr.LAUNCHES.values())


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_f32_kernels_take_the_weights_transposed(use_time):
    """The f32 kernels' weights (mats_kn, packed once with the weights):
    each packed matrix W (out, K) as W^T (K, out) row-major at W's own
    offset, zeros between; bf16 packing has none."""
    from danerf_tpu_torch.kernels.fused_mlp import _check_packed

    over = dict(use_time=True, time_enc_levels=3) if use_time else {}
    cfg = NeRFConfig(**SMALL, use_bf16=False, **over)
    torch.manual_seed(0)
    from danerf_tpu_torch.models.nerf import NeRF

    model = NeRF(cfg)
    packed = pack_params(model, cfg)
    kn = packed.mats_kn
    assert kn.dtype == torch.float32 and kn.shape == packed.mats.shape
    covered = torch.zeros(kn.numel(), dtype=torch.bool)
    for name, (off, (n, k)) in packed.mat_at.items():
        np.testing.assert_array_equal(kn[off:off + n * k].view(k, n).numpy(),
                                      packed.mat(name).t().numpy(), err_msg=name)
        covered[off:off + n * k] = True
    assert not bool(kn[~covered].any())
    cfg16 = cfg.replace(use_bf16=True)
    packed16 = pack_params(model, cfg16)
    assert packed16.mats_kn is None
    _check_packed(packed, torch.device("cpu"), cfg)
    _check_packed(packed16, torch.device("cpu"), cfg16)
    with pytest.raises(ValueError, match="packed params must be torch.bfloat16"):
        _check_packed(packed, torch.device("cpu"), cfg16)
    with pytest.raises(ValueError, match="packed params must be torch.float32"):
        _check_packed(packed16, torch.device("cpu"), cfg)
