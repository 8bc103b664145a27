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
    """The forward kernels (K1, K2, K5) and the backward kernels (K3, K4,
    K6, K7, K8, K9) take both configurations, each on its own library and
    weights: without use_bf16 the f32 K1, K2 and K5 read the packed f32
    weights and their TF32 halves, and every f32 backward kernel (K3, K4,
    K6, K7, K8, K9) the packed f32 weights with their TF32 halves for the
    forward, the weights transposed for its gate pass and the transposed
    weights' TF32 halves for the chain, with each chain block's own
    offset."""
    from danerf_tpu_torch.kernels import _build
    from danerf_tpu_torch.kernels.fused_mlp import bwd_weights, fwd_weights, transposed_mats
    from danerf_tpu_torch.models.nerf import NeRF

    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16)
    torch.manual_seed(0)
    packed = pack_params(NeRF(cfg), cfg)
    if not backward:
        for name in ("march", "merged", "mlp_fwd"):
            lib, weights = fwd_weights(packed, cfg, name)
            assert lib == (name if use_bf16 else f"{name}_f32")
            if use_bf16:
                assert len(weights) == 1 and weights[0] is packed.mats
            else:
                mats, hi, lo = weights
                assert mats is packed.mats and mats.dtype == torch.float32
                assert hi.data_ptr() == packed.mats_tf32[0].data_ptr()
                assert lo.data_ptr() == packed.mats_tf32[1].data_ptr()
        return
    for name in ("march_bwd", "merged_train", "merged_bwd", "march_train", "mlp_bwd",
                 "hier_onepass"):
        lib, mats, mats_t, offs = bwd_weights(packed, cfg, name)
        assert lib == (name if use_bf16 else f"{name}_f32")
        tf32 = not use_bf16 and name in ("march_bwd", "merged_train", "merged_bwd",
                                         "march_train", "mlp_bwd", "hier_onepass")
        if use_bf16:
            want_t, want_offs = transposed_mats(packed, cfg)
            assert len(mats) == 1 and len(mats_t) == 1
            assert mats[0] is packed.mats and torch.equal(mats_t[0], want_t)
            assert offs == want_offs
        else:
            assert tf32
            assert mats[0] is packed.mats and mats[0].dtype == torch.float32
            assert [m.data_ptr() for m in mats[1:3]] == [h.data_ptr() for h in packed.mats_tf32]
            assert len(mats) == 4 and mats[3] is packed.mats_kn
            assert [m.data_ptr() for m in mats_t] == [h.data_ptr() for h in packed.mats_kn_tf32]
        if not use_bf16:
            assert offs == (-1, *(packed.mat_at[f"w{i}"][0] for i in range(1, cfg.num_layers)),
                            packed.mat_at["wdir"][0], packed.mat_at["wapp"][0])
        assert lib in _build.SOURCES and lib in _build._SIGNATURES and lib in fr.LAUNCHES
        # the C entry takes every weight pointer of bwd_weights
        n_ptr = len(_build._SIGNATURES[name][1]) + len(mats) - 1 + len(mats_t) - 1
        assert len(_build._SIGNATURES[lib][1]) == n_ptr
        if not use_bf16:  # the f32 stash's size; K9's holds two row sets a tile
            assert _build.SCRATCH_FN[lib] == ("danerf_hier_onepass_f32_scratch_bytes"
                                              if name == "hier_onepass"
                                              else "danerf_bwd_tf32_scratch_bytes")


@pytest.mark.parametrize("kernel", ["K3", "K4", "K6", "K7", "K8", "K9"])
def test_backward_wrappers_go_for_their_f32_library(kernel, monkeypatch):
    """With use_bf16=False, every backward wrapper (K3, K4, K6, K7, K8, K9)
    goes for its f32 library, before anything launches (the build is
    stopped here, on the CPU): no backward kernel refuses f32."""
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
    with pytest.raises(Stop):
        call()
    lib = {"K3": "march_bwd", "K4": "merged_train", "K6": "merged_bwd", "K7": "march_train",
           "K8": "mlp_bwd", "K9": "hier_onepass"}[kernel]
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


@pytest.mark.parametrize("path", ["per_sample", "hier_onepass"])
def test_f32_k8_k9_steps_on_cpu_take_the_plain_versions(path, monkeypatch):
    """An f32 step (use_bf16=False) on CPU tensors of the per-sample route
    (K1 and K8 at the coarse samples and at the union) and of the one-kernel
    route (K9) takes K8's and K9's plain versions, builds nothing and
    launches nothing; the loss is finite and every parameter gets a
    gradient."""
    from danerf_tpu_torch.kernels import _build
    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    over = {"per_sample": {"use_fused_train": False},
            "hier_onepass": {"use_hier_onepass": True}}[path]
    cfg = NeRFConfig(**SMALL, use_bf16=False, num_samples=SC, num_importance=SF, **over)
    torch.manual_seed(0)
    model = NeRF(cfg)
    calls = {"fused_bwd_plain": 0, "hier_onepass_plain": 0}
    for module, name in ((fm, "fused_bwd_plain"), (fr, "hier_onepass_plain")):
        def spy(*a, _f=getattr(module, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(module, name, spy)

    def load(name):
        raise AssertionError(f"built {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", load)
    rng = np.random.default_rng(5)
    o = rng.normal(size=(R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.3 * rng.normal(size=(R, 3))
    batch = {"rays_o": torch.tensor(o, dtype=torch.float32),
             "rays_d": torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                                    dtype=torch.float32),
             "rgb": torch.tensor(rng.random((R, 3)), dtype=torch.float32),
             "img_idx": torch.tensor(rng.integers(0, 3, size=R))}
    draws = (torch.tensor(rng.random((R, SC)), dtype=torch.float32),
             torch.tensor(rng.random((R, SF)), dtype=torch.float32))
    table = torch.nn.Parameter(torch.tensor(rng.normal(size=(3, cfg.appearance_dim)),
                                            dtype=torch.float32))
    fr.reset_launch_counts()
    loss, aux = compute_loss_and_grads(model, table, cfg, batch, draws=draws)
    want = {"per_sample": {"fused_bwd_plain": 2, "hier_onepass_plain": 0},
            "hier_onepass": {"fused_bwd_plain": 0, "hier_onepass_plain": 1}}[path]
    assert calls == want
    assert not any(fr.LAUNCHES.values())
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(aux["coarse_mse"]))
    assert table.grad is not None and bool(table.grad.abs().sum() > 0)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
