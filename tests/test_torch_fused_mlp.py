"""The per-sample field route against danerf_tpu on the CPU: K1's plain
version (``fused_nerf_apply``) against the JAX ``fused_nerf_apply``, K8's
plain version (``FieldFn`` backward) against ``jax.value_and_grad``
through it, ``render_rays(fused_composite=False)`` under ``use_kernels``
against the JAX function under ``use_pallas``, and which plain versions the
per-sample training step runs.  (The step itself against the JAX step is in
tests/test_torch_train.py, beside the other routes.)

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py runs them.  Small config (hidden 64, 4 layers, skip
at 2, appearance 16); params from the JAX init (params_from_jax); points,
directions, embeddings and targets from seeded numpy.

Tolerances.  f32: the plain versions repeat the Pallas kernels' arithmetic
(matmul-form encoding, f32 density head, appearance added after the relu)
in another summation order, so the limits are tests/test_kernels.py's
(rgb 2e-5, sigma 2e-4, each gradient leaf and the embedding's 5e-5).  bf16:
an activation on a bf16 rounding boundary can round apart in the two sum
orders and move an output by ~1e-3, hence 5e-3 (tests/test_torch_kernels.py
takes the same for K2/K5).  Renders: tests/test_torch_render.py's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels import fused_nerf_apply as j_fused_nerf_apply
from danerf_tpu.models import init_nerf_params
from danerf_tpu.render.renderer import render_rays as j_render_rays
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_mlp as fm
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import fused_nerf_apply, params_from_jax_module
from danerf_tpu_torch.render.renderer import render_rays
from danerf_tpu_torch.utils.convert import params_to_jax

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16)
N = 700   # pads the Pallas tile (512 rows at f32, 1024 at bf16): a ragged last tile
TOL = {False: (2e-5, 2e-4), True: (5e-3, 5e-3)}   # (rgb, sigma) by use_bf16


def _setup(use_bf16=False, seed=0, **over):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    return jcfg, cfg, params, params_from_jax_module(params, cfg, device="cpu")


def _inputs(n, cfg, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = rng.normal(size=(n, cfg.appearance_dim)).astype(np.float32)
    return x, d, e, rng


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, grad=False):
    return None if x is None else torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("use_bf16,app", [(False, "emb"), (False, "emb_none"),
                                          (False, "no_projection"), (True, "emb")],
                         ids=["f32-emb", "f32-emb_none", "f32-no_projection", "bf16-emb"])
def test_fused_fwd_plain_matches_jax(use_bf16, app):
    """K1's plain version at N = 700 rows: with an embedding, without one
    (the projection packed as zeros), and for a model without the
    projection."""
    over = {"use_appearance": False} if app == "no_projection" else {}
    jcfg, cfg, params, model = _setup(use_bf16, **over)
    x, d, e, _ = _inputs(N, cfg)
    emb = e if app == "emb" else None
    want_rgb, want_sigma = j_fused_nerf_apply(params, jcfg, _j(x), _j(d), _j(emb))
    with torch.no_grad():
        rgb, sigma = fused_nerf_apply(model, cfg, _t(x), _t(d), _t(emb))
    assert rgb.shape == (N, 3) and sigma.shape == (N,)
    atol_rgb, atol_sigma = TOL[use_bf16]
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=atol_rgb)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=atol_sigma)


def test_fused_nerf_apply_broadcasts():
    """(R, S, 3) points with per-ray directions and embeddings (R, 1, .):
    the same as the flat call on the broadcast rows, and the embedding's
    gradient is the per-row demb summed over each ray's samples."""
    _, cfg, _, model = _setup()
    x, d, e, _ = _inputs(20 * 7, cfg)
    x = torch.tensor(x).view(20, 7, 3)
    d = torch.tensor(d[:20]).view(20, 1, 3)
    emb = torch.tensor(e[:20]).view(20, 1, -1).requires_grad_(True)
    rgb, sigma = fused_nerf_apply(model, cfg, x, d, emb)
    assert rgb.shape == (20, 7, 3) and sigma.shape == (20, 7)
    emb_f = emb.detach().expand(20, 7, -1).reshape(140, -1).requires_grad_(True)
    rgb_f, sigma_f = fused_nerf_apply(model, cfg, x.reshape(140, 3),
                                      d.expand(20, 7, 3).reshape(140, 3), emb_f)
    torch.testing.assert_close(rgb.reshape(140, 3), rgb_f, rtol=0, atol=0)
    torch.testing.assert_close(sigma.reshape(140), sigma_f, rtol=0, atol=0)
    (rgb.sum() + sigma.sum()).backward()
    (rgb_f.sum() + sigma_f.sum()).backward()
    torch.testing.assert_close(emb.grad.view(20, -1), emb_f.grad.view(20, 7, -1).sum(1))


def _port_grads(model):
    return params_to_jax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                          for n, p in model.named_parameters()})


def _bwd_matches_jax(n, with_emb):
    """K8's plain version through autograd (FieldFn) at n rows against
    jax.value_and_grad of tests/test_kernels.py's loss (MSE + 1e-3 mean
    sigma) through the JAX fused_nerf_apply: every parameter leaf and the
    embedding.  Without an embedding the projection's gradients are exactly
    zero."""
    jcfg, cfg, params, model = _setup()
    x, d, e, rng = _inputs(n, cfg, seed=5)
    target = rng.random((n, 3)).astype(np.float32)

    def j_loss(p, emb):
        rgb, sigma = j_fused_nerf_apply(p, jcfg, _j(x), _j(d), emb)
        return jnp.mean((rgb - target) ** 2) + 1e-3 * jnp.mean(sigma)

    if with_emb:
        j_val, (j_grads, j_demb) = jax.value_and_grad(j_loss, argnums=(0, 1))(params, _j(e))
    else:
        j_val, j_grads = jax.value_and_grad(lambda p: j_loss(p, None))(params)
    emb_t = _t(e, grad=True) if with_emb else None
    rgb, sigma = fused_nerf_apply(model, cfg, _t(x), _t(d), emb_t)
    loss = torch.mean((rgb - torch.tensor(target)) ** 2) + 1e-3 * torch.mean(sigma)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    got, want = _port_grads(model), jax.tree.map(np.asarray, j_grads)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key] if hasattr(k, "key") else g[k.idx]
        np.testing.assert_allclose(np.asarray(g), leaf, atol=5e-5,
                                   err_msg=jax.tree_util.keystr(path))
    if with_emb:
        np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(j_demb), atol=5e-5,
                                   err_msg="demb")
    else:
        proj = model.appearance_projection
        assert not proj.weight.grad.any() and not proj.bias.grad.any()


@pytest.mark.parametrize("with_emb", [True, False], ids=["emb", "emb_none"])
def test_fused_bwd_plain_matches_jax_value_and_grad(with_emb):
    """K8's plain version at N = 700 rows (a ragged last tile) against the
    JAX value_and_grad (_bwd_matches_jax)."""
    _bwd_matches_jax(N, with_emb)


@pytest.mark.parametrize("with_emb", [True, False], ids=["emb", "emb_none"])
def test_fused_bwd_plain_matches_jax_below_one_tile(with_emb):
    """K8's plain version at 37 rows, fewer than one tile of either
    package (the CUDA kernel masks 91 of its 128 rows), against the JAX
    value_and_grad (_bwd_matches_jax)."""
    _bwd_matches_jax(37, with_emb)


@pytest.mark.parametrize("bg", [None, (1.0, 1.0, 1.0)], ids=["black", "white"])
@pytest.mark.parametrize("n_importance", [0, 8], ids=["coarse_only", "hier"])
def test_render_rays_per_sample_route_matches(n_importance, bg):
    """render_rays(fused_composite=False) with use_kernels (K1's plain
    version at the coarse samples and at the sorted union) against the JAX
    function with use_pallas (K1 in interpret mode), 16 (+ 8) samples."""
    over = dict(density_bias_init=0.5, num_samples=16, num_importance=n_importance)
    jcfg, cfg, params, model = _setup(**over)
    jcfg = jcfg.replace(use_pallas=True)
    model.requires_grad_(False)
    rng = np.random.default_rng(1)
    o = (rng.normal(size=(24, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(24, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    emb = rng.normal(size=(24, cfg.appearance_dim)).astype(np.float32)
    want = j_render_rays(params, jcfg, jax.random.key(0), _j(o), _j(d), _j(emb),
                         perturb=False, background_color=bg, fused_composite=False)
    fm.reset_launch_counts()
    got = render_rays(model, cfg, _t(o), _t(d), _t(emb), perturb=False, background_color=bg,
                      fused_composite=False)
    assert not any(fm.LAUNCHES.values())   # CPU tensors take the plain versions
    s = 16 + n_importance
    assert got["weights"].shape == (24, s) and float(got["acc"].mean()) > 0.1
    keys = ["rgb", "depth", "acc", "weights", "z_vals"]
    if n_importance:
        keys += ["coarse_rgb", "coarse_depth"]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def _spy(monkeypatch, module, names):
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(module, n)

        def spy(*a, _real=real, _n=n, **k):
            calls[_n] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, n, spy)
    return calls


@pytest.mark.parametrize("n_importance", [8, 0], ids=["hier", "coarse_only"])
def test_per_sample_step_routes_through_k1_k8(monkeypatch, n_importance):
    """use_fused_train=False: no one-pass kernel; the step evaluates the
    field by K1's plain version at the coarse samples (and at the union) and
    runs K8's plain version for each, never the ray-march kernels' plain
    versions."""
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads, use_onepass

    _, cfg, _, model = _setup(density_bias_init=0.5, num_samples=16,
                              num_importance=n_importance)
    assert use_onepass(cfg) and not use_onepass(cfg.replace(use_fused_train=False))
    cfg = cfg.replace(use_fused_train=False)
    mlp = _spy(monkeypatch, fm, ["fused_fwd_plain", "fused_bwd_plain"])
    march = _spy(monkeypatch, fr, ["march_plain", "march_bwd_plain", "march_train_plain",
                                   "merged_plain", "merged_bwd_plain", "merged_train_plain"])
    x, d, _, rng = _inputs(16, cfg)
    batch = {"rays_o": torch.tensor(x * 0.1 + [0.0, 0.0, 4.0], dtype=torch.float32),
             "rays_d": torch.tensor(d - [0.0, 0.0, 2.0], dtype=torch.float32),
             "rgb": torch.tensor(rng.random((16, 3)), dtype=torch.float32),
             "img_idx": torch.tensor(rng.integers(0, 3, size=16))}
    table = torch.nn.Parameter(torch.randn(3, cfg.appearance_dim,
                                           generator=torch.Generator().manual_seed(0)))
    loss, aux = compute_loss_and_grads(model, table, cfg, batch,
                                       generator=torch.Generator().manual_seed(1))
    passes = 2 if n_importance else 1
    assert mlp == {"fused_fwd_plain": passes, "fused_bwd_plain": passes}
    assert not any(march.values()), march
    assert bool(torch.isfinite(loss)) and ("coarse_mse" in aux) == bool(n_importance)
    assert table.grad is not None and all(p.grad is not None for p in model.parameters())


def test_kernel_wrappers_refuse_use_time():
    """The K1/K8 wrappers launch their has_time variants now (held against
    JAX in tests/test_torch_time.py); they refuse use_time without a time
    input, and a time input for a layout without time columns, before any
    build or launch."""
    _, cfg, _, model = _setup(use_bf16=True)
    packed = fm.pack_params(model, cfg)
    x = torch.zeros(4, 3)
    emb = torch.zeros(4, cfg.appearance_dim)
    tcfg = cfg.replace(use_time=True)
    with pytest.raises(ValueError, match="requires a time input"):
        fm.fused_fwd_cuda(packed, tcfg, x, x, emb)
    with pytest.raises(ValueError, match="requires a time input"):
        fm.fused_bwd_cuda(packed, tcfg, x, x, emb, x, x[:, 0])
    with pytest.raises(ValueError, match="use_time is False"):
        fm.fused_fwd_cuda(packed, cfg, x, x, emb, x[:, :1])
