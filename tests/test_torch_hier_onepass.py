"""The one-kernel hierarchical training step (``use_hier_onepass``, K9) of
the port against danerf_tpu on the CPU:

- ``hier_onepass_plain`` (K9's plain version, through the public
  ``fused_hier_onepass_train``) against the JAX ``fused_hier_onepass_train``
  (its Pallas kernel in interpret mode, as tests/test_kernels.py runs it),
  f32 and bf16, without and with the time input: both MSEs, every gradient
  leaf and demb;
- the port's ``use_hier_onepass`` step (``_onepass_hier_fused_loss_grads``)
  against the JAX one with the JAX draws passed in, and against the port's
  own two-kernel step (K2, K4, K3's plain versions) on the same draws;
- the config's warning when the switch is set where no route takes it, and
  the routing: the switch is ignored without ``use_kernels``, with
  ``num_importance=0`` or with ``use_time``.

Small config (hidden 64, 4 layers, skip at 2, appearance 16, 16 + 8
samples, coarse_loss_weight 0.7, 24 rays: not a tile multiple, so the JAX
kernel masks padded rays); params from the JAX init (params_from_jax),
rays, targets and times from seeded numpy, the uniforms and draws from
``jax.random`` handed to both packages.

Tolerances.  The two packages do the same arithmetic in another summation
order; the JAX kernel's CDF is a triangular matmul, the port's a cumsum, and
a u within f32 rounding of a CDF value can change its bracket, which moves
the depth by about as much (the inverse CDF is continuous).  f32: losses
within 1e-5 relative, each gradient leaf within rtol 1e-4 + atol 2e-5 (an
f32 relu gate can flip on a rounding boundary), demb within 1e-7 under the
MSE's 2 / (3R) (values ~1e-3).  bf16: an activation or cotangent on a bf16
rounding boundary rounds apart in the two sum orders, so losses within
1e-4, the gradients as the concatenation of all leaves within 3e-2
relative, demb within 1e-4.  Measured at these seeds: f32 losses 1.7e-7
relative, worst leaf 0.2% of its limit, demb 7.6e-10; bf16 losses 5.7e-6,
gradients 1.2e-3, demb 4.1e-7.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels.fused_render import fused_hier_onepass_train
from danerf_tpu.models import init_appearance_embeddings as j_init_app
from danerf_tpu.models import init_nerf_params
from danerf_tpu.ops.sampling import importance_uniforms as j_importance_uniforms
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
from danerf_tpu_torch.utils.convert import params_to_jax

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5, num_samples=16, num_importance=8, coarse_loss_weight=0.7)
TIME = dict(use_time=True, time_enc_levels=4)
R, SC, SF = 24, 16, 8
LOSS_RTOL = {False: 1e-5, True: 1e-4}
GRAD_RTOL = {False: 1e-4, True: 3e-2}
GRAD_ATOL_F32 = 2e-5
DEMB_ATOL = {False: 1e-7, True: 1e-4}


def _setup(use_bf16, seed=0, **over):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    return jcfg, cfg, params, params_from_jax_module(params, cfg), np.random.default_rng(seed)


def _rays(rng, n=R):
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    return o, d


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _assert_grads(got, want, use_bf16, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    if use_bf16:
        a, b = np.concatenate([x.ravel() for x in g]), np.concatenate([x.ravel() for x in w])
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err < GRAD_RTOL[True], f"{what}: {err}"
        return
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL[False], atol=GRAD_ATOL_F32,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("use_bf16,with_t", [(False, False), (True, False), (False, True),
                                             (True, True)],
                         ids=["f32", "bf16", "f32-time", "bf16-time"])
def test_hier_onepass_plain_matches_jax(use_bf16, with_t):
    """K9's plain version against the JAX one-kernel step on the same
    weights, rays, depths, uniforms and targets (with t: each ray's time,
    the has_time variant, which no route of either package reaches)."""
    jcfg, cfg, params, model, rng = _setup(use_bf16, **(TIME if with_t else {}))
    o, d = _rays(rng)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(R, cfg.appearance_dim)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, SC + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((R, SC)) * (edges[1] - edges[0])).astype(np.float32)
    target = rng.random((R, 3)).astype(np.float32)
    u = np.asarray(j_importance_uniforms(jax.random.key(5), (R,), SF))
    t = rng.random((R, 1)).astype(np.float32) if with_t else None
    j_f, j_c, j_grads, j_demb = fused_hier_onepass_train(params, jcfg, o, d, z, u, target, emb,
                                                         t=t)
    mse_f, mse_c, grads, demb = fr.fused_hier_onepass_train(
        model, cfg, *(torch.tensor(x) for x in (o, d, z, u, target, emb)),
        t=None if t is None else torch.tensor(t))
    np.testing.assert_allclose(float(mse_f), float(j_f), rtol=LOSS_RTOL[use_bf16], err_msg="fine")
    np.testing.assert_allclose(float(mse_c), float(j_c), rtol=LOSS_RTOL[use_bf16],
                               err_msg="coarse")
    _assert_grads(params_to_jax(grads), j_grads, use_bf16, "K9 params")
    np.testing.assert_allclose(demb.numpy(), np.asarray(j_demb), atol=DEMB_ATOL[use_bf16],
                               err_msg="demb")


def _batch(rng, n=R, n_images=5):
    o, d = _rays(rng, n)
    img = rng.integers(0, 3, size=n)            # repeated rows: the scatter-add sums them
    return {"rays_o": o, "rays_d": d, "rgb": rng.random((n, 3)).astype(np.float32),
            "img_idx": img.astype(np.int32)}


def _port_step(model, cfg, table, batch, draws):
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    t_table = torch.nn.Parameter(torch.tensor(table))
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    t_batch["img_idx"] = t_batch["img_idx"].long()
    for p in model.parameters():
        p.grad = None
    loss, aux = compute_loss_and_grads(model, t_table, cfg, t_batch, draws=draws)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    return loss, aux, grads, t_table.grad


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_hier_onepass_step_matches_jax_and_two_kernel_step(use_bf16):
    """One use_hier_onepass step against the JAX _onepass_hier_fused_loss_grads
    (the JAX draws passed in), and against the port's two-kernel step
    (K2, K4, K3) on the same draws: loss, mse, coarse_mse, every gradient
    leaf and the appearance table's scatter-add."""
    from danerf_tpu.train.trainer import _onepass_hier_fused_loss_grads as j_step

    jcfg, cfg, params, model, rng = _setup(use_bf16)
    jcfg = jcfg.replace(use_pallas=True, use_fused_train=True, use_hier_onepass=True)
    cfg = cfg.replace(use_hier_onepass=True)
    table = np.asarray(j_init_app(jax.random.key(1), 5, cfg.appearance_dim))
    batch = _batch(rng)
    key = jax.random.key(13)
    (j_loss, j_aux), j_grads = j_step({"model": params, "appearance": jnp.asarray(table)}, jcfg,
                                      key, batch)
    k_strat, k_imp = jax.random.split(key)
    draws = (torch.tensor(np.asarray(jax.random.uniform(k_strat, (R, SC)))),
             torch.tensor(np.asarray(jax.random.uniform(k_imp, (R, SF)))))
    fr.reset_launch_counts()
    loss, aux, grads, g_table = _port_step(model, cfg, table, batch, draws)
    two = _port_step(model, cfg.replace(use_hier_onepass=False), table, batch, draws)
    assert not any(fr.LAUNCHES.values())   # CPU tensors: the plain versions, no kernel
    for what, (w_loss, w_aux, w_grads, w_table) in (
            ("jax", (j_loss, j_aux, j_grads["model"], j_grads["appearance"])),
            ("two-kernel", two)):
        np.testing.assert_allclose(float(loss), float(w_loss), rtol=LOSS_RTOL[use_bf16],
                                   err_msg=what)
        assert set(aux) == {"mse", "coarse_mse"}
        for k in aux:
            np.testing.assert_allclose(float(aux[k]), float(w_aux[k]), rtol=LOSS_RTOL[use_bf16],
                                       err_msg=f"{what} {k}")
        _assert_grads(grads, w_grads, use_bf16, f"{what} model grads")
        _assert_grads([g_table.numpy()], [np.asarray(w_table)], use_bf16, f"{what} table grad")
    assert np.count_nonzero(g_table.numpy().any(axis=1)) == 3   # only the batch's images


def test_hier_onepass_warns_where_ignored():
    """As the JAX config: the switch warns where no route takes it, and not
    on the one-pass route with a fine pass (nor when off)."""
    for over in ({"use_kernels": False}, {"use_fused_train": False}, {"num_importance": 0},
                 {"use_time": True}):
        with pytest.warns(UserWarning, match="use_hier_onepass=True is ignored"):
            NeRFConfig(use_hier_onepass=True, **over)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        NeRFConfig(use_hier_onepass=True)
        NeRFConfig(use_hier_onepass=False, num_importance=0)


@pytest.mark.parametrize("over,want", [
    ({}, "hier_fused"),
    ({"use_kernels": False}, "loss_fn"),
    ({"num_importance": 0}, "coarse_onepass"),
    ({"use_time": True}, "loss_fn")],
    ids=["on", "no_kernels", "coarse_only", "use_time"])
def test_hier_onepass_routing(monkeypatch, over, want):
    """compute_loss_and_grads takes K9's route only where the JAX package
    takes its one-kernel step: with the kernels, a fine pass and no time."""
    from danerf_tpu_torch.train import trainer

    taken = []
    for name, tag in (("_onepass_hier_fused_loss_grads", "hier_fused"),
                      ("_onepass_hier_loss_grads", "hier_two_kernel"),
                      ("_onepass_loss_grads", "coarse_onepass"), ("loss_fn", "loss_fn")):
        monkeypatch.setattr(trainer, name, lambda *a, _tag=tag, **k: taken.append(_tag) or (
            torch.zeros((), requires_grad=True), {}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = NeRFConfig(**{**SMALL, **over}, use_hier_onepass=True)
    batch = {"t": torch.zeros(R, 1)} if cfg.use_time else {}
    trainer.compute_loss_and_grads(None, None, cfg, batch)
    assert taken == [want]
