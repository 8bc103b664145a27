"""The training paths beside the default 64 + 64 one, their plain versions
against danerf_tpu on the CPU:

- K7's plain version (``fused_train_loss_grads``) against the JAX package's
  ``fused_train_loss_grads`` (Pallas interpret mode, as tests/test_kernels.py
  runs it), f32 and bf16, with and without the embedding, and at a sample
  count that does not divide the kernel's tile;
- K6's plain version (``MergedFn``'s backward) against ``jax.vjp`` of the
  JAX package's ``fused_render_rays_merged``, with a coarse/fine tie in z,
  under every cotangent non-zero, the white-background pattern (None for
  depth and the weights) and rgb alone;
- the coarse-only kernel-route step (``num_importance=0``) against the JAX
  package's ``_onepass_loss_grads``;
- the white-background kernel-route step, hierarchical and coarse-only,
  against ``jax.value_and_grad(loss_fn)`` with ``use_pallas=True``.

Small config (hidden 64, 4 layers, skip at 2, appearance 16) with the
params from the JAX init, as tests/test_torch_train.py; rays, targets and
cotangents from seeded numpy, the jitter from ``jax.random`` draws handed
to both packages.

Tolerances, as tests/test_torch_train.py states them: f32 losses within
1e-5 relative, each gradient leaf within rtol 1e-4 + atol 2e-5 (another
summation order, and an f32 relu gate that can flip on a rounding
boundary); bf16 gradients as the concatenation of all leaves within 3e-2
relative (a value on a bf16 rounding boundary rounds apart).  Per-ray
cotangents: demb 1e-5 (f32) / 2e-3 (bf16) under O(1) cotangents, as the K3
test; 1e-7 / 1e-4 under the MSE's 2 / (3R); K6's g_field (values up to
~0.3) 1e-5 / 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels.fused_render import (fused_render_rays_coarse_field,
                                             fused_render_rays_merged,
                                             fused_train_loss_grads)
from danerf_tpu.models import init_appearance_embeddings as j_init_app
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
from danerf_tpu_torch.utils.convert import params_to_jax

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5)
R, SC, SF = 24, 16, 8
GRAD_RTOL = {False: 1e-4, True: 3e-2}
GRAD_ATOL_F32 = 2e-5
DEMB_ATOL = {False: 1e-5, True: 2e-3}        # O(1) cotangents
DEMB_MSE_ATOL = {False: 1e-7, True: 1e-4}    # the MSE's 2 / (3R)


def _setup(use_bf16, seed=0, samples=SC, **over):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(R, cfg.appearance_dim)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, samples + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((R, samples)) * (edges[1] - edges[0])).astype(np.float32)
    return jcfg, cfg, params, model, o, d, emb, z, rng


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _port_grads(model):
    return params_to_jax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                          for n, p in model.named_parameters()})


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


@pytest.mark.parametrize("use_bf16,with_emb,samples", [
    (False, True, SC), (False, False, SC), (True, True, SC), (True, False, SC),
    (False, True, 12), (True, True, 12)],
    ids=["f32-emb", "f32-emb_none", "bf16-emb", "bf16-emb_none", "f32-emb-s12", "bf16-emb-s12"])
def test_march_train_plain_matches_jax(use_bf16, with_emb, samples):
    """K7's plain version: the loss, every parameter gradient and demb; also
    at 12 samples a ray, which do not divide the kernel's 128-row tile (10
    rays a tile, 8 rows of no ray)."""
    jcfg, cfg, params, model, o, d, emb, z, rng = _setup(use_bf16, samples=samples)
    target = rng.random((R, 3)).astype(np.float32)
    e = emb if with_emb else None
    j_mse, j_grads, j_demb = fused_train_loss_grads(params, jcfg, o, d, z, target, e)
    mse, grads, demb = fr.fused_train_loss_grads(
        model, cfg, *(torch.tensor(x) for x in (o, d, z, target)),
        None if e is None else torch.tensor(e))
    np.testing.assert_allclose(float(mse), float(j_mse), rtol=1e-5)
    _assert_grads(params_to_jax(grads), j_grads, use_bf16, "coarse train params")
    np.testing.assert_allclose(demb.numpy(), np.asarray(j_demb), atol=DEMB_MSE_ATOL[use_bf16],
                               err_msg="demb")


@pytest.mark.parametrize("use_bf16,used", [
    (False, ("rgb", "depth", "acc", "weights")), (True, ("rgb", "depth", "acc", "weights")),
    (False, ("rgb", "acc")), (True, ("rgb", "acc")), (False, ("rgb",)), (True, ("rgb",))],
    ids=["f32", "bf16", "f32-white", "bf16-white", "f32-rgb_only", "bf16-rgb_only"])
def test_merged_bwd_plain_matches_jax_vjp(use_bf16, used):
    """K6's plain version through MergedFn's backward: the gradients of the
    parameters, the embedding and the coarse field under the cotangents
    the kernel sees: non-zero ones of rgb, depth, acc and the merged
    weights; the white-background pattern (only rgb and acc used, so
    autograd hands None for depth and the weights, against JAX's zeros);
    and rgb alone."""
    jcfg, cfg, params, model, o, d, emb, z, rng = _setup(use_bf16)
    field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb)["field"])
    zf = np.sort(rng.uniform(2.0, 6.0, size=(R, SF)).astype(np.float32), axis=-1)
    zf[:, 0] = z[:, 3]   # a coarse/fine tie: the coarse sample goes first
    zf = np.sort(zf, axis=-1)
    cot = {"rgb": rng.normal(size=(R, 3)), "depth": rng.normal(size=R),
           "acc": rng.normal(size=R), "weights": rng.normal(size=(R, SC + SF)) * 0.3}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    cot = {k: v if k in used else np.zeros_like(v) for k, v in cot.items()}
    _, vjp = jax.vjp(lambda p, e, f: fused_render_rays_merged(p, jcfg, o, d, z, f, zf, e),
                     params, jnp.asarray(emb), jnp.asarray(field))
    j_params, j_emb, j_field = vjp({**{k: jnp.asarray(v) for k, v in cot.items()},
                                    "z_vals": jnp.zeros((R, SC + SF), jnp.float32)})
    emb_t = torch.tensor(emb, requires_grad=True)
    field_t = torch.tensor(field, requires_grad=True)
    out = fr.fused_render_rays_merged(model, cfg, torch.tensor(o), torch.tensor(d),
                                      torch.tensor(z), field_t, torch.tensor(zf), emb_t)
    np.testing.assert_array_equal(out["z_vals"].numpy(), np.sort(np.concatenate([z, zf], -1)))
    sum((out[k] * torch.tensor(cot[k])).sum() for k in used).backward()
    _assert_grads(_port_grads(model), j_params, use_bf16, "merged params")
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(j_emb), atol=DEMB_ATOL[use_bf16],
                               err_msg="demb")
    np.testing.assert_allclose(field_t.grad.numpy(), np.asarray(j_field),
                               atol=DEMB_ATOL[use_bf16], err_msg="g_field")


def _batch(rng, n=R):
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    img = rng.integers(0, 3, size=n)            # repeated rows: the scatter-add sums them
    return {"rays_o": o, "rays_d": d, "rgb": rng.random((n, 3)).astype(np.float32),
            "img_idx": img.astype(np.int32)}


def _step_pair(use_bf16, with_jax=True, **over):
    """The kernel-route step of both packages on the same params, table,
    batch and jitter: the JAX package's own route for the config (the
    one-pass ``_onepass_loss_grads`` or ``value_and_grad(loss_fn)``, as its
    ``compute_loss_and_grads`` picks) against the port's
    ``compute_loss_and_grads``.  Returns (JAX (loss, aux, grads) or None,
    port (loss, aux, model grads, table grad))."""
    from danerf_tpu.train.trainer import compute_loss_and_grads as j_compute
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    over = {"num_samples": SC, "num_importance": SF, **over}
    jcfg, cfg, params, model, *_, rng = _setup(use_bf16, **over)
    jcfg = jcfg.replace(use_pallas=True, use_fused_train=True)
    table = np.asarray(j_init_app(jax.random.key(1), 5, cfg.appearance_dim))
    batch = _batch(rng)
    key = jax.random.key(13)
    want = None
    if with_jax:
        (j_loss, j_aux), j_grads = j_compute({"model": params, "appearance": jnp.asarray(table)},
                                             jcfg, key, batch)
        want = (j_loss, j_aux, j_grads)
    k_strat, k_imp = jax.random.split(key)
    u_strat = torch.tensor(np.asarray(jax.random.uniform(k_strat, (R, SC))))
    if cfg.num_importance > 0:
        draws = (u_strat, torch.tensor(np.asarray(jax.random.uniform(k_imp, (R, SF)))))
    elif cfg.white_background:
        draws = (u_strat, None)
    else:
        draws = (u_strat,)
    t_table = torch.nn.Parameter(torch.tensor(table))
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    t_batch["img_idx"] = t_batch["img_idx"].long()
    fr.reset_launch_counts()
    loss, aux = compute_loss_and_grads(model, t_table, cfg, t_batch, draws=draws)
    assert not any(fr.LAUNCHES.values())     # CPU tensors take the plain versions
    return want, (loss, aux, _port_grads(model), t_table.grad)


def _assert_step(pair, use_bf16, keys):
    (j_loss, j_aux, j_grads), (loss, aux, grads, g_table) = pair
    assert set(aux) == set(keys) == set(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in keys:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, err_msg=k)
    _assert_grads(grads, j_grads["model"], use_bf16, "step model grads")
    _assert_grads([g_table.numpy()], [j_grads["appearance"]], use_bf16, "step table grad")
    assert np.count_nonzero(g_table.numpy().any(axis=1)) == 3   # only the batch's images


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_onepass_coarse_step_matches_jax(use_bf16):
    """The coarse-only kernel-route step (K7's plain version) against the
    JAX one-pass step: loss, mse and every gradient leaf, the appearance
    table's scatter-add included; only the stratified jitter is drawn."""
    _assert_step(_step_pair(use_bf16, num_importance=0), use_bf16, ("mse",))


@pytest.mark.parametrize("use_bf16,hier", [(False, True), (True, True), (False, False),
                                           (True, False)],
                         ids=["f32-hier", "bf16-hier", "f32-coarse", "bf16-coarse"])
def test_white_background_step_matches_jax(use_bf16, hier):
    """The white-background kernel-route step against
    jax.value_and_grad(loss_fn): hierarchical (K2, K5 forward; K6, K3
    backward, with the background term in both passes' acc cotangent) and
    coarse-only (K2, K3)."""
    over = dict(white_background=True) if hier else dict(white_background=True,
                                                          num_importance=0)
    keys = ("mse", "coarse_mse") if hier else ("mse",)
    _assert_step(_step_pair(use_bf16, **over), use_bf16, keys)


def test_white_background_changes_the_gradients():
    """The background term moves the loss and the gradients (a route that
    dropped it would still train): the same step without it differs."""
    _, (loss_w, _, grads_w, _) = _step_pair(False, False, white_background=True)
    _, (loss_b, _, grads_b, _) = _step_pair(False, False)
    assert abs(float(loss_w) - float(loss_b)) > 1e-3
    a, b = (np.concatenate([x.ravel() for x in _leaves(g)]) for g in (grads_w, grads_b))
    assert np.linalg.norm(a - b) > 0.1 * np.linalg.norm(b)
