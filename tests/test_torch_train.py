"""The training slice's plain path against danerf_tpu on the CPU:

- K3's plain version (``MarchFn`` backward) against ``jax.vjp`` of the JAX
  package's fused march (Pallas interpret mode, as tests/test_kernels.py
  runs it), every cotangent non-zero, with and without the field output and
  the embedding;
- K4's plain version against ``fused_hier_train_loss_grads``;
- one whole kernel-route step (``_onepass_hier_loss_grads``) against the
  JAX one, and the reference route and the per-sample kernel route (K1/K8's
  plain versions; hierarchical, coarse-only, white background) against
  ``jax.value_and_grad(loss_fn)``;
- torch Adam + StepLR against optax's flattened Adam over the same
  gradients.

Small config (hidden 64, 4 layers, skip at 2, appearance 16); params from
the JAX init (params_from_jax), rays and targets from seeded numpy, the
jitter from ``jax.random`` draws handed to both packages.

Tolerances.  f32: the two packages do the same arithmetic in another
summation order (cumprod vs exp-of-log transmittance, matmul association),
so losses agree to ~1e-6 relative and gradients to ~1e-4 relative; a relu
gate whose input lies within f32 rounding of 0 can flip between the two,
which moves one unit's gradients by ~1e-5 absolute (seen in the step
test), hence each leaf within rtol 1e-4 + atol 2e-5.  bf16: an activation
or cotangent on a bf16 rounding boundary rounds apart in the two sum orders
and moves a leaf by up to a few percent of its norm, so bf16 compares the
concatenation of all leaves at 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels.fused_render import (fused_hier_train_loss_grads,
                                             fused_render_rays_coarse_field,
                                             fused_render_rays_eval)
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


def _setup(use_bf16, seed=0, **over):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(R, cfg.appearance_dim)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, SC + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((R, SC)) * (edges[1] - edges[0])).astype(np.float32)
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


@pytest.mark.parametrize("use_bf16,want_field,with_emb", [
    (False, True, True), (False, False, True), (False, True, False), (False, False, False),
    (True, True, True), (True, False, False)],
    ids=["f32-field-emb", "f32-eval-emb", "f32-field-emb_none", "f32-eval-emb_none",
         "bf16-field-emb", "bf16-eval-emb_none"])
def test_march_bwd_plain_matches_jax_vjp(use_bf16, want_field, with_emb):
    jcfg, cfg, params, model, o, d, emb, z, rng = _setup(use_bf16)
    cot = {"rgb": rng.normal(size=(R, 3)), "depth": rng.normal(size=R),
           "acc": rng.normal(size=R), "weights": rng.normal(size=(R, SC)) * 0.3}
    if want_field:
        cot["field"] = rng.normal(size=(R, 4, SC)) * 0.3
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    jfn = fused_render_rays_coarse_field if want_field else fused_render_rays_eval
    tfn = fr.fused_render_rays_coarse_field if want_field else fr.fused_render_rays_eval
    if with_emb:
        _, vjp = jax.vjp(lambda p, e: jfn(p, jcfg, o, d, z, e), params, jnp.asarray(emb))
        g_params, g_emb = vjp({k: jnp.asarray(v) for k, v in cot.items()})
        emb_t = torch.tensor(emb, requires_grad=True)
    else:
        _, vjp = jax.vjp(lambda p: jfn(p, jcfg, o, d, z, None), params)
        (g_params,) = vjp({k: jnp.asarray(v) for k, v in cot.items()})
        emb_t = None
    out = tfn(model, cfg, torch.tensor(o), torch.tensor(d), torch.tensor(z), emb_t)
    sum((out[k] * torch.tensor(v)).sum() for k, v in cot.items()).backward()
    _assert_grads(_port_grads(model), g_params, use_bf16, "march params")
    if with_emb:
        np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb),
                                   atol=2e-3 if use_bf16 else 1e-5, err_msg="demb")


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_merged_train_plain_matches_jax(use_bf16):
    jcfg, cfg, params, model, o, d, emb, z, rng = _setup(use_bf16)
    field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb)["field"])
    zf = np.sort(rng.uniform(2.0, 6.0, size=(R, SF)).astype(np.float32), axis=-1)
    zf[:, 0] = z[:, 3]   # a coarse/fine tie: the coarse sample goes first
    zf = np.sort(zf, axis=-1)
    target = rng.random((R, 3)).astype(np.float32)
    j_mse, j_grads, j_demb, j_gf = fused_hier_train_loss_grads(
        params, jcfg, o, d, z, field, zf, target, emb)
    mse, grads, demb, g_field = fr.fused_hier_train_loss_grads(
        model, cfg, *(torch.tensor(x) for x in (o, d, z, field, zf, target, emb)))
    np.testing.assert_allclose(float(mse), float(j_mse), rtol=1e-5)
    _assert_grads(params_to_jax(grads), j_grads, use_bf16, "merged train params")
    atol = 1e-4 if use_bf16 else 1e-7
    np.testing.assert_allclose(demb.numpy(), np.asarray(j_demb), atol=atol, err_msg="demb")
    np.testing.assert_allclose(g_field.numpy(), np.asarray(j_gf), atol=atol, err_msg="g_field")


def _batch(cfg, rng, n=R, n_images=5):
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    img = rng.integers(0, 3, size=n)            # repeated rows: the scatter-add sums them
    return {"rays_o": o, "rays_d": d, "rgb": rng.random((n, 3)).astype(np.float32),
            "img_idx": img.astype(np.int32)}


# route: (JAX use_pallas, JAX use_fused_train, the port's use_kernels,
# use_fused_train).  "onepass" is the fused kernel route (K2/K4/K3), whose
# JAX side is _onepass_hier_loss_grads; "per_sample" the per-sample kernel
# route (K1/K8), and "reference" the module's forward, both differentiated
# by jax.value_and_grad(loss_fn) on the JAX side.
STEP_ROUTES = {"onepass": (True, True, True, True), "reference": (False, False, False, True),
               "per_sample": (True, False, True, False)}


def _step_pair(use_bf16, route, **over):
    from danerf_tpu.train.trainer import _onepass_hier_loss_grads as j_onepass
    from danerf_tpu.train.trainer import loss_fn as j_loss_fn
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    over = {"num_samples": SC, "num_importance": SF, **over}
    jcfg, cfg, params, model, *_, rng = _setup(use_bf16, **over)
    use_pallas, j_fused_train, use_kernels, fused_train = STEP_ROUTES[route]
    jcfg = jcfg.replace(use_pallas=use_pallas, use_fused_train=j_fused_train)
    cfg = cfg.replace(use_kernels=use_kernels, use_fused_train=fused_train)
    table = np.asarray(j_init_app(jax.random.key(1), 5, cfg.appearance_dim))
    jparams = {"model": params, "appearance": jnp.asarray(table)}
    batch = _batch(cfg, rng)
    key = jax.random.key(13)
    if route == "onepass":
        (j_loss, j_aux), j_grads = j_onepass(jparams, jcfg, key, batch)
    else:
        (j_loss, j_aux), j_grads = jax.value_and_grad(j_loss_fn, has_aux=True)(
            jparams, jcfg, key, batch)
    k_strat, k_imp = jax.random.split(key)
    draws = (torch.tensor(np.asarray(jax.random.uniform(k_strat, (R, SC)))),
             torch.tensor(np.asarray(jax.random.uniform(k_imp, (R, cfg.num_importance)))))
    t_table = torch.nn.Parameter(torch.tensor(table))
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    t_batch["img_idx"] = t_batch["img_idx"].long()
    loss, aux = compute_loss_and_grads(model, t_table, cfg, t_batch, draws=draws)
    return (j_loss, j_aux, j_grads), (loss, aux, _port_grads(model), t_table.grad)


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_onepass_hier_step_matches_jax(use_bf16):
    """The kernel-route step at Sc = 16, Sf = 8: loss, mse, coarse_mse and
    every gradient leaf, the appearance table's scatter-add included."""
    (j_loss, j_aux, j_grads), (loss, aux, grads, g_table) = _step_pair(use_bf16, "onepass")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in ("mse", "coarse_mse"):
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, err_msg=k)
    _assert_grads(grads, j_grads["model"], use_bf16, "step model grads")
    _assert_grads([g_table.numpy()], [j_grads["appearance"]], use_bf16, "step table grad")
    assert np.count_nonzero(g_table.numpy().any(axis=1)) == 3   # only the batch's images


def test_reference_route_matches_jax_value_and_grad():
    """The reference route (module forward + composite + autograd) against
    jax.value_and_grad(loss_fn), f32."""
    (j_loss, j_aux, j_grads), (loss, aux, grads, g_table) = _step_pair(False, "reference")
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["coarse_mse"]), float(j_aux["coarse_mse"]), rtol=1e-5)
    _assert_grads(grads, j_grads["model"], False, "reference model grads")
    _assert_grads([g_table.numpy()], [j_grads["appearance"]], False, "reference table grad")


@pytest.mark.parametrize("over", [{}, {"num_importance": 0}, {"white_background": True}],
                         ids=["hier", "coarse_only", "white_background"])
def test_per_sample_route_matches_jax_value_and_grad(over):
    """The per-sample kernel route (use_kernels, use_fused_train=False: K1's
    and K8's plain versions, composite, the sorted union for the fine pass)
    against jax.value_and_grad(loss_fn) under use_pallas with
    use_fused_train=False (K1/K8 in interpret mode), f32, same params, batch
    and draws."""
    (j_loss, j_aux, j_grads), (loss, aux, grads, g_table) = _step_pair(False, "per_sample",
                                                                       **over)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(aux) == set(j_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, err_msg=k)
    _assert_grads(grads, j_grads["model"], False, "per-sample model grads")
    _assert_grads([g_table.numpy()], [j_grads["appearance"]], False, "per-sample table grad")


def test_adam_steplr_matches_optax():
    """torch Adam + StepLR stepped after every update equals optax's
    flattened Adam under the staircase schedule, across a decay."""
    from danerf_tpu.train.trainer import make_optimizer as j_make_optimizer
    from danerf_tpu_torch.train.trainer import lr_schedule, make_optimizer

    jcfg = JaxConfig(scheduler_step_size=2, scheduler_gamma=0.5, learning_rate=1e-2)
    cfg = NeRFConfig(scheduler_step_size=2, scheduler_gamma=0.5, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    opt = j_make_optimizer(jcfg)
    j_params = jax.tree.map(jnp.asarray, init)
    state = opt.init(j_params)
    t_params = [torch.nn.Parameter(torch.tensor(init[k])) for k in ("a", "b")]
    t_opt, sched = make_optimizer(cfg, t_params)
    for step in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
        updates, state = opt.update(jax.tree.map(jnp.asarray, grads), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        assert t_opt.param_groups[0]["lr"] == pytest.approx(lr_schedule(cfg)(step))
        for p, k in zip(t_params, ("a", "b")):
            p.grad = torch.tensor(grads[k])
        t_opt.step()
        sched.step()
        for p, k in zip(t_params, ("a", "b")):
            # the two compute m_hat / (sqrt(v_hat) + eps) in another
            # order: ~1 f32 ulp of the update, 1e-7 next to parameters of ~1
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k} at step {step}")


def test_kernel_route_refuses_unported_configs():
    """Coarse-only (K7), white-background (K6) and use_time training (the
    has_time variants, tests/test_torch_time.py) run on the kernel route
    now; use_time takes loss_fn's route, as in the JAX package, and refuses
    a batch without per-ray times."""
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads, use_onepass

    _, cfg, _, model, *_ = _setup(False)
    assert use_onepass(cfg) and not use_onepass(cfg.replace(use_time=True))
    with pytest.raises(ValueError, match="per-ray times"):
        compute_loss_and_grads(model, None, cfg.replace(use_time=True), {})


def test_merged_render_still_refuses_autograd():
    """fused_render_rays_merged is differentiable through the module (K6,
    tests/test_torch_train_paths.py); through a packed copy of the weights,
    which autograd cannot reach, it still refuses."""
    from danerf_tpu_torch.kernels.fused_mlp import pack_params

    _, cfg, _, model, o, d, emb, z, _ = _setup(False)
    field = torch.zeros(R, 4, SC, requires_grad=True)
    with pytest.raises(ValueError, match="module"):
        fr.fused_render_rays_merged(pack_params(model, cfg), cfg, torch.tensor(o),
                                    torch.tensor(d), torch.tensor(z), field, torch.tensor(z),
                                    torch.tensor(emb))
    out = fr.fused_render_rays_merged(model, cfg, torch.tensor(o), torch.tensor(d),
                                      torch.tensor(z), field, torch.tensor(z), torch.tensor(emb))
    assert out["rgb"].requires_grad and not out["z_vals"].requires_grad
