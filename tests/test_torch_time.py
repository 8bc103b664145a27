"""The time-conditioned variant (``use_time``) of the port against danerf_tpu
on the CPU:

- the time-varying procedural scene, byte for byte, and the batches drawn
  from it (each ray carries its image's time);
- the plain versions of the kernels' has_time variants against the JAX
  package's Pallas kernels with ``t`` (interpret mode, as
  tests/test_kernels.py runs them), f32 and bf16: K1/K8
  (``fused_nerf_apply`` and its gradients), K2/K5 (the coarse march with its
  field, the merged composite), K3/K6 (the VJPs of both), K7/K4 (the
  one-pass losses, which take ``t`` though no route of either package
  reaches them with it);
- one ``use_time`` training step, 64 + 64 and coarse-only, against
  ``jax.value_and_grad(loss_fn)`` under ``use_pallas=True``;
- ``render_frame(t=0.3)`` against the JAX ``render_frame``;
- the kernels' layout record with time.

Small config (hidden 64, 4 layers, skip at 2, appearance 16, 4 time
levels); params from the JAX init (params_from_jax), rays, times, targets
and cotangents from seeded numpy, the jitter from ``jax.random`` draws
handed to both packages.

Tolerances, those of tests/test_torch_train_paths.py and
tests/test_torch_kernels.py: the two packages do the same arithmetic in
another summation order.  f32: forward outputs within 5e-5 (K1: rgb 2e-5,
sigma 2e-4, tests/test_torch_fused_mlp.py's), losses within 1e-5 relative,
each gradient leaf within rtol 1e-4 + atol 2e-5 (an f32 relu gate can flip
on a rounding boundary), demb 1e-5 under O(1) cotangents and 1e-7 under the
MSE's 2 / (3R).  bf16: a value on a bf16 rounding boundary rounds apart in
the two sum orders, so forward outputs within 5e-3 and the gradients as the
concatenation of all leaves within 3e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels import fused_nerf_apply as j_fused_nerf_apply
from danerf_tpu.kernels.fused_render import (fused_hier_train_loss_grads,
                                             fused_render_rays_coarse_field,
                                             fused_render_rays_merged,
                                             fused_train_loss_grads)
from danerf_tpu.models import init_appearance_embeddings as j_init_app
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import (enc_widths, fused_nerf_apply, kernel_meta,
                                                pack_params, params_from_jax_module)
from danerf_tpu_torch.utils.convert import params_to_jax

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5, use_time=True, time_enc_levels=4)
R, SC, SF = 20, 16, 8
FWD_TOL = {False: 5e-5, True: 5e-3}
GRAD_RTOL = {False: 1e-4, True: 3e-2}
GRAD_ATOL_F32 = 2e-5
DEMB_ATOL = {False: 1e-5, True: 2e-3}        # O(1) cotangents
DEMB_MSE_ATOL = {False: 1e-7, True: 1e-4}    # the MSE's 2 / (3R)


def _setup(use_bf16, seed=0, **over):
    jcfg = JaxConfig(**SMALL, use_bf16=use_bf16, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=use_bf16, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg)
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(R, cfg.appearance_dim)).astype(np.float32)
    t = rng.random((R, 1)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, SC + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((R, SC)) * (edges[1] - edges[0])).astype(np.float32)
    zf = np.sort(rng.uniform(2.0, 6.0, size=(R, SF)).astype(np.float32), axis=-1)
    zf[:, 0] = z[:, 3]   # a coarse/fine tie: the coarse sample goes first
    zf = np.sort(zf, axis=-1)
    return jcfg, cfg, params, model, o, d, emb, t, z, zf, rng


def _tt(*xs):
    return [torch.tensor(x) for x in xs]


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


def _close(got, want, keys, atol):
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=atol,
                                   rtol=atol, err_msg=k)


# ---------------------------------------------------------------- data

def test_time_varying_scene_matches_jax():
    """Images, alphas, poses, focal and the capture times t_k = k / (n - 1)
    byte for byte at 16x16, and load_dataset picks the scene under
    use_time."""
    from danerf_tpu.data.synthetic import make_time_varying_scene as j_make
    from danerf_tpu_torch.data.synthetic import make_time_varying_scene

    kw = dict(height=16, width=16, n_samples=64)
    want, got = j_make(**kw), make_time_varying_scene(**kw)
    for k in ("images", "alphas", "c2ws", "times"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.focal == want.focal and got.n_images == 16
    np.testing.assert_array_equal(got.times, np.arange(16, dtype=np.float32) / 15)
    # the blobs move: the first and last views' scenes differ
    from danerf_tpu_torch.data.synthetic import field_sigma_rgb

    pts = np.zeros((1, 3))
    assert field_sigma_rgb(pts, t=0.0)[0] != field_sigma_rgb(pts, t=1.0)[0]


def test_sample_ray_batch_carries_image_time(monkeypatch):
    """Each ray's t (B, 1) is its image's capture time, as the JAX batch's
    ``pool["times"][img_idx][:, None]``; a pool without times gives no t."""
    from danerf_tpu_torch.data import dataset as ds_mod
    from danerf_tpu_torch.data import synthetic

    make = synthetic.make_time_varying_scene
    monkeypatch.setattr(synthetic, "make_time_varying_scene",
                        lambda **kw: make(height=8, width=8, n_samples=16, **kw))
    ds = ds_mod.load_dataset(NeRFConfig(use_time=True, dataset_path="no_such_dir"))
    assert ds.times is not None and ds.times.shape == (16,)
    pool = ds.device_arrays()
    cfg = NeRFConfig(use_time=True)
    batch = ds_mod.sample_ray_batch(pool, cfg, 8, 8, ds.focal, batch_size=6, img_idx=5,
                                    pix_idx=torch.arange(6))
    assert batch["t"].shape == (6, 1) and batch["t"].dtype == torch.float32
    np.testing.assert_array_equal(batch["t"].numpy(), np.full((6, 1), ds.times[5]))
    batch = ds_mod.sample_ray_batch(pool, cfg, 8, 8, ds.focal, batch_size=6,
                                    generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(batch["t"][:, 0].numpy(), ds.times[batch["img_idx"].numpy()])
    del pool["times"]
    assert "t" not in ds_mod.sample_ray_batch(pool, cfg, 8, 8, ds.focal, batch_size=6)


# ---------------------------------------------------------------- kernels' plain versions

@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_field_plain_with_time_matches_jax(use_bf16):
    """K1's has_time plain version (``fused_nerf_apply`` with t) against the
    JAX ``fused_nerf_apply`` with t, at 700 rows (a ragged Pallas tile)."""
    jcfg, cfg, params, model, *_ = _setup(use_bf16)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = rng.normal(size=(700, cfg.appearance_dim)).astype(np.float32)
    t = rng.random((700, 1)).astype(np.float32)
    want_rgb, want_sigma = j_fused_nerf_apply(params, jcfg, *map(jnp.asarray, (x, d, e, t)))
    with torch.no_grad():
        rgb, sigma = fused_nerf_apply(model, cfg, *_tt(x, d, e, t))
    atol_rgb, atol_sigma = (2e-5, 2e-4) if not use_bf16 else (5e-3, 5e-3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=atol_rgb)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=atol_sigma)
    with torch.no_grad():
        rgb0, _ = fused_nerf_apply(model, cfg, *_tt(x, d, e, np.zeros_like(t)))
    assert float((rgb0 - rgb).abs().max()) > 1e-3     # the time input is used


def test_field_bwd_plain_with_time_matches_jax():
    """K8's has_time plain version through autograd against
    jax.value_and_grad through the JAX fused_nerf_apply with t (f32): every
    parameter leaf and demb; t gets no gradient in either package."""
    jcfg, cfg, params, model, *_ = _setup(False)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = rng.normal(size=(300, cfg.appearance_dim)).astype(np.float32)
    t = rng.random((300, 1)).astype(np.float32)
    target = rng.random((300, 3)).astype(np.float32)

    def j_loss(p, emb):
        rgb, sigma = j_fused_nerf_apply(p, jcfg, jnp.asarray(x), jnp.asarray(d), emb,
                                        jnp.asarray(t))
        return jnp.mean((rgb - target) ** 2) + 1e-3 * jnp.mean(sigma)

    j_val, (j_grads, j_demb) = jax.value_and_grad(j_loss, argnums=(0, 1))(params, jnp.asarray(e))
    emb_t = torch.tensor(e, requires_grad=True)
    t_t = torch.tensor(t, requires_grad=True)
    rgb, sigma = fused_nerf_apply(model, cfg, *_tt(x, d), emb_t, t_t)
    loss = torch.mean((rgb - torch.tensor(target)) ** 2) + 1e-3 * torch.mean(sigma)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    _assert_grads(_port_grads(model), j_grads, False, "field params")
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(j_demb), atol=5e-5)
    assert t_t.grad is None


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_march_and_merged_plain_with_time_match_jax(use_bf16):
    """K2's plain version with the field output (the JAX
    ``_march_pallas_fwd`` with t) and K5's (``_hier_pallas_fwd`` with t) on
    its field, z_f with a coarse/fine tie."""
    jcfg, cfg, params, model, o, d, emb, t, z, zf, _ = _setup(use_bf16)
    want = fused_render_rays_coarse_field(params, jcfg, o, d, z, emb, jnp.asarray(t))
    with torch.no_grad():
        got = fr.fused_render_rays_coarse_field(model, cfg, *_tt(o, d, z, emb, t))
    assert float(got["acc"].mean()) > 0.1   # the composite is not vacuous
    _close(got, want, ("rgb", "depth", "acc", "weights", "field"), FWD_TOL[use_bf16])
    field = np.asarray(want["field"])
    want = fused_render_rays_merged(params, jcfg, o, d, z, field, zf, emb, jnp.asarray(t))
    with torch.no_grad():
        got = fr.fused_render_rays_merged(model, cfg, *_tt(o, d, z, field, zf, emb, t))
    np.testing.assert_array_equal(got["z_vals"].numpy(), np.asarray(want["z_vals"]))
    _close(got, want, ("rgb", "depth", "acc", "weights"), FWD_TOL[use_bf16])


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_march_and_merged_bwd_plain_with_time_match_jax_vjp(use_bf16):
    """K3's plain version (MarchFn's backward, with the field output) and
    K6's (MergedFn's) against jax.vjp of the JAX functions with t, every
    cotangent non-zero: the parameters', the embedding's and (K6) the coarse
    field's gradients."""
    jcfg, cfg, params, model, o, d, emb, t, z, zf, rng = _setup(use_bf16)
    jt = jnp.asarray(t)
    cot = {"rgb": rng.normal(size=(R, 3)), "depth": rng.normal(size=R),
           "acc": rng.normal(size=R), "weights": rng.normal(size=(R, SC)) * 0.3,
           "field": rng.normal(size=(R, 4, SC)) * 0.3}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    _, vjp = jax.vjp(lambda p, e: fused_render_rays_coarse_field(p, jcfg, o, d, z, e, jt),
                     params, jnp.asarray(emb))
    g_params, g_emb = vjp({k: jnp.asarray(v) for k, v in cot.items()})
    emb_t = torch.tensor(emb, requires_grad=True)
    out = fr.fused_render_rays_coarse_field(model, cfg, *_tt(o, d, z), emb_t, torch.tensor(t))
    sum((out[k] * torch.tensor(v)).sum() for k, v in cot.items()).backward()
    _assert_grads(_port_grads(model), g_params, use_bf16, "march params")
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb), atol=DEMB_ATOL[use_bf16],
                               err_msg="K3 demb")

    model.zero_grad()
    field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb, jt)["field"])
    cot = {"rgb": rng.normal(size=(R, 3)), "depth": rng.normal(size=R),
           "acc": rng.normal(size=R), "weights": rng.normal(size=(R, SC + SF)) * 0.3}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    _, vjp = jax.vjp(lambda p, e, f: fused_render_rays_merged(p, jcfg, o, d, z, f, zf, e, jt),
                     params, jnp.asarray(emb), jnp.asarray(field))
    j_params, j_emb, j_field = vjp({**{k: jnp.asarray(v) for k, v in cot.items()},
                                    "z_vals": jnp.zeros((R, SC + SF), jnp.float32)})
    emb_t = torch.tensor(emb, requires_grad=True)
    field_t = torch.tensor(field, requires_grad=True)
    out = fr.fused_render_rays_merged(model, cfg, *_tt(o, d, z), field_t, torch.tensor(zf),
                                      emb_t, torch.tensor(t))
    sum((out[k] * torch.tensor(v)).sum() for k, v in cot.items()).backward()
    _assert_grads(_port_grads(model), j_params, use_bf16, "merged params")
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(j_emb), atol=DEMB_ATOL[use_bf16],
                               err_msg="K6 demb")
    np.testing.assert_allclose(field_t.grad.numpy(), np.asarray(j_field),
                               atol=DEMB_ATOL[use_bf16], err_msg="K6 g_field")


@pytest.mark.parametrize("kernel", ["k7", "k4"])
def test_onepass_plain_with_time_match_jax(kernel):
    """K7's and K4's has_time plain versions (f32) against the JAX
    ``fused_train_loss_grads`` / ``fused_hier_train_loss_grads`` with t."""
    jcfg, cfg, params, model, o, d, emb, t, z, zf, rng = _setup(False)
    target = rng.random((R, 3)).astype(np.float32)
    jt = jnp.asarray(t)
    if kernel == "k7":
        j_mse, j_grads, j_demb = fused_train_loss_grads(params, jcfg, o, d, z, target, emb, jt)
        mse, grads, demb = fr.fused_train_loss_grads(model, cfg, *_tt(o, d, z, target, emb, t))
    else:
        field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb,
                                                          jt)["field"])
        j_mse, j_grads, j_demb, j_gf = fused_hier_train_loss_grads(
            params, jcfg, o, d, z, field, zf, target, emb, jt)
        mse, grads, demb, g_field = fr.fused_hier_train_loss_grads(
            model, cfg, *_tt(o, d, z, field, zf, target, emb, t))
        np.testing.assert_allclose(g_field.numpy(), np.asarray(j_gf),
                                   atol=DEMB_MSE_ATOL[False], err_msg="g_field")
    np.testing.assert_allclose(float(mse), float(j_mse), rtol=1e-5)
    _assert_grads(params_to_jax(grads), j_grads, False, f"{kernel} params")
    np.testing.assert_allclose(demb.numpy(), np.asarray(j_demb), atol=DEMB_MSE_ATOL[False],
                               err_msg="demb")


# ---------------------------------------------------------------- step, frame

def _step_pair(use_bf16, **over):
    """The use_time kernel-route step of both packages on the same params,
    table, batch (with t) and jitter: the JAX package's
    ``compute_loss_and_grads`` (``value_and_grad(loss_fn)``: use_time takes
    no one-pass kernel) against the port's."""
    from danerf_tpu.train.trainer import compute_loss_and_grads as j_compute
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads, use_onepass

    over = {"num_samples": SC, "num_importance": SF, **over}
    jcfg, cfg, params, model, o, d, _, t, *_, rng = _setup(use_bf16, **over)
    jcfg = jcfg.replace(use_pallas=True, use_fused_train=True)
    assert not use_onepass(cfg)
    table = np.asarray(j_init_app(jax.random.key(1), 5, cfg.appearance_dim))
    batch = {"rays_o": o, "rays_d": d, "rgb": rng.random((R, 3)).astype(np.float32),
             "img_idx": rng.integers(0, 3, size=R).astype(np.int32), "t": t}
    key = jax.random.key(13)
    (j_loss, j_aux), j_grads = j_compute({"model": params, "appearance": jnp.asarray(table)},
                                         jcfg, key, batch)
    k_strat, k_imp = jax.random.split(key)
    u_strat = torch.tensor(np.asarray(jax.random.uniform(k_strat, (R, SC))))
    u_imp = (torch.tensor(np.asarray(jax.random.uniform(k_imp, (R, SF))))
             if cfg.num_importance > 0 else None)
    t_table = torch.nn.Parameter(torch.tensor(table))
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    t_batch["img_idx"] = t_batch["img_idx"].long()
    fr.reset_launch_counts()
    loss, aux = compute_loss_and_grads(model, t_table, cfg, t_batch, draws=(u_strat, u_imp))
    assert not any(fr.LAUNCHES.values())     # CPU tensors take the plain versions
    return (j_loss, j_aux, j_grads), (loss, aux, _port_grads(model), t_table.grad)


@pytest.mark.parametrize("use_bf16,hier", [(False, True), (True, True), (False, False)],
                         ids=["f32-hier", "bf16-hier", "f32-coarse"])
def test_use_time_step_matches_jax(use_bf16, hier):
    """One use_time step through the kernels' plain versions (64 + 64, here
    16 + 8: K2, K5 forward, K6, K3 backward; coarse-only: K2, K3) against
    jax.value_and_grad(loss_fn) with use_pallas=True: loss, mse,
    coarse_mse, every gradient leaf and the appearance table's
    scatter-add."""
    over = {} if hier else {"num_importance": 0}
    (j_loss, j_aux, j_grads), (loss, aux, grads, g_table) = _step_pair(use_bf16, **over)
    assert set(aux) == set(j_aux) == ({"mse", "coarse_mse"} if hier else {"mse"})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, err_msg=k)
    _assert_grads(grads, j_grads["model"], use_bf16, "step model grads")
    _assert_grads([g_table.numpy()], [j_grads["appearance"]], use_bf16, "step table grad")


def test_render_frame_with_time_matches_jax():
    """render_frame at t = 0.3 (f32, 12x10 in chunks of 48, the kernel
    route) against the JAX render_frame at t = 0.3; t = 0.7 renders another
    frame."""
    from danerf_tpu.render.renderer import render_frame as j_render_frame
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    jcfg, cfg, params, model, *_ = _setup(False)
    model.requires_grad_(False)
    c2w = camera_path("circle", 3, "lego")[1]
    emb = np.random.default_rng(2).normal(size=cfg.appearance_dim).astype(np.float32)
    want = j_render_frame(params, jcfg.replace(use_pallas=True), jax.random.key(0), c2w, 12,
                          10, 11.0, appearance_embedding=jnp.asarray(emb), chunk=48, t=0.3)
    got = render_frame(model, cfg, c2w, 12, 10, 11.0, appearance_embedding=torch.tensor(emb),
                       chunk=48, t=0.3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    other = render_frame(model, cfg, c2w, 12, 10, 11.0, appearance_embedding=torch.tensor(emb),
                         chunk=48, t=0.7, device="cpu")
    assert float((other[0] - got[0]).abs().max()) > 1e-3


def test_kernel_meta_carries_time_levels():
    """The layout record's head ends in the time levels (-1 without time);
    with time at the default widths the position encoding is 63 + 13 = 76
    columns, padded to kx = 80, and the first and skip layers are 80 and
    256 + 80 wide, the time columns after the position's."""
    from danerf_tpu_torch.models.nerf import NeRF

    cfg = NeRFConfig(use_time=True)
    assert enc_widths(cfg) == (80, 32) and enc_widths(NeRFConfig()) == (64, 32)
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    packed = pack_params(model, cfg)
    assert packed.mat("w0").shape == (256, 80) and packed.mat("w4").shape == (256, 256 + 80)
    w0 = model.pts_linears[0].weight.detach()
    np.testing.assert_array_equal(packed.mat("w0")[:, :76].float().numpy(),
                                  w0.to(torch.bfloat16).float().numpy())
    assert not packed.mat("w0")[:, 76:].any() and not packed.mat("w4")[:, 256 + 76:].any()
    meta = kernel_meta(packed, cfg)
    assert len(meta) == 10 + 2 * 8 + 8 and meta[4] == 80 and meta[9] == 6
    plain = NeRFConfig()
    assert kernel_meta(pack_params(NeRF(plain), plain), plain)[9] == -1


def test_time_input_must_match_the_config():
    """The kernels and their plain versions take t exactly when the config
    has time columns (before any build or launch)."""
    _, cfg, _, model, o, d, emb, t, z, *_ = _setup(True)
    packed = pack_params(model, cfg)
    with pytest.raises(ValueError, match="time input"):
        fr.march_cuda(packed, cfg, *_tt(o, d, emb, z))
    with pytest.raises(ValueError, match="time input"):
        fr.fused_render_rays_eval(model, cfg, *_tt(o, d, z, emb))
    plain = cfg.replace(use_time=False)
    with pytest.raises(ValueError, match="use_time is False"):
        fr.fused_render_rays_eval(packed, plain, *_tt(o, d, z, emb, t))
    with pytest.raises(ValueError, match="shape"):
        fr.march_cuda(packed, cfg, *_tt(o, d, emb, z), t=torch.zeros(R, 2))
