"""Evaluation against danerf_tpu on the CPU: ``_score_view``, the test-time
embedding fit (``optimize_embedding``) on the reference route and on the
kernel route (the port's plain K2/K5/K6/K3 against the JAX kernels in
Pallas interpret mode), the embedding's gradient through the expand of one
embedding over the batch, ``evaluate`` end to end under both protocols,
the ``eval`` subcommand, and ``remat``.

Small config (hidden 32, 2 layers, skip at 1, appearance 8, 8 + 4
samples, f32), params from the JAX init carried across with
``params_from_jax``, views 16x16 of the procedural scenes; the fit's index
draws are the JAX ones (``fold_in(fold_in(key, step), 1)``), handed to the
port through ``idx=`` / ``fit_idx=``.

Tolerances.  The score is the same f32 arithmetic but for SSIM's window
sums (a matmul against JAX's stacked slices): 1e-6.  The fit: the packages
differ in f32 summation order only, and Adam's first steps move each
component by ~lr whatever the gradient's size, so the embedding after 50
reference-route steps agrees within rtol 1e-4 + atol 1e-5, and after 2
kernel-route steps likewise.  One step's embedding gradient: rtol 1e-4 +
atol 1e-7.  ``evaluate``: per view, PSNR within 1e-3 dB and SSIM within
1e-4.  ``remat``: bit for bit against the route without it (the same ops
are recomputed), and within the training test's rtol 1e-4 + atol 2e-5 per
leaf of the JAX ``remat=True`` reference route.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch import config as config_mod
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module

torch.set_num_threads(2)

SMALL = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
             num_samples=8, num_importance=4, density_bias_init=0.5, use_bf16=False)
H = W = 16


def _setup(seed=0, use_kernels=False, **over):
    jcfg = JaxConfig(**{**SMALL, **over}, use_pallas=use_kernels)
    cfg = NeRFConfig(**{**SMALL, **over}, use_kernels=use_kernels)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu").requires_grad_(False)
    return jcfg, cfg, params, model


def _scene(use_time=False, split="val", n_images=2):
    from danerf_tpu.data.synthetic import make_synthetic_scene, make_time_varying_scene
    from danerf_tpu_torch.data.dataset import RayDataset

    make = make_time_varying_scene if use_time else make_synthetic_scene
    ds = make(split=split, n_images=n_images, height=H, width=W, n_samples=16)
    return ds, RayDataset(ds.images, ds.alphas, ds.c2ws, ds.focal, ds.near, ds.far, split,
                          ds.times)


def _jax_idx(key, steps, batch, n_rays):
    """The JAX fit's (steps, batch) index draws under ``key``."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(key, s), 1), (batch,), 0, n_rays))
        for s in range(steps)])


@pytest.mark.parametrize("alpha", [False, True], ids=["no_alpha", "alpha"])
@pytest.mark.parametrize("crop", [False, True], ids=["full", "right_half"])
def test_score_view_matches_jax(alpha, crop):
    from danerf_tpu.train.evaluate import _score_view as j_score
    from danerf_tpu_torch.train.evaluate import _score_view

    rng = np.random.default_rng(0)
    pred = rng.random((18, 20, 3)).astype(np.float32)
    gt = rng.integers(0, 256, (18, 20, 3), dtype=np.uint8)
    a = rng.integers(0, 256, (18, 20), dtype=np.uint8) if alpha else None
    want = np.asarray(j_score(jnp.asarray(pred), jnp.asarray(gt), 10, crop,
                              alpha_u8=None if a is None else jnp.asarray(a)))
    got = _score_view(torch.tensor(pred), torch.tensor(gt), 10, crop,
                      alpha_u8=None if a is None else torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _fit_pair(use_kernels, steps, **over):
    from danerf_tpu.train.evaluate import optimize_embedding as j_fit
    from danerf_tpu_torch.train.evaluate import optimize_embedding

    jcfg, cfg, params, model = _setup(use_kernels=use_kernels, **over)
    ds, _ = _scene(use_time=cfg.use_time)
    gt = ds.images[0].astype(np.float32) / 255.0
    t = float(ds.times[0]) if cfg.use_time else None
    key = jax.random.key(3)
    want = np.asarray(j_fit(params, jcfg, key, ds.c2ws[0], gt, ds.focal, steps=steps, t=t))
    idx = _jax_idx(key, steps, H * (W // 2), H * (W // 2))
    got = optimize_embedding(model, cfg, ds.c2ws[0], gt, ds.focal, steps=steps, t=t,
                             idx=torch.tensor(idx), device="cpu")
    assert all(not p.requires_grad for p in model.parameters())
    return got.numpy(), want


@pytest.mark.parametrize("over", [{}, {"white_background": True}], ids=["black", "white"])
def test_optimize_embedding_reference_route_matches_jax(over):
    got, want = _fit_pair(False, 50, **over)
    assert np.abs(want).max() > 0.1           # the fit moved the embedding
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("over", [{}, {"white_background": True}, {"use_time": True},
                                  {"num_importance": 0}],
                         ids=["hier", "white", "use_time", "coarse_only"])
def test_optimize_embedding_kernel_route_matches_jax(over):
    got, want = _fit_pair(True, 2, **over)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "reference_route"])
def test_embedding_gradient_matches_jax_grad(use_kernels):
    """One step's gradient of the fit's loss in the (app_dim,) embedding:
    the per-ray cotangent (K3's and K6's plain versions on the kernel
    route) summed back through the expand over the batch."""
    from danerf_tpu.render.renderer import render_rays as j_render_rays
    from danerf_tpu_torch.render.renderer import render_rays

    jcfg, cfg, params, model = _setup(use_kernels=use_kernels)
    rng = np.random.default_rng(1)
    o = (rng.normal(size=(40, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(40, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    tg = rng.random((40, 3)).astype(np.float32)
    e0 = (rng.normal(size=8) * 0.3).astype(np.float32)

    def j_loss(e):
        out = j_render_rays(params, jcfg, jax.random.key(0), o, d,
                            appearance_embedding=jnp.broadcast_to(e, (40, 8)), perturb=False,
                            fused_composite=use_kernels)
        return jnp.mean((out["rgb"] - tg) ** 2)

    want = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(e0)))
    emb = torch.tensor(e0, requires_grad=True)
    out = render_rays(model, cfg, torch.tensor(o), torch.tensor(d), emb.expand(40, 8),
                      perturb=False, fused_composite=use_kernels)
    (got,) = torch.autograd.grad(torch.mean((out["rgb"] - torch.tensor(tg)) ** 2), [emb])
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("fit", [False, True], ids=["full_image", "fit"])
@pytest.mark.parametrize("use_time", [False, True], ids=["procedural", "time_varying"])
def test_evaluate_matches_jax(fit, use_time):
    from danerf_tpu.train.evaluate import evaluate as j_evaluate
    from danerf_tpu_torch.train.evaluate import evaluate

    jcfg, cfg, params, model = _setup(use_time=use_time)
    jds, ds = _scene(use_time=use_time, n_images=3)
    table = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32) * 0.3
    steps = 10
    want = j_evaluate(params, jcfg, jds, appearance=table, max_views=2, seed=4,
                      optimize_embeddings=fit, opt_steps=steps)
    n_rays = H * (W // 2)
    key = jax.random.key(4)
    fit_idx = [_jax_idx(jax.random.fold_in(key, 10_000 + i), steps, n_rays, n_rays)
               for i in range(2)]
    got = evaluate(model, cfg, ds, appearance=table, max_views=2, seed=4,
                   optimize_embeddings=fit, opt_steps=steps, device="cpu", fit_idx=fit_idx)
    assert got["protocol"] == want["protocol"] and got["n_views"] == want["n_views"] == 2
    assert [v["view"] for v in got["per_view"]] == [0, 1]
    for g, w in zip(got["per_view"], want["per_view"]):
        assert abs(g["psnr"] - w["psnr"]) < 1e-3, (g, w)
        assert abs(g["ssim"] - w["ssim"]) < 1e-4, (g, w)
    for k in ("psnr", "ssim", "mse"):
        assert set(got) == set(want) and np.isfinite(got[k])


@dataclasses.dataclass(frozen=True)
class _Small(config_mod.NeRFConfig):
    hidden_dim: int = 32
    num_layers: int = 2
    skip_connect_layers: tuple = (1,)
    appearance_dim: int = 8
    num_samples: int = 8
    num_importance: int = 4
    warmup_iters: int = 1
    batch_size: int = 16
    density_bias_init: float = 0.5


def _tiny_scene(root):
    """A Blender scene ``tiny`` of 12x12 RGB frames, two to train on and
    one to validate on; returns the dataset path."""
    from danerf_tpu_torch.viz.png import write_png

    rng = np.random.default_rng(0)
    for split, angles in (("train", (0.0, 1.2)), ("val", (0.6,))):
        (root / "tiny" / split).mkdir(parents=True)
        frames = []
        for i, ang in enumerate(angles):
            write_png(str(root / "tiny" / split / f"r_{i}.png"),
                      rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8))
            c2w = np.eye(4)
            c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                           [-np.sin(ang), 0, np.cos(ang)]]
            c2w[:3, 3] = c2w[:3, 2] * 4.0
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (root / "tiny" / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return str(root)


def test_cli_eval_flags_match_jax():
    from danerf_tpu.cli.main import build_parser as j_build_parser
    from danerf_tpu_torch.cli.main import build_parser

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd").choices["eval"]
        return {a.option_strings[0]: a.default for a in sub._actions
                if a.option_strings and a.option_strings[0] != "-h"}

    assert flags(build_parser()) == {**flags(j_build_parser()), "--device": "cuda"}


@pytest.mark.parametrize("flags", [[], ["--optimize_embeddings", "--opt_steps", "3"],
                                   ["--split", "train", "--no_pallas"]],
                         ids=["val", "val_fit", "train_reference_route"])
def test_cli_eval_from_a_train_checkpoint(tmp_path, monkeypatch, capsys, flags):
    """``train`` writes a .pt, ``eval`` scores it: the JSON line, the
    report, and the same numbers as ``evaluate`` called directly with the
    appearance the JAX ``cmd_eval`` picks (per view on the training split,
    else embedding 0)."""
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.utils.checkpoint import load_model

    monkeypatch.setattr(config_mod, "NeRFConfig", _Small)
    data = _tiny_scene(tmp_path / "data")
    save = tmp_path / "run"
    main(["train", "--dataset_path", data, "--scene", "tiny", "--iters", "3", "--save_dir",
          str(save), "--checkpoint_every", "0", "--device", "cpu"])
    capsys.readouterr()
    ckpt = str(save / "checkpoint_final.pt")
    out = tmp_path / "eval.json"
    res = main(["eval", "--checkpoint", ckpt, "--dataset_path", data, "--scene", "tiny",
                "--max_views", "1", "--out", str(out), "--device", "cpu", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"psnr", "ssim", "mse", "n_views", "protocol"}
    assert line["n_views"] == 1 and np.isfinite(line["psnr"])
    assert json.loads(out.read_text())["per_view"] == res["per_view"]
    split = "train" if "train" in flags else "val"
    cfg = _Small(dataset_path=data, scene="tiny", use_kernels="--no_pallas" not in flags)
    ds = load_dataset(cfg, split)
    model, table, _, cfg = load_model(ckpt, cfg, "cpu")
    app = table if split == "train" else table[:1].repeat(ds.n_images, 1)
    fit = "--optimize_embeddings" in flags
    want = evaluate(model.requires_grad_(False), cfg, ds, appearance=app, max_views=1,
                    optimize_embeddings=fit, opt_steps=3, device="cpu")
    assert line["protocol"] == want["protocol"]
    assert line["psnr"] == want["psnr"] and line["ssim"] == want["ssim"]


def test_cli_eval_refuses_orbax_directory(tmp_path):
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(NotImplementedError, match="orbax_to_pt.py"):
        main(["eval", "--checkpoint", str(tmp_path), "--device", "cpu"])


def _remat_pair(remat):
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads

    jcfg, cfg, params, model = _setup(remat=remat)
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {"rays_o": (rng.normal(size=(24, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32),
             "rays_d": (rng.normal(size=(24, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32),
             "rgb": rng.random((24, 3)).astype(np.float32),
             "img_idx": rng.integers(0, 3, size=24).astype(np.int32)}
    table = (rng.normal(size=(3, 8)) * 0.3).astype(np.float32)
    key = jax.random.key(7)
    k_strat, k_imp = jax.random.split(key)
    draws = (torch.tensor(np.asarray(jax.random.uniform(k_strat, (24, cfg.num_samples)))),
             torch.tensor(np.asarray(jax.random.uniform(k_imp, (24, cfg.num_importance)))))
    t_table = torch.nn.Parameter(torch.tensor(table))
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    t_batch["img_idx"] = t_batch["img_idx"].long()
    loss, _ = compute_loss_and_grads(model, t_table, cfg, t_batch, draws=draws)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    grads["table"] = t_table.grad.clone()
    return (jcfg, params, table, batch, key), loss, grads


def test_remat_matches_jax_and_the_route_without_it():
    from danerf_tpu.train.trainer import loss_fn as j_loss_fn
    from danerf_tpu_torch.utils.convert import params_to_jax

    (jcfg, params, table, batch, key), loss, grads = _remat_pair(True)
    _, loss0, grads0 = _remat_pair(False)
    assert torch.equal(loss, loss0)
    for n in grads:
        assert torch.equal(grads[n], grads0[n]), n
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                                   static_argnums=1)(
        {"model": params, "appearance": jnp.asarray(table)}, jcfg, key, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = params_to_jax({n: g for n, g in grads.items() if n != "table"})
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(j_grads["model"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(grads["table"].numpy(), np.asarray(j_grads["appearance"]),
                               rtol=1e-4, atol=2e-5)


def test_remat_recomputes_the_module_forward(monkeypatch):
    """Under ``remat`` the module's forward runs again in the backward."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.render.renderer import render_rays

    calls = []
    forward = NeRF.forward
    monkeypatch.setattr(NeRF, "forward", lambda self, *a: calls.append(1) or forward(self, *a))
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        _, cfg, _, model = _setup(remat=remat)
        model.requires_grad_(True)
        out = render_rays(model, cfg, torch.zeros(4, 3) + torch.tensor([0.0, 0.0, 4.0]),
                          torch.tensor([[0.0, 0.0, -1.0]] * 4), torch.zeros(4, 8),
                          perturb=False)
        (out["rgb"].sum() + out["coarse_rgb"].sum()).backward()
        assert len(calls) == want, (remat, calls)
