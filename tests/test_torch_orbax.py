"""``orbax_to_pt.py``: a danerf_tpu checkpoint (3 training steps through
the JAX package, saved by its ``save_checkpoint``) converted to the port's
reference-format ``.pt``, then read by the port: ``render_rays`` against
the JAX ``render_rays`` on the restored params (reference route, f32,
within rtol 1e-5 + atol 1e-5: the depths near 3 differ by f32 rounding of
the sum over the samples), Adam's moments against the JAX ones (split from
optax's flat state and transposed, exactly), StepLR and the count,
``restore_training_state`` and one resumed training step on the CPU
(``train --resume``).  Also with
``--no_appearance`` and ``--use_time`` (the architecture flags), and the
command line.

Small config (hidden 32, 2 layers, appearance 8, 8 + 4 samples, f32) on a
procedural scene of 3 images at 12x12.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import orbax_to_pt  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
             num_samples=8, num_importance=4, density_bias_init=0.5, use_bf16=False,
             warmup_iters=1, batch_size=16, warmup_batch_size=16)


def _jax_checkpoint(tmp_path, steps=3, **over):
    """``steps`` JAX training steps from seed 0, saved as checkpoint_NNNNNN."""
    from danerf_tpu.data.synthetic import make_synthetic_scene, make_time_varying_scene
    from danerf_tpu.train.trainer import create_train_state, make_train_step
    from danerf_tpu.utils.checkpoint import save_checkpoint

    cfg = JaxConfig(**{**SMALL, **over})
    make = make_time_varying_scene if cfg.use_time else make_synthetic_scene
    ds = make(n_images=3, height=12, width=12, n_samples=16)
    state = create_train_state(jax.random.key(0), cfg, ds.n_images)
    step = make_train_step(cfg, ds.height, ds.width, ds.focal)
    pool = ds.device_arrays(cfg.white_background)
    for _ in range(steps):
        state, metrics = step(state, pool)
    path = save_checkpoint(str(tmp_path / "jax"), f"checkpoint_{steps:06d}", state,
                           {"step": steps, **{k: float(v) for k, v in metrics.items()}})
    return cfg, ds, state, path


def _port_cfg(cfg):
    from danerf_tpu_torch.config import NeRFConfig

    return NeRFConfig(**{k: getattr(cfg, k) for k in NeRFConfig.__dataclass_fields__
                         if hasattr(cfg, k)})


@pytest.mark.parametrize("over", [{}, {"use_appearance": False}, {"use_time": True}],
                         ids=["appearance", "no_appearance", "use_time"])
def test_orbax_round_trip(tmp_path, over):
    from danerf_tpu.render.renderer import render_rays as j_render_rays
    from danerf_tpu_torch.render.renderer import render_rays
    from danerf_tpu_torch.utils.checkpoint import load_model
    from danerf_tpu_torch.utils.convert import params_from_jax

    cfg, ds, state, path = _jax_checkpoint(tmp_path, **over)
    out = str(tmp_path / "port" / "checkpoint_000003.pt")
    assert orbax_to_pt.convert(path, out, cfg, ds.n_images) == out
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    assert ckpt["iteration"] == 3 and "generator_state" not in ckpt
    assert np.isfinite(ckpt["loss"]) and np.isfinite(ckpt["psnr"])

    tcfg = _port_cfg(cfg)
    model, table, meta, tcfg = load_model(out, tcfg, "cpu")
    assert meta["iteration"] == 3 and tcfg.use_appearance == cfg.use_appearance
    params = jax.tree.map(np.asarray, state.params)
    if cfg.use_appearance:
        np.testing.assert_array_equal(table.numpy(), params["appearance"])
    else:
        assert table is None
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(20, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(20, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    emb = rng.normal(size=(20, 8)).astype(np.float32) if cfg.use_appearance else None
    t = np.full((20, 1), 0.3, np.float32) if cfg.use_time else None
    want = j_render_rays(params["model"], cfg, jax.random.key(0), jnp.asarray(o), jnp.asarray(d),
                         None if emb is None else jnp.asarray(emb),
                         t=None if t is None else jnp.asarray(t), perturb=False)
    with torch.no_grad():
        got = render_rays(model, tcfg, torch.tensor(o), torch.tensor(d),
                          None if emb is None else torch.tensor(emb),
                          t=None if t is None else torch.tensor(t), perturb=False)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    # Adam: the moments of each parameter, transposed like it, and the count
    adam = orbax_to_pt._adam_state(state.opt_state)
    opt = ckpt["optimizer_state_dict"]
    names = [n for n, _ in model.named_parameters()]
    for key, flat in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        tree = orbax_to_pt._unflatten(np.asarray(flat), params)
        sd = params_from_jax(tree["model"])
        for i, n in enumerate(names):
            np.testing.assert_array_equal(opt["state"][i][key].numpy(), sd[n].numpy())
            assert float(np.abs(sd[n].numpy()).max()) > 0 or key == "exp_avg", n
        if cfg.use_appearance:
            np.testing.assert_array_equal(opt["state"][len(names)][key].numpy(),
                                          tree["appearance"])
    assert all(float(s["step"]) == 3 for s in opt["state"].values())
    assert ckpt["scheduler_state_dict"]["last_epoch"] == 3


def test_converted_checkpoint_resumes(tmp_path, monkeypatch):
    """restore_training_state takes the file, and `train --resume` of the
    port's CLI continues it by one step on the CPU (the small config in
    place of the CLI's default widths; the JAX run's scene saved as a
    Blender scene)."""
    import dataclasses

    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu_torch import config as config_mod
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer
    from danerf_tpu_torch.utils.checkpoint import restore_training_state

    cfg, ds, state, path = _jax_checkpoint(tmp_path)
    save = tmp_path / "run"
    out = orbax_to_pt.convert(path, str(save / "checkpoint_000003.pt"), cfg, ds.n_images)
    tcfg = _port_cfg(cfg)
    model, table = init_model(tcfg, ds.n_images, 0, "cpu")
    opt, sched = make_optimizer(tcfg, list(model.parameters()) + [table])
    assert restore_training_state(out, model, table, opt, sched) == 3
    np.testing.assert_array_equal(table.detach().numpy(), np.asarray(state.params["appearance"]))
    assert opt.param_groups[0]["lr"] == tcfg.learning_rate

    save_blender_scene(ds, str(tmp_path / "data" / "tiny"), split="train")
    small = {k: getattr(tcfg, k) for k in SMALL}
    small_cls = dataclasses.make_dataclass(
        "Small", [(k, type(v), dataclasses.field(default=v)) for k, v in small.items()],
        bases=(config_mod.NeRFConfig,), frozen=True)
    monkeypatch.setattr(config_mod, "NeRFConfig", small_cls)
    main(["train", "--dataset_path", str(tmp_path / "data"), "--scene", "tiny", "--save_dir",
          str(save), "--iters", "4", "--resume", "--checkpoint_every", "0", "--device", "cpu"])
    final = torch.load(str(save / "checkpoint_final.pt"), map_location="cpu", weights_only=False)
    assert final["iteration"] == 4
    assert all(float(s["step"]) == 4 for s in final["optimizer_state_dict"]["state"].values())
    rows = [json.loads(line) for line in open(save / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [4] and np.isfinite(rows[0]["loss"])


def test_orbax_to_pt_command_line(tmp_path, capsys):
    cfg, ds, _, path = _jax_checkpoint(tmp_path, steps=2, hidden_dim=256, num_layers=8,
                                       skip_connect_layers=(4,), appearance_dim=32)
    out = str(tmp_path / "m.pt")
    # the command line's config is the JAX CLI's: the default widths
    orbax_to_pt.main([path, out, "--n_images", str(ds.n_images)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"wrote": out, "step": 2}
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    assert ckpt["model_state_dict"]["pts_linears.0.weight"].shape == (256, 63)
    assert ckpt["appearance_embeddings"].shape == (3, 32)
