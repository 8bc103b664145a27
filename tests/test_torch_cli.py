"""The port's ``train`` entry point end to end on the CPU: ``cli.main
train --device cpu`` on a tiny Blender scene at a small config (hidden 32,
2 layers, 8 + 4 samples, one warm-up step, 16-ray batches) writes its
checkpoints and metrics, and ``render --device cpu`` reads the final
checkpoint.  The small config replaces the defaults of ``NeRFConfig`` for
the duration of the test (the CLI has no width flags, as the JAX CLI has
none)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from danerf_tpu_torch import config as config_mod

torch.set_num_threads(2)


@dataclasses.dataclass(frozen=True)
class _Small(config_mod.NeRFConfig):
    hidden_dim: int = 32
    num_layers: int = 2
    skip_connect_layers: tuple = (1,)
    appearance_dim: int = 8
    num_samples: int = 8
    num_importance: int = 4
    warmup_iters: int = 1
    density_bias_init: float = 0.5


@pytest.fixture
def scene(tmp_path, monkeypatch):
    from danerf_tpu_torch.viz.png import write_png

    monkeypatch.setattr(config_mod, "NeRFConfig", _Small)
    root = tmp_path / "data"
    (root / "tiny" / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = []
    for i, ang in enumerate((0.0, 1.2)):
        write_png(str(root / "tiny" / "train" / f"r_{i}.png"),
                  rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = c2w[:3, 2] * 4.0
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (root / "tiny" / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return root


@pytest.mark.parametrize("route", [[], ["--no_pallas"]], ids=["kernel_route", "reference_route"])
def test_cli_train_then_render(scene, tmp_path, route):
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.utils.checkpoint import latest_checkpoint

    save = tmp_path / "run"
    model, table, logger = main(["train", "--dataset_path", str(scene), "--scene", "tiny",
                                 "--iters", "8", "--checkpoint_every", "4", "--batch_size",
                                 "16", "--save_dir", str(save), "--device", "cpu", *route])
    for name in ("checkpoint_000004.pt", "checkpoint_000008.pt", "checkpoint_final.pt",
                 "metrics.jsonl"):
        assert (save / name).exists(), name
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["psnr"]) for r in rows)
    ckpt = torch.load(save / "checkpoint_final.pt", weights_only=False)
    assert ckpt["iteration"] == 8 and ckpt["appearance_embeddings"].shape == (2, 8)
    assert {"optimizer_state_dict", "scheduler_state_dict", "loss", "psnr"} <= set(ckpt)
    assert ckpt["scheduler_state_dict"]["last_epoch"] == 8
    assert latest_checkpoint(str(save)).endswith("checkpoint_final.pt")

    out = tmp_path / "frames"
    written = main(["render", "--checkpoint", str(save / "checkpoint_final.pt"),
                    "--dataset_path", str(scene), "--scene", "tiny", "--output_dir", str(out),
                    "--frames", "1", "--width", "10", "--height", "6", "--quality", "preview",
                    "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])


@pytest.mark.parametrize("flags", [["--num_importance", "0"], ["--white_background"]],
                         ids=["coarse_only", "white_background"])
def test_cli_train_paths(scene, tmp_path, flags):
    """The other kernel-route training paths through the entry point: the
    coarse-only one-pass step (K7's plain version) and the white-background
    step (K2, K5 forward; K6, K3 backward)."""
    from danerf_tpu_torch.cli.main import main

    save = tmp_path / "run"
    main(["train", "--dataset_path", str(scene), "--scene", "tiny", "--iters", "3",
          "--batch_size", "16", "--save_dir", str(save), "--device", "cpu", *flags])
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert ("coarse_mse" in rows[0]) == ("--white_background" in flags)
    ckpt = torch.load(save / "checkpoint_final.pt", weights_only=False)
    assert ckpt["iteration"] == 3 and ckpt["appearance_embeddings"].shape == (2, 8)


# --use_time, --resume, --profile and the mesh and multi-process flags are
# ported (tests/test_torch_parallel.py trains in 2 processes): without a
# process group --mesh_data 2 trains on one rank, as the JAX CLI does with
# more axis than devices, and a partial set of the multi-process flags
# raises before any work, naming the missing ones.
@pytest.mark.parametrize("flag", [["--mesh_data", "2"], ["--num_processes", "2"]],
                         ids=["mesh", "multihost"])
def test_cli_train_refuses_unported_flags(scene, tmp_path, flag):
    from danerf_tpu_torch.cli.main import main

    save = tmp_path / "run"
    argv = ["train", "--dataset_path", str(scene), "--scene", "tiny", "--iters", "2",
            "--batch_size", "16", "--save_dir", str(save), "--device", "cpu", *flag]
    if "--mesh_data" in flag:
        main(argv)
        ckpt = torch.load(save / "checkpoint_final.pt", weights_only=False)
        assert ckpt["iteration"] == 2
    else:
        with pytest.raises(ValueError, match="coordinator_address, num_processes and "
                                             "process_id are needed together"):
            main(argv)
        assert not save.exists()


def test_cli_train_resume_continues(scene, tmp_path):
    """train --resume continues a 3-step run to 5: rows 4 and 5 are appended
    to its metrics.jsonl and the final checkpoint is at step 5."""
    from danerf_tpu_torch.cli.main import main

    save = tmp_path / "run"
    argv = ["train", "--dataset_path", str(scene), "--scene", "tiny", "--batch_size", "16",
            "--save_dir", str(save), "--device", "cpu"]
    main([*argv, "--iters", "3"])
    main([*argv, "--iters", "5", "--resume"])
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    ckpt = torch.load(save / "checkpoint_final.pt", weights_only=False)
    assert ckpt["iteration"] == 5 and ckpt["scheduler_state_dict"]["last_epoch"] == 5
    assert "generator_state" in ckpt


def test_cli_train_use_time_resume_continues(time_scene, tmp_path):
    """The same under --use_time on the time-varying scene."""
    from danerf_tpu_torch.cli.main import main

    save = tmp_path / "run"
    argv = ["train", "--use_time", "--dataset_path", str(tmp_path / "no_data"),
            "--batch_size", "16", "--save_dir", str(save), "--device", "cpu"]
    main([*argv, "--iters", "3"])
    model, table, logger = main([*argv, "--iters", "5", "--resume"])
    assert model.cfg.use_time and [r["step"] for r in logger.history] == [4, 5]
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert torch.load(save / "checkpoint_final.pt", weights_only=False)["iteration"] == 5


def test_cli_train_profile_writes_a_trace(scene, tmp_path):
    """train --profile DIR writes a torch.profiler trace of 20 steps into
    DIR (that run's checkpoint under DIR/run), then trains as asked."""
    from danerf_tpu_torch.cli.main import main

    save, prof = tmp_path / "run", tmp_path / "prof"
    main(["train", "--dataset_path", str(scene), "--scene", "tiny", "--iters", "2",
          "--batch_size", "16", "--save_dir", str(save), "--device", "cpu", "--profile",
          str(prof)])
    (trace_file,) = prof.glob("trace_*.json")
    assert "traceEvents" in json.loads(trace_file.read_text())
    assert torch.load(prof / "run" / "checkpoint_final.pt",
                      weights_only=False)["iteration"] == 20
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]


def test_cli_version(capsys):
    """--version prints the program and its version, and exits 0."""
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0 and capsys.readouterr().out.startswith("danerf-torch ")


@pytest.fixture
def time_scene(monkeypatch):
    """The small config, and the procedural time-varying scene at 8x8 (16
    views, 16 samples a ray) in place of its 64x64 default."""
    from danerf_tpu_torch.data import synthetic

    monkeypatch.setattr(config_mod, "NeRFConfig", _Small)
    make = synthetic.make_time_varying_scene
    monkeypatch.setattr(synthetic, "make_time_varying_scene",
                        lambda **kw: make(height=8, width=8, n_samples=16, **kw))


def test_cli_train_use_time_then_render(time_scene, tmp_path):
    """train --use_time on the procedural time-varying scene (no Blender
    data), then render --use_time --animate_time of its checkpoint: two
    frames at t = 0 and t = 1.  The checkpoint's first layer is the time
    columns wider, and rendering it without --use_time refuses."""
    from danerf_tpu_torch.cli.main import main

    save, none = tmp_path / "run", str(tmp_path / "no_data")
    model, table, _ = main(["train", "--use_time", "--dataset_path", none, "--iters", "3",
                            "--batch_size", "16", "--save_dir", str(save), "--device", "cpu"])
    assert model.cfg.use_time and table.shape == (16, 8)
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)
    ckpt = str(save / "checkpoint_final.pt")
    sd = torch.load(ckpt, weights_only=False)["model_state_dict"]
    cfg = _Small()
    assert sd["pts_linears.0.weight"].shape[1] == cfg.pos_enc_dim + cfg.time_enc_dim
    out = tmp_path / "frames"
    written = main(["render", "--checkpoint", ckpt, "--use_time", "--animate_time",
                    "--dataset_path", none, "--output_dir", str(out), "--frames", "2",
                    "--width", "6", "--height", "5", "--quality", "medium", "--device", "cpu"])
    assert written == [str(out / "rgb_000.png"), str(out / "rgb_001.png")]
    with pytest.raises(ValueError, match="time-conditioned"):
        main(["render", "--checkpoint", ckpt, "--dataset_path", none, "--output_dir",
              str(out), "--frames", "1", "--width", "6", "--height", "5", "--device", "cpu"])


def test_cli_render_time_without_use_time_warns(scene, tmp_path):
    """--time without --use_time warns (the JAX CLI ignores it silently) and
    renders the model without a time."""
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.models.nerf import NeRF

    ckpt = tmp_path / "m.pt"
    torch.save({"model_state_dict": NeRF(_Small(), torch.Generator().manual_seed(0)).state_dict(),
                "iteration": 0}, ckpt)
    with pytest.warns(UserWarning, match="--use_time"):
        written = main(["render", "--checkpoint", str(ckpt), "--time", "0.5", "--dataset_path",
                        str(scene), "--scene", "tiny", "--output_dir", str(tmp_path / "out"),
                        "--frames", "1", "--width", "6", "--height", "5", "--quality",
                        "preview", "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])


def test_load_model_defaults_to_the_card(tmp_path):
    """load_model puts the module on the card unless the caller asks for the
    CPU, as every other entry point does: without CUDA the default raises,
    and device="cpu" loads."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.checkpoint import load_model

    ckpt = tmp_path / "m.pt"
    torch.save({"model_state_dict": NeRF(_Small(), torch.Generator().manual_seed(0)).state_dict(),
                "iteration": 0}, ckpt)
    if torch.cuda.is_available():
        model, *_ = load_model(str(ckpt), _Small())
        assert model.density_head.weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(ckpt), _Small())
    model, table, _, cfg = load_model(str(ckpt), _Small(), device="cpu")
    assert model.density_head.weight.device.type == "cpu" and table is None
    assert not cfg.use_appearance or "appearance_projection.weight" in model.state_dict()


def test_cli_train_use_time_needs_times(scene, tmp_path):
    """train --use_time on a Blender scene, which has no per-image times,
    raises (as the JAX trainer does)."""
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(ValueError, match="no per-image times"):
        main(["train", "--use_time", "--dataset_path", str(scene), "--scene", "tiny", "--iters",
              "1", "--save_dir", str(tmp_path / "run"), "--device", "cpu"])


@pytest.mark.parametrize("final", [True, False], ids=["final", "numbered"])
def test_cli_render_takes_latest_checkpoint(scene, tmp_path, monkeypatch, capsys, final):
    """render without --checkpoint takes the latest checkpoint of
    checkpoints_<scene> (train's default --save_dir), checkpoint_final.pt
    or else the highest-numbered one, and says which, as the JAX CLI does."""
    from danerf_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    main(["train", "--dataset_path", str(scene), "--scene", "tiny", "--iters", "2",
          "--batch_size", "16", "--checkpoint_every", "1", "--device", "cpu"])
    want = os.path.join("checkpoints_tiny", "checkpoint_final.pt")
    if not final:
        os.remove(want)
        want = os.path.join("checkpoints_tiny", "checkpoint_000002.pt")
    capsys.readouterr()
    written = main(["render", "--dataset_path", str(scene), "--scene", "tiny", "--output_dir",
                    str(tmp_path / "frames"), "--frames", "1", "--width", "6", "--height", "5",
                    "--quality", "preview", "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])
    assert f"Using checkpoint: {want}" in capsys.readouterr().out


def test_cli_render_without_any_checkpoint_exits(scene, tmp_path, monkeypatch):
    """An empty checkpoints_<scene> and no --checkpoint: render exits with
    the JAX CLI's message."""
    from danerf_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    os.makedirs("checkpoints_tiny")
    with pytest.raises(SystemExit, match="No checkpoint found in checkpoints_tiny; pass "
                                         "--checkpoint"):
        main(["render", "--dataset_path", str(scene), "--scene", "tiny", "--output_dir",
              str(tmp_path / "frames"), "--frames", "1", "--device", "cpu"])


# The subcommands of the depth-aware effects pipeline: the JAX CLI's flags and
# defaults, plus the port's own (--device; for spiral --seed, and the model
# axis and multi-process flags that render and train take too).
EXTRA_FLAGS = {"spiral": {"--device": "cuda", "--seed": 0, "--mesh_model": 1,
                          "--coordinator_address": None, "--num_processes": None,
                          "--process_id": None},
               "effects": {"--device": "cuda"},
               "preview": {"--device": "cuda"}, "video": {}}


def _flags(parser, cmd):
    sub = next(a for a in parser._actions if a.dest == "cmd").choices[cmd]
    return {a.option_strings[0]: a.default for a in sub._actions
            if a.option_strings and a.option_strings[0] != "-h"}


@pytest.mark.parametrize("cmd", list(EXTRA_FLAGS))
def test_cli_subcommand_flags_match_jax(cmd):
    from danerf_tpu.cli.main import build_parser as j_build_parser
    from danerf_tpu_torch.cli.main import build_parser

    assert _flags(build_parser(), cmd) == {**_flags(j_build_parser(), cmd), **EXTRA_FLAGS[cmd]}


def _small_checkpoint(tmp_path):
    from danerf_tpu_torch.models.nerf import NeRF

    ckpt = tmp_path / "m.pt"
    torch.save({"model_state_dict": NeRF(_Small(), torch.Generator().manual_seed(0)).state_dict(),
                "appearance_embeddings": torch.randn(2, 8), "iteration": 0}, ckpt)
    return str(ckpt)


def test_cli_spiral_effects_preview_video(scene, tmp_path, monkeypatch, capsys):
    """spiral -> effects -> preview -> video on the CPU, the reference's
    pipeline: spiral writes 11 frames under output/ with depth on frames 0
    and 10 and its video; effects runs all 14 (Fog on the 2 depth frames)
    with a video each; preview sweeps fog_start; video encodes the frames."""
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.fx import EFFECTS
    from danerf_tpu_torch.viz.video import read_avi

    ckpt = _small_checkpoint(tmp_path)
    monkeypatch.chdir(tmp_path)
    written = main(["spiral", "--checkpoint", ckpt, "--dataset_path", str(scene), "--scene",
                    "tiny", "--output_dir", "sp", "--frames", "11", "--width", "8", "--height",
                    "6", "--device", "cpu", "--seed", "1", "--fps", "12"])
    assert written == [os.path.join("output", "sp", f"frame_{i:04d}.png") for i in range(11)]
    assert sorted(p.name for p in (tmp_path / "output" / "sp").glob("depth_*")) == [
        "depth_0000.png", "depth_0010.png"]
    frames, fps = read_avi("output/sp/tiny_spiral.avi")
    assert frames.shape == (11, 6, 8, 3) and fps == 12

    names = main(["effects", "--input_dir", "output/sp", "--device", "cpu"])
    assert names == list(EFFECTS)
    for name in names:
        slug = name.lower().replace(" ", "_")
        outs = sorted(p.name for p in (tmp_path / "output" / "sp_effects" / slug).iterdir())
        assert outs == (["frame_0000.png", "frame_0010.png"] if name == "Fog" else
                        [f"frame_{i:04d}.png" for i in range(11)]), name
        assert read_avi(f"output/sp_effects/{slug}.avi")[0].shape[0] == len(outs)
    one = main(["effects", "--input_dir", "output/sp", "--effect", "Sepia", "--output_dir",
                "one", "--device", "cpu"])
    assert len(one) == 11 and os.path.exists("one/sepia.avi")

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"effects": [{"name": "Fog",
                                             "sweep": {"fog_start": [0.0, 0.2, 0.4]}}]}))
    capsys.readouterr()
    previews = main(["preview", "--image", "output/sp/frame_0000.png", "--depth",
                     "output/sp/depth_0000.png", "--spec", str(spec), "--output_dir", "pv",
                     "--device", "cpu"])
    assert [os.path.basename(p) for p in previews] == [
        f"fog__fog_start={v:g}.png" for v in (0.0, 0.2, 0.4)]
    assert "wrote 3 previews to pv" in capsys.readouterr().out
    assert len(json.loads((tmp_path / "pv" / "manifest.json").read_text())) == 3
    assert read_png(previews[0]).shape == (6, 8, 3)

    assert main(["video", "--input_dir", "output/sp", "--output", "v.mp4", "--pattern",
                 "frame_*.png", "--fps", "5", "--resolution", "16", "12"])
    frames, fps = read_avi("v.avi")
    assert frames.shape == (11, 12, 16, 3) and fps == 5
    with pytest.raises(SystemExit, match="no images matching"):
        main(["video", "--input_dir", "output/sp", "--output", "w.avi"])


def test_cli_render_effect_and_video(scene, tmp_path, capsys):
    """render --effect Fog --create_video writes the fogged frames and
    <scene>_render.avi of them; an unknown effect raises the JAX KeyError;
    --mesh_data 2 without a process group renders single-device with the
    JAX CLI's message, by render and by spiral."""
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.video import read_avi

    ckpt = _small_checkpoint(tmp_path)
    out = tmp_path / "frames"
    argv = ["render", "--checkpoint", ckpt, "--dataset_path", str(scene), "--scene", "tiny",
            "--output_dir", str(out), "--frames", "2", "--width", "8", "--height", "6",
            "--quality", "medium", "--device", "cpu"]
    written = main([*argv, "--effect", "Fog", "--create_video", "--fps", "4"])
    assert written == [str(out / "rgb_000.png"), str(out / "rgb_001.png")]
    frames, fps = read_avi(str(out / "tiny_render.avi"))
    assert fps == 4
    np.testing.assert_array_equal(frames, np.stack([read_png(p) for p in written]))
    assert frames.min() >= 178   # fog: at most 30% of the scene shows through
    with pytest.raises(KeyError, match="unknown effect 'nope'"):
        main([*argv, "--effect", "nope"])
    spiral = ["spiral", "--checkpoint", ckpt, "--dataset_path", str(scene), "--scene", "tiny",
              "--device", "cpu", "--frames", "1", "--width", "8", "--height", "6",
              "--output_dir", str(tmp_path / "output" / "sp")]
    for cmd in (argv, spiral):
        capsys.readouterr()
        assert len(main([*cmd, "--mesh_data", "2"])) >= 1
        assert "--mesh_data 2 > 1 devices; rendering single-device" in capsys.readouterr().out
