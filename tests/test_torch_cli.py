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


@pytest.mark.parametrize("flag", [["--resume"], ["--use_time"], ["--mesh_data", "2"],
                                  ["--profile", "x"], ["--num_processes", "2"]],
                         ids=["resume", "use_time", "mesh", "profile", "multihost"])
def test_cli_train_refuses_unported_flags(flag):
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(["train", "--device", "cpu", *flag])
