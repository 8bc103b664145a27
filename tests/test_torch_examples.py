"""The port's example scripts (``danerf_tpu_torch/examples/``) on the CPU at
a narrow width: each writes every numeric key of the report its JAX script
committed (``examples/*_report_v5e.json``), its videos under the JAX names
decode to their frame count, ``measure_io_overlap`` runs on
``full_scale``'s output, the flags reach the run function, and asking for
the card on a host without one raises."""

import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from danerf_tpu_torch.config import NeRFConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
NARROW = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
                    num_samples=8, num_importance=4, batch_size=64, warmup_batch_size=32,
                    warmup_iters=1, render_chunk=128, scheduler_step_size=4)
SCRIPTS = ("full_scale", "measure_io_overlap", "hier_demo", "demo_synthetic", "multi_scene")


def numeric_keys(tree, prefix=()):
    """The key paths of a report's numbers (a list of numbers counts as one)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numeric_keys(v, prefix + (k,))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield prefix
    elif isinstance(tree, list) and tree and all(isinstance(v, (int, float)) for v in tree):
        yield prefix


def holds_numbers_of(report, committed):
    """The numeric keys of the committed JAX report that ``report`` lacks
    or holds as another type."""
    with open(ROOT / "examples" / committed) as f:
        want = json.load(f)
    have = set(numeric_keys(report))
    return ["/".join(path) for path in numeric_keys(want) if path not in have]


def frames_of(path):
    from danerf_tpu_torch.viz.video import read_video

    frames, _ = read_video(str(path))
    return frames.shape


def test_full_scale_and_measure_io_overlap(tmp_path):
    from danerf_tpu_torch.examples import full_scale, measure_io_overlap

    out, path = tmp_path / "fs", tmp_path / "fs.json"
    report = full_scale.run(NARROW, str(out), str(path), iters=9, size=16, train_views=3,
                            val_views=2, frames=2, checkpoint_every=4, device="cpu")
    block = measure_io_overlap.run(str(out), str(path), cfg=NARROW, device="cpu")
    with open(path) as f:
        saved = json.load(f)
    assert saved["io_overlap_remeasure"] == json.loads(json.dumps(block))
    assert holds_numbers_of(saved, "full_scale_report_v5e.json") == []
    assert saved["backend"] == "cpu" and saved["device"]["name"] == "cpu"
    assert set(saved["reduced"]) == {"--iters 9 (default 30000)", "--size 16 (default 800)",
                                     "--train-views 3 (default 100)",
                                     "--val-views 2 (default 16)", "--frames 2 (default 120)"}
    # the mp4s under the JAX names: the spiral's, Fog's (the frames with a
    # depth map: frame 0) and Toon Shader's
    assert frames_of(out / "spiral" / "lego_spiral.mp4") == (2, 16, 16, 3)
    assert frames_of(out / "fog.mp4")[0] == 1 and frames_of(out / "toon_shader.mp4")[0] == 2
    assert report["effects_breakdown"]["Toon Shader"]["frames"] == 2
    # checkpoints at 4 and 8 with their validation renders; StepLR halves
    # the rate at 4 and 8 steps
    rates = report["train"]["lr_at_checkpoints"]
    assert [r[:2] for r in rates["rows"]] == [[4, 4], [8, 8]] and rates["all_match"]
    assert [r[2] for r in rates["rows"]] == [NARROW.learning_rate / 2, NARROW.learning_rate / 4]
    assert [s for s, _ in report["train"]["validation_render_psnr"]] == [4, 8]
    assert report["train"]["curve"]["step_end"] == [4, 8, 9]
    # on the CPU the kernel route's plain versions count no launch
    assert report["train"]["launches"] == {} and report["eval"]["launches"] == {}
    assert report["data"]["device_vs_numpy_val_view_0"]["image"]["max_levels"] <= 1
    assert np.isfinite(report["eval"]["val_psnr"]) and len(report["eval"]["per_view_psnr"]) == 2
    steady = block["steady_state"]
    assert set(steady["effects_device_ms_per_frame_steady"]) == set(
        measure_io_overlap.STEADY_EFFECTS)


def test_hier_demo(tmp_path):
    from danerf_tpu_torch.examples import hier_demo

    report = hier_demo.run(NARROW, iters=4, size=16, out=str(tmp_path), device="cpu")
    with open(tmp_path / "report.json") as f:
        assert json.load(f) == report
    assert holds_numbers_of(report, "hier_report_v5e.json") == []
    assert os.path.exists(tmp_path / "checkpoints" / "checkpoint_final.pt")


def test_demo_synthetic(tmp_path):
    from danerf_tpu_torch.examples import demo_synthetic

    cfg = NARROW.replace(num_importance=0, render_chunk=16 * 16)
    report = demo_synthetic.run(cfg, iters=4, out=str(tmp_path), size=16, frames=2,
                                device="cpu")
    assert holds_numbers_of(report, "demo_report_v5e.json") == []
    assert frames_of(tmp_path / "frames" / "lego_spiral.mp4") == (2, 16, 16, 3)
    assert sorted(os.listdir(tmp_path / "fog_frames")) == ["frame_0000.png"]
    assert report["use_pallas"] is True


def test_multi_scene(tmp_path):
    from danerf_tpu_torch.examples import multi_scene

    cfg = NARROW.replace(num_importance=0, render_chunk=16 * 16)
    report = multi_scene.run(cfg, ("0", "1"), iters=4, size=16, frames=2, out=str(tmp_path),
                             device="cpu")
    assert holds_numbers_of(report, "multi_scene_report_v5e.json") == []
    for name in ("0", "1"):
        assert frames_of(tmp_path / f"spiral_{name}" / f"{name}_spiral.mp4") == (2, 16, 16, 3)
    assert report["0"]["psnr"] != report["1"]["psnr"]   # two scenes, two models


@pytest.mark.parametrize("name", SCRIPTS)
def test_main_takes_the_jax_flags_and_device(monkeypatch, name):
    mod = importlib.import_module(f"danerf_tpu_torch.examples.{name}")
    argv = {"full_scale": ["--iters", "7", "--size", "20", "--train-views", "3", "--val-views",
                           "2", "--frames", "4", "--out", "o", "--report", "r.json",
                           "--no-pallas"],
            "measure_io_overlap": ["o", "r.json"],
            "hier_demo": ["--iters", "7", "--size", "20", "--out", "o"],
            "demo_synthetic": ["--iters", "7", "--size", "20", "--frames", "4", "--out", "o",
                               "--pallas"],
            "multi_scene": ["--scenes", "2", "lego", "--iters", "7", "--size", "20",
                            "--frames", "4", "--out", "o"]}[name]
    seen = {}
    monkeypatch.setattr(mod, "run", lambda *a, **kw: seen.update(args=a, kw=kw))
    mod.main([*argv, "--device", "cpu"])
    got = [*seen["args"], *seen["kw"].values()]
    assert "cpu" in got
    if name != "measure_io_overlap":
        cfg = seen["args"][0]
        assert isinstance(cfg, NeRFConfig) and cfg.use_bf16
        assert 7 in got and 20 in got
        assert cfg.use_kernels == (name != "full_scale")
        assert cfg.num_importance == (64 if name in ("full_scale", "hier_demo") else 0)
    else:
        assert got[:2] == ["o", "r.json"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_the_card_is_not_replaced_by_the_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    mod = importlib.import_module(f"danerf_tpu_torch.examples.{name}")
    argv = ([str(tmp_path), str(tmp_path / "r.json")] if name == "measure_io_overlap"
            else ["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([*argv, "--device", "cuda"])
    assert os.listdir(tmp_path) == []


def test_the_study_starts_with_a_live_density_head():
    """The full-scale study trains the default config from seed 0 (``train``'s
    default, drawn on the CPU as on the card): its relu density head gives
    sigma > 0 at nearly every point of the scene's box at initialisation.  A
    head born dead (sigma = 0 everywhere, as some seeds are) never learns."""
    from danerf_tpu_torch.train.trainer import init_model

    model, _ = init_model(NeRFConfig(), 100, 0, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1.2, 1.2, (20000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(20000, 3))
                                                       .astype(np.float32)), dim=-1)
    with torch.no_grad():
        _, sigma = model(x, d)
    assert float((sigma > 0).float().mean()) > 0.99
