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


def _digest(model, table) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in [*model.state_dict().values(), *([] if table is None else [table])]:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def _writer():
    """``tests/data_torch/write_jax_init.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "write_jax_init", ROOT / "tests" / "data_torch" / "write_jax_init.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow_jax_npz(path, n_images):
    """A JAX init of NARROW's widths (``create_train_state``) saved as
    ``write_jax_init.py`` saves the full-width one."""
    import jax

    from danerf_tpu.config import NeRFConfig as JaxConfig
    from danerf_tpu.train.trainer import create_train_state

    writer = _writer()
    widths = {k: getattr(NARROW, k) for k in ("hidden_dim", "num_layers",
                                              "skip_connect_layers", "appearance_dim")}
    state = create_train_state(jax.random.key(0), JaxConfig(use_bf16=True, **widths), n_images)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32)
                                 for k, v in writer.leaves(state.params)})
    return path


def _curve(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def test_full_scale_seed_zero_is_the_default_run_and_a_seed_moves_init_and_batches(tmp_path):
    """``--seed 0`` is the run without the flag (``train``'s seed 0, the
    init ``init_model(cfg, n, 0)`` draws), bit for bit; another seed draws
    another init and, from one init, another batch stream."""
    from danerf_tpu_torch.examples import full_scale
    from danerf_tpu_torch.train.trainer import init_model

    kw = dict(iters=6, size=24, train_views=3, val_views=1, frames=1, checkpoint_every=3,
              device="cpu")
    reps = {}
    for name, extra in (("default", {}), ("seed0", {"seed": 0}), ("seed3", {"seed": 3})):
        reps[name] = full_scale.run(NARROW, str(tmp_path / name), str(tmp_path / f"{name}.json"),
                                    **kw, **extra)
    a, b, c = reps["default"], reps["seed0"], reps["seed3"]
    assert a["seed"] == b["seed"] == 0 and c["seed"] == 3
    assert a["init"] == b["init"] and a["init"]["from"] == "init_model"
    assert a["init"]["sha256"] == _digest(*init_model(NARROW, 3, 0, "cpu"))
    assert _curve(tmp_path / "default" / "metrics.jsonl") == _curve(tmp_path / "seed0" /
                                                                     "metrics.jsonl")
    assert a["eval"]["per_view_psnr"] == b["eval"]["per_view_psnr"]
    assert c["init"]["sha256"] != a["init"]["sha256"]
    assert c["init"]["sha256"] == _digest(*init_model(NARROW, 3, 3, "cpu"))
    # one init, two seeds: the batches alone move the run
    npz = _narrow_jax_npz(tmp_path / "init.npz", 3)
    same = {s: full_scale.run(NARROW, str(tmp_path / f"npz{s}"), str(tmp_path / f"npz{s}.json"),
                              **kw, seed=s, init_npz=str(npz)) for s in (0, 3)}
    assert same[0]["init"]["sha256"] == same[3]["init"]["sha256"] != a["init"]["sha256"]
    first = [_curve(tmp_path / f"npz{s}" / "metrics.jsonl")[0] for s in (0, 3)]
    assert first[0] != first[1]


def test_init_npz_builds_the_model_of_the_file(tmp_path):
    """``--init-npz``: ``train``'s module and table hold the file's arrays
    (``params_from_jax`` of them) before the first step, and the report's
    init digest is theirs."""
    from danerf_tpu_torch.examples import full_scale
    from danerf_tpu_torch.train.trainer import init_model, load_jax_params
    from danerf_tpu_torch.utils.convert import params_from_jax, read_params_npz

    npz = _narrow_jax_npz(tmp_path / "init.npz", 3)
    tree = read_params_npz(str(npz))
    with np.load(npz) as z:
        assert tree["model"]["trunk"][1]["w"].tobytes() == z["model.trunk.1.w"].tobytes()
        assert len(tree["model"]["trunk"]) == NARROW.num_layers and len(z.files) == 2 * (
            NARROW.num_layers + 4) + 1
    model, table = init_model(NARROW, 3, 7, "cpu")
    load_jax_params(model, table, tree)
    want = params_from_jax(tree["model"])
    assert model.state_dict().keys() == want.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(table.detach(), torch.tensor(tree["appearance"]))
    with pytest.raises(ValueError, match="appearance table"):
        load_jax_params(*init_model(NARROW, 4, 0, "cpu"), tree)
    rep = full_scale.run(NARROW, str(tmp_path / "o"), str(tmp_path / "o.json"), iters=2,
                         size=24, train_views=3, val_views=1, frames=1, checkpoint_every=2,
                         device="cpu", seed=5, init_npz=str(npz))
    assert rep["init"]["sha256"] == _digest(model, table)
    assert rep["init"]["from"] == "init.npz" and rep["seed"] == 5


def test_the_committed_jax_init_is_what_jax_draws():
    """``danerf_tpu_torch/examples/jax_init_seed0.npz`` equals, bit for bit,
    ``create_train_state(jax.random.key(0), NeRFConfig(use_bf16=True), 100)``
    drawn here (``tests/data_torch/write_jax_init.py``), and the port reads
    it into the default-width model."""
    from danerf_tpu_torch.examples import full_scale
    from danerf_tpu_torch.train.trainer import init_model, load_jax_params
    from danerf_tpu_torch.utils.convert import read_params_npz

    writer = _writer()
    want = writer.jax_init_arrays()
    assert os.path.samefile(writer.NPZ, full_scale.JAX_INIT)
    with np.load(full_scale.JAX_INIT) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.float32 and z[k].tobytes() == v.tobytes(), k
    assert sum(v.size for v in want.values()) == 537_476
    assert os.path.getsize(full_scale.JAX_INIT) < 2_200_000
    model, table = init_model(NeRFConfig(use_bf16=True), 100, 0, "cpu")
    load_jax_params(model, table, read_params_npz(full_scale.JAX_INIT))


def test_the_jax_seed0_init_is_born_dead_on_the_study_scene():
    """The JAX run's own init (the committed ``jax_init_seed0.npz``) gives
    sigma = 0 at every coarse sample of 5,000 training rays of the 800x800
    study scene, through the JAX ``nerf_apply`` in f32 and in bf16, and the
    port's ``density_alive_probe`` is 0.0 for it: at these points no
    gradient reaches it (the highest pre-activation is ~-1.7e-3, so a
    kernel's rounding can flip a gate and revive it).  The port's seed 0
    is alive on the same points."""
    import jax
    import jax.numpy as jnp

    from danerf_tpu.config import NeRFConfig as JaxConfig
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_scene
    from danerf_tpu.models.nerf import nerf_apply
    from danerf_tpu.ops.rays import rays_for_pixels
    from danerf_tpu_torch.benchmarks.reference_init import density_alive_probe
    from danerf_tpu_torch.examples import full_scale
    from danerf_tpu_torch.train.trainer import init_model, load_jax_params
    from danerf_tpu_torch.utils.convert import read_params_npz

    size, n = 800, 100
    # the poses do not depend on the size, the focal scales with it
    small = j_scene("train", n_images=n, height=8, width=8, n_samples=4)
    assert np.array_equal(small.c2ws, j_scene("train", n_images=n, height=4, width=4,
                                              n_samples=4).c2ws)
    focal = small.focal * size / 8
    tree = read_params_npz(full_scale.JAX_INIT)
    rng = np.random.default_rng(1)
    img, pix = rng.integers(0, n, 5000), rng.integers(0, size * size, 5000)
    ro, rd = rays_for_pixels(jnp.asarray(pix), jnp.asarray(small.c2ws)[img], size, size, focal)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    z = jnp.linspace(2.0, 6.0, 64)
    pts = (ro[:, None] + rd[:, None] * z[None, :, None]).reshape(-1, 3)
    dirs = jnp.broadcast_to(rd[:, None], (5000, 64, 3)).reshape(-1, 3)
    for bf16 in (False, True):
        _, sigma = nerf_apply(jax.tree.map(jnp.asarray, tree["model"]),
                              JaxConfig(use_bf16=bf16), pts, dirs)
        assert float(jnp.max(sigma)) == 0.0, bf16
    # the margin: the highest pre-activation (softplus inverted) is just below 0
    _, soft = nerf_apply(jax.tree.map(jnp.asarray, tree["model"]),
                         JaxConfig(density_activation="softplus"), pts, dirs)
    top = float(jnp.log(jnp.expm1(jnp.max(soft))))
    assert -2e-3 < top < -1.5e-3, top
    shape = (n, size, size, 3)
    cfg = NeRFConfig(use_bf16=True)
    jax_model, table = init_model(cfg, n, 0, "cpu")
    load_jax_params(jax_model, table, tree)
    assert density_alive_probe(jax_model, cfg, shape, small.c2ws, focal) == 0.0
    port_model, _ = init_model(cfg, n, 0, "cpu")
    assert density_alive_probe(port_model, cfg, shape, small.c2ws, focal) > 0.0
    with torch.no_grad():
        _, sigma = port_model(torch.tensor(np.asarray(pts[:64000])),
                              torch.tensor(np.asarray(dirs[:64000])))
    assert float((sigma > 0).float().mean()) > 0.99


@pytest.mark.parametrize("name", ["hier_demo", "demo_synthetic", "multi_scene"])
def test_small_drivers_take_seed(monkeypatch, name):
    """``--seed`` reaches the run function (default 0), and the arms
    runner's config of each small driver is the one its ``main`` builds."""
    from danerf_tpu_torch.examples import full_scale_arms

    mod = importlib.import_module(f"danerf_tpu_torch.examples.{name}")
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a, **kw: seen.append(a))
    size = full_scale_arms.SMALL[name]["size"]
    argv = ["--size", str(size), "--device", "cpu"] + (["--pallas"] if name ==
                                                       "demo_synthetic" else [])
    mod.main(argv)
    mod.main([*argv, "--seed", "4"])
    assert seen[0][-1] == 0 and seen[1][-1] == 4
    assert seen[1][0] == full_scale_arms.small_config(name, size)


def test_small_drivers_report_their_seed(tmp_path):
    from danerf_tpu_torch.examples import demo_synthetic, hier_demo, multi_scene

    cfg = NARROW.replace(num_importance=0, render_chunk=16 * 16)
    a = hier_demo.run(NARROW, iters=3, size=16, out=str(tmp_path / "h0"), device="cpu")
    b = hier_demo.run(NARROW, iters=3, size=16, out=str(tmp_path / "h2"), device="cpu", seed=2)
    assert (a["seed"], b["seed"]) == (0, 2) and a["psnr"] != b["psnr"]
    d = demo_synthetic.run(cfg, iters=3, out=str(tmp_path / "d"), size=16, frames=1,
                           device="cpu", seed=2)
    m = multi_scene.run(cfg, ("1",), iters=3, size=16, frames=1, out=str(tmp_path / "m"),
                        device="cpu", seed=2)
    assert d["seed"] == m["seed"] == 2 and "1" in m


def test_arms_runner_and_its_decision_rule(tmp_path, monkeypatch):
    """``full_scale_arms`` at a narrow width on the CPU: the seed, live-seed
    and plain arms on one shared scene and a small driver over seeds, each
    record in the summary file beside the device; the v5e figures are the
    committed reports'; each clause of the decision rule on crafted arms; a
    second call on the same summary file."""
    from danerf_tpu_torch.examples import full_scale_arms as A

    summary = tmp_path / "arms.json"
    small = {"hier_demo": {"iters": 3, "size": 24}}
    # three steps train no arm to the study's TRAINED_PSNR
    monkeypatch.setattr(A, "TRAINED_PSNR", 0.0)
    out = A.run(["seed:0", "live:1", "no_pallas", "hier_demo"], str(summary),
                str(tmp_path / "o"), frames=1, small_seeds=2, device="cpu", base=NARROW,
                small=small, iters=3, size=24, train_views=2, val_views=1, checkpoint_every=3)
    with open(summary) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    arms = out["full_scale"]["arms"]
    live = out["full_scale"]["live_seeds"]["live:1"]["live"]
    assert set(arms) == {"seed:0", f"seed:{live[0]}", "no_pallas"} and len(live) == 1
    assert arms["no_pallas"]["route"] == "plain" and arms["seed:0"]["route"] == "kernels"
    assert arms["no_pallas"]["init"] == arms["seed:0"]["init"]
    assert all(a["device"] == "cpu" for a in arms.values())
    assert "port_seeds" in out["full_scale"]["decision_rule"]
    hier = out["small"]["hier_demo"]
    assert hier["port"]["n"] == 2 and hier["v5e"]["psnr"] == 29.8
    assert [r["seed"] for r in hier["runs"]] == [
        s for s in range(hier["runs"][-1]["seed"] + 1) if str(s) not in hier["dead_seeds"]]
    for name, report in (("full_scale", "full_scale"), ("hier_demo", "hier"),
                         ("demo_synthetic", "demo"), ("multi_scene", "multi_scene")):
        with open(ROOT / "examples" / f"{report}_report_v5e.json") as f:
            want = json.load(f)
        got = A.V5E[name]
        if name == "full_scale":
            assert got["val_psnr"] == want["eval"]["val_psnr"]
            assert got["final_train_psnr"] == want["train"]["final_train_psnr"]
            assert got["per_view_psnr"] == [min(want["eval"]["per_view_psnr"]),
                                            max(want["eval"]["per_view_psnr"])]
        elif name == "multi_scene":
            assert got == {s: want[s] for s in ("0", "1")}
        else:
            key = "psnr" if name == "hier_demo" else "val_psnr"
            assert got["psnr"] == want[key]
    monkeypatch.undo()

    def arm(psnr, route="kernels", source="init_model", alive=0.02):
        return {"val_psnr": psnr, "route": route, "init": {"from": source,
                                                           "density_alive": alive}}

    seeds = {"seed:0": arm(54.9), "seed:2": arm(54.1), "seed:3": arm(55.3)}
    rule = A.decide({"arms": {**seeds, "no_pallas": arm(54.7, "plain"),
                              "jax_init": arm(6.0, source="jax_init_seed0.npz", alive=0.0)}})
    assert rule["probe_dead_arms"] == rule["untrained_arms"] == ["jax_init"]
    assert not rule["port_fault"]
    assert not rule["init_effect"] and not rule["seed_effect"] and rule["every_arm_3db_above"]
    rule = A.decide({"arms": {**seeds, "no_pallas": arm(50.0, "plain"),
                              "jax_init": arm(49.0, source="jax_init_seed0.npz")}})
    assert rule["port_fault"] and rule["init_effect"] and not rule["every_arm_3db_above"]
    rule = A.decide({"arms": {**seeds, "seed:5": arm(49.2)}})
    assert rule["seed_effect"] and rule["port_seeds"]["n"] == 4
    lo, hi = rule["prediction_interval_95"]
    assert lo < 49.487 < hi and rule["jax_run_inside_prediction_interval"]
    # a seed the probe reads as dead counts in the seed clause once it
    # trained, and in no clause if it did not
    rule = A.decide({"arms": {**seeds, "seed:1": arm(49.2, alive=0.0),
                              "seed:4": arm(6.0, alive=0.0)}})
    assert rule["seed_effect"] and rule["every_arm_3db_above"]
    assert rule["port_seeds"]["n"] == 3 and rule["all_seeds"]["n"] == 4
    assert rule["probe_dead_arms"] == ["seed:1", "seed:4"]
    assert rule["untrained_arms"] == ["seed:4"]
    # a later call on the same summary adds its arms; another card's is refused
    monkeypatch.setattr(A, "TRAINED_PSNR", 0.0)
    again = A.run(["seed:5"], str(summary), str(tmp_path / "o"), frames=1, device="cpu",
                  base=NARROW, iters=3, size=24, train_views=2, val_views=1,
                  checkpoint_every=3)
    assert set(again["full_scale"]["arms"]) == set(arms) | {"seed:5"}
    assert again["small"] == out["small"] and again["full_scale"]["live_seeds"] == {
        "live:1": out["full_scale"]["live_seeds"]["live:1"]}
    with open(tmp_path / "other.json", "w") as f:
        json.dump(dict(out, device="another card"), f)
    with pytest.raises(ValueError, match="another card"):
        A.run(["seed:5"], str(tmp_path / "other.json"), str(tmp_path / "o"), device="cpu",
              base=NARROW)
