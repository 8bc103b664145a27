"""The parity study's slice of the port (``danerf_tpu_torch/benchmarks/``,
``examples/parity_study.py``, ``examples/parity_chair.py``) on the CPU.

- The init: the reference init drawn from a generator of its own equals the
  repository's ``benchmarks/torch_reference`` (``torch.manual_seed`` then
  ``ReferenceNeRF`` then ``torch.randn``) bit for bit at seeds 0-3, and so
  does the port's ``init_model`` (the study's paired arms rest on it).
- The reference trainer: 16 steps on the CPU equal the repository
  script's bit for bit, coarse and 64 + 64 (on one thread: see
  ``test_torch_train_loop._one_thread``), and track the JAX mirror
  (``benchmarks/jax_reference.train_mirror``) within the 2e-3 relative loss
  of ``tests/test_torch_parity.py``.
- Conversion and probe: ``params_from_reference`` equals
  ``params_from_jax(torch_init_to_params(...))`` leaf for leaf; the port's
  f32 ``NeRF`` on them is within 1e-5 of ``nerf_apply`` (f32, no Pallas);
  ``density_alive_probe`` agrees with the JAX probe within rtol 1e-5 at
  full width on ``examples/procedural_scene``, and its dead set over seeds
  0-11 is ``examples/parity_runs/dead_rates.json``'s exactly.
- Statistics: ``welch``, ``arm_stats``, the paired deltas and the
  attribution block equal the JAX script's on the same fixed numbers.
- A tiny study (narrow width, 24x24 scene, 2 seeds, 10 steps) writes every
  key of the JAX report and nothing under ``examples/``; ``parity_chair``
  at a tiny size writes the JAX script's keys; the entry points refuse the
  card on a host without one.
"""

import contextlib
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from danerf_tpu_torch.config import NeRFConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SCENE = str(ROOT / "examples" / "procedural_scene")
NARROW = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
                    num_samples=8, num_importance=4, batch_size=64, warmup_batch_size=32,
                    warmup_iters=1, render_chunk=128)
# tests/test_torch_parity.py's trajectory width
TRAJ = dict(hidden_dim=48, num_layers=3, skip_connect_layers=(2,), num_samples=12,
            num_importance=6, batch_size=96, use_bf16=False, appearance_dim=8,
            pos_enc_levels=4, dir_enc_levels=2, warmup_iters=2)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _traj_data():
    rng = np.random.default_rng(1)
    images = rng.random((3, 16, 16, 3), dtype=np.float32)
    c2ws = np.stack([np.eye(4, dtype=np.float32)] * 3)
    c2ws[:, 2, 3] = 4.0
    return images, c2ws


def _jax_script(name):
    """A repository script (``examples/<name>.py``) as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- the init

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reference_init_is_the_repository_init_bit_for_bit(seed):
    from benchmarks import torch_reference as repo

    from danerf_tpu_torch.benchmarks.reference_init import sample_torch_init

    cfg = NeRFConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = repo.ReferenceNeRF(cfg)
        emb = torch.nn.Parameter(torch.randn(20, cfg.appearance_dim))
        want = repo.export_init(model, emb)
    state = torch.get_rng_state()
    got = sample_torch_init(cfg, 20, seed)
    assert torch.equal(torch.get_rng_state(), state)   # the global generator untouched
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_trainers_init_is_the_reference_init_bit_for_bit(seed):
    # the framework_paired arms reuse the framework arms' runs on this ground
    from danerf_tpu_torch.benchmarks.reference_init import (model_from_reference,
                                                            sample_torch_init)
    from danerf_tpu_torch.train.trainer import init_model

    cfg = NeRFConfig()
    model, table = init_model(cfg, 20, seed, "cpu")
    ref, ref_table = model_from_reference(sample_torch_init(cfg, 20, seed), cfg, "cpu")
    got, want = model.state_dict(), ref.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(table.detach(), ref_table.detach())


# ------------------------------------------------------ the reference trainer

@pytest.mark.parametrize("n_importance", [0, 6], ids=["coarse", "hier"])
def test_reference_trainer_is_the_repository_trainer_bit_for_bit(n_importance):
    from benchmarks import torch_reference as repo

    from danerf_tpu_torch.benchmarks import torch_reference as port

    cfg = NeRFConfig(**TRAJ).replace(num_importance=n_importance, use_kernels=False)
    images, c2ws = _traj_data()
    with _one_thread(), torch.random.fork_rng(devices=[]):
        init_r, init_p = {}, {}
        _, emb_r, want = repo.train_reference(cfg, images, c2ws, 20.0, 16, seed=3,
                                              init_out=init_r, log_every=10 ** 9)
        model, emb_p, got = port.train_reference(cfg, images, c2ws, 20.0, 16, seed=3,
                                                 init_out=init_p, log_every=10 ** 9,
                                                 device="cpu")
    assert len(got) == 16 and got == want
    assert all(np.array_equal(init_p[k], init_r[k]) for k in init_r)
    assert torch.equal(emb_p.detach(), emb_r.detach())


@pytest.mark.parametrize("n_importance", [0, 6], ids=["coarse", "hier"])
def test_reference_trainer_tracks_the_jax_mirror(n_importance):
    from benchmarks.jax_reference import train_mirror
    from danerf_tpu.config import NeRFConfig as JaxConfig

    from danerf_tpu_torch.benchmarks.torch_reference import train_reference

    images, c2ws = _traj_data()
    init = {}
    _, _, mses_t = train_reference(NeRFConfig(**TRAJ).replace(num_importance=n_importance),
                                   images, c2ws, 20.0, 16, seed=3, init_out=init,
                                   log_every=10 ** 9, device="cpu")
    _, mses_j = train_mirror(JaxConfig(**TRAJ, use_pallas=False).replace(
        num_importance=n_importance), images, c2ws, 20.0, 16, seed=3, init=init, chunk=5)
    mt, mj = np.asarray(mses_t), np.asarray(mses_j)
    rel = np.abs(mt - mj) / np.maximum(np.abs(mt), 1e-12)
    assert rel.max() < 2e-3, f"trajectory drift {rel.max():.2e}\n{mt}\n{mj}"


def test_reference_trainer_refuses_the_card_without_one():
    from danerf_tpu_torch.benchmarks.torch_reference import train_reference

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    images, c2ws = _traj_data()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_reference(NeRFConfig(**TRAJ), images, c2ws, 20.0, 2, device="cuda")


# ------------------------------------------------------ conversion and probe

@pytest.fixture(scope="module")
def scene():
    from danerf_tpu.data.blender import load_blender_scene

    return load_blender_scene(SCENE, "train")


@pytest.mark.parametrize("width", ["narrow", "full"])
def test_params_from_reference_is_the_jax_conversion_leaf_for_leaf(width):
    import jax
    from benchmarks.jax_reference import torch_init_to_params
    from danerf_tpu.config import NeRFConfig as JaxConfig
    from danerf_tpu.models.nerf import nerf_apply

    from danerf_tpu_torch.benchmarks.reference_init import (model_from_reference,
                                                            params_from_reference,
                                                            sample_torch_init)
    from danerf_tpu_torch.utils.convert import params_from_jax

    kw = {k: v for k, v in TRAJ.items() if k not in ("num_importance", "use_bf16")}
    kw = kw if width == "narrow" else {}
    cfg = NeRFConfig(**kw).replace(use_bf16=False)
    init = sample_torch_init(cfg, 5, 2)
    jparams = torch_init_to_params(init, JaxConfig(**kw, use_bf16=False, use_pallas=False))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams["model"]))
    sd, table = params_from_reference(init, cfg)
    assert list(sd) == list(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    assert np.array_equal(table.numpy(), np.asarray(jparams["appearance"]))

    # the port's f32 module on them against nerf_apply (f32, no Pallas)
    model, tab = model_from_reference(init, cfg, "cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = np.repeat(np.asarray(jparams["appearance"])[1:2], 257, 0)
    rgb_j, sigma_j = nerf_apply(jparams["model"], JaxConfig(**kw, use_bf16=False,
                                                            use_pallas=False), x, d, emb)
    with torch.no_grad():
        rgb_p, sigma_p = model(torch.from_numpy(x), torch.from_numpy(d),
                               tab.detach()[1:2].expand(257, -1))
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sigma_p.numpy(), np.asarray(sigma_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_alive_probe_agrees_with_the_jax_probe(scene, seed):
    from benchmarks.jax_reference import density_alive_probe as jax_probe
    from benchmarks.jax_reference import torch_init_to_params
    from danerf_tpu.config import NeRFConfig as JaxConfig

    from danerf_tpu_torch.benchmarks.reference_init import (density_alive_probe,
                                                            model_from_reference,
                                                            sample_torch_init)

    cfg = NeRFConfig(num_importance=0, near=scene.near, far=scene.far)
    init = sample_torch_init(cfg, scene.n_images, seed)
    model, _ = model_from_reference(init, cfg, "cpu")
    got = density_alive_probe(model, cfg, scene.images.shape, scene.c2ws, scene.focal)
    jcfg = JaxConfig(num_importance=0, use_pallas=False, use_bf16=False, near=scene.near,
                     far=scene.far)
    want = jax_probe(torch_init_to_params(init, jcfg)["model"], jcfg, scene.images.shape,
                     scene.c2ws, scene.focal)
    assert want > 0 and got == pytest.approx(want, rel=1e-5, abs=0)


def test_dead_set_over_seeds_0_to_11_is_the_jax_studys(scene):
    from danerf_tpu_torch.benchmarks.dead_rate_probe import run

    with open(ROOT / "examples" / "parity_runs" / "dead_rates.json") as f:
        want = [s for s in json.load(f)["torch_dead_seeds"] if s < 12]
    report = run(12, SCENE, None, "cpu")
    assert report["torch_dead_seeds"] == want
    assert report["n_seeds"] == 12 and set(report) >= {
        "torch_init_dead_rate", "jax_init_dead_rate", "jax_dead_seeds", "note"}


# --------------------------------------------------------------- statistics

def _fixed_results():
    """Alive runs of every arm on fixed numbers: the torch-family arms share
    seeds (some in common with each other, not all), the port-family arms
    have their own."""
    rng = np.random.default_rng(7)
    torch_seeds = {"reference": [0, 2, 3, 5, 6], "reference_hier": [0, 2, 3, 5],
                   "framework_paired": [0, 2, 3, 5, 6],
                   "framework_paired_hier": [0, 2, 3, 5, 6],
                   "framework_paired_hier_f32p": [0, 2, 3, 6],
                   "framework_paired_hier_xla32": [0, 2, 5, 6]}
    own = {"framework": [2, 6, 7, 8], "framework_f32": [2, 6], "framework_hier": [2, 6, 7]}
    return {arm: [{"seed": s, "val_psnr": float(36 + 2 * rng.normal()),
                   "val_ssim": float(0.99 + 0.001 * rng.normal())} for s in seeds]
            for arm, seeds in {**torch_seeds, **own}.items()}


def test_welch_and_arm_stats_equal_the_jax_scripts():
    from danerf_tpu_torch.examples import parity_study as port

    js = _jax_script("parity_study")
    rng = np.random.default_rng(3)
    for na, nb in ((5, 4), (24, 24), (2, 2), (1, 3)):
        a, b = (36 + 2 * rng.normal(size=na)).tolist(), (36 + rng.normal(size=nb)).tolist()
        assert port.welch(a, b) == js.welch(a, b)
    assert port.welch([1.0, 1.0], [1.0, 1.0]) == js.welch([1.0, 1.0], [1.0, 1.0])
    for runs in _fixed_results().values():
        assert port.arm_stats(runs) == js.arm_stats(runs)


def test_paired_deltas_and_attribution_equal_the_jax_scripts(tmp_path, monkeypatch):
    """The JAX script's main on the same fixed runs (its collect_arm and
    scene loader replaced), against ``statistics``; the texts naming each
    package's trainer differ, every number is equal."""
    from types import SimpleNamespace

    from danerf_tpu_torch.examples import parity_study as port

    js = _jax_script("parity_study")
    results = _fixed_results()
    monkeypatch.setattr(js, "collect_arm", lambda name, *a, **k: (results[name], []))
    monkeypatch.setattr(js, "load_blender_scene", lambda *a, **k: SimpleNamespace(
        near=2.0, far=6.0, height=24, width=24, n_images=4))
    out = tmp_path / "jax_report.json"
    monkeypatch.setattr("sys.argv", ["parity_study.py", "--out", str(out)])
    monkeypatch.chdir(ROOT)   # the JAX script reads its committed runs relative to the root
    js.main()
    with open(out) as f:
        want = json.load(f)
    got = json.loads(json.dumps(port.statistics(results)))
    keys = [k for k in want if k.startswith(("delta", "attribution"))]
    assert sorted(got) == sorted(keys) and len(keys) == 10
    texts = {("attribution_init_family", "design"),
             ("attribution", "factors_identical_by_construction")}
    for k in keys:
        for field in set(want[k]) | set(got[k]):
            if (k, field) not in texts:
                assert got[k][field] == want[k][field], (k, field)


# -------------------------------------------------------------- a tiny study

def _tiny_scene(root):
    from danerf_tpu_torch.data.blender import save_blender_scene
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    path = os.path.join(root, "scene")
    for split, n in (("train", 4), ("val", 2)):
        save_blender_scene(make_synthetic_scene(split, n_images=n, height=24, width=24), path,
                           split)
    return path


def _tree(root):
    return {(p, os.path.getmtime(os.path.join(d, p)))
            for d, _, files in os.walk(root) for p in files}


def test_tiny_study_writes_every_key_of_the_jax_report(tmp_path):
    from danerf_tpu_torch.benchmarks import dead_rate_probe, parity_equivalence
    from danerf_tpu_torch.examples import parity_study

    examples = _tree(ROOT / "examples")
    scene_dir = _tiny_scene(str(tmp_path))
    runs = tmp_path / "runs"
    dead_rate_probe.run(4, scene_dir, str(runs / "dead_rates.json"), "cpu", base=NARROW)
    for hier, name in ((False, "equivalence"), (True, "equivalence_hier")):
        whole, first = parity_equivalence.run(6, 0, hier, scene_dir, "cpu", base=NARROW,
                                              windows=(3,))
        assert first["iters"] == 3 and whole["iters"] == 6
        assert first["loss_trace_torch_every10"] == whole["loss_trace_torch_every10"][:1]
        # on one device both sides are the same program
        assert whole["rel_drift_full"]["max"] == 0.0
        parity_equivalence._write(str(runs / f"{name}.json"), first)
        parity_equivalence._write(str(runs / f"{name}_600.json"), whole)

    out = tmp_path / "report.json"
    report = parity_study.run(iters=10, seeds=2, hier_seeds=2, f32_seeds=2, abl_seeds=2,
                              scene=scene_dir, out=str(out), runs_dir=str(runs), device="cpu",
                              base=NARROW)
    with open(ROOT / "examples" / "parity_report.json") as f:
        want = json.load(f)
    with open(out) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(report))
    assert sorted(set(want) - set(saved)) == []
    assert saved["backend"] == "cpu" and saved["device"]["name"] == "cpu"
    assert saved["iters"] == 10 and set(saved["arms"]) == set(parity_study.ARMS)
    # the paired arms are the framework arms' runs, trained once
    for arm, src in parity_study.SAME_AS.items():
        assert saved["runs"][arm] == saved["runs"][src]
        assert not list(runs.glob(f"{arm}_seed*.json"))
    assert saved["attribution_init_family"]["delta"] == 0.0
    for arm in parity_study.ARMS:
        assert saved["arms"][arm]["n"] == 2
        jax_run = want["runs"][arm][0]
        for run in saved["runs"][arm]:
            assert sorted(set(jax_run) - set(run)) == []
            assert run["steps"] == (10 if arm.startswith("reference") else 11)
    # the committed CPU anchor, paired with this study's reference seed 0
    anchor = saved["torch_anchors"][0]
    assert anchor["file"] == "examples/parity_runs/torch_anchor_seed0.json"
    pairing = anchor["mirror_pairing"]
    assert pairing["mirror_file"] == "reference_seed0.json" and pairing["n_trace_points"] == 1
    # the cache: a second call runs nothing and gives the same statistics
    again = parity_study.run(iters=10, seeds=2, hier_seeds=2, f32_seeds=2, abl_seeds=2,
                             scene=scene_dir, out=str(tmp_path / "again.json"),
                             runs_dir=str(runs), device="cpu", base=NARROW)
    assert again["delta_hier"] == report["delta_hier"]
    assert again["attribution"] == report["attribution"]
    assert _tree(ROOT / "examples") == examples


def test_parity_chair_writes_the_jax_scripts_keys(tmp_path):
    from danerf_tpu_torch.data.blender import load_blender_scene
    from danerf_tpu_torch.examples import parity_chair

    out = tmp_path / "chair.json"
    report = parity_chair.run(NARROW, data=str(tmp_path / "none"), iters=12, height=24,
                              val_views=1, workdir=str(tmp_path / "work"), out=str(out),
                              jax_seeds=2, jax_f32_control=True, device="cpu")
    assert set(report) >= {"experiment", "data", "config", "hardware", "jax", "jax_runs",
                           "jax_psnr_spread", "torch_reference", "psnr_delta_jax_minus_torch",
                           "at_reference_scale", "scale_note"}
    assert report["data"]["kind"] == "procedural-roundtrip" and not report["at_reference_scale"]
    assert [(r["seed"], r["bf16"]) for r in report["jax_runs"]] == [(0, True), (1, True),
                                                                    (0, False)]
    assert np.isfinite(report["psnr_delta_jax_minus_torch"])
    # the procedural scene, written in the Blender layout and read back
    ds = load_blender_scene(str(tmp_path / "work" / "procedural_scene"), "val")
    assert ds.images.shape == (1, 24, 24, 3)
    # --skip-torch keeps the earlier torch section
    again = parity_chair.run(NARROW, data=str(tmp_path / "none"), iters=6, height=24,
                             val_views=1, workdir=str(tmp_path / "work"), out=str(out),
                             skip_torch=True, device="cpu")
    assert again["torch_reference"] == json.loads(json.dumps(report["torch_reference"]))


@pytest.mark.parametrize("module, argv", [
    ("examples.parity_study", ["--iters", "2"]),
    ("examples.parity_chair", ["--iters", "2"]),
    ("benchmarks.dead_rate_probe", ["--n", "1"]),
    ("benchmarks.parity_equivalence", ["--iters", "2"]),
    ("benchmarks.run_torch_anchor", ["--iters", "2"]),
])
def test_entry_points_default_to_the_card_and_refuse_without_one(module, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    mod = importlib.import_module(f"danerf_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_committed_h100_report_holds_the_jax_reports_keys():
    """The study's committed report (``parity_report_h100.json``, from the
    card at 5,000 steps): every key of the JAX report, every arm at the JAX
    script's default seed counts or more, the card's name and power limit,
    and the reference arm's dead seeds the JAX study's over the seeds it
    probed."""
    with open(ROOT / "examples" / "parity_report.json") as f:
        want = json.load(f)
    with open(ROOT / "danerf_tpu_torch" / "examples" / "parity_report_h100.json") as f:
        got = json.load(f)
    assert sorted(set(want) - set(got)) == []
    assert got["iters"] == 5000 and got["backend"] == "cuda"
    assert got["data"]["source"] == "examples/procedural_scene"
    assert "H100" in got["device"]["name"] and got["device"]["power_limit"].endswith(" W")
    defaults = {"reference": 4, "framework": 4, "framework_paired": 4, "framework_f32": 2,
                "reference_hier": 3, "framework_hier": 3, "framework_paired_hier": 3,
                "framework_paired_hier_f32p": 12, "framework_paired_hier_xla32": 12}
    assert {arm: got["arms"][arm]["n"] >= n for arm, n in defaults.items()} == {
        arm: True for arm in defaults}
    for key in ("delta_framework_minus_reference", "delta_hier", "delta_paired_coarse",
                "delta_paired_hier"):
        assert len(got[key]["ci95"]) == 2
    runs = got["runs"]["reference"]
    probed = max(got["dead_seeds"]["reference"] + [r["seed"] for r in runs]) + 1
    assert got["dead_seeds"]["reference"] == [s for s in want["dead_seeds"]["reference"]
                                              if s < probed]
    for arm, launches in got["launches_per_seed"].items():
        if arm.startswith("reference") or arm.endswith("xla32"):
            assert launches == {"train": {}, "eval": {}}, arm
