"""The port's ``parallel/mesh.py`` on ``torch.distributed`` against the JAX
package's ``danerf_tpu.parallel`` on the CPU.

The JAX references run here, on the fake CPU devices of tests/conftest.py
(``make_mesh(data=2, devices=jax.devices()[:2])``, and a 2 x 2 mesh for
tensor parallelism), with the tiny configs of tests/test_parallel.py.  Their
initial parameters, and each step's batch and jitter (drawn from the JAX
state's key as ``make_sharded_train_step`` draws them), go as ``.npz`` to
worker processes (tests/torch_parallel_worker.py) that join a gloo group
through ``initialize_distributed`` and import only torch and
danerf_tpu_torch: 2 ranks for data parallelism, 4 for the 2 x 2 mesh.  The
CLI runs as 2 processes on a tiny Blender scene beside one single-process
run, and ``render --mesh_data 2`` on 4 ranks beside one single-process
render.  All processes start at once and the cases read their results.

Tolerances.  The sharded steps are held to the JAX bar of
tests/test_parallel.py, loss rtol 1e-4 and parameters atol 1e-5 after the
steps (f32), against the port's own unsharded steps on the same batches and
draws: what the mesh changes is the order of the gradient's f32 sums.
Against the JAX sharded steps the losses meet rtol 1e-4, but the parameters
only atol 1e-4: the two packages sum in another order, and Adam scales an
element's update by 1 / (|g| + eps), so an element whose gradient is near 0
moves by a different fraction of the rate.  The gap is the same without a
mesh (the port's unsharded steps against the JAX sharded ones, 2 steps:
3.6e-6 on the module and the kernel route, 3.4e-5 under ``use_time``; 2.7e-5
after 3 module-route steps), so it is the packages', not the sharding's.  The TP
forward: atol 1e-5 (rgb) / 1e-4 (sigma), the JAX bar.  The kernel routes
compare the port's plain versions with the JAX kernels in interpret mode.  Frames: atol 1e-5 (rgb, acc) and 1e-4 (depth), as
tests/test_parallel.py holds the JAX sharded frame.  The CLI's 2-rank
checkpoint against the single-process one: atol 1e-5 (the same f32 steps,
the gradient summed over two half batches).  The 4-rank render against the
single-process one: the PNGs within 1 level, the raw depth within
chip_smoke.py's TWO_RANK_TOL (a frame gathered over two ranks).
"""

import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.data import make_synthetic_scene
from danerf_tpu.data.dataset import sample_ray_batch
from danerf_tpu.data.synthetic import make_time_varying_scene
from danerf_tpu.parallel import (make_mesh, make_sharded_train_step, param_pspecs,
                                 replicate_pool, shard_train_state)
from danerf_tpu.train import create_train_state
from danerf_tpu_torch.config import NeRFConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
from chip_smoke import TWO_RANK_TOL  # noqa: E402
from torch_parallel_worker import FRAME, SMALL, SOURCE, STEPS, TIME, TINY  # noqa: E402

TIMEOUT = 300
CASES = {"module": (TINY, {}), "kernel": (TINY, {"use_pallas": True}), "time": (TIME, {})}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, **kw):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return subprocess.Popen([sys.executable, WORKER, *map(str, args)], cwd=kw.get("cwd", ROOT),
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs):
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"


def _put_tree(ref, prefix, tree):
    for i, layer in enumerate(tree["trunk"]):
        ref[f"{prefix}/trunk{i}/w"] = np.asarray(layer["w"])
        ref[f"{prefix}/trunk{i}/b"] = np.asarray(layer["b"])
    for head in ("density", "dir", "rgb", "appearance_proj"):
        if head in tree:
            ref[f"{prefix}/{head}/w"] = np.asarray(tree[head]["w"])
            ref[f"{prefix}/{head}/b"] = np.asarray(tree[head]["b"])


def _tiny_blender(root):
    """A 2-view Blender scene of random 6x8 frames (tests/test_torch_cli.py's)."""
    from danerf_tpu_torch.viz.png import write_png

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


def _small_checkpoint(path):
    """A seeded model of the CLI runs' config and a 2-view table, as a
    reference-format checkpoint for ``render``."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.checkpoint import save_checkpoint

    model = NeRF(NeRFConfig(**SMALL), torch.Generator().manual_seed(0))
    table = torch.randn(2, SMALL["appearance_dim"], generator=torch.Generator().manual_seed(1))
    return save_checkpoint(str(path), model, table)


def _jax_steps(ref, want, case, scene, time_scene):
    """JAX ``make_sharded_train_step`` for ``STEPS[case]`` steps: the initial
    parameters, each step's batch and stratified jitter into ``ref``, the
    losses and the parameters after the steps into ``want``."""
    base, over = CASES[case]
    cfg = JaxConfig(**base, **over)
    sc = time_scene if cfg.use_time else scene
    st = create_train_state(jax.random.key(0), cfg, sc.n_images)
    _put_tree(ref, f"{case}/p", st.params["model"])
    ref[f"{case}/p/appearance"] = np.asarray(st.params["appearance"])
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    pool1 = sc.device_arrays()
    key = st.key
    for s in range(STEPS):
        k_batch, k_render, key = jax.random.split(key, 3)
        batch = sample_ray_batch(k_batch, pool1, cfg, sc.height, sc.width, sc.focal)
        for k, v in batch.items():
            ref[f"{case}/batch{s}/{k}"] = np.asarray(v)
        k_strat, _ = jax.random.split(k_render)
        ref[f"{case}/strat{s}"] = np.asarray(
            jax.random.uniform(k_strat, (cfg.batch_size, cfg.num_samples)))
    pool = replicate_pool(pool1, mesh)
    st = shard_train_state(st, mesh)
    step = make_sharded_train_step(cfg, mesh, sc.height, sc.width, sc.focal)
    losses = []
    for _ in range(STEPS):
        st, m = step(st, pool)
        losses.append(float(m["loss"]))
    want[f"{case}/losses"] = np.array(losses)
    want[f"{case}/params"] = jax.tree.map(np.asarray, st.params)


def _jax_frame(ref, want):
    """The JAX sharded frame (tests/test_parallel.py's fused hierarchical
    one) on 2 devices."""
    from danerf_tpu.models import init_nerf_params
    from danerf_tpu.render.renderer import render_frame

    cfg = JaxConfig(**FRAME, use_pallas=True)
    params = init_nerf_params(jax.random.key(0), cfg)
    _put_tree(ref, "frame/p", params)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    ref["frame/c2w"] = c2w
    want["frame"] = jax.tree.map(np.asarray, render_frame(
        params, cfg, jax.random.key(1), c2w, 16, 16, 20.0, n_importance=4, perturb=False,
        chunk=64, mesh=make_mesh(data=2, model=1, devices=jax.devices()[:2])))


def _jax_render(ref, want, scene):
    """JAX make_sharded_render of a 16x16 view on 2 devices (K1)."""
    from danerf_tpu.ops.rays import generate_rays
    from danerf_tpu.parallel.mesh import make_sharded_render

    cfg = JaxConfig(**TINY, use_pallas=True)
    params = create_train_state(jax.random.key(0), cfg, scene.n_images).params["model"]
    _put_tree(ref, "render/p", params)
    o, d = generate_rays(16, 16, scene.focal, jnp.asarray(scene.c2ws[0]))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ref["render/o"], ref["render/d"] = np.asarray(o), np.asarray(d)
    render = make_sharded_render(cfg, make_mesh(data=2, model=1, devices=jax.devices()[:2]),
                                 16, 16, cfg.num_samples, 0)
    want["render"] = jax.tree.map(np.asarray, render(params, jax.random.key(0), o, d, None))


def _jax_tp(ref, want, scene):
    """JAX nerf_apply on shard_train_state(..., tensor_parallel=True) over a
    2 x 2 mesh, and the layout of that state."""
    from danerf_tpu.models import nerf_apply

    cfg = JaxConfig(**TINY)
    st = create_train_state(jax.random.key(0), cfg, scene.n_images)
    x = jax.random.normal(jax.random.key(1), (64, 3))
    dirs = jax.random.normal(jax.random.key(2), (64, 3))
    ref["tp/x"], ref["tp/d"] = np.asarray(x), np.asarray(dirs)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    st_tp = shard_train_state(st, mesh, tensor_parallel=True)
    want["tp/forward"] = jax.tree.map(np.asarray, jax.jit(
        lambda p: nerf_apply(p, cfg, x, dirs))(st_tp.params["model"]))
    want["tp/state"] = st_tp.params["model"]
    want["tp/pspecs"] = param_pspecs(st.params, tensor_parallel=True)["model"]
    want["tp/devices"] = mesh.devices


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of the module, started at once: the CLI's 2
    ranks and its single-process run, the 2 data-parallel ranks and the 4
    ranks of the 2 x 2 mesh, which run what needs no reference while the
    JAX references are computed (on 4 threads), then wait for them.
    Returns ({name: npz of each rank}, {reference name: value}, the run
    directory)."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("parallel")
    _tiny_blender(d / "data")
    cli = ["train", "--dataset_path", str(d / "data"), "--scene", "tiny", "--iters", "3",
           "--batch_size", "16", "--device", "cpu", "--checkpoint_every", "0"]
    port = _free_port()
    procs = [_spawn(["cli", *cli, "--save_dir", d / f"cli_rank{i}", "--coordinator_address",
                     f"127.0.0.1:{port}", "--num_processes", 2, "--process_id", i,
                     "--mesh_data", 2]) for i in range(2)]
    procs.append(_spawn(["cli", *cli, "--save_dir", d / "cli_single"]))
    # render --mesh_data 2 on 4 ranks (2 outside the mesh) and in one process
    render = ["render", "--checkpoint", _small_checkpoint(d / "small.pt"), "--frames", 2,
              "--width", 8, "--height", 6, "--quality", "medium", "--save_depth", "--seed", 3,
              "--device", "cpu"]
    port = _free_port()
    procs += [_spawn(["cli", *render, "--output_dir", d / f"render4_rank{i}",
                      "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", 4,
                      "--process_id", i, "--mesh_data", 2]) for i in range(4)]
    procs.append(_spawn(["cli", *render, "--output_dir", d / "render_single"]))
    for case, world in (("dp", 2), ("tp", 4)):
        port = _free_port()
        procs += [_spawn([case, r, world, port, d]) for r in range(world)]

    ref, want = {}, {}
    scene = make_synthetic_scene("train", n_images=4, height=32, width=32)
    time_scene = make_time_varying_scene("train", n_images=4, height=24, width=24, n_samples=48)
    jobs = [(_jax_steps, ref, want, case, scene, time_scene) for case in CASES]
    jobs += [(_jax_frame, ref, want), (_jax_render, ref, want, scene),
             (_jax_tp, ref, want, scene)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for fut in [pool.submit(*job) for job in jobs]:
            fut.result()

    np.savez(d / "ref.tmp.npz", **ref)
    os.replace(d / "ref.tmp.npz", d / "ref.npz")
    want["ref"] = ref
    _wait(procs)
    got = {f"{case}{r}": dict(np.load(d / f"{case}_rank{r}.npz"))
           for case, world in (("dp", 2), ("tp", 4)) for r in range(world)}
    return got, want, d


def _port_params(got, prefix):
    """The JAX param tree of a state a worker wrote under ``prefix``."""
    from danerf_tpu_torch.utils.convert import params_to_jax

    sd = {k[len(prefix) + 1:]: torch.tensor(v) for k, v in got.items()
          if k.startswith(prefix + "/") and not k.endswith("/appearance")
          and not k.endswith("/losses") and "/grad/" not in k}
    return params_to_jax(sd), got[f"{prefix}/appearance"]


def _unsharded_steps(ref, case):
    """The port's unsharded steps (``compute_loss_and_grads`` on the whole
    batch, then Adam) from the same state on the same batches and draws:
    (losses, {"model": JAX param tree, "appearance": table}, {name: the
    first step's gradient})."""
    from torch_parallel_worker import batch_of, load_state

    from danerf_tpu_torch.train.trainer import (_set_rate, compute_loss_and_grads,
                                                make_optimizer)
    from danerf_tpu_torch.utils.convert import params_to_jax

    cfg, model, table = load_state(ref, case)
    opt, _ = make_optimizer(cfg, list(model.parameters()) + [table])
    losses = []
    for s in range(STEPS):
        batch, draws = batch_of(ref, case, s)
        opt.zero_grad()
        loss, _ = compute_loss_and_grads(model, table, cfg, batch, draws=draws)
        if s == 0:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            grads["appearance"] = table.grad.numpy().copy()
        _set_rate(opt, cfg)
        opt.step()
        losses.append(float(loss))
    return np.array(losses), {"model": params_to_jax(model.state_dict()),
                              "appearance": table.detach().numpy()}, grads


def _assert_state(got, want, case, ranks):
    """Each rank's losses and state after the steps against the port's
    unsharded steps (the JAX bar) and the JAX sharded steps (params atol
    1e-4, the packages' gap: module docstring)."""
    one_losses, one, _ = _unsharded_steps(want["ref"], case)
    src = SOURCE[case]
    for r in ranks:
        g = got[r]
        model, table = _port_params(g, case)
        for what, losses, w, atol in (("unsharded port", one_losses, one, 1e-5),
                                      ("JAX sharded", want[f"{src}/losses"],
                                       want[f"{src}/params"], 1e-4)):
            np.testing.assert_allclose(g[f"{case}/losses"], losses, rtol=1e-4,
                                       err_msg=f"{case} losses vs {what}, rank {r}")
            for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(w["model"]),
                                    jax.tree_util.tree_leaves(model)):
                np.testing.assert_allclose(b, np.asarray(a), atol=atol,
                                           err_msg=f"{case} {path} vs {what}, rank {r}")
            np.testing.assert_allclose(table, np.asarray(w["appearance"]), atol=atol,
                                       err_msg=f"{case} table vs {what}, rank {r}")


@pytest.mark.parametrize("case", ["module", "kernel", "time"])
def test_sharded_step_matches_jax(runs, case):
    """2 data-parallel steps on 2 ranks (module route; kernel route, K7's
    plain version against the JAX kernel in interpret mode; use_time) against
    JAX make_sharded_train_step on 2 devices and the port's unsharded steps,
    the JAX batches and draws passed in: every step's loss and every
    parameter after, on both ranks."""
    got, want, _ = runs
    _assert_state(got, want, case, ("dp0", "dp1"))


@pytest.mark.parametrize("case", ["module", "kernel", "time", "tp_module", "tp_kernel"])
def test_sharded_gradients_equal_unsharded(runs, case):
    """The first step's averaged gradient (every module parameter, gathered
    under tensor parallelism, and the table) on every rank against the
    unsharded step's on the same batch and draws: the f32 sums of two half
    batches (rtol 1e-4, atol 1e-7); a sum in place of the mean would be 2x."""
    got, want, _ = runs
    _, _, one = _unsharded_steps(want["ref"], case)
    ranks = ("dp0", "dp1") if case in ("module", "kernel", "time") else (
        "tp0", "tp1", "tp2", "tp3")
    for r in ranks:
        for name, g in one.items():
            np.testing.assert_allclose(got[r][f"{case}/grad/{name}"], g, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{case} {name}, rank {r}")


def test_steps_per_call_equals_single_steps(runs):
    """make_sharded_train_step with steps_per_call=3 against 3 calls of one
    step from one seeded state: parameters, table, losses and the
    generator's next draw, bit for bit, on both ranks."""
    got, _, _ = runs
    assert bool(got["dp0"]["chained_equal"]) and bool(got["dp1"]["chained_equal"])


def test_render_frame_with_mesh_matches_jax(runs):
    """render_frame(mesh=) on 2 ranks, 8 + 4 samples through the kernel
    route (K2/K5's plain versions), chunk 64, against the JAX sharded
    frame; and perturbed, against the port's unsharded frame from the same
    seed (each rank's share of the chunk's jitter, drawn whole)."""
    got, want, _ = runs
    for r in ("dp0", "dp1"):
        for k, w, atol in zip(("rgb", "depth", "acc"), want["frame"], (1e-5, 1e-4, 1e-5)):
            np.testing.assert_allclose(got[r][f"frame/{k}"], np.asarray(w), atol=atol,
                                       err_msg=f"{k}, rank {r}")
        assert float(got[r]["frame/perturb_max_err"]) < 1e-5


def test_render_mesh_data_below_ranks(runs):
    """`render --mesh_data 2` on 4 gloo ranks renders on the first 2 (the
    JAX CLI renders on the first D devices) what one process renders:
    rank 0's PNGs within 1 level and its raw depth within TWO_RANK_TOL of
    the single-process run's; the other ranks write nothing."""
    from danerf_tpu_torch.data.png import read_png

    _, _, d = runs
    one, four = d / "render_single", d / "render4_rank0"
    names = sorted(os.listdir(one))
    assert names == ["depth_000.png", "depth_001.png", "raw", "rgb_000.png", "rgb_001.png"]
    assert sorted(os.listdir(four)) == names
    assert sorted(os.listdir(four / "raw")) == sorted(os.listdir(one / "raw"))
    for i in (1, 2, 3):
        assert not (d / f"render4_rank{i}").exists(), f"rank {i} wrote files"
    for name in names[:2] + names[3:]:
        diff = np.abs(read_png(str(four / name)).astype(int) - read_png(str(one / name)).astype(int))
        assert diff.max() <= 1, (name, diff.max())
    for name in os.listdir(one / "raw"):
        np.testing.assert_allclose(np.load(four / "raw" / name), np.load(one / "raw" / name),
                                   atol=TWO_RANK_TOL["frame_depth"], err_msg=name)


def test_mesh_smaller_than_ranks(monkeypatch):
    """Over 4 ranks a renderer's 2 x 1 mesh (``subset``) lies over ranks 0
    and 1: every rank creates every group, rank 3 is outside (no share, no
    sum); ``train``'s mesh refuses, as JAX's make_mesh asserts data x model
    == devices, and ``render``'s CLI mesh is the subset one."""
    import argparse

    import torch.distributed as dist

    from danerf_tpu_torch.cli.main import _make_mesh
    from danerf_tpu_torch.parallel import make_mesh

    groups = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "new_group", lambda ranks: groups.append(ranks) or tuple(ranks))
    with pytest.raises(ValueError, match="mesh 2x1 != 4 ranks"):
        make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 4 ranks"):
        _make_mesh(argparse.Namespace(mesh_data=2, mesh_model=1), "cpu", render=False)
    assert groups == []
    mesh = _make_mesh(argparse.Namespace(mesh_data=2, mesh_model=1), "cpu", render=True)
    assert groups == [[0], [1], [0, 1]]
    assert not mesh.member and mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="outside the 2x1 mesh"):
        mesh.share(10)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    mesh = make_mesh(data=2, device="cpu", subset=True)
    assert mesh.member and (mesh.data_index, mesh.model_index) == (1, 0)
    assert mesh.data_group == (0, 1) and mesh.share(10) == slice(5, 10)
    with pytest.raises(ValueError, match="mesh 4x2 != 4 ranks"):
        make_mesh(data=4, model=2, device="cpu", subset=True)


def test_make_sharded_render_matches_jax(runs):
    """make_sharded_render (per-sample route: K1's plain version) on 2 ranks
    against the JAX make_sharded_render (K1 in interpret mode) on 2 devices."""
    got, want, _ = runs
    for r in ("dp0", "dp1"):
        for k, w, atol in zip(("rgb", "depth", "acc"), want["render"], (1e-5, 1e-4, 1e-5)):
            np.testing.assert_allclose(got[r][f"render/{k}"], np.asarray(w), atol=atol,
                                       err_msg=f"{k}, rank {r}")


def test_process_slice_over_ranks(runs, monkeypatch):
    """process_slice covers [0, n) once, in contiguous rank order, over 1,
    2, 3 and 8 ranks (as the JAX one does); the 2 ranks of a real group
    take 0-8 and 9-16 of 17."""
    from danerf_tpu.parallel import mesh as jax_mesh
    from danerf_tpu_torch.parallel import mesh as mesh_mod

    for n_proc in (1, 2, 3, 8):
        covered = []
        for pid in range(n_proc):
            monkeypatch.setattr(mesh_mod, "_rank_world", lambda p=pid, n=n_proc: (p, n))
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            monkeypatch.setattr(jax, "process_count", lambda n=n_proc: n)
            mine = range(17)[mesh_mod.process_slice(17)]
            assert mine == range(17)[jax_mesh.process_slice(17)]
            covered.extend(mine)
        assert covered == list(range(17)), (n_proc, covered)
    got, _, _ = runs
    assert list(got["dp0"]["process_slice"]) == list(range(9))
    assert list(got["dp1"]["process_slice"]) == list(range(9, 17))


def test_initialize_distributed_wiring(monkeypatch):
    """The multi-process arguments reach init_process_group (tcp://, gloo on
    the CPU; auto: torchrun's env://); the single-process calls are no-ops;
    a partial set raises."""
    import torch.distributed as dist

    from danerf_tpu_torch.parallel import initialize_distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(num_processes=1, device="cpu") is False
    assert initialize_distributed("host0:1234", 1, 0, device="cpu") is False
    assert calls == []
    assert initialize_distributed("host0:1234", 4, 2, device="cpu") is True
    assert calls == [(("gloo",), {"init_method": "tcp://host0:1234", "world_size": 4,
                                  "rank": 2})]
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert initialize_distributed("auto", device="cpu", backend="gloo") is True
    assert calls[-1] == (("gloo",), {"init_method": "env://", "world_size": 8, "rank": 3})
    with pytest.raises(ValueError, match="together"):
        initialize_distributed(num_processes=2, device="cpu")
    assert len(calls) == 2


def test_tensor_parallel_forward_matches_jax(runs):
    """TP 2 x 2 (4 ranks): TPNeRF's Megatron forward (column-, row-,
    column-parallel trunk, the slices gathered for the heads) against JAX
    nerf_apply on shard_train_state(..., tensor_parallel=True)."""
    got, want, _ = runs
    rgb, sigma = want["tp/forward"]
    for r in range(4):
        np.testing.assert_allclose(got[f"tp{r}"]["tp/rgb"], np.asarray(rgb), atol=1e-5)
        np.testing.assert_allclose(got[f"tp{r}"]["tp/sigma"], np.asarray(sigma), atol=1e-4)


def test_tensor_parallel_shards_match_jax_layout(runs):
    """Each rank's shards are the JAX shards of the device at its mesh
    position (rank r at (r // 2, r % 2)), weights transposed; the port's
    param_pspecs name the JAX PartitionSpecs in torch's (out, in) layout."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.parallel import param_pspecs as port_pspecs
    from danerf_tpu_torch.utils.convert import params_from_jax

    got, want, _ = runs
    devices = list(np.asarray(want["tp/devices"]).reshape(-1))
    sd_names = list(params_from_jax(jax.tree.map(np.asarray, want["tp/state"])))
    leaves = {}
    for i, layer in enumerate(want["tp/state"]["trunk"]):
        leaves[f"pts_linears.{i}.weight"], leaves[f"pts_linears.{i}.bias"] = layer["w"], layer["b"]
    for jname, tname in (("density", "density_head"), ("dir", "dir_linear"),
                         ("rgb", "rgb_linear"), ("appearance_proj", "appearance_projection")):
        leaves[f"{tname}.weight"] = want["tp/state"][jname]["w"]
        leaves[f"{tname}.bias"] = want["tp/state"][jname]["b"]
    assert set(leaves) == set(sd_names)
    for name, arr in leaves.items():
        for shard in arr.addressable_shards:
            rank = devices.index(shard.device)
            want_shard = np.asarray(shard.data)
            np.testing.assert_array_equal(got[f"tp{rank}"][f"shard/{name}"],
                                          want_shard.T if name.endswith("weight") else want_shard,
                                          err_msg=f"{name}, rank {rank}")
    specs = port_pspecs(NeRF(NeRFConfig(**TINY)), tensor_parallel=True)
    jspecs = want["tp/pspecs"]
    for i, layer in enumerate(jspecs["trunk"]):
        assert specs[f"pts_linears.{i}.weight"] == (tuple(layer["w"])[::-1] if layer["w"] else ())
        assert specs[f"pts_linears.{i}.bias"] == tuple(layer["b"])
    assert specs["density_head.weight"] == () == tuple(jspecs["density"]["w"])


@pytest.mark.parametrize("case", ["tp_module", "tp_kernel"])
def test_tensor_parallel_step_matches_jax(runs, case):
    """2 steps on the 2 x 2 mesh against the port's unsharded steps and the
    JAX sharded steps of the same route (which equal JAX's tensor-parallel
    ones: tests/test_parallel.py), on the same batches and draws: the module
    route computes the Megatron way, the kernel route gathers the trunk,
    runs the plain kernels on whole weights and keeps its shard of the
    gradient; the state, gathered, on every rank."""
    got, want, _ = runs
    _assert_state(got, want, case, [f"tp{r}" for r in range(4)])


def test_odd_skip_layer_does_not_split():
    """A skip layer at an odd index is row-parallel over hidden + encoded
    inputs (32 + 27 here), which does not split in two: refused, as JAX's
    device_put refuses it."""
    from danerf_tpu_torch.parallel.mesh import _shard

    w = torch.zeros(32, 59)
    with pytest.raises(ValueError, match="does not split"):
        _shard(w, "pts_linears.3.weight", types.SimpleNamespace(model=2, model_index=0))
    assert _shard(w, "pts_linears.2.weight", types.SimpleNamespace(model=2, model_index=1)
                  ).shape == (16, 59)


def test_train_with_mesh_writes_on_rank0_only(runs):
    """train(mesh=) for 3 steps (a checkpoint with its validation render at
    2), each rank given its own save_dir: rank 0 writes everything, the
    other ranks nothing, on the 2-rank data mesh and the 2 x 2 mesh; the
    2 x 2 run's checkpoints hold the whole model."""
    got, _, d = runs
    files = ["checkpoint_000002.pt", "checkpoint_final.pt", "metrics.jsonl",
             "render_000002.png", "training_curves.png"]
    assert list(got["dp0"]["train/files"]) == files
    assert list(got["tp0"]["train/files"]) == [f for f in files if f != "metrics.jsonl"]
    for r in ("dp1", "tp1", "tp2", "tp3"):
        assert list(got[r]["train/files"]) == []
    rows = [json.loads(x) for x in (d / "train_rank0" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    ckpt = torch.load(d / "tp_train_rank0" / "checkpoint_final.pt", weights_only=False)
    assert ckpt["model_state_dict"]["pts_linears.0.weight"].shape == (32, 63)
    assert ckpt["iteration"] == 3


def test_cli_train_two_processes(runs):
    """`train --device cpu --coordinator_address 127.0.0.1:P --num_processes 2
    --process_id i --mesh_data 2` in 2 processes: rank 0 writes the
    checkpoint and the rows, rank 1 nothing, and the checkpoint equals a
    single-process run's within atol 1e-5."""
    _, _, d = runs
    assert not (d / "cli_rank1").exists()
    a = torch.load(d / "cli_rank0" / "checkpoint_final.pt", weights_only=False)
    b = torch.load(d / "cli_single" / "checkpoint_final.pt", weights_only=False)
    assert a["iteration"] == b["iteration"] == 3
    for k, v in b["model_state_dict"].items():
        np.testing.assert_allclose(a["model_state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(a["appearance_embeddings"].numpy(),
                               b["appearance_embeddings"].numpy(), atol=1e-5)
    rows = (d / "cli_rank0" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in rows] == [1, 2, 3]


def test_render_path_two_ranks(runs, tmp_path):
    """render_path (64 + 64 medium, jittered) over 2 ranks: with a mesh each
    frame's rays are sharded and rank 0 writes both frames (within 1 level
    of one process's: the same jitter, drawn whole, in f32 sums of another
    order), rank 1 nothing; without a mesh each rank renders and writes its
    slice of the frames, equal to one process's."""
    from torch_parallel_worker import render_path_case

    from danerf_tpu_torch.data.png import read_png

    _, _, d = runs
    render_path_case(str(tmp_path / "single"))
    single = {n: read_png(str(tmp_path / "single" / n)) for n in ("rgb_000.png", "rgb_001.png")}
    assert not (d / "render_mesh1").exists()
    for name, want in single.items():
        got = read_png(str(d / "render_mesh0" / name)).astype(int)
        assert np.abs(got - want).max() <= 1, name
    assert sorted(os.listdir(d / "render_slices0")) == ["depth_000.png", "rgb_000.png"]
    assert sorted(os.listdir(d / "render_slices1")) == ["depth_001.png", "rgb_001.png"]
    for i in range(2):
        np.testing.assert_array_equal(read_png(str(d / f"render_slices{i}" / f"rgb_00{i}.png")),
                                      single[f"rgb_00{i}.png"])


def _orbax_leaves(tree, prefix=()):
    """{orbax name: array} of the port's tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _orbax_leaves(sub, prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _orbax_leaves(sub, prefix + (str(i),)).items()}
    return {".".join(map(str, prefix)): np.asarray(tree)}


@pytest.mark.parametrize("mesh_data,mesh_model", [(2, 1), (2, 2), (1, 2)],
                         ids=["mesh_data2", "mesh_data2_model2", "mesh_model2"])
def test_checkpoint_of_a_sharded_state_reads_as_jax_restores(tmp_path, mesh_data, mesh_model):
    """The JAX ``save_checkpoint`` of a train state on a mesh of the fake CPU
    devices (``shard_train_state``, ``tensor_parallel`` where the model axis
    is 2: the trunk split over it), after one sharded step so that Adam's
    moments are laid out as the parameters: ``read_jax_checkpoint`` equals
    the JAX ``restore_checkpoint`` leaf for leaf, bit for bit.  The JAX
    writer gathers every leaf to one host array before Orbax sees it
    (``_to_host``), so the store has the one-device layout."""
    from danerf_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint
    from danerf_tpu_torch.utils.checkpoint import read_jax_checkpoint

    cfg = JaxConfig(**TINY)
    sc = make_synthetic_scene("train", n_images=4, height=8, width=8)
    st = create_train_state(jax.random.key(0), cfg, sc.n_images)
    mesh = make_mesh(data=mesh_data, model=mesh_model,
                     devices=jax.devices()[:mesh_data * mesh_model])
    tp = mesh_model > 1
    st = shard_train_state(st, mesh, tensor_parallel=tp)
    st, _ = make_sharded_train_step(cfg, mesh, sc.height, sc.width, sc.focal,
                                    tensor_parallel=tp)(st, replicate_pool(sc.device_arrays(),
                                                                           mesh))
    w0 = st.params["model"]["trunk"][0]["w"]
    assert len(w0.sharding.device_set) == mesh_data * mesh_model
    assert w0.sharding.is_fully_replicated != tp
    save_checkpoint(str(tmp_path), "checkpoint_000001", st, {"step": 1})
    path = str(tmp_path / "checkpoint_000001")
    restored, meta = restore_checkpoint(path, create_train_state(jax.random.key(1), cfg,
                                                                 sc.n_images))
    tree, got_meta = read_jax_checkpoint(path)
    assert got_meta == meta
    want = {}
    for p, x in jax.tree_util.tree_leaves_with_path(restored):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        want[".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))))
                      for k in p)] = np.asarray(x)
    got = _orbax_leaves(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    assert any(np.abs(v).max() > 0 for k, v in want.items() if k.endswith(".mu"))
