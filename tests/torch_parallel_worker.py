"""One rank of the port's multi-process runs for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py dp|tp RANK WORLD PORT DIR
    python tests/torch_parallel_worker.py cli ARGV...

``dp`` (2 ranks) and ``tp`` (4 ranks) join a gloo group on the CPU through
``initialize_distributed``, read the inputs the test wrote to
``DIR/ref.npz`` (the JAX package's initial parameters, batches and draws),
run the port's data- and tensor-parallel cases on them and write
``DIR/<case>_rank<RANK>.npz``.  ``cli`` runs ``cli.main`` with the small
config of the tests in place of ``NeRFConfig``'s defaults (the CLI has no
width flags).  Run as a script, only torch and danerf_tpu_torch are
importable: JAX and danerf_tpu are blocked.  The test imports the configs.
"""

import dataclasses
import importlib.abc
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "danerf_tpu"):
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None


sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from danerf_tpu_torch.config import NeRFConfig  # noqa: E402

# The configs of tests/test_parallel.py, for both packages.
TINY = dict(hidden_dim=32, num_layers=3, skip_connect_layers=(2,), num_samples=16,
            num_importance=0, batch_size=128, use_bf16=False, appearance_dim=8)
TIME = dict(TINY, use_time=True, time_enc_levels=4)
# The CLI runs' config (tests/test_torch_cli.py's), in place of the defaults.
SMALL = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
             num_samples=8, num_importance=4, warmup_iters=1, density_bias_init=0.5)
FRAME = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(), num_samples=8,
             num_importance=4, batch_size=16, use_bf16=False, appearance_dim=4,
             pos_enc_levels=4, dir_enc_levels=2)
# Steps of each case; the tensor-parallel cases run on the batches, draws
# and initial state of the data-parallel case of their route.
STEPS = 2
SOURCE = {"module": "module", "kernel": "kernel", "time": "time", "tp_module": "module",
          "tp_kernel": "kernel"}


def cfg_of(case):
    """The port's config of a step case."""
    base = TIME if case == "time" else TINY
    return NeRFConfig(**base, use_kernels=SOURCE[case] == "kernel")


def load_state(ref, case):
    """The module and table of the JAX initial state of ``case``."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.convert import params_from_jax

    cfg = cfg_of(case)
    src = SOURCE[case]
    model = NeRF(cfg)
    model.load_state_dict(params_from_jax(_tree(ref, f"{src}/p", cfg)))
    table = torch.nn.Parameter(torch.tensor(ref[f"{src}/p/appearance"]))
    return cfg, model, table


def state_arrays(prefix, model, table):
    out = {f"{prefix}/{n}": p.detach().numpy().copy() for n, p in model.state_dict().items()}
    if table is not None:
        out[f"{prefix}/appearance"] = table.detach().numpy().copy()
    return out


def batch_of(ref, case, s):
    """Step ``s``'s global batch and stratified jitter of ``case``."""
    src = SOURCE[case]
    batch = {k: torch.tensor(ref[f"{src}/batch{s}/{k}"])
             for k in ("rays_o", "rays_d", "rgb", "img_idx", "t")
             if f"{src}/batch{s}/{k}" in ref}
    batch["img_idx"] = batch["img_idx"].long()
    return batch, (torch.tensor(ref[f"{src}/strat{s}"]), None)


def run_steps(ref, case, mesh):
    """``STEPS`` sharded steps from the JAX initial state on the JAX batches
    and draws; returns (losses, {name: the first step's averaged gradient,
    gathered}, the whole state after the steps)."""
    from danerf_tpu_torch.parallel.mesh import (_unshard, gather_model, sharded_step,
                                                shard_train_state)
    from danerf_tpu_torch.train.trainer import make_optimizer

    cfg, model, table = load_state(ref, case)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    model, table, opt, sched = shard_train_state(model, table, opt, sched, None, mesh,
                                                 tensor_parallel=case.startswith("tp"))
    full = gather_model(model) if case == "tp_kernel" else None
    if full is model:
        full = None
    losses, grads = [], {}
    for s in range(STEPS):
        m = sharded_step(model, table, opt, cfg, mesh, *batch_of(ref, case, s), full)
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {f"{case}/grad/{n}": _unshard(p.grad, n, model.mesh).numpy()
                     if hasattr(model, "mesh") else p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
            grads[f"{case}/grad/appearance"] = table.grad.numpy().copy()
    return np.array(losses), grads, gather_model(model), table


def wait_for_refs(d):
    """The references, once the test has written them (atomically)."""
    import time

    path = os.path.join(d, "ref.npz")
    deadline = time.time() + 250
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return dict(np.load(path))


def join(rank, world, port, data, model):
    """Join the gloo group and return the (data, model) mesh and the scene
    (the port's procedural scene, which equals the JAX package's)."""
    import torch.distributed as dist

    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") is True
    assert dist.get_backend() == "gloo"
    mesh = make_mesh(data=data, model=model, device="cpu")
    assert (mesh.data_index, mesh.model_index) == divmod(rank, model)
    return mesh, make_synthetic_scene("train", n_images=4, height=32, width=32)


def train_files(mesh, scene, save, steps_per_call):
    """train(mesh=) for 3 steps (one warm-up step, then 2) with a checkpoint
    and its validation render at 2, into ``save``; the files it wrote."""
    from danerf_tpu_torch.train.trainer import train

    cfg = NeRFConfig(**TINY, use_kernels=False, warmup_iters=1)
    log = os.path.join(save, "metrics.jsonl") if mesh.model == 1 else None
    train(cfg, scene, save_dir=save, num_iterations=3, checkpoint_every=2, device="cpu",
          progress=False, steps_per_call=steps_per_call, mesh=mesh, log_path=log)
    return np.array(sorted(os.listdir(save)) if os.path.isdir(save) else [])


def render_path_case(out, mesh=None):
    """render_path of 2 jittered 8x6 medium frames of the small model."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.render.frames import render_path

    model = NeRF(NeRFConfig(**SMALL), torch.Generator().manual_seed(0))
    return render_path(model, NeRFConfig(**SMALL), out, num_frames=2, quality="medium",
                       width=8, height=6, seed=3, device="cpu", mesh=mesh)


def dp(rank, world, port, d):
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.parallel import make_sharded_train_step, process_slice
    from danerf_tpu_torch.parallel.mesh import make_sharded_render
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer
    from danerf_tpu_torch.utils.convert import params_from_jax

    mesh, scene = join(rank, world, port, 2, 1)
    out = {"process_slice": np.array([i for i in range(17)][process_slice(17)])}

    # steps_per_call=3 against 3 single calls, from one seeded state
    cfg = NeRFConfig(**TINY, use_kernels=False)
    pool = scene.device_arrays(device="cpu")
    runs = []
    for k, calls in ((3, 1), (1, 3)):
        model, table = init_model(cfg, 4, 0, "cpu")
        opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
        gen = torch.Generator().manual_seed(0)
        step = make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, scene.height,
                                       scene.width, scene.focal, None, gen, k)
        metrics = [step() for _ in range(calls)]
        runs.append((model, table, torch.cat([m["loss"] for m in metrics]),
                     torch.rand(4, generator=gen)))
    (m3, t3, l3, g3), (m1, t1, l1, g1) = runs
    out["chained_equal"] = np.array(
        all(torch.equal(a, b) for a, b in zip(m3.parameters(), m1.parameters()))
        and torch.equal(t3, t1) and torch.equal(l3, l1) and torch.equal(g3, g1))
    # each rank is given its own directory, so that what a rank other than 0
    # writes shows
    out["train/files"] = train_files(mesh, scene, os.path.join(d, f"train_rank{rank}"), 2)
    render_path_case(os.path.join(d, f"render_mesh{rank}"), mesh)
    render_path_case(os.path.join(d, f"render_slices{rank}"))

    ref = wait_for_refs(d)
    for case in ("module", "kernel", "time"):
        losses, grads, model, table = run_steps(ref, case, mesh)
        out[f"{case}/losses"] = losses
        out.update(grads)
        out.update(state_arrays(case, model, table))

    # render_frame(mesh=) through the kernel route (plain versions), 8 + 4
    fcfg = NeRFConfig(**FRAME, use_kernels=True)
    frame_model = NeRF(fcfg)
    frame_model.load_state_dict(params_from_jax(_tree(ref, "frame/p", fcfg)))
    c2w = ref["frame/c2w"]
    rgb, depth, acc = render_frame(frame_model, fcfg, c2w, 16, 16, 20.0, n_importance=4,
                                   perturb=False, chunk=64, device="cpu", mesh=mesh)
    out.update({"frame/rgb": rgb.numpy(), "frame/depth": depth.numpy(), "frame/acc": acc.numpy()})
    # perturbed: each rank takes its share of the chunk's jitter, drawn whole
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    jit_mesh = render_frame(frame_model, fcfg, c2w, 16, 16, 20.0, perturb=True, chunk=64,
                            generator=gens[0], device="cpu", mesh=mesh)
    jit_one = render_frame(frame_model, fcfg, c2w, 16, 16, 20.0, perturb=True, chunk=64,
                           generator=gens[1], device="cpu")
    out["frame/perturb_max_err"] = np.array(max(float((a - b).abs().max())
                                                for a, b in zip(jit_mesh, jit_one)))

    # make_sharded_render (the per-sample route, K1's plain version)
    rcfg = NeRFConfig(**TINY, use_kernels=True)
    rmodel = NeRF(rcfg)
    rmodel.load_state_dict(params_from_jax(_tree(ref, "render/p", rcfg)))
    render = make_sharded_render(rcfg, mesh, 16, 16, rcfg.num_samples, 0)
    with torch.no_grad():
        r_rgb, r_depth, r_acc = render(rmodel, torch.tensor(ref["render/o"]),
                                       torch.tensor(ref["render/d"]))
    out.update({"render/rgb": r_rgb.numpy(), "render/depth": r_depth.numpy(),
                "render/acc": r_acc.numpy()})
    np.savez(os.path.join(d, f"dp_rank{rank}.npz"), **out)


def tp(rank, world, port, d):
    from danerf_tpu_torch.parallel.mesh import TPNeRF, shard_train_state
    from danerf_tpu_torch.train.trainer import make_optimizer

    mesh, scene = join(rank, world, port, 2, 2)
    # train(mesh=) tensor-parallel; its checkpoints are gathered
    out = {"train/files": train_files(mesh, scene, os.path.join(d, f"tp_train_rank{rank}"), 1)}

    ref = wait_for_refs(d)
    cfg, model, table = load_state(ref, "tp_module")
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    tp_model, *_ = shard_train_state(model, table, opt, sched, None, mesh, tensor_parallel=True)
    assert isinstance(tp_model, TPNeRF)
    out.update({f"shard/{n}": p.detach().numpy() for n, p in tp_model.named_parameters()})
    with torch.no_grad():
        rgb, sigma = tp_model(torch.tensor(ref["tp/x"]), torch.tensor(ref["tp/d"]))
    out.update({"tp/rgb": rgb.numpy(), "tp/sigma": sigma.numpy()})

    for case in ("tp_module", "tp_kernel"):
        losses, grads, full, table = run_steps(ref, case, mesh)
        out[f"{case}/losses"] = losses
        out.update(grads)
        out.update(state_arrays(case, full, table))
    np.savez(os.path.join(d, f"tp_rank{rank}.npz"), **out)


def _tree(ref, prefix, cfg):
    """A JAX param tree stored under ``prefix`` in ``ref``."""
    tree = {"trunk": [{"w": ref[f"{prefix}/trunk{i}/w"], "b": ref[f"{prefix}/trunk{i}/b"]}
                      for i in range(cfg.num_layers)]}
    for head in ("density", "dir", "rgb", "appearance_proj"):
        if f"{prefix}/{head}/w" in ref:
            tree[head] = {"w": ref[f"{prefix}/{head}/w"], "b": ref[f"{prefix}/{head}/b"]}
    return tree


def cli(argv):
    """``cli.main`` with the small config of the tests as NeRFConfig's
    defaults."""
    from danerf_tpu_torch import config as config_mod
    from danerf_tpu_torch.cli.main import main

    small = dataclasses.make_dataclass(
        "Small", [(k, type(v), v) for k, v in SMALL.items()],
        bases=(config_mod.NeRFConfig,), frozen=True)
    config_mod.NeRFConfig = small
    main(argv)


if __name__ == "__main__":
    sys.meta_path.insert(0, _Block())
    if sys.argv[1] == "cli":
        cli(sys.argv[2:])
    else:
        {"dp": dp, "tp": tp}[sys.argv[1]](*map(int, sys.argv[2:5]), sys.argv[5])
