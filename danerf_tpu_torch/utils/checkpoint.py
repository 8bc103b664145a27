"""Training checkpoints as reference-format ``.pt`` files: a dict with
``model_state_dict`` (the reference keys), ``appearance_embeddings``,
``optimizer_state_dict``, ``scheduler_state_dict``, ``iteration``, ``loss``
and ``psnr``, so ``render --checkpoint <file>`` (and the reference's own
loader) reads it as it is, plus ``generator_state``, the training
generator's state, which a reader of the reference keys ignores.  The
optimizer and scheduler state is written as a CPU run holds it (host
tensors, float rates), whatever device trained.  ``load_model`` builds the
module of one; ``restore_training_state`` puts the whole training state of
one back, so that ``train(resume=True)`` continues where it stopped.

Both also take the JAX package's checkpoint directories
(``checkpoint_NNNNNN/`` or ``checkpoint_final/`` with a ``meta.json``, as
its ``save_checkpoint`` writes them), read without JAX by
``read_jax_checkpoint``: Orbax (an OCDBT store of zarr v2 arrays, zstd
chunks; ``ocdbt.py``, ``zarr.py``, ``zstd.py``).  ``latest_checkpoint``
considers both kinds.  The port writes only ``.pt``."""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch


def _float(v):
    """A hyperparameter as the CPU run holds it: a tensor rate as a float."""
    if isinstance(v, torch.Tensor):
        return float(v)
    if isinstance(v, list):
        return [_float(x) for x in v]
    return v


def _portable_optimizer_state(optimizer) -> dict:
    """Adam's state dict with its tensors on the host, its rates as floats
    and ``capturable`` off: what a CPU run writes (``capturable`` Adam
    refuses CPU parameters)."""
    sd = optimizer.state_dict()
    state = {i: {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
             for i, s in sd["state"].items()}
    groups = [{**{k: _float(v) for k, v in g.items()}, "capturable": False}
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def save_checkpoint(path: str, model, appearance=None, optimizer=None, scheduler=None,
                    iteration: int = 0, loss: Optional[float] = None,
                    psnr: Optional[float] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write the checkpoint to ``path`` (via a temporary file, so a reader
    never sees half of one) and return the path."""
    ckpt = {"model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "iteration": int(iteration), "loss": loss, "psnr": psnr}
    if appearance is not None:
        ckpt["appearance_embeddings"] = appearance.detach().cpu()
    if optimizer is not None:
        ckpt["optimizer_state_dict"] = _portable_optimizer_state(optimizer)
    if scheduler is not None:
        ckpt["scheduler_state_dict"] = {k: _float(v) for k, v in scheduler.state_dict().items()}
    if generator is not None:
        ckpt["generator_state"] = generator.get_state()
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The newest checkpoint in ``save_dir``, a ``.pt`` file or a JAX
    checkpoint directory.  The rule: a ``checkpoint_final`` of either kind
    beats any step; otherwise the highest step (``checkpoint_NNNNNN``)
    wins; on a tie the ``.pt`` wins.  A directory counts only with its
    ``meta.json``, as in the JAX package.  None when there is none."""
    if not os.path.isdir(save_dir):
        return None
    found = []
    for name in os.listdir(save_dir):
        m = re.fullmatch(r"checkpoint_(\d+|final)(\.pt)?", name)
        if not m:
            continue
        path = os.path.join(save_dir, name)
        pt = m.group(2) is not None
        if not (os.path.isfile(path) if pt else
                os.path.isfile(os.path.join(path, "meta.json"))):
            continue
        final = m.group(1) == "final"
        found.append((final, 0 if final else int(m.group(1)), pt, path))
    return max(found)[-1] if found else None


def _tree(leaves) -> dict:
    """Nested dicts and lists from (key path, key types, value): key type 1
    is a sequence index, 2 a dict key (orbax's ``key_type``)."""
    root: dict = {}
    for keys, types, value in leaves:
        node = root
        for i, (k, t) in enumerate(zip(keys, types)):
            if t not in (1, 2):
                raise ValueError(f"orbax leaf {'.'.join(keys)}: key_type {t} is neither 1 "
                                 "(sequence index) nor 2 (dict key)")
            k = int(k) if t == 1 else k
            if i == len(keys) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        ints = [isinstance(k, int) for k in node]
        if any(ints) and not all(ints):
            raise ValueError(f"orbax tree mixes sequence indices and dict keys: {list(node)}")
        if ints and all(ints):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"orbax sequence has indices {sorted(node)}, not 0..n-1")
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def _read_orbax(state: str) -> dict:
    """The tree of an orbax ``StandardCheckpointer`` directory ``state``."""
    from danerf_tpu_torch.utils import zarr
    from danerf_tpu_torch.utils.ocdbt import OcdbtStore

    path = os.path.join(state, "_METADATA")
    if not os.path.isfile(path):
        raise ValueError(f"{state}: no _METADATA; not an orbax checkpoint this reader knows")
    with open(path) as f:
        md = json.load(f)
    if md.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is true (zarr v3 arrays); only zarr v2 is "
                         "supported")
    tm = md.get("tree_metadata")
    if not isinstance(tm, dict) or not tm:
        raise ValueError(f"{path}: no tree_metadata; an orbax layout this reader does not know")
    leaves = []
    for name, entry in tm.items():
        km = entry.get("key_metadata")
        vm = entry.get("value_metadata", {})
        if not km:
            raise ValueError(f"{path}: leaf {name} has no key_metadata")
        if vm.get("value_type") not in ("np.ndarray", "jax.Array", "scalar"):
            raise ValueError(f"{path}: leaf {name} has value_type {vm.get('value_type')!r}; "
                             "only arrays and scalars are supported")
        if vm.get("skip_deserialize"):
            raise ValueError(f"{path}: leaf {name} is marked skip_deserialize")
        keys = [str(k["key"]) for k in km]
        if tuple(keys) != tuple(ast.literal_eval(name)):
            raise ValueError(f"{path}: leaf {name} does not match its key_metadata {keys}")
        leaves.append((keys, [k.get("key_type") for k in km]))
    if md.get("use_ocdbt", True):
        store = OcdbtStore(state)
    else:
        store = zarr.DirectoryStore(state)
    arrays = zarr.read_arrays(store, [".".join(k) for k, _ in leaves])
    return _tree([(k, t, arrays[".".join(k)]) for k, t in leaves])


def read_jax_checkpoint(path: str) -> Tuple[dict, dict]:
    """The state tree of a JAX checkpoint directory ``path`` (what the JAX
    package's ``save_checkpoint`` wrote: for a train state ``params``,
    ``opt_state``, ``step`` and ``key``) as nested dicts and lists of numpy
    arrays, and its ``meta.json``.

    It reads ``meta["backend"]`` ``orbax``, ``state/`` (its ``_METADATA``
    gives each leaf's key path).  It needs no template: shapes and dtypes
    come from the store.  Any other backend is refused: the JAX package's
    msgpack fallback raises ``TypeError`` on a train state (flax's
    ``msgpack_serialize`` refuses its namedtuple and the optimizer's
    tuples), so its trainer writes no other kind.  A layout it does not
    know raises ``ValueError`` naming it; it never falls back to anything."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: no meta.json; not a danerf_tpu checkpoint directory")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("backend") != "orbax":
        raise ValueError(f"{path}: meta.json names backend {meta.get('backend')!r}; only "
                         "'orbax' is read (the JAX package's msgpack fallback cannot write "
                         "a train state)")
    return _read_orbax(os.path.join(path, "state")), meta


def _jax_params(tree: dict, path: str):
    """(model param tree, appearance table or None) of a JAX state tree."""
    params = tree.get("params") if isinstance(tree, dict) else None
    if not isinstance(params, dict) or "model" not in params:
        raise ValueError(f"{path}: the checkpoint holds no params.model")
    return params, params["model"], params.get("appearance")


def _jax_training_checkpoint(path: str, model, table, optimizer, scheduler) -> dict:
    """The ``.pt`` dict that ``orbax_to_pt.py`` writes for JAX checkpoint
    ``path``, for ``model`` and ``table``: the parameters, Adam's moments
    and count, the rates of a CPU Adam and StepLR with ``optimizer``'s and
    ``scheduler``'s settings after ``step`` steps, and the iteration."""
    from danerf_tpu_torch.utils.convert import jax_moments, params_from_jax

    tree, meta = read_jax_checkpoint(path)
    params, mparams, app = _jax_params(tree, path)
    if (table is None) != (app is None):
        raise ValueError(f"{path}: the checkpoint has {'an' if app is not None else 'no'} "
                         f"appearance table and the model being resumed "
                         f"{'has one' if table is not None else 'has none'}")
    adam = []

    def find(node):
        if isinstance(node, dict) and "mu" in node and "nu" in node:
            adam.append(node)
        elif isinstance(node, (dict, list)):
            for v in (node.values() if isinstance(node, dict) else node):
                find(v)

    find(tree.get("opt_state"))
    if len(adam) != 1:
        raise ValueError(f"{path}: no single Adam state (count, mu, nu) in opt_state")
    adam = adam[0]
    step = int(np.asarray(tree["step"]))
    names = [n for n, _ in model.named_parameters()]
    moments = {k: jax_moments(adam[m], params, names, table is not None)
               for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
    count = float(np.asarray(adam["count"]))
    n = len(names) + (table is not None)
    state = {i: {"step": torch.tensor(count), "exp_avg": moments["exp_avg"][i],
                 "exp_avg_sq": moments["exp_avg_sq"][i]} for i in range(n)}
    # the rates as orbax_to_pt.py leaves them: a CPU Adam and StepLR made
    # with these settings (make_optimizer's) after ``step`` steps, each lr
    # the product StepLR forms, one gamma per ``step_size`` steps
    group = optimizer.param_groups[0]
    lr = float(group.get("initial_lr", group["lr"]))
    cpu = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1)) for _ in range(n)], lr=lr,
                           betas=tuple(float(b) for b in group["betas"]), eps=group["eps"])
    sched = torch.optim.lr_scheduler.StepLR(cpu, step_size=scheduler.step_size,
                                            gamma=scheduler.gamma)
    for _ in range(step // scheduler.step_size):
        lr *= scheduler.gamma
    for g in cpu.param_groups:
        g["lr"] = lr
    sched_state = {**sched.state_dict(), "last_epoch": step, "_step_count": step + 1,
                   "_last_lr": [lr] * len(cpu.param_groups)}
    ckpt = {"model_state_dict": params_from_jax(mparams), "iteration": step,
            "loss": meta.get("loss"), "psnr": meta.get("psnr"),
            "optimizer_state_dict": {"state": state,
                                     "param_groups": _portable_optimizer_state(cpu)[
                                         "param_groups"]},
            "scheduler_state_dict": {k: _float(v) for k, v in sched_state.items()}}
    if app is not None:
        ckpt["appearance_embeddings"] = torch.tensor(np.asarray(app, np.float32))
    return ckpt


def restore_training_state(path: str, model, table, optimizer, scheduler,
                           generator: Optional[torch.Generator] = None) -> int:
    """Put the training state of checkpoint ``path`` back into ``model``,
    the appearance ``table``, ``optimizer`` (Adam), ``scheduler`` (StepLR)
    and ``generator``, each on the device it lies on, and return the
    checkpoint's iteration.  Adam keeps its own ``capturable`` setting and
    rate type: on the card its step counts come back as device tensors and
    its rate as a device tensor.  A checkpoint without ``generator_state``
    leaves the generator as it is.

    ``path`` may be a JAX checkpoint directory: its parameters and
    appearance table, Adam's moments (optax's flat ``mu``/``nu`` split into
    the parameters' shapes in JAX's tree order and transposed like them)
    with the count of ``opt_state[0].count``, StepLR after ``step`` steps
    and the iteration come back exactly as through the ``.pt`` that
    ``orbax_to_pt.py`` writes of it.  The JAX PRNG ``key`` has no torch
    counterpart: the generator stays as it was seeded (``--seed``)."""
    if os.path.isdir(path):
        ckpt = _jax_training_checkpoint(path, model, table, optimizer, scheduler)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(ckpt["model_state_dict"])
    if table is not None:
        with torch.no_grad():
            table.copy_(ckpt["appearance_embeddings"])
    saved = ckpt["optimizer_state_dict"]
    groups = []
    for g, now in zip(saved["param_groups"], optimizer.param_groups):
        g = {**g, "capturable": now["capturable"]}
        for key in ("lr", "initial_lr"):
            if key in g and isinstance(now.get(key), torch.Tensor):
                g[key] = torch.tensor(float(g[key]), device=now[key].device)
        groups.append(g)
    optimizer.load_state_dict({"state": saved["state"], "param_groups": groups})
    scheduler.load_state_dict(ckpt["scheduler_state_dict"])
    if generator is not None and "generator_state" in ckpt:
        generator.set_state(ckpt["generator_state"])
    return int(ckpt["iteration"])


def _load_state(path: str):
    """(state dict, appearance table or None, metadata) of a ``.pt`` or a
    JAX checkpoint directory."""
    from danerf_tpu_torch.utils.convert import load_reference_checkpoint, params_from_jax

    if not os.path.isdir(path):
        return load_reference_checkpoint(path)
    tree, meta = read_jax_checkpoint(path)
    _, mparams, app = _jax_params(tree, path)
    emb = None if app is None else torch.tensor(np.asarray(app, np.float32))
    info = {k: meta[k] for k in ("loss", "psnr") if k in meta}
    if "step" in tree:
        info["iteration"] = int(np.asarray(tree["step"]))
    return params_from_jax(mparams), emb, info


def load_model(path: str, cfg, device="cuda"):
    """The ``NeRF`` module of a reference-format ``.pt`` or of a JAX
    checkpoint directory on ``device``: the card unless the caller asks for
    the CPU (``resolve_device``: raises when CUDA is asked for and absent).

    ``cfg`` gives the architecture; its ``use_appearance`` is taken from the
    checkpoint (a JAX directory: whether it holds ``params.appearance``).
    Its ``use_time`` must match the checkpoint: a time-conditioned model's
    first and skip layers take ``time_enc_dim`` (13 at 6 levels) more input
    columns.  Returns (model, appearance table or None, metadata, cfg)."""
    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.models.nerf import NeRF

    device = resolve_device(device)
    sd, emb_table, meta = _load_state(path)
    cfg = cfg.replace(use_appearance="appearance_projection.weight" in sd)
    width = sd["pts_linears.0.weight"].shape[1]
    want = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
    if width != want:
        timed = width == cfg.pos_enc_dim + cfg.time_enc_dim
        raise ValueError(f"{path}: the first layer takes {width} inputs, the config "
                         f"{want} (use_time={cfg.use_time}); the checkpoint is "
                         f"{'' if timed else 'not '}a time-conditioned model")
    model = NeRF(cfg)
    model.load_state_dict(sd)
    return model.to(device), emb_table, meta, cfg
