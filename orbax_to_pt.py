"""Convert a danerf_tpu checkpoint directory (Orbax, or its msgpack
fallback) into a reference-format ``.pt``.

    python orbax_to_pt.py CHECKPOINT_DIR OUT.pt [--scene S --dataset_path P
        | --n_images N] [--no_appearance] [--use_time]

The port reads an Orbax directory itself (``danerf_tpu_torch.utils.
checkpoint.read_jax_checkpoint``, without JAX); this script restores it
through the JAX package instead, and so is the JAX-side referee of the
port's reader (``tests/test_torch_jax_checkpoint.py``), or gives a ``.pt``
for a reader of the reference's format.  Runs where JAX is installed (it
imports ``danerf_tpu``; the port itself never does).  The architecture flags are the JAX CLI's (the default
``NeRFConfig``, ``--no_appearance``, ``--use_time``); the number of
appearance rows comes from ``--n_images`` or from the scene's train split,
as the JAX CLI sizes its template.  The file holds:

- ``model_state_dict``: the model's parameters (``utils/convert.params_from_jax``:
  the JAX (in, out) weights transposed to torch's (out, in));
- ``appearance_embeddings``: the table;
- ``iteration``: the step; ``loss``/``psnr`` from the checkpoint's meta.json;
- ``optimizer_state_dict``: Adam's moments (optax's flattened state, split
  into the parameters' shapes and transposed like them) and its count, in
  the order of the port's optimizer (the module's parameters, then the
  table);
- ``scheduler_state_dict``: StepLR's state after that many steps.

The JAX PRNG key has no torch counterpart, so no generator state is
written: ``train --resume`` of the file continues with the port's own
generator seeded from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside ``opt_state``."""
    import jax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
        if hasattr(s, "mu")]
    if len(found) != 1:
        raise ValueError("no single Adam state in the checkpoint's optimizer state")
    return found[0]


def _unflatten(flat, params):
    """A flat vector of optax.flatten's state in the shapes of ``params``
    (the leaves of jax.tree.flatten(params), in order)."""
    import jax
    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(params)
    sizes = np.cumsum([np.size(x) for x in leaves])[:-1]
    parts = np.split(np.asarray(flat), sizes)
    return jax.tree_util.tree_unflatten(
        treedef, [p.reshape(np.shape(x)) for p, x in zip(parts, leaves)])


def convert(ckpt_dir: str, out_path: str, cfg, n_images: int) -> str:
    """Restore ``ckpt_dir`` (danerf_tpu.utils.checkpoint.restore_checkpoint
    on a template of ``cfg`` with ``n_images`` appearance rows) and write the
    port's ``.pt`` to ``out_path``."""
    import dataclasses

    import jax
    import numpy as np
    import torch

    from danerf_tpu.train.trainer import TrainState, create_train_state
    from danerf_tpu.utils.checkpoint import restore_checkpoint
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.train.trainer import make_optimizer
    from danerf_tpu_torch.utils.checkpoint import save_checkpoint
    from danerf_tpu_torch.utils.convert import params_from_jax

    template = create_train_state(jax.random.key(0), cfg, n_images)
    restored, meta = restore_checkpoint(ckpt_dir, template)
    state = TrainState(*jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                                     jax.tree_util.tree_leaves(restored)))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    adam = _adam_state(state.opt_state)
    mu, nu = _unflatten(adam.mu, params), _unflatten(adam.nu, params)
    step = int(np.asarray(state.step))

    tcfg = NeRFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(NeRFConfig)
                         if hasattr(cfg, f.name)})
    model = NeRF(tcfg)
    model.load_state_dict(params_from_jax(params["model"]))
    table = None
    if cfg.use_appearance:
        table = torch.nn.Parameter(torch.tensor(np.asarray(params["appearance"], np.float32)))
    tensors = list(model.parameters()) + ([table] if table is not None else [])
    optimizer, scheduler = make_optimizer(tcfg, tensors)
    moments = {}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        sd = params_from_jax(tree["model"])
        moments[key] = [sd[n] for n, _ in model.named_parameters()]
        if table is not None:
            moments[key].append(torch.tensor(np.asarray(tree["appearance"], np.float32)))
    count = float(np.asarray(adam.count))
    for i, p in enumerate(tensors):
        optimizer.state[p] = {"step": torch.tensor(count),
                              "exp_avg": moments["exp_avg"][i].clone(),
                              "exp_avg_sq": moments["exp_avg_sq"][i].clone()}
    with warnings.catch_warnings():      # StepLR stepped without optimizer steps
        warnings.simplefilter("ignore")
        for _ in range(step):
            scheduler.step()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return save_checkpoint(out_path, model, table, optimizer, scheduler, iteration=step,
                           loss=meta.get("loss"), psnr=meta.get("psnr"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="a danerf_tpu checkpoint directory")
    ap.add_argument("out", help="the .pt to write")
    ap.add_argument("--scene", type=str, default="lego")
    ap.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    ap.add_argument("--n_images", type=int, default=None,
                    help="appearance rows (default: the scene's train split)")
    ap.add_argument("--no_appearance", action="store_true")
    ap.add_argument("--use_time", action="store_true")
    args = ap.parse_args(argv)

    from danerf_tpu.config import NeRFConfig

    cfg = NeRFConfig(scene=args.scene, dataset_path=args.dataset_path,
                     use_appearance=not args.no_appearance, use_time=args.use_time)
    n_images = args.n_images
    if n_images is None:
        from danerf_tpu.data import load_dataset

        n_images = load_dataset(cfg, "train").n_images
    path = convert(args.checkpoint, args.out, cfg, n_images)
    with open(os.path.join(args.checkpoint, "meta.json")) as f:
        print(json.dumps({"wrote": path, "step": json.load(f).get("step")}))
    return path


if __name__ == "__main__":
    main()
