"""Write the full-width JAX checkpoint fixture and its digests.

    python tests/data_torch/write_jax_checkpoint.py

Runs where JAX, orbax and the danerf_tpu package are (from the repository
root).  Writes ``tests/data_torch/jax_run/checkpoint_000003/`` through
``danerf_tpu.utils.checkpoint.save_checkpoint`` (Orbax: an OCDBT store of
zarr v2 arrays with zstd chunks) and ``jax_checkpoint_digests.json``: each
leaf as ``restore_checkpoint`` returns it (the PRNG key as its raw uint32
data), by its orbax name (``params.model.trunk.0.w``, ``opt_state.0.mu``,
``step``, ``key``), with its dtype, shape and the sha256 of its C-order
bytes.

The model: the default ``NeRFConfig`` widths (a trunk of 8 x 256 with the
skip at layer 4, appearance 32, 5 appearance rows) with
``density_bias_init=0.5``, trained 3 steps of ``make_train_step`` (1,024
rays a step, 64 + 64 samples) on ``make_synthetic_scene(n_images=5,
height=16, width=16)`` from ``jax.random.key(0)``.  At the default
``density_bias_init`` of 0 the model is dead on this scene after 3 steps:
every gradient is 0 and Adam's moments stay all zero, which would leave
their split and their zstd blocks untested.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(HERE, "jax_run")
STEPS = 3
CONFIG = {"density_bias_init": 0.5}
SCENE = {"n_images": 5, "height": 16, "width": 16}


def leaf_name(path) -> str:
    """A JAX key path as orbax names the leaf: its keys joined by '.'."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def main():
    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from danerf_tpu.config import NeRFConfig
    from danerf_tpu.data.synthetic import make_synthetic_scene
    from danerf_tpu.train.trainer import create_train_state, make_train_step
    from danerf_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = NeRFConfig(**CONFIG)
    ds = make_synthetic_scene(**SCENE)
    state = create_train_state(jax.random.key(0), cfg, ds.n_images)
    step = make_train_step(cfg, ds.height, ds.width, ds.focal)
    pool = ds.device_arrays(cfg.white_background)
    for _ in range(STEPS):
        state, metrics = step(state, pool)
    shutil.rmtree(RUN, ignore_errors=True)
    path = save_checkpoint(RUN, f"checkpoint_{STEPS:06d}", state,
                           {"step": STEPS, **{k: float(v) for k, v in metrics.items()}})
    template = create_train_state(jax.random.key(0), cfg, ds.n_images)
    restored, meta = restore_checkpoint(path, template)
    leaves = {}
    for p, x in jax.tree_util.tree_leaves_with_path(restored):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        x = np.asarray(x)
        leaves[leaf_name(p)] = {"dtype": x.dtype.name, "shape": list(x.shape),
                                "sha256": hashlib.sha256(x.tobytes()).hexdigest()}
    out = {"checkpoint": os.path.relpath(path, HERE), "config": CONFIG, "scene": SCENE,
           "steps": STEPS, "meta": meta, "leaves": leaves}
    with open(os.path.join(HERE, "jax_checkpoint_digests.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"wrote": path, "leaves": len(leaves)}))


if __name__ == "__main__":
    main()
