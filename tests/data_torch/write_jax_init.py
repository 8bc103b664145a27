"""Write the JAX full-scale run's initial parameters as an ``.npz``.

    python tests/data_torch/write_jax_init.py

Runs where JAX and the danerf_tpu package are (from the repository root).
Draws ``create_train_state(jax.random.key(0), NeRFConfig(use_bf16=True),
100)`` (``danerf_tpu/train/trainer.py``), the state that
``examples/full_scale.py`` trains from at its defaults (seed 0, 100 train
views), and writes its ``params["model"]`` and ``params["appearance"]`` to
``danerf_tpu_torch/examples/jax_init_seed0.npz``: one f32 array a leaf
under its dotted name (``model.trunk.0.w``, ``model.density.b``,
``appearance``), JAX's (in, out) weight layout, ~537k values.  The port
reads it with numpy only (``danerf_tpu_torch/utils/convert.read_params_npz``)
and starts ``examples/full_scale.py --init-npz`` from it on a host without
JAX.  ``tests/test_torch_examples.py`` holds the committed file equal to a
fresh draw, bit for bit.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NPZ = os.path.join(ROOT, "danerf_tpu_torch", "examples", "jax_init_seed0.npz")
SEED, N_IMAGES = 0, 100


def leaves(tree, prefix=""):
    """(dotted name, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def jax_init_arrays(seed: int = SEED, n_images: int = N_IMAGES) -> dict:
    """{dotted name: float32 ndarray} of the JAX train state's params."""
    import jax
    import numpy as np

    sys.path.insert(0, ROOT)
    from danerf_tpu.config import NeRFConfig
    from danerf_tpu.train.trainer import create_train_state

    state = create_train_state(jax.random.key(seed), NeRFConfig(use_bf16=True), n_images)
    return {name: np.asarray(leaf, np.float32) for name, leaf in leaves(state.params)}


def main():
    import numpy as np

    arrays = jax_init_arrays()
    np.savez_compressed(NPZ, **arrays)
    print(f"{NPZ}: {len(arrays)} arrays, {sum(a.size for a in arrays.values()):,} values, "
          f"{os.path.getsize(NPZ):,} bytes")


if __name__ == "__main__":
    main()
