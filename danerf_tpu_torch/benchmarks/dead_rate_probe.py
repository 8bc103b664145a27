"""The born-dead rate of the density head over many seeds, for two init
families (counterpart of benchmarks/dead_rate_probe.py).

The reference's ReLU density head under torch's default init can be BORN
DEAD (sigma_pre < 0 at every visible point -> zero gradients forever).  The
parity study excludes dead seeds symmetrically; this probe measures the rate
itself for (a) the reference's torch inits and (b) the port's trainer inits
(``train.trainer.init_model``: the same U(+-1/sqrt(in)) distribution from
another stream), with the same fixed probe set.

The report has the keys of ``examples/parity_runs/dead_rates.json``: the
``torch_*`` keys are family (a), the ``jax_*`` keys the framework family,
here the port's own inits (b).

    python -m danerf_tpu_torch.benchmarks.dead_rate_probe --n 60 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from danerf_tpu_torch import resolve_device


def run(n: int = 60, scene: str | None = None, out: str | None = None, device="cuda",
        base=None) -> dict:
    """Probe seeds 0..n-1 of both families on ``device``; write the report
    to ``out`` (when given) and return it."""
    from danerf_tpu_torch.benchmarks.reference_init import (density_alive_probe,
                                                            model_from_reference,
                                                            sample_torch_init)
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import load_blender_scene
    from danerf_tpu_torch.examples.parity_study import SCENE
    from danerf_tpu_torch.train.trainer import init_model

    dev = resolve_device(device)
    ds = load_blender_scene(scene or SCENE, "train")
    cfg = (base or NeRFConfig()).replace(num_importance=0, use_kernels=False, use_bf16=False,
                                         near=ds.near, far=ds.far)

    def alive(model) -> bool:
        return density_alive_probe(model, cfg, ds.images.shape, ds.c2ws, ds.focal) > 0.0

    torch_alive = [alive(model_from_reference(sample_torch_init(cfg, ds.n_images, s), cfg,
                                              dev)[0]) for s in range(n)]
    port_alive = [alive(init_model(cfg, ds.n_images, s, dev)[0]) for s in range(n)]
    report = {
        "n_seeds": n,
        "torch_init_dead_rate": 1.0 - float(np.mean(torch_alive)),
        "jax_init_dead_rate": 1.0 - float(np.mean(port_alive)),
        "torch_dead_seeds": [s for s, a in enumerate(torch_alive) if not a],
        "jax_dead_seeds": [s for s, a in enumerate(port_alive) if not a],
        "families": {"torch": "the reference's torch inits (reference_init)",
                     "jax": "the port's trainer inits (train.trainer.init_model), in the "
                            "place of the JAX package's"},
        "device": str(dev),
        "note": "same fixed probe set both families (density_alive_probe); the hazard is "
                "a property of the reference architecture (ReLU density head, "
                "U(+-1/sqrt(in)) init), not of either framework",
    }
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


def main(argv=None) -> dict:
    from danerf_tpu_torch.examples.parity_study import RUNS_DIR, SCENE

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "dead_rates.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.n, args.scene, args.out, args.device)


if __name__ == "__main__":
    main()
