"""The 64 coarse + 64 importance samples demo, end to end (counterpart of
examples/hier_demo.py): train on the procedural scene, then score 3 val
views with the trained appearance table; writes OUT/report.json.

    python -m danerf_tpu_torch.examples.hier_demo [--iters 1500] [--size 100] [--device cuda]
        [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import sync

OUT = os.path.join("build", "hier_out")   # gitignored


def run(cfg, iters: int = 1500, size: int = 100, out: str = OUT,
        device="cuda", seed: int = 0, scenes=None) -> dict:
    """Train ``cfg`` for ``iters`` steps at ``size`` x ``size`` from
    ``seed`` (``train``'s init and batches), evaluate, write
    ``out/report.json`` and return the report.  ``scenes``, a (train, val)
    pair made as this function makes them, is used as it is (several seeds
    on one scene)."""
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.train.trainer import train

    dev = resolve_device(device)
    scene, val = scenes or (make_synthetic_scene("train", height=size, width=size),
                            make_synthetic_scene("val", height=size, width=size))

    t0 = time.time()
    model, table, _ = train(cfg, scene, save_dir=os.path.join(out, "checkpoints"),
                            num_iterations=iters, checkpoint_every=iters, eval_every=0,
                            progress=False, device=dev, seed=seed)
    sync(dev)
    train_s = time.time() - t0
    m = evaluate(model, cfg, val, appearance=None if table is None else table.detach(),
                 max_views=3, device=dev)

    report = {
        "iters": iters,
        "seed": seed,
        "train_s": train_s,
        "train_rays_per_sec": iters * cfg.batch_size / train_s,
        "psnr": m["psnr"],
        "ssim": m["ssim"],
        "config": f"{'kernels' if cfg.use_kernels else 'plain'} hier "
                  f"{cfg.num_samples}+{cfg.num_importance}",
        "backend": str(dev),
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    from danerf_tpu_torch.config import NeRFConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--size", type=int, default=100)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init's and the batch stream's seed (train's)")
    args = ap.parse_args(argv)
    return run(NeRFConfig(use_bf16=True), args.iters, args.size, args.out, args.device,
               args.seed)


if __name__ == "__main__":
    main()
