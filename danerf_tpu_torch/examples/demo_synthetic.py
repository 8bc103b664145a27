"""End-to-end demo on the procedural scene, coarse-only (counterpart of
examples/demo_synthetic.py): train -> eval PSNR -> aligned-spiral render
with its video -> depth-aware Fog over the frames that have a depth map.

    python -m danerf_tpu_torch.examples.demo_synthetic [--iters 3000] [--out build/demo_out]
        [--size 100] [--frames 24] [--pallas | --no-pallas] [--device cuda] [--seed 0]

Writes OUT/{checkpoints, metrics.jsonl, frames (with lego_spiral.mp4),
fog_frames, report.json}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import sync

OUT = os.path.join("build", "demo_out")   # gitignored


def run(cfg, iters: int = 3000, out: str = OUT, size: int = 100, frames: int = 24,
        device="cuda", seed: int = 0, scenes=None) -> dict:
    """Train ``cfg`` on 20 views at ``size`` x ``size`` from ``seed``
    (``train``'s init and batches), score 4 val views, render ``frames``
    spiral frames and their video, apply Fog; write ``out/report.json`` and
    return the report.  ``scenes``, a (train, val) pair made as this
    function makes them, is used as it is (several seeds on one scene)."""
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.render.frames import render_aligned_spiral
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.train.trainer import train

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    scene, val = scenes or (make_synthetic_scene("train", n_images=20, height=size, width=size),
                            make_synthetic_scene("val", n_images=4, height=size, width=size))

    t0 = time.time()
    model, table, _ = train(cfg, scene, save_dir=os.path.join(out, "checkpoints"),
                            num_iterations=iters, checkpoint_every=0,
                            log_path=os.path.join(out, "metrics.jsonl"), device=dev,
                            seed=seed)
    sync(dev)
    train_s = time.time() - t0
    table = None if table is None else table.detach()

    res = evaluate(model, cfg, val, appearance=table, max_views=4, device=dev)
    print(f"val PSNR {res['psnr']:.2f} dB  SSIM {res['ssim']:.3f} after {iters} steps in "
          f"{train_s:.1f}s")

    frames_dir = os.path.join(out, "frames")
    t1 = time.time()
    render_aligned_spiral(model, cfg, frames_dir,
                          appearance_embedding=None if table is None else table[0],
                          num_frames=frames, rotation_axis="none", height=size, width=size,
                          focal=scene.focal, make_video=True, device=dev)
    render_s = time.time() - t1

    apply_effect_to_frames(frames_dir, os.path.join(out, "fog_frames"), "Fog",
                           make_video=False, device=dev)

    report = {
        "iters": iters,
        "seed": seed,
        "train_seconds": train_s,
        "train_rays_per_sec": iters * cfg.batch_size / train_s,
        "render_seconds_per_frame": render_s / frames,
        "val_psnr": res["psnr"],
        "val_ssim": res["ssim"],
        "backend": str(dev),
        "use_pallas": cfg.use_kernels,
    }
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    from danerf_tpu_torch.config import NeRFConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--size", type=int, default=100)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--pallas", action="store_true",
                    help="the kernel route on the CPU too (its plain versions; default: on "
                         "the card only)")
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init's and the batch stream's seed (train's)")
    args = ap.parse_args(argv)
    use_kernels = ((args.pallas or resolve_device(args.device).type == "cuda")
                   and not args.no_pallas)
    cfg = NeRFConfig(num_importance=0, use_bf16=True, use_kernels=use_kernels,
                     render_chunk=args.size * args.size)
    return run(cfg, args.iters, args.out, args.size, args.frames, args.device, args.seed)


if __name__ == "__main__":
    main()
