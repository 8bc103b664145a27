"""One model per scene, each with its aligned-spiral video, and a combined
report (counterpart of examples/multi_scene.py).  An integer names a
variant of the procedural scene (its blob-field seed); any other name a
scene on disk, loaded as ``load_dataset`` loads it.

    python -m danerf_tpu_torch.examples.multi_scene [--scenes 0 1] [--iters 1500]
        [--size 80] [--frames 16] [--out build/multi_scene_out] [--device cuda] [--seed 0]

Writes OUT/{checkpoints_<scene>, spiral_<scene> (with <scene>_spiral.mp4),
report.json}.
"""

from __future__ import annotations

import argparse
import json
import os

from danerf_tpu_torch import resolve_device

OUT = os.path.join("build", "multi_scene_out")   # gitignored


def run(cfg, scenes=("0", "1"), iters: int = 1500, size: int = 80, frames: int = 16,
        out: str = OUT, device="cuda", seed: int = 0, datasets=None) -> dict:
    """Train one model of ``cfg`` per scene from ``seed`` (``train``'s init
    and batches; a scene's integer name stays its blob-field seed), score 2
    val views and render ``frames`` spiral frames of each; write
    ``out/report.json`` and return the report.  ``datasets``, {scene name:
    (train, val)} made as this function makes them, are used as they are
    (several seeds on one scene)."""
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.render.frames import render_aligned_spiral
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.train.trainer import train

    dev = resolve_device(device)
    report = {}
    for scene_name in scenes:
        scfg = cfg.replace(scene=scene_name)
        if datasets and scene_name in datasets:
            scene, val = datasets[scene_name]
        elif scene_name.isdigit():
            scene = make_synthetic_scene("train", n_images=16, height=size, width=size,
                                         seed=int(scene_name))
            val = make_synthetic_scene("val", n_images=2, height=size, width=size,
                                       seed=int(scene_name))
        else:
            scene = load_dataset(scfg, "train")
            val = load_dataset(scfg, "val")
        model, table, _ = train(scfg, scene, save_dir=os.path.join(out, f"checkpoints_{scene_name}"),
                                checkpoint_every=0, num_iterations=iters, progress=False,
                                device=dev, seed=seed)
        table = None if table is None else table.detach()
        res = evaluate(model, scfg, val, appearance=table, max_views=2, device=dev)
        render_aligned_spiral(model, scfg, os.path.join(out, f"spiral_{scene_name}"),
                              appearance_embedding=None if table is None else table[0],
                              num_frames=frames, rotation_axis="none", height=size, width=size,
                              focal=scene.focal, device=dev)
        report[scene_name] = {"psnr": res["psnr"], "ssim": res["ssim"]}
        print(f"scene {scene_name}: {report[scene_name]}")
    report.update(iters=iters, seed=seed, use_pallas=cfg.use_kernels, backend=str(dev))

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    from danerf_tpu_torch.config import NeRFConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", type=str, nargs="+", default=["0", "1"])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--size", type=int, default=80)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init's and the batch stream's seed (train's); the scenes' "
                         "names stay their blob-field seeds")
    args = ap.parse_args(argv)
    cfg = NeRFConfig(num_importance=0, use_bf16=True, render_chunk=args.size * args.size)
    return run(cfg, args.scenes, args.iters, args.size, args.frames, args.out, args.device,
               args.seed)


if __name__ == "__main__":
    main()
