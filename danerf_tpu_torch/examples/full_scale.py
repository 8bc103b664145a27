"""Full-scale study: the reference's native workload, end to end, through the
port (counterpart of examples/full_scale.py).

The reference trains 800x800 scenes of 100 train views for 30,000 steps
(its config.py:23, data/nerf_synthetic/README.txt:5-9) and renders 800x800
novel-view videos.  This script runs that scale on the card, with the
procedural scene at the same resolution, view count and step budget:

  1. scene        100 train + 16 val views at 800x800, rendered on the device
                  (make_synthetic_scene(backend="torch")); one val view again
                  by the float64 numpy path on the host, timed, and the
                  pixels the two put a level apart counted
  2. train        the default 64 + 64 configuration, 30,000 steps, a
                  checkpoint and validation render every 1000
  3. eval         PSNR/SSIM over the val views with the mean appearance
                  embedding
  4. spiral       120 aligned-spiral frames at 800x800, a depth map every
                  10th frame, the mp4
  5. effects      Fog and Toon Shader over those frames, an mp4 each

The report holds the JAX report's keys ("backend" is the torch device) and
more: the seed and what the run started from ("init": its source, digest
and density probe), the card's name and power limit ("device"), the
seconds the path's kernels took to build before anything was timed, the
kernel launches of each stage, the loss and PSNR per checkpoint interval,
the rate Adam took at each checkpoint beside StepLR's formula, each
validation render's PSNR against the ground truth of its view, and any
flag set below its default ("reduced").

    python -m danerf_tpu_torch.examples.full_scale [--device cuda] [--seed S]
        [--init-npz danerf_tpu_torch/examples/jax_init_seed0.npz] [--no-pallas]
    python -m danerf_tpu_torch.examples.measure_io_overlap      (then)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import device_block, launches, launches_since, sync
from danerf_tpu_torch.utils.convert import read_params_npz

DEFAULTS = {"iters": 30000, "size": 800, "train_views": 100, "val_views": 16, "frames": 120}
OUT = os.path.join("build", "full_scale_out")
REPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "full_scale_report_h100.json")
# the JAX run's initial parameters (create_train_state(jax.random.key(0), ...),
# 100 train views), written by tests/data_torch/write_jax_init.py
JAX_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_init_seed0.npz")
CHECKPOINT_EVERY = 1000
EFFECTS = ("Fog", "Toon Shader")


def _curve(history, every: int) -> dict:
    """Mean loss and train PSNR over each ``every`` steps of the run, and
    the logger's clock at each window's last row (seconds since the loop
    began; a row is written a graph replay behind the device)."""
    ends, loss, psnr, wall = [], [], [], []
    for end in range(every, len(history) + every, every):
        rows = [r for r in history if end - every < r["step"] <= end]
        if rows:
            ends.append(rows[-1]["step"])
            loss.append(float(np.mean([r["loss"] for r in rows])))
            psnr.append(float(np.mean([r["psnr"] for r in rows])))
            wall.append(rows[-1]["t"])
    return {"window": every, "step_end": ends, "loss_mean": loss, "psnr_mean": psnr,
            "wall_s_end": wall}


def _checkpoint_steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"checkpoint_(\d+)\.pt", n) for n in os.listdir(ckpt_dir)) if m)


def _rates(cfg, ckpt_dir: str) -> dict:
    """The rate of the next step that Adam holds in each checkpoint, beside
    StepLR's formula at Adam's count of steps taken: a boundary crossed
    inside a graph replay shows here."""
    from danerf_tpu_torch.train.trainer import lr_schedule

    formula = lr_schedule(cfg)
    rows = []
    for step in _checkpoint_steps(ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, f"checkpoint_{step:06d}.pt"),
                          map_location="cpu", weights_only=False)
        opt = ckpt["optimizer_state_dict"]
        count = int(opt["state"][0]["step"])
        rows.append([step, count, float(opt["param_groups"][0]["lr"]), formula(count)])
    return {"columns": ["checkpoint", "adam_count", "lr", "steplr_formula"], "rows": rows,
            # the card holds the rate as an f32 tensor
            "all_match": all(abs(r[2] - r[3]) <= 1e-6 * r[3] for r in rows)}


def _validation_psnr(scene, ckpt_dir: str, dev) -> list:
    """[step, PSNR] of each checkpoint's validation render (the rgb half of
    ``render_NNNNNN.png``, the last train view) against that view's ground
    truth rendered at the render's size."""
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.data.synthetic import render_view

    out, gt = [], None
    for step in _checkpoint_steps(ckpt_dir):
        path = os.path.join(ckpt_dir, f"render_{step:06d}.png")
        if not os.path.exists(path):
            continue
        strip = read_png(path)
        h, w = strip.shape[0], strip.shape[1] // 2
        if gt is None:
            gt, _ = render_view(np.asarray(scene.c2ws[-1], np.float64), h, w,
                                scene.focal / (scene.height // h), scene.near, scene.far,
                                backend="torch", device=dev)
        mse = np.mean((strip[:, :w].astype(np.float64) - gt) ** 2) / 255.0 ** 2
        out.append([step, float(-10.0 * np.log10(max(mse, 1e-12)))])
    return out


def init_block(cfg, scene, seed: int, init: Optional[dict], init_npz: Optional[str]) -> dict:
    """What a run starts from: its seed, the init's source, the sha256 of
    the init's parameters (the module's state dict in order, then the
    appearance table; f32 bytes) and ``density_alive_probe``'s max sigma
    on ``scene`` over its 1024 rays, or as many as a small scene's first
    two views hold (0.0: zero density at every probe point, read as born
    dead; a kernel's rounding can still revive such a head).  Drawn on
    the CPU, as ``train`` draws it."""
    import hashlib

    from danerf_tpu_torch.benchmarks.reference_init import density_alive_probe
    from danerf_tpu_torch.train.trainer import init_model, load_jax_params

    pixels = scene.height * scene.width
    model, table = init_model(cfg, scene.n_images, seed, "cpu")
    if init is not None:
        load_jax_params(model, table, init)
    digest = hashlib.sha256()
    for t in [*model.state_dict().values(), *([] if table is None else [table])]:
        digest.update(t.detach().float().contiguous().numpy().tobytes())
    return {"seed": seed,
            "from": "init_model" if init_npz is None else os.path.basename(init_npz),
            "sha256": digest.hexdigest(),
            "density_alive": density_alive_probe(model, cfg, scene.images.shape, scene.c2ws,
                                                 scene.focal, n_probe=min(1024, 2 * pixels))}


def run(cfg, out: str = OUT, report_path: str = REPORT, iters: int = DEFAULTS["iters"],
        size: int = DEFAULTS["size"], train_views: int = DEFAULTS["train_views"],
        val_views: int = DEFAULTS["val_views"], frames: int = DEFAULTS["frames"],
        checkpoint_every: int = CHECKPOINT_EVERY, device="cuda", seed: int = 0,
        init_npz: Optional[str] = None, scenes=None) -> dict:
    """The study at ``cfg`` (the default 64 + 64 ``NeRFConfig`` from
    ``main``); writes its outputs under ``out`` and its report to
    ``report_path``, and returns the report.

    ``seed`` seeds ``train``'s init and batch stream (0: the JAX script's
    ``jax.random.key(0)`` counterpart).  ``init_npz``, a JAX param tree
    saved by ``tests/data_torch/write_jax_init.py``, is the start in place
    of the init's draw; the batches still come from ``seed``.  ``scenes``,
    a (train, val) pair of scenes at this size, is used as it is (several
    runs on one scene, ``full_scale_arms``): the numpy check view is then
    not rendered."""
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene, render_view
    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.render.frames import render_aligned_spiral
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.train.trainer import train

    dev = resolve_device(device)
    card = device_block(dev)
    os.makedirs(out, exist_ok=True)
    print(f"device: {card}  config: {cfg.num_samples}+{cfg.num_importance}, batch "
          f"{cfg.batch_size}, kernels={cfg.use_kernels}", flush=True)
    # the 64 + 64 path's kernels (K2, K5, K3, K4), built before anything is
    # timed: a first use would build them inside the training time
    t0 = time.time()
    if dev.type == "cuda" and cfg.use_kernels:
        from danerf_tpu_torch.kernels import _build

        f32 = "" if cfg.use_bf16 else "_f32"
        _build.build([n + f32 for n in ("march", "merged", "march_bwd", "merged_train")])
    build_s = time.time() - t0

    if scenes is None:
        t0 = time.time()
        scene = make_synthetic_scene("train", n_images=train_views, height=size, width=size,
                                     backend="torch", device=dev)
        val = make_synthetic_scene("val", n_images=val_views, height=size, width=size,
                                   backend="torch", device=dev)
        gen_s = time.time() - t0
        t0 = time.time()
        image, alpha = render_view(np.asarray(val.c2ws[0], np.float64), size, size, val.focal,
                                   val.near, val.far)
        numpy_s = time.time() - t0
        apart = {}
        for name, ref, got in (("image", image, val.images[0]),
                               ("alpha", alpha, val.alphas[0])):
            d = np.abs(ref.astype(np.int16) - got.astype(np.int16))
            apart[name] = {"max_levels": int(d.max()), "pixels_apart": int((d > 0).sum()),
                           "values": int(d.size)}
    else:
        scene, val = scenes
        gen_s = numpy_s = apart = None
    pool_mb = scene.images.size * 4 / 1e6   # the f32 pool once uploaded
    print(f"scene: {train_views}+{val_views} views at {size}x{size} "
          f"{'shared' if scenes else f'in {gen_s:.1f}s'} on {dev} (pool {pool_mb:.0f} MB); "
          f"numpy check view: {apart}", flush=True)
    init = None if init_npz is None else read_params_npz(init_npz)
    start = init_block(cfg, scene, seed, init, init_npz)
    print(f"init: {start}", flush=True)

    ckpt_dir = os.path.join(out, "checkpoints")
    log_path = os.path.join(out, "metrics.jsonl")
    shutil.rmtree(ckpt_dir, ignore_errors=True)    # a study measures afresh; the log appends
    if os.path.exists(log_path):
        os.remove(log_path)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launches()
    t0 = time.time()
    model, table, logger = train(cfg, scene, save_dir=ckpt_dir, num_iterations=iters,
                                 checkpoint_every=checkpoint_every, log_path=log_path,
                                 device=dev, seed=seed, init_params=init)
    sync(dev)
    train_s = time.time() - t0
    train_launches = launches_since(before)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6 if dev.type == "cuda" else None
    rays_s = iters * cfg.batch_size / train_s
    print(f"train: {iters} iters in {train_s:.1f}s ({rays_s:,.0f} rays/s incl. "
          f"checkpointing)", flush=True)

    emb = None
    if cfg.use_appearance and table is not None:
        emb = table.detach().mean(0, keepdim=True)
    before = launches()
    t0 = time.time()
    res = evaluate(model, cfg, val, appearance=emb, n_importance=cfg.num_importance,
                   device=dev)
    eval_s = time.time() - t0
    eval_launches = launches_since(before)
    print(f"eval: PSNR {res['psnr']:.2f} dB SSIM {res['ssim']:.4f} over {val_views} views "
          f"at {size}x{size} ({eval_s / val_views:.2f} s/view)", flush=True)

    frames_dir = os.path.join(out, "spiral")
    before = launches()
    t0 = time.time()
    render_aligned_spiral(model, cfg, frames_dir,
                          appearance_embedding=emb[0] if emb is not None else None,
                          num_frames=frames, rotation_axis="none", height=size, width=size,
                          focal=scene.focal, make_video=True, device=dev)
    spiral_s = time.time() - t0
    spiral_launches = launches_since(before)
    print(f"spiral: {frames} frames at {size}x{size} in {spiral_s:.1f}s "
          f"({spiral_s / frames * 1e3:.0f} ms/frame)", flush=True)

    fx_seconds, fx_breakdown = {}, {}
    for effect in EFFECTS:
        tm: dict = {}
        t0 = time.time()
        # skip_existing=False: a study measures even over a reused --out
        apply_effect_to_frames(frames_dir, os.path.join(out, effect.lower().replace(" ", "_")),
                               effect, make_video=True, skip_existing=False, timings=tm,
                               device=dev)
        fx_seconds[effect] = time.time() - t0
        n = max(tm.get("frames", 0), 1)
        fx_breakdown[effect] = {
            "frames": tm.get("frames", 0),
            "png_load_ms_per_frame": tm.get("load_s", 0) / n * 1e3,
            "device_ms_per_frame": tm.get("device_s", 0) / n * 1e3,
            "fetch_encode_ms_per_frame_overlapped": tm.get("write_s", 0) / n * 1e3,
        }
    print(f"effects: {fx_seconds}  breakdown: {fx_breakdown}", flush=True)

    settings = {"iters": iters, "size": size, "train_views": train_views,
                "val_views": val_views, "frames": frames}
    last = logger.history[-1] if logger.history else {}
    report = {
        "study": f"reference-native workload end to end ({size}x{size}, {train_views} views, "
                 f"{iters} iters, hier {cfg.num_samples}+{cfg.num_importance})",
        "reference_workload": "reference config.py:23 + data/nerf_synthetic/README.txt:5-9",
        "data": {"kind": "procedural, rendered on the device (make_synthetic_scene "
                         "backend='torch', float32)",
                 "resolution": [size, size], "train_views": train_views,
                 "val_views": val_views, "pool_mb_f32": pool_mb,
                 "generation_seconds": gen_s,
                 "seconds_per_view": None if gen_s is None else gen_s / (train_views + val_views),
                 "numpy_one_view_seconds": numpy_s, "device_vs_numpy_val_view_0": apart},
        "seed": seed,
        "init": start,
        "config": {"samples": [cfg.num_samples, cfg.num_importance],
                   "batch_size": cfg.batch_size, "bf16": cfg.use_bf16,
                   "pallas": cfg.use_kernels, "checkpoint_every": checkpoint_every,
                   "kernel_build_seconds": build_s},
        "train": {"iters": iters, "seconds": train_s, "rays_per_sec_incl_ckpt": rays_s,
                  "final_train_psnr": last.get("psnr"), "final_loss": last.get("loss"),
                  "peak_device_memory_mb": peak_mb, "launches": train_launches,
                  "curve": _curve(logger.history, checkpoint_every),
                  "lr_at_checkpoints": _rates(cfg, ckpt_dir),
                  "validation_render_psnr": _validation_psnr(scene, ckpt_dir, dev)},
        "eval": {"val_psnr": res["psnr"], "val_ssim": res["ssim"],
                 "seconds_per_view": eval_s / val_views,
                 "per_view_psnr": [v["psnr"] for v in res["per_view"]],
                 "per_view_ssim": [v["ssim"] for v in res["per_view"]],
                 "launches": eval_launches},
        "spiral": {"frames": frames, "ms_per_frame": spiral_s / frames * 1e3,
                   "video": os.path.join(frames_dir, f"{cfg.scene}_spiral.mp4"),
                   "launches": spiral_launches},
        "effects_seconds": fx_seconds,
        "effects_breakdown": fx_breakdown,
        "oom": False,
        "backend": str(dev),
        "device": card,
        "reduced": [f"--{k.replace('_', '-')} {v} (default {DEFAULTS[k]})"
                    for k, v in settings.items() if v != DEFAULTS[k]],
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=DEFAULTS["iters"])
    ap.add_argument("--size", type=int, default=DEFAULTS["size"])
    ap.add_argument("--train-views", type=int, default=DEFAULTS["train_views"])
    ap.add_argument("--val-views", type=int, default=DEFAULTS["val_views"])
    ap.add_argument("--frames", type=int, default=DEFAULTS["frames"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--no-pallas", action="store_true",
                    help="the plain PyTorch route (use_kernels=False)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init's and the batch stream's seed (train's)")
    ap.add_argument("--init-npz", default=None,
                    help="start from this JAX param tree (tests/data_torch/write_jax_init.py "
                         "writes the JAX run's, jax_init_seed0.npz here) in place of the "
                         "init's draw")
    return ap


def main(argv=None) -> dict:
    from danerf_tpu_torch.config import NeRFConfig

    args = build_parser().parse_args(argv)
    cfg = NeRFConfig(use_bf16=True, use_kernels=not args.no_pallas)
    if (cfg.num_samples, cfg.num_importance) != (64, 64):
        raise ValueError("the full-scale study runs the default 64 + 64 configuration")
    return run(cfg, args.out, args.report, args.iters, args.size, args.train_views,
               args.val_views, args.frames, device=args.device, seed=args.seed,
               init_npz=args.init_npz)


if __name__ == "__main__":
    main()
