"""Re-measure the host-I/O-overlap surfaces of a full-scale study from its
outputs, without training again (counterpart of
examples/measure_io_overlap.py):

  - eval s/view over the val views through the pipelined scoring path,
  - Fog and Toon Shader's per-stage costs (PNG load / device / fetch and
    encode) over the study's spiral frames, into cleared directories,
  - steady_state: a second pass in the same process, since the first pays
    the kernel builds and graph captures: evaluate() again over up to 8 val
    views, each of five effects over 20 frames already on the device, and
    the spiral's video encode alone.

Reads the study's final checkpoint with the port's own reader
(``utils/checkpoint.load_model``) and its size and view count from the
report, and adds the block to the report as "io_overlap_remeasure".

    python -m danerf_tpu_torch.examples.measure_io_overlap [OUT [REPORT]] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time

import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import device_block, sync
from danerf_tpu_torch.examples.full_scale import EFFECTS, OUT, REPORT

STEADY_EFFECTS = ("Fog", "Toon Shader", "Sepia", "Neon Glow", "Hologram")
STEADY_VIEWS = 8
STEADY_FRAMES = 20


def _device_frames(frames_dir: str, n: int, dev) -> list:
    """``n`` (frame, depth) pairs on ``dev`` from the spiral frames that have
    a depth map, taken in turn."""
    from danerf_tpu_torch.data.custom import read_rgb
    from danerf_tpu_torch.fx.batch import find_frames_with_depth, load_depth

    nums = find_frames_with_depth(frames_dir)
    pairs = [(torch.from_numpy(read_rgb(os.path.join(frames_dir, f"frame_{k}.png"))).to(dev),
              torch.from_numpy(load_depth(os.path.join(frames_dir, f"depth_{k}.png"))).to(dev))
             for k in nums[:n]]
    return [pairs[i % len(pairs)] for i in range(n)]


def _effect_ms(effect: str, frames: list, dev) -> float:
    """ms a frame of ``effect`` over ``frames``, after one warm frame,
    closed by a synchronize."""
    from danerf_tpu_torch.fx.effects import apply_effect

    apply_effect(effect, *frames[0], device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for rgb, depth in frames:
        apply_effect(effect, rgb, depth, device=dev)
    sync(dev)
    return (time.perf_counter() - t0) / len(frames) * 1e3


def run(out_dir: str = OUT, report_path: str = REPORT, cfg=None, device="cuda") -> dict:
    """Add ``io_overlap_remeasure`` to the report at ``report_path`` of the
    study whose outputs are under ``out_dir``; ``cfg`` gives the model's
    architecture (default: ``NeRFConfig`` as ``full_scale.main`` makes
    it).  Returns the block."""
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.utils.checkpoint import load_model
    from danerf_tpu_torch.viz.video import create_video_from_images

    dev = resolve_device(device)
    with open(report_path) as f:
        report = json.load(f)
    size, n_val = report["data"]["resolution"][0], report["data"]["val_views"]
    if cfg is None:
        cfg = NeRFConfig(use_bf16=True, use_kernels=report["config"]["pallas"])

    val = make_synthetic_scene("val", n_images=n_val, height=size, width=size,
                               backend="torch", device=dev)
    model, table, _, cfg = load_model(os.path.join(out_dir, "checkpoints",
                                                   "checkpoint_final.pt"), cfg, dev)
    emb = None
    if cfg.use_appearance and table is not None:
        emb = table.mean(0, keepdim=True)

    t0 = time.time()
    res = evaluate(model, cfg, val, appearance=emb, n_importance=cfg.num_importance,
                   device=dev)
    eval_s = time.time() - t0
    print(f"eval: {eval_s / n_val:.2f} s/view (PSNR {res['psnr']:.2f}, SSIM "
          f"{res['ssim']:.4f})", flush=True)

    frames_dir = os.path.join(out_dir, "spiral")
    fx = {}
    for effect in EFFECTS:
        fx_dir = os.path.join(out_dir, "remeasure_" + effect.lower().replace(" ", "_"))
        shutil.rmtree(fx_dir, ignore_errors=True)
        tm: dict = {}
        t0 = time.time()
        apply_effect_to_frames(frames_dir, fx_dir, effect, make_video=False,
                               skip_existing=False, timings=tm, device=dev)
        wall = time.time() - t0
        n = max(tm.get("frames", 0), 1)
        fx[effect] = {
            "frames": tm.get("frames", 0),
            "wall_ms_per_frame": wall / n * 1e3,
            "png_load_ms_per_frame": tm.get("load_s", 0) / n * 1e3,
            "device_ms_per_frame": tm.get("device_s", 0) / n * 1e3,
            "fetch_encode_ms_per_frame_overlapped": tm.get("write_s", 0) / n * 1e3,
        }
        print(f"{effect}: {fx[effect]}", flush=True)

    steady_views = min(STEADY_VIEWS, n_val)
    t0 = time.time()
    evaluate(model, cfg, val, appearance=emb, n_importance=cfg.num_importance,
             max_views=steady_views, device=dev)
    eval_steady = (time.time() - t0) / steady_views
    frames = _device_frames(frames_dir, STEADY_FRAMES, dev)
    effects_steady = {e: _effect_ms(e, frames, dev) for e in STEADY_EFFECTS}
    n_frames = len([f for f in os.listdir(frames_dir) if re.fullmatch(r"frame_\d+\.png", f)])
    scratch = os.path.join(out_dir, "remeasure_spiral.mp4")
    t0 = time.time()
    create_video_from_images(frames_dir, scratch, pattern="frame_*.png", fps=60)
    encode_ms = (time.time() - t0) / n_frames * 1e3
    os.remove(scratch)

    block = {
        "eval_seconds_per_view": eval_s / n_val,
        "eval_psnr_check": res["psnr"],
        "effects": fx,
        "note": "pipelined loops: device time is the main thread's serial time closed by a "
                "synchronize; fetch and PNG encode run on worker threads overlapped with "
                "the next frame's load and compute",
        "steady_state": {
            "eval_seconds_per_view_steady": eval_steady,
            "eval_seconds_per_view_first_call_with_compiles": eval_s / n_val,
            "effects_device_ms_per_frame_steady": effects_steady,
            "spiral_video_encode_ms_per_frame": encode_ms,
            "method": f"a second evaluate() in the same process over {steady_views} val views "
                      f"at {size}x{size}; each effect over {STEADY_FRAMES} frames already on "
                      "the device (the spiral frames with a depth map, in turn) after one warm "
                      "frame, closed by a synchronize; the spiral's "
                      f"{n_frames} PNGs encoded again to an mp4 on the host",
            "note": "the first pass pays the kernel builds, the first launches and the "
                    "evaluation's set-up; the steady numbers are the production loop's costs",
        },
        "device": device_block(dev),
    }
    report["io_overlap_remeasure"] = block
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(block, indent=2), flush=True)
    return block


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=OUT)
    ap.add_argument("report", nargs="?", default=REPORT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.out, args.report, device=args.device)


if __name__ == "__main__":
    main()
