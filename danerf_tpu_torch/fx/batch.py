"""Batch effects driver (counterpart of danerf_tpu/fx/batch.py): apply
effects across a directory of rendered frames.

Frames and depth maps pair by name, ``frame_NNNN.png`` with the grayscale
``depth_NNNN.png`` that the aligned spiral writes every 10th frame; each
effect gets its own output directory and a video beside it, both skipped
where they exist; Fog runs only on the frames that have a depth map.  PNGs
are read with the port's decoder (``data/png.py``), which refuses palette
and 16-bit images.
"""

from __future__ import annotations

import os
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.data.png import read_png
from danerf_tpu_torch.fx.effects import EFFECTS, apply_effect
from danerf_tpu_torch.utils.hostio import fetch_async
from danerf_tpu_torch.viz.png import write_png
from danerf_tpu_torch.viz.video import create_video_from_images, load_rgb


def find_frames_with_depth(input_dir: str):
    """Frame numbers that have a matching depth map."""
    nums = []
    for f in os.listdir(input_dir):
        m = re.fullmatch(r"depth_(\d+)\.png", f)
        if m:
            nums.append(m.group(1))
    return sorted(nums)


def load_depth(path: str) -> np.ndarray:
    """A grayscale depth PNG as float32 (H, W) in [0, 1]."""
    d = read_png(path).astype(np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    return d / 255.0


def apply_effect_to_frames(input_dir: str, output_dir: str, effect: str,
                           params: Optional[dict] = None,
                           make_video: bool = True, fps: int = 60,
                           skip_existing: bool = True,
                           timings: Optional[dict] = None,
                           device="cuda") -> list[str]:
    """Apply one effect to every frame in ``input_dir``; returns the output
    paths in frame order.

    Pipelined: frame k's result is copied to the host and encoded on one of
    two worker threads while frame k + 1 loads and computes (at most 3
    frames in flight).  ``timings``, if given, is filled with
    {'load_s', 'device_s', 'write_s', 'frames'}: load and device are the
    main thread's serial time (device closed by a synchronize on CUDA),
    write the workers' time, overlapped with the rest.
    """
    if effect not in EFFECTS:
        raise KeyError(f"unknown effect {effect!r}")
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)

    frames = sorted(f for f in os.listdir(input_dir) if re.fullmatch(r"frame_\d+\.png", f))
    depth_nums = set(find_frames_with_depth(input_dir))
    if effect == "Fog":  # fog needs depth
        frames = [f for f in frames
                  if re.fullmatch(r"frame_(\d+)\.png", f).group(1) in depth_nums]

    t_load = t_device = 0.0
    t_write = [0.0]
    n_done = 0
    lock = threading.Lock()

    def _save(fetch, out_path):
        t0 = time.perf_counter()
        write_png(out_path, fetch())
        with lock:
            t_write[0] += time.perf_counter() - t0
        return out_path

    futures = []
    results = []  # str (skipped) or future, in frame order
    with ThreadPoolExecutor(max_workers=2) as io_pool:
        for f in frames:
            out_path = os.path.join(output_dir, f)
            if skip_existing and os.path.exists(out_path):
                results.append(out_path)
                continue
            t0 = time.perf_counter()
            rgb = load_rgb(os.path.join(input_dir, f))
            num = re.fullmatch(r"frame_(\d+)\.png", f).group(1)
            depth = None
            if num in depth_nums:
                depth = load_depth(os.path.join(input_dir, f"depth_{num}.png"))
            t1 = time.perf_counter()
            out = apply_effect(effect, rgb, depth, params, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            t_load += t1 - t0
            t_device += t2 - t1
            n_done += 1
            fut = io_pool.submit(_save, fetch_async(out), out_path)
            futures.append(fut)
            results.append(fut)
            if len(futures) >= 3:
                futures[-3].result()  # bound the frames in flight
        written = [r if isinstance(r, str) else r.result() for r in results]

    if timings is not None:
        timings.update(load_s=t_load, device_s=t_device, write_s=t_write[0], frames=n_done)

    if make_video and written:
        video = os.path.join(os.path.dirname(output_dir.rstrip("/")) or ".",
                             f"{effect.lower().replace(' ', '_')}.avi")
        if not (skip_existing and os.path.exists(video)):
            create_video_from_images(output_dir, video, pattern="frame_*.png", fps=fps)
    return written


def apply_all_effects(input_dir: str, output_base_dir: str,
                      effects: Optional[Iterable[str]] = None,
                      fog_only: bool = False, skip: Iterable[str] = (),
                      fps: int = 60, device="cuda"):
    """Apply every effect, one output directory and video per effect;
    returns the effect names run."""
    names = list(effects) if effects is not None else list(EFFECTS)
    if fog_only:
        names = ["Fog"]
    names = [n for n in names if n not in set(skip)]
    os.makedirs(output_base_dir, exist_ok=True)
    for name in names:
        out_dir = os.path.join(output_base_dir, name.lower().replace(" ", "_"))
        apply_effect_to_frames(input_dir, out_dir, name, fps=fps, device=device)
    return names
