"""Novel-view frame rendering along a camera path (counterpart of
danerf_tpu/render/frames.py ``render_path``): quality presets, rgb/depth PNG
output named ``rgb_NNN.png`` / ``depth_NNN.png`` (viridis), and with
``save_depth`` the raw depth as ``raw/depth_NNN.npy``.

Random draws come from a ``torch.Generator`` seeded from ``seed`` and the
frame index, so a frame renders the same whatever frames precede it.  A
time-conditioned model (``cfg.use_time``) renders every frame at ``time``
(default 0), or with ``animate_time`` frame i of n at t = i / (n - 1).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import RENDER_PRESETS, NeRFConfig
from danerf_tpu_torch.render.renderer import render_frame
from danerf_tpu_torch.viz.depth import colorize_depth
from danerf_tpu_torch.viz.paths import camera_path
from danerf_tpu_torch.viz.png import write_png

# Frame i's draws come from seed * FRAME_SEED_STRIDE + i.
FRAME_SEED_STRIDE = 1_000_003


def render_path(model, cfg: NeRFConfig, output_dir: str,
                appearance_embedding=None, num_frames: int = 120,
                quality: str = "high", width: int = 800, height: int = 800,
                start_frame: int = 0, end_frame: Optional[int] = None,
                camera_path_kind: str = "circle", spiral_loops: float = 2.0,
                height_range=(-0.5, 0.5), save_depth: bool = False,
                raw_output: bool = False, dataset_width: Optional[int] = None,
                focal: Optional[float] = None, seed: int = 0,
                frame_name: str = "rgb_{:03d}.png", chunk: Optional[int] = None,
                time: Optional[float] = None, animate_time: bool = False,
                device="cuda") -> list[str]:
    """Render frames along a parametric path; returns the rgb paths written.

    focal: the dataset's focal at ``dataset_width``, rescaled to ``width``.
    time / animate_time: the frame time of a ``use_time`` model, fixed or
    swept from 0 to 1 over the path's frames.
    """
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    preset = RENDER_PRESETS[quality]
    n_samples = max(int(cfg.num_samples * preset["samples_scale"]), 1)
    n_importance = cfg.num_importance if preset["importance"] else 0
    perturb = preset["perturb"]
    if chunk is None:
        chunk = preset["chunk"]

    if focal is None:
        focal = 0.5 * width / np.tan(0.5 * 0.6911)
    elif dataset_width is not None:
        focal = focal * (width / dataset_width)

    c2ws = camera_path(camera_path_kind, num_frames, cfg.scene, spiral_loops, height_range)
    if end_frame is None:
        end_frame = num_frames
    raw_dir = os.path.join(output_dir, "raw")
    if raw_output or save_depth:
        os.makedirs(raw_dir, exist_ok=True)

    written = []
    for i, c2w in enumerate(c2ws):
        frame_idx = start_frame + i
        if frame_idx >= end_frame:
            continue
        gen = torch.Generator(device=dev).manual_seed(seed * FRAME_SEED_STRIDE + i)
        t_frame = i / max(num_frames - 1, 1) if animate_time else time
        rgb, depth, _ = render_frame(
            model, cfg, c2w, height, width, focal,
            appearance_embedding=appearance_embedding, n_samples=n_samples,
            n_importance=n_importance, perturb=perturb, chunk=chunk, t=t_frame,
            generator=gen, device=dev)
        rgb_u8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        depth_np = depth.cpu().numpy()
        if raw_output:
            write_png(os.path.join(raw_dir, f"rgb_{frame_idx:03d}.png"), rgb_u8)
        if save_depth:
            np.save(os.path.join(raw_dir, f"depth_{frame_idx:03d}.npy"), depth_np)
        out_path = os.path.join(output_dir, frame_name.format(frame_idx))
        write_png(out_path, rgb_u8)
        write_png(os.path.join(output_dir, f"depth_{frame_idx:03d}.png"),
                  colorize_depth(depth_np))
        written.append(out_path)
    return written
