"""Novel-view frame rendering drivers (counterpart of
danerf_tpu/render/frames.py): ``render_path`` along a parametric camera path
(quality presets, ``rgb_NNN.png`` / viridis ``depth_NNN.png``, with
``save_depth`` the raw depth as ``raw/depth_NNN.npy``, an optional
depth-aware effect, a video) and ``render_aligned_spiral`` (``frame_NNNN.png``,
a grayscale ``depth_NNNN.png`` every 10th frame, a video).

The effect runs on the device while the depth buffer is still there: the
colour is quantised and the depth normalised as (d - min) / (max - min +
1e-6) on the device, and the effect's noise comes from a generator of the
frame's own.

Both take a ``mesh`` (``parallel/mesh.py``): each frame's rays shard over
its data axis and rank 0 writes the frame; with several ranks and no mesh,
each rank renders and writes its ``process_slice`` of the frames.

Both drivers double-buffer the host I/O against the device: frame k + 1 is
dispatched before frame k is fetched and encoded, the fetch (an event-waited
copy, ``utils/hostio.py``) and the PNG encodes run on two worker threads,
and at most 3 frames are in flight.

Random draws come from ``torch.Generator``s: frame i's sampling draws from
seed * FRAME_SEED_STRIDE + i, its effect's noise from seed *
FRAME_SEED_STRIDE + 10_000 + i (the counterpart of the JAX package's
``fold_in(key, i)`` and ``fold_in(key, 10_000 + i)``; another stream, so a
jittered frame or a noise effect differs from the JAX one by its draws).
A time-conditioned model (``cfg.use_time``) renders every frame at ``time``
(default 0), or with ``animate_time`` frame i of n at t = i / (n - 1).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import RENDER_PRESETS, NeRFConfig
from danerf_tpu_torch.fx.effects import apply_effect
from danerf_tpu_torch.render.renderer import render_frame
from danerf_tpu_torch.utils.hostio import fetch_async
from danerf_tpu_torch.viz.depth import colorize_depth, depth_to_gray_u8
from danerf_tpu_torch.viz.paths import aligned_spiral_path, camera_path
from danerf_tpu_torch.viz.png import write_png
from danerf_tpu_torch.viz.video import create_video_from_images

# Frame i's draws come from seed * FRAME_SEED_STRIDE + i.
FRAME_SEED_STRIDE = 1_000_003
# Frame i's effect noise comes from seed * FRAME_SEED_STRIDE + EFFECT_SEED_OFFSET + i.
EFFECT_SEED_OFFSET = 10_000
# Frames dispatched to the device and not yet written.
IN_FLIGHT = 3


def _quantize(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb * 255.0).clamp(0, 255).to(torch.uint8)


class _Pipeline:
    """Two I/O workers writing each frame's files as tasks of their own (so
    both work on a frame's rgb and depth PNGs at once), and the bound on
    frames dispatched and not yet written."""

    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=2)
        self.frames = []   # a frame's futures, the first one giving its path

    def submit(self, *tasks):
        """Queue one frame's tasks, each (fn, *args)."""
        self.frames.append([self.pool.submit(*task) for task in tasks])
        if len(self.frames) >= IN_FLIGHT:
            for fut in self.frames[-IN_FLIGHT]:
                fut.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True)

    def results(self) -> list:
        """Each frame's path, once all its files are written."""
        return [[fut.result() for fut in futs][0] for futs in self.frames]


def _frames_of_rank(num_frames: int, mesh):
    """(the frame indices this rank renders, whether it writes them): every
    frame, and rank 0 writes, under a mesh; with several ranks and no mesh,
    its ``process_slice``, which it writes; alone, every frame."""
    from danerf_tpu_torch.parallel.mesh import process_slice

    ids = list(range(num_frames))
    if mesh is not None:
        return ids, mesh.rank == 0
    return ids[process_slice(num_frames)], True


def _video_writer(mesh) -> bool:
    """True on the rank that encodes the video: rank 0, once every rank's
    frames are on disk (a barrier when there are several ranks)."""
    from danerf_tpu_torch.parallel.mesh import _rank_world

    rank, world = _rank_world()
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
    return rank == 0


def render_path(model, cfg: NeRFConfig, output_dir: str,
                appearance_embedding=None, num_frames: int = 120,
                quality: str = "high", width: int = 800, height: int = 800,
                start_frame: int = 0, end_frame: Optional[int] = None,
                camera_path_kind: str = "circle", spiral_loops: float = 2.0,
                height_range=(-0.5, 0.5), effect: Optional[str] = None,
                effect_params: Optional[dict] = None, save_depth: bool = False,
                raw_output: bool = False, make_video: bool = False, fps: int = 30,
                dataset_width: Optional[int] = None, focal: Optional[float] = None,
                seed: int = 0, frame_name: str = "rgb_{:03d}.png",
                chunk: Optional[int] = None, time: Optional[float] = None,
                animate_time: bool = False, device="cuda", mesh=None) -> list[str]:
    """Render frames along a parametric path; returns the rgb paths written.

    focal: the dataset's focal at ``dataset_width``, rescaled to ``width``.
    effect: a depth-aware effect applied to each frame on the device (not
    with ``raw_output``, as in the JAX package).  make_video: encode the
    frames as ``{scene}_render.avi`` at ``fps``.  time / animate_time: the
    frame time of a ``use_time`` model, fixed or swept from 0 to 1 over the
    path's frames.  mesh: each frame's rays shard over its data axis
    (``render_frame``) and rank 0 writes; with several ranks and no mesh
    each renders and writes its ``process_slice`` of the frames, and rank 0
    encodes the video once all are written.
    """
    dev = resolve_device(device)
    frame_ids, writes = _frames_of_rank(num_frames, mesh)
    if writes:
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
    if writes and (raw_output or save_depth):
        os.makedirs(raw_dir, exist_ok=True)

    def write_rgb(frame_idx, fetch):
        """Worker side: wait for the frame's copy and encode its PNGs, while
        the next frame computes on the device."""
        rgb_u8 = fetch()
        if raw_output:
            write_png(os.path.join(raw_dir, f"rgb_{frame_idx:03d}.png"), rgb_u8)
        out_path = os.path.join(output_dir, frame_name.format(frame_idx))
        write_png(out_path, rgb_u8)
        return out_path

    def write_depth(frame_idx, fetch):
        depth_np = fetch()
        if save_depth:
            np.save(os.path.join(raw_dir, f"depth_{frame_idx:03d}.npy"), depth_np)
        write_png(os.path.join(output_dir, f"depth_{frame_idx:03d}.png"),
                  colorize_depth(depth_np))

    with _Pipeline() as pipe:
        for i in frame_ids:
            c2w = c2ws[i]
            frame_idx = start_frame + i
            if frame_idx >= end_frame:
                continue
            gen = torch.Generator(device=dev).manual_seed(seed * FRAME_SEED_STRIDE + i)
            t_frame = i / max(num_frames - 1, 1) if animate_time else time
            rgb, depth, _ = render_frame(
                model, cfg, c2w, height, width, focal,
                appearance_embedding=appearance_embedding, n_samples=n_samples,
                n_importance=n_importance, perturb=perturb, chunk=chunk, t=t_frame,
                generator=gen, device=dev, mesh=mesh)
            if not writes:
                continue
            rgb_u8 = _quantize(rgb)
            if effect is not None and not raw_output:
                depth_norm = (depth - depth.min()) / (depth.max() - depth.min() + 1e-6)
                fx_gen = torch.Generator(device=dev).manual_seed(
                    seed * FRAME_SEED_STRIDE + EFFECT_SEED_OFFSET + i)
                rgb_u8 = apply_effect(effect, rgb_u8, depth_norm, effect_params,
                                      generator=fx_gen)
            pipe.submit((write_rgb, frame_idx, fetch_async(rgb_u8)),
                        (write_depth, frame_idx, fetch_async(depth)))
        written = pipe.results()

    if make_video and _video_writer(mesh) and written:
        create_video_from_images(output_dir, os.path.join(output_dir, f"{cfg.scene}_render.avi"),
                                 pattern=frame_name.replace("{:03d}", "*"), fps=fps)
    return written


def render_aligned_spiral(model, cfg: NeRFConfig, output_dir: str,
                          appearance_embedding=None, num_frames: int = 120,
                          fps: int = 60, loops: float = 2.0, rotation_axis: str = "x",
                          height: int = 800, width: int = 800,
                          focal: Optional[float] = None, make_video: bool = True,
                          seed: int = 0, device="cuda", mesh=None) -> list[str]:
    """Aligned spiral render: ``frame_NNNN.png``, a grayscale
    ``depth_NNNN.png`` every 10th frame, the config's samples without
    jitter, and ``{scene}_spiral.avi`` at ``fps``; returns the frame paths.
    ``mesh`` and several ranks as in ``render_path``."""
    dev = resolve_device(device)
    frame_ids, writes = _frames_of_rank(num_frames, mesh)
    if writes:
        os.makedirs(output_dir, exist_ok=True)
    if focal is None:
        focal = 0.5 * width / np.tan(0.5 * 0.6911)
    c2ws = aligned_spiral_path(num_frames, loops, rotation_axis, cfg.scene)

    def write_rgb(i, fetch):
        path = os.path.join(output_dir, f"frame_{i:04d}.png")
        write_png(path, fetch())
        return path

    def write_depth(i, fetch):
        write_png(os.path.join(output_dir, f"depth_{i:04d}.png"), depth_to_gray_u8(fetch()))

    with _Pipeline() as pipe:
        for i in frame_ids:
            gen = torch.Generator(device=dev).manual_seed(seed * FRAME_SEED_STRIDE + i)
            rgb, depth, _ = render_frame(model, cfg, c2ws[i], height, width, focal,
                                         appearance_embedding=appearance_embedding,
                                         perturb=False, generator=gen, device=dev, mesh=mesh)
            if not writes:
                continue
            tasks = [(write_rgb, i, fetch_async(_quantize(rgb)))]
            if i % 10 == 0:   # a depth map every 10th frame
                tasks.append((write_depth, i, fetch_async(depth)))
            pipe.submit(*tasks)
        written = pipe.results()

    if make_video and _video_writer(mesh):
        create_video_from_images(output_dir, os.path.join(output_dir, f"{cfg.scene}_spiral.avi"),
                                 pattern="frame_*.png", fps=fps)
    return written
