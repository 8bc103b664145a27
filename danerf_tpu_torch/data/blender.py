"""Blender nerf_synthetic loader (counterpart of danerf_tpu/data/blender.py):
``transforms_{split}.json`` with per-frame ``file_path`` and
``transform_matrix``, focal from ``camera_angle_x`` (else ``fl_x``, else a
55-degree field of view), RGBA frames with the alpha split off.  Images are
decoded once, by the port's own PNG decoder.
"""

from __future__ import annotations

import json
import os

import numpy as np

from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.data.png import read_png


def load_blender_scene(scene_dir: str, split: str = "train", near: float = 2.0,
                       far: float = 6.0, downscale: int = 1) -> RayDataset:
    """Load one split of a scene.  ``downscale > 1`` needs a Lanczos resize
    and is not yet ported."""
    if downscale != 1:
        raise NotImplementedError("load_blender_scene(downscale > 1) is not yet ported to "
                                  "danerf_tpu_torch (it needs a Lanczos resize)")
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    images, alphas, c2ws = [], [], []
    for frame in meta["frames"]:
        fp = frame["file_path"]
        if fp.startswith("./"):
            fp = fp[2:]
        arr = read_png(os.path.join(scene_dir, fp + ".png"))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        elif arr.shape[-1] == 2:                       # gray + alpha
            arr = np.concatenate([np.repeat(arr[..., :1], 3, axis=-1), arr[..., 1:]], axis=-1)
        images.append(arr[..., :3])
        alphas.append(arr[..., 3] if arr.shape[-1] == 4
                      else np.full(arr.shape[:2], 255, np.uint8))
        c2ws.append(np.asarray(frame["transform_matrix"], np.float32))

    images = np.stack(images)
    width = images.shape[2]
    if "camera_angle_x" in meta:
        focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
    elif "fl_x" in meta:
        focal = float(meta["fl_x"])
    else:
        focal = width / (2 * np.tan(np.radians(55) / 2))
    return RayDataset(images=images, alphas=np.stack(alphas), c2ws=np.stack(c2ws),
                      focal=float(focal), near=near, far=far, split=split)
