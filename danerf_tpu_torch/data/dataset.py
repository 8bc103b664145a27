"""Scene intrinsics for rendering (the part of danerf_tpu.data.load_dataset
that ``render`` uses: the scene's image width and focal length).

A Blender ``nerf_synthetic`` scene is read from its ``transforms_{split}.json``
header (focal from ``camera_angle_x``, else ``fl_x``, else a 55-degree field
of view) and the first frame's PNG header for the width, without decoding any
image.  Without one, the procedural scene's constants apply (100 px wide,
``0.5 W / tan(0.5 * 0.6911)``).  The full ray-pool loaders come with training.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from danerf_tpu_torch.config import NeRFConfig

SYNTHETIC_WIDTH = 100
SYNTHETIC_FOV = 0.6911


@dataclasses.dataclass(frozen=True)
class SceneIntrinsics:
    width: int
    focal: float


def _png_width(path: str) -> int:
    """Image width from a PNG's IHDR chunk (bytes 16-20)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">I", head[16:20])[0]


def load_dataset(cfg: NeRFConfig, split: str = "train") -> SceneIntrinsics:
    if cfg.dataset_type != "nerf_synthetic":
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r} is not yet ported to "
            "danerf_tpu_torch (only nerf_synthetic and the procedural scene)")
    scene_dir = os.path.join(cfg.dataset_path, cfg.scene)
    meta_path = os.path.join(scene_dir, f"transforms_{split}.json")
    if not os.path.exists(meta_path):
        width = SYNTHETIC_WIDTH
        return SceneIntrinsics(width, float(0.5 * width / np.tan(0.5 * SYNTHETIC_FOV)))

    with open(meta_path) as f:
        meta = json.load(f)
    fp = meta["frames"][0]["file_path"]
    if fp.startswith("./"):
        fp = fp[2:]
    width = _png_width(os.path.join(scene_dir, fp + ".png"))
    if "camera_angle_x" in meta:
        focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
    elif "fl_x" in meta:
        focal = float(meta["fl_x"])
    else:
        focal = width / (2 * np.tan(np.radians(55) / 2))
    return SceneIntrinsics(width, float(focal))
