"""Scene data (counterpart of danerf_tpu/data/dataset.py).

- ``RayDataset``: images, alphas and camera matrices of one split, decoded
  once, and each image's capture time where the scene has one;
  ``device_arrays`` uploads the pixel pool to the device once as (N*H*W, 3)
  f32, composited over white when asked.
- ``sample_ray_batch``: one training batch drawn on the device -- one image
  per batch, pixels with replacement, then ``rays_for_pixels``; each ray's
  time is its image's.
- ``load_dataset``: the Blender scene when ``transforms_{split}.json``
  exists, otherwise the procedural scene (its time-varying form under
  ``use_time``).
- ``scene_intrinsics``: what ``render`` needs of a scene (its width and
  focal length), read from the ``transforms`` header and the first frame's
  PNG header without decoding any image.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import NeRFConfig

SYNTHETIC_WIDTH = 100


@dataclasses.dataclass
class RayDataset:
    """images (N, H, W, 3) uint8; alphas (N, H, W) uint8; c2ws (N, 4, 4)
    f32; focal in pixels; near/far bounds; times (N,) f32 capture times in
    [0, 1] for the time-conditioned variant (``use_time``), else None."""

    images: np.ndarray
    alphas: np.ndarray
    c2ws: np.ndarray
    focal: float
    near: float
    far: float
    split: str = "train"
    times: Optional[np.ndarray] = None

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    def __len__(self) -> int:
        return self.n_images

    def device_arrays(self, white_background: bool = False, device="cuda") -> dict:
        """The pool on ``device`` (the card unless the caller asks for the
        CPU; raises without CUDA, ``resolve_device``): images (N*H*W, 3) f32
        in [0, 1] (over white when asked), c2ws (N, 4, 4) f32, and times (N,)
        f32 when the scene has them."""
        device = resolve_device(device)
        imgs = self.images.astype(np.float32) / 255.0
        if white_background:
            a = self.alphas.astype(np.float32)[..., None] / 255.0
            imgs = imgs * a + (1.0 - a)
        pool = {"images": torch.from_numpy(imgs.reshape(-1, 3)).to(device),
                "c2ws": torch.from_numpy(np.asarray(self.c2ws, np.float32)).to(device)}
        if self.times is not None:
            pool["times"] = torch.from_numpy(np.asarray(self.times, np.float32)).to(device)
        return pool


def sample_ray_batch(pool: dict, cfg: NeRFConfig, height: int, width: int, focal,
                     batch_size: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     img_idx: Optional[torch.Tensor] = None,
                     pix_idx: Optional[torch.Tensor] = None) -> dict:
    """A training batch, drawn on the pool's device.

    All rays come from one random image; pixels are drawn with replacement.
    ``img_idx`` (a scalar or (B,)) and ``pix_idx`` (B,) replace the draws
    from ``generator`` when given.

    Returns dict rays_o, rays_d (B, 3), rgb (B, 3), img_idx (B,) int64,
    and t (B, 1), each ray's image time, when the pool has times.
    """
    from danerf_tpu_torch.ops.rays import rays_for_pixels

    if batch_size is None:
        batch_size = cfg.batch_size
    dev = pool["images"].device
    n_images = pool["c2ws"].shape[0]
    if img_idx is None:
        img_idx = torch.randint(0, n_images, (), generator=generator, device=dev)
    img_idx = torch.as_tensor(img_idx, device=dev).to(torch.int64).expand(batch_size)
    if pix_idx is None:
        pix_idx = torch.randint(0, height * width, (batch_size,), generator=generator,
                                device=dev)
    pix_idx = torch.as_tensor(pix_idx, device=dev).to(torch.int64)
    rays_o, rays_d = rays_for_pixels(pix_idx, pool["c2ws"][img_idx], height, width, focal)
    rgb = pool["images"][img_idx * (height * width) + pix_idx]
    batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb, "img_idx": img_idx}
    if "times" in pool:
        batch["t"] = pool["times"][img_idx][:, None]
    return batch


def load_dataset(cfg: NeRFConfig, split: str = "train") -> RayDataset:
    """The Blender scene under ``dataset_path/scene`` when its transforms
    file exists, otherwise the procedural scene (seed 0): under
    ``cfg.use_time`` its time-varying form, which carries per-image times (a
    Blender scene has none)."""
    if cfg.dataset_type != "nerf_synthetic":
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r} (the custom loader) is not yet ported to "
            "danerf_tpu_torch (only nerf_synthetic and the procedural scene)")
    scene_dir = os.path.join(cfg.dataset_path, cfg.scene)
    if os.path.exists(os.path.join(scene_dir, f"transforms_{split}.json")):
        from danerf_tpu_torch.data.blender import load_blender_scene

        return load_blender_scene(scene_dir, split=split, near=cfg.near, far=cfg.far)
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene, make_time_varying_scene

    make = make_time_varying_scene if cfg.use_time else make_synthetic_scene
    return make(split=split, near=cfg.near, far=cfg.far, seed=0)


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


def scene_intrinsics(cfg: NeRFConfig, split: str = "train") -> SceneIntrinsics:
    """Width and focal of the scene ``load_dataset`` would load, without
    decoding or rendering its images."""
    if cfg.dataset_type != "nerf_synthetic":
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r} is not yet ported to "
            "danerf_tpu_torch (only nerf_synthetic and the procedural scene)")
    scene_dir = os.path.join(cfg.dataset_path, cfg.scene)
    meta_path = os.path.join(scene_dir, f"transforms_{split}.json")
    if not os.path.exists(meta_path):
        from danerf_tpu_torch.data.synthetic import SYNTHETIC_FOV

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
