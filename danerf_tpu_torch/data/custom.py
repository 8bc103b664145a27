"""Custom-dataset loader (counterpart of danerf_tpu/data/custom.py): one
``transforms.json`` one directory above ``dataset_path`` (else in it), with
``w``/``camera_angle_x``/``fl_x`` metadata and per-frame ``file_path``
(relative to ``dataset_path``, extension included) and
``transform_matrix``.  The train split is every frame but the last, the
val/test split the last frame; alphas are all 255.

Each image is read by its signature, as ``Image.open(...).convert("RGB")``
reads it (``read_rgb``, on ``data/images.py``): PNG, JPEG (sequential or
progressive), BMP, Netpbm, TIFF, GIF and WebP (lossless or lossy).
"""

from __future__ import annotations

import json
import os

import numpy as np

from danerf_tpu_torch.data.dataset import RayDataset


def _meta_path(dataset_path: str) -> str:
    path = os.path.join(dataset_path, "..", "transforms.json")
    if not os.path.exists(path):
        path = os.path.join(dataset_path, "transforms.json")
    return path


def _split_frames(meta: dict, split: str) -> list:
    frames = meta["frames"]
    return frames[:-1] if split == "train" else frames[-1:]


def read_rgb(path: str) -> np.ndarray:
    """Any image file the port reads, as (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(path).convert("RGB")`` gives it (``data/images.py``)."""
    from danerf_tpu_torch.data.images import read_rgb as read

    return read(path)


def image_width(path: str) -> int:
    """An image file's width from its header, without decoding it."""
    from danerf_tpu_torch.data.images import image_size

    return image_size(path)[0]


def focal_from_meta(meta: dict, width: int) -> float:
    if "camera_angle_x" in meta:
        return float(0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"])))
    if "fl_x" in meta:
        return float(meta["fl_x"])
    return float(width / (2 * np.tan(np.radians(55) / 2)))


def load_custom_scene(dataset_path: str, split: str = "train", near: float = 2.0,
                      far: float = 6.0) -> RayDataset:
    with open(_meta_path(dataset_path)) as f:
        meta = json.load(f)
    images, c2ws = [], []
    for frame in _split_frames(meta, split):
        images.append(read_rgb(os.path.join(dataset_path, frame["file_path"])))
        c2ws.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images)
    alphas = np.full(images.shape[:3], 255, np.uint8)
    width = int(meta.get("w", images.shape[2]))
    return RayDataset(images=images, alphas=alphas, c2ws=np.stack(c2ws),
                      focal=focal_from_meta(meta, width), near=near, far=far, split=split)


def custom_intrinsics(dataset_path: str, split: str = "train"):
    """(image width, focal) of the scene ``load_custom_scene`` would load,
    from the metadata and the first frame's header."""
    with open(_meta_path(dataset_path)) as f:
        meta = json.load(f)
    first = _split_frames(meta, split)[0]
    width = image_width(os.path.join(dataset_path, first["file_path"]))
    return width, focal_from_meta(meta, int(meta.get("w", width)))
