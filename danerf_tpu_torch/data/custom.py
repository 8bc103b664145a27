"""Custom-dataset loader (counterpart of danerf_tpu/data/custom.py): one
``transforms.json`` one directory above ``dataset_path`` (else in it), with
``w``/``camera_angle_x``/``fl_x`` metadata and per-frame ``file_path``
(relative to ``dataset_path``, extension included) and
``transform_matrix``.  The train split is every frame but the last, the
val/test split the last frame; alphas are all 255.

Each image is read by its signature, as ``Image.open(...).convert("RGB")``
reads it (``read_rgb``): a PNG by ``data/png.py``, a JPEG, sequential or
progressive, by ``data/jpeg.py``.
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
    """A PNG or JPEG file as (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(path).convert("RGB")`` gives it: gray repeated, an alpha
    channel dropped (also a palette's tRNS), 16-bit gray clipped at 255 (PIL
    clips mode I;16, it does not scale it)."""
    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.data.png import read_png

    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"\xff\xd8"):
        return read_jpeg(path)
    if head != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    arr = read_png(path)
    if arr.ndim == 2:
        arr = np.minimum(arr, 255).astype(np.uint8)[..., None]
    if arr.shape[-1] <= 2:                              # gray [+ alpha]
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def image_width(path: str) -> int:
    """A PNG's or JPEG's width from its header, without decoding it."""
    from danerf_tpu_torch.data.dataset import _png_width
    from danerf_tpu_torch.data.jpeg import jpeg_size

    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return jpeg_size(data)[1]
    return _png_width(path)


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
