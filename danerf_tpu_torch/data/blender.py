"""Blender nerf_synthetic loader (counterpart of danerf_tpu/data/blender.py):
``transforms_{split}.json`` with per-frame ``file_path`` and
``transform_matrix``, focal from ``camera_angle_x`` (else ``fl_x``, else a
55-degree field of view), RGBA frames with the alpha split off.  Images are
decoded once, by the port's own PNG decoder (``data/png.py``), to the
array of the mode PIL opens, as the JAX loader's ``np.asarray`` takes it:
gray, gray + alpha, RGB or RGBA, 16-bit colour as its high byte, any
interlacing.  Where PIL's array is not pixels, the port differs from the
JAX loader: a palette is expanded to RGB (RGBA with tRNS) where JAX takes
the indices, a 1-bit frame is 0/255 (``convert("L")``) where JAX takes a
bool array, and a 16-bit gray frame raises ValueError where JAX takes
uint16 samples as 8-bit ones.  ``downscale > 1`` shrinks each to (W // k,
H // k) with ``data/resize.lanczos_resize`` (PIL's LANCZOS, an alpha
channel resized premultiplied) and divides ``fl_x`` by k.
``save_blender_scene`` writes a dataset in that layout (RGBA PNGs through
the port's own PNG writer).
"""

from __future__ import annotations

import json
import os

import numpy as np

from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.data.png import read_png
from danerf_tpu_torch.data.resize import lanczos_resize
from danerf_tpu_torch.viz.png import write_png


def load_blender_scene(scene_dir: str, split: str = "train", near: float = 2.0,
                       far: float = 6.0, downscale: int = 1) -> RayDataset:
    """Load one split of a scene, each image shrunk by the integer factor
    ``downscale`` (the focal scales with the width)."""
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    images, alphas, c2ws = [], [], []
    for frame in meta["frames"]:
        fp = frame["file_path"]
        if fp.startswith("./"):
            fp = fp[2:]
        path = os.path.join(scene_dir, fp + ".png")
        arr = read_png(path)
        if arr.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit gray frame (PIL mode I;16) is not an 8-bit "
                             "image; save it as 8-bit or 16-bit RGB(A)")
        if downscale > 1:
            arr = lanczos_resize(arr, arr.shape[1] // downscale, arr.shape[0] // downscale)
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
        focal = float(meta["fl_x"]) / downscale
    else:
        focal = width / (2 * np.tan(np.radians(55) / 2))
    return RayDataset(images=images, alphas=np.stack(alphas), c2ws=np.stack(c2ws),
                      focal=float(focal), near=near, far=far, split=split)


def save_blender_scene(dataset: RayDataset, out_dir: str, split: str | None = None) -> str:
    """Write ``dataset`` in the nerf_synthetic layout: ``{split}/r_{i}.png``
    (RGBA: its images with their alphas) and ``transforms_{split}.json``
    (``camera_angle_x`` from the focal, each frame's ``file_path`` and
    ``transform_matrix``), which ``load_blender_scene`` reads back; returns
    the JSON's path."""
    split = split or dataset.split
    img_dir = os.path.join(out_dir, split)
    os.makedirs(img_dir, exist_ok=True)
    camera_angle_x = 2.0 * np.arctan(0.5 * dataset.width / dataset.focal)
    frames = []
    for i in range(dataset.n_images):
        rgba = np.concatenate([dataset.images[i], dataset.alphas[i][..., None]], axis=-1)
        name = f"r_{i}"
        write_png(os.path.join(img_dir, name + ".png"), rgba.astype(np.uint8))
        frames.append({"file_path": f"./{split}/{name}",
                       "transform_matrix": np.asarray(dataset.c2ws[i], np.float64).tolist()})
    path = os.path.join(out_dir, f"transforms_{split}.json")
    with open(path, "w") as f:
        json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)
    return path
