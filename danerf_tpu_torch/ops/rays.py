"""Ray generation for a pinhole camera (counterpart of danerf_tpu.ops.rays).

Pixel (i=row, j=col) maps to the camera-space direction
``((j - W/2)/f, -(i - H/2)/f, -1)`` (x right, y up, looking down -z), rotated
to world space by the upper-left 3x3 of the camera-to-world matrix and
normalized; origins broadcast from the c2w translation column.
"""

from __future__ import annotations

import numpy as np
import torch


def generate_rays(height: int, width: int, focal, c2w: torch.Tensor):
    """Rays for every pixel of an image.

    Args:
        height, width: ints; focal: focal length in pixels.
        c2w: (3, 4) or (4, 4) camera-to-world matrix (its device and dtype
            are the rays').

    Returns:
        origins, directions: each (height, width, 3); directions unit-norm.
    """
    dev = c2w.device
    i, j = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    x = (j - width * 0.5) / focal
    y = -(i - height * 0.5) / focal
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    rot = c2w[..., :3, :3].to(torch.float32)
    dirs = torch.sum(dirs[..., None, :] * rot, dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = torch.broadcast_to(c2w[..., :3, 3].to(torch.float32), dirs.shape)
    return origins, dirs


def look_at_c2w(cam_pos, center, up) -> np.ndarray:
    """4x4 c2w from camera position, look-at center and up vector; columns
    [right | up | -forward | position], with the degenerate-basis guards of
    the JAX package.  Host-side numpy: a path is a few 4x4 matrices."""
    cam_pos = np.asarray(cam_pos, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    forward = center - cam_pos
    n = np.linalg.norm(forward)
    forward = np.array([0.0, 0.0, -1.0]) if n < 1e-10 else forward / n

    right = np.cross(forward, up)
    n = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if n < 1e-10 else right / n

    camera_up = np.cross(right, forward)
    n = np.linalg.norm(camera_up)
    camera_up = up if n < 1e-10 else camera_up / n

    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = camera_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = cam_pos
    return c2w.astype(np.float32)
