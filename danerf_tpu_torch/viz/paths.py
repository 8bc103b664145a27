"""Camera paths for novel-view rendering (counterpart of
danerf_tpu.viz.paths): circle / spiral / horizontal_only / hemisphere
(Fibonacci) at radius 4 around a per-scene look-at center, and the
axis-aligned spiral with its 90-degree scene-upright rotation.  Host-side
numpy.
"""

from __future__ import annotations

import math

import numpy as np

from danerf_tpu_torch.ops.rays import look_at_c2w


def scene_center_up(scene: str):
    """Per-scene look-at center and up vector."""
    center = np.array([0.0, 0.0, 0.0])
    up = np.array([0.0, 1.0, 0.0])
    if scene == "lego":
        center = np.array([0.0, 0.5, 0.0])
        up = np.array([0.0, 0.0, 1.0])
    elif scene == "chair":
        center = np.array([0.0, 0.5, 0.0])
    return center, up


def camera_path(kind: str, num_frames: int, scene: str = "",
                spiral_loops: float = 2.0, height_range=(-0.5, 0.5),
                radius: float = 4.0) -> np.ndarray:
    """(num_frames, 4, 4) c2w matrices along the requested path."""
    center, up = scene_center_up(scene)

    if kind == "circle":
        theta = np.linspace(0, 2 * np.pi, num_frames)
        heights = np.full_like(theta, 0.5 if scene == "lego" else 0.0)
        phi = np.zeros_like(theta)
    elif kind == "spiral":
        theta = np.linspace(0, 2 * np.pi * spiral_loops, num_frames)
        hr = (0.3, 0.7) if scene == "lego" else height_range
        heights = np.linspace(hr[0], hr[1], num_frames)
        phi = np.zeros_like(theta)
    elif kind == "horizontal_only":
        theta = np.linspace(0, 2 * np.pi * spiral_loops, num_frames)
        heights = np.full_like(theta, 0.5)
        phi = np.zeros_like(theta)
    elif kind == "hemisphere":
        indices = np.arange(0, num_frames, dtype=float) + 0.5
        phi = np.arccos(1 - 2 * indices / num_frames) - np.pi / 2
        theta = np.pi * (1 + 5 ** 0.5) * indices
        heights = np.zeros_like(theta)
    else:
        raise ValueError(f"unknown camera path {kind!r}")

    c2ws = []
    for i, angle in enumerate(theta):
        if kind == "hemisphere":
            pos = np.array([radius * np.cos(phi[i]) * np.sin(angle),
                            radius * np.sin(phi[i]),
                            radius * np.cos(phi[i]) * np.cos(angle)])
        else:
            pos = np.array([radius * np.sin(angle), heights[i],
                            radius * np.cos(angle)])
        c2ws.append(look_at_c2w(pos, center, up))
    return np.stack(c2ws)


def alignment_matrix(rotation_axis: str) -> np.ndarray:
    """90-degree scene-upright rotation about ``rotation_axis`` (x, y, z;
    anything else: the identity)."""
    a = math.pi / 2
    c, s = math.cos(a), math.sin(a)
    if rotation_axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if rotation_axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if rotation_axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return np.eye(3)


def aligned_spiral_path(num_frames: int, loops: float = 2.0,
                        rotation_axis: str = "x", scene: str = "",
                        radius: float = 4.0) -> np.ndarray:
    """Spiral with a vertical sweep of +-0.3 radius, the alignment rotation
    applied to both position and up; the chair's center is lifted to y = 0.5
    when the rotation is about x."""
    A = alignment_matrix(rotation_axis)
    center = np.array([0.0, 0.0, 0.0])
    if rotation_axis == "x" and scene == "chair":
        center = np.array([0.0, 0.5, 0.0])
    up = np.array([0.0, 1.0, 0.0])

    theta = np.linspace(0, 2 * math.pi * loops, num_frames)
    phi = np.linspace(-0.3, 0.3, num_frames)

    c2ws = []
    for i in range(num_frames):
        base = np.array([radius * math.sin(theta[i]),
                         phi[i] * radius,
                         radius * math.cos(theta[i])])
        pos = A @ base
        aligned_up = A @ up
        c2ws.append(look_at_c2w(pos, center, aligned_up))
    return np.stack(c2ws)
