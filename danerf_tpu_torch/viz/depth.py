"""Depth-map visualization (counterpart of danerf_tpu.viz.depth), with the
viridis table carried in source instead of matplotlib."""

from __future__ import annotations

import numpy as np

from danerf_tpu_torch.viz._viridis import VIRIDIS

_VIRIDIS = np.asarray(VIRIDIS, np.float64)


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """(d - min) / (max - min + eps)."""
    d = np.asarray(depth, np.float32)
    return (d - d.min()) / (d.max() - d.min() + 1e-6)


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) viridis-coloured depth, indexed as matplotlib's
    256-entry listed colormap indexes a float in [0, 1]."""
    xa = normalize_depth(depth) * np.float32(len(_VIRIDIS))
    xa[xa == len(_VIRIDIS)] = len(_VIRIDIS) - 1
    idx = np.clip(xa, 0, len(_VIRIDIS) - 1).astype(np.int64)
    return (_VIRIDIS[idx] * 255).astype(np.uint8)


def depth_to_gray_u8(depth: np.ndarray) -> np.ndarray:
    """uint8 (H, W) grayscale depth: the normalised depth times 255,
    truncated (the aligned spiral's depth_NNNN.png)."""
    return (normalize_depth(depth) * 255).astype(np.uint8)
