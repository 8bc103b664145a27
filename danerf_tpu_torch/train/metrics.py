"""Training metrics (counterpart of danerf_tpu/train/metrics.py): PSNR,
SSIM on the host (``ssim``, numpy) and on the device (``ssim_device``,
torch), and an append-only JSONL logger."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


def psnr(mse):
    """PSNR in dB from MSE (reference src/train.py:100)."""
    return -10.0 * torch.log10(torch.as_tensor(mse))


def _gaussian_win(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    i = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(i ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _filt_valid(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D correlation with a 1-D kernel, 'valid' region only."""
    from numpy.lib.stride_tricks import sliding_window_view

    x = np.tensordot(sliding_window_view(x, k.size, axis=1), k, axes=([2], [0]))
    return np.tensordot(sliding_window_view(x, k.size, axis=0), k, axes=([2], [0]))


def _window(h: int, w: int, win_size: int) -> int:
    """The window: ``win_size``, or for an image smaller than it the largest
    odd size that fits (a global window)."""
    if min(h, w) < win_size:
        win_size = min(h, w)
        if win_size % 2 == 0:
            win_size -= 1
    return win_size


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5) -> float:
    """Standard SSIM (Wang et al. 2004): 11x11 Gaussian sliding window
    (sigma 1.5), population statistics, mean over the valid region, averaged
    over channels; skimage's ``structural_similarity`` with
    ``gaussian_weights=True, use_sample_covariance=False``, the convention
    NeRF papers report.  In float64.

    a, b: (H, W) or (H, W, C) in [0, data_range].
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_win(_window(a.shape[0], a.shape[1], win_size), sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mu_x = _filt_valid(x, k)
        mu_y = _filt_valid(y, k)
        var_x = _filt_valid(x * x, k) - mu_x ** 2
        var_y = _filt_valid(y * y, k) - mu_y ** 2
        cov = _filt_valid(x * y, k) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def _filt_valid_torch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable valid-region correlation of (C, H, W) with a 1-D kernel:
    the windows along W, then along H (``unfold``), each contracted with k
    by a matmul (full f32: PyTorch's default for matmul on the card)."""
    w = k.numel()
    x = x.unfold(2, w, 1) @ k
    return x.unfold(1, w, 1) @ k


def ssim_device(a, b, data_range: float = 1.0, win_size: int = 11, sigma: float = 1.5):
    """SSIM on the images' device in f32: the math of :func:`ssim` with a
    separable valid-region filter, so an evaluation moves only the score to
    the host.

    a, b: (H, W) or (H, W, C) tensors in [0, data_range].  Returns a 0-dim
    tensor on their device.
    """
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(device=a.device, dtype=torch.float32)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    k = torch.from_numpy(_gaussian_win(_window(a.shape[0], a.shape[1], win_size), sigma))
    k = k.to(device=a.device, dtype=torch.float32)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    mu_x = _filt_valid_torch(x, k)
    mu_y = _filt_valid_torch(y, k)
    var_x = _filt_valid_torch(x * x, k) - mu_x ** 2
    var_y = _filt_valid_torch(y * y, k) - mu_y ** 2
    cov = _filt_valid_torch(x * y, k) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    return s.mean(dim=(1, 2)).mean()


class MetricsLogger:
    """Append-only JSONL scalar logger with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        self.history: list[dict] = []
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        self.history.append(row)
        if self._f is not None:
            self._f.write(json.dumps(row) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
