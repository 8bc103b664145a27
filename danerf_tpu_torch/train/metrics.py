"""Training metrics (counterpart of danerf_tpu/train/metrics.py): PSNR and
an append-only JSONL logger.  SSIM comes with the evaluation slice."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch


def psnr(mse):
    """PSNR in dB from MSE (reference src/train.py:100)."""
    return -10.0 * torch.log10(torch.as_tensor(mse))


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
