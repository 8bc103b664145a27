"""Workspace bootstrap (counterpart of danerf_tpu/utils/dirs.py; reference
ensure_dirs.py:4-49)."""

from __future__ import annotations

import os


def ensure_directories(base: str = ".") -> list[str]:
    """Create the standard working directories; returns their paths."""
    dirs = [os.path.join(base, d) for d in ("checkpoints", "output", "shaders")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    return dirs


def list_checkpoints(base: str = ".") -> dict:
    """Map scene -> newest ``.pt`` checkpoint across the ``checkpoints*``
    directories of ``base`` (``latest_checkpoint`` of each)."""
    from danerf_tpu_torch.utils.checkpoint import latest_checkpoint

    out = {}
    for entry in sorted(os.listdir(base)):
        if entry.startswith("checkpoints"):
            path = latest_checkpoint(os.path.join(base, entry))
            if path:
                scene = entry.replace("checkpoints_", "") or "default"
                out[scene] = path
    return out
