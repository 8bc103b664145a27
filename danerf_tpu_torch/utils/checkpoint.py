"""Training checkpoints as reference-format ``.pt`` files: a dict with
``model_state_dict`` (the reference keys), ``appearance_embeddings``,
``optimizer_state_dict``, ``scheduler_state_dict``, ``iteration``, ``loss``
and ``psnr``, so ``render --checkpoint <file>`` (and the reference's own
loader) reads it as it is.  Resuming from one waits for the train-loop
slice."""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch


def save_checkpoint(path: str, model, appearance=None, optimizer=None, scheduler=None,
                    iteration: int = 0, loss: Optional[float] = None,
                    psnr: Optional[float] = None) -> str:
    """Write the checkpoint to ``path`` (via a temporary file, so a reader
    never sees half of one) and return the path."""
    ckpt = {"model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "iteration": int(iteration), "loss": loss, "psnr": psnr}
    if appearance is not None:
        ckpt["appearance_embeddings"] = appearance.detach().cpu()
    if optimizer is not None:
        ckpt["optimizer_state_dict"] = optimizer.state_dict()
    if scheduler is not None:
        ckpt["scheduler_state_dict"] = scheduler.state_dict()
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The newest checkpoint in ``save_dir``: ``checkpoint_final.pt`` when
    present, else the highest-numbered ``checkpoint_NNNNNN.pt``, else None."""
    final = os.path.join(save_dir, "checkpoint_final.pt")
    if os.path.exists(final):
        return final
    steps = []
    for p in glob.glob(os.path.join(save_dir, "checkpoint_*.pt")):
        m = re.fullmatch(r"checkpoint_(\d+)\.pt", os.path.basename(p))
        if m:
            steps.append((int(m.group(1)), p))
    return max(steps)[1] if steps else None
