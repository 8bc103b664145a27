"""Training checkpoints as reference-format ``.pt`` files: a dict with
``model_state_dict`` (the reference keys), ``appearance_embeddings``,
``optimizer_state_dict``, ``scheduler_state_dict``, ``iteration``, ``loss``
and ``psnr``, so ``render --checkpoint <file>`` (and the reference's own
loader) reads it as it is; ``load_model`` builds the module of one.
Resuming from one waits for the train-loop slice."""

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


def load_model(path: str, cfg, device="cuda"):
    """The ``NeRF`` module of a reference-format ``.pt`` on ``device``: the
    card unless the caller asks for the CPU (``resolve_device``: raises
    when CUDA is asked for and absent).

    ``cfg`` gives the architecture; its ``use_appearance`` is taken from the
    checkpoint.  Its ``use_time`` must match the checkpoint: a
    time-conditioned model's first and skip layers take ``time_enc_dim``
    (13 at 6 levels) more input columns.  Returns (model, appearance table or
    None, metadata, cfg)."""
    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.convert import load_reference_checkpoint

    device = resolve_device(device)
    sd, emb_table, meta = load_reference_checkpoint(path)
    cfg = cfg.replace(use_appearance="appearance_projection.weight" in sd)
    width = sd["pts_linears.0.weight"].shape[1]
    want = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
    if width != want:
        timed = width == cfg.pos_enc_dim + cfg.time_enc_dim
        raise ValueError(f"{path}: the first layer takes {width} inputs, the config "
                         f"{want} (use_time={cfg.use_time}); the checkpoint is "
                         f"{'' if timed else 'not '}a time-conditioned model")
    model = NeRF(cfg)
    model.load_state_dict(sd)
    return model.to(device), emb_table, meta, cfg
