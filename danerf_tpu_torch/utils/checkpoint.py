"""Training checkpoints as reference-format ``.pt`` files: a dict with
``model_state_dict`` (the reference keys), ``appearance_embeddings``,
``optimizer_state_dict``, ``scheduler_state_dict``, ``iteration``, ``loss``
and ``psnr``, so ``render --checkpoint <file>`` (and the reference's own
loader) reads it as it is, plus ``generator_state``, the training
generator's state, which a reader of the reference keys ignores.  The
optimizer and scheduler state is written as a CPU run holds it (host
tensors, float rates), whatever device trained.  ``load_model`` builds the
module of one; ``restore_training_state`` puts the whole training state of
one back, so that ``train(resume=True)`` continues where it stopped."""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch


def _float(v):
    """A hyperparameter as the CPU run holds it: a tensor rate as a float."""
    if isinstance(v, torch.Tensor):
        return float(v)
    if isinstance(v, list):
        return [_float(x) for x in v]
    return v


def _portable_optimizer_state(optimizer) -> dict:
    """Adam's state dict with its tensors on the host, its rates as floats
    and ``capturable`` off: what a CPU run writes (``capturable`` Adam
    refuses CPU parameters)."""
    sd = optimizer.state_dict()
    state = {i: {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
             for i, s in sd["state"].items()}
    groups = [{**{k: _float(v) for k, v in g.items()}, "capturable": False}
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def save_checkpoint(path: str, model, appearance=None, optimizer=None, scheduler=None,
                    iteration: int = 0, loss: Optional[float] = None,
                    psnr: Optional[float] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write the checkpoint to ``path`` (via a temporary file, so a reader
    never sees half of one) and return the path."""
    ckpt = {"model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "iteration": int(iteration), "loss": loss, "psnr": psnr}
    if appearance is not None:
        ckpt["appearance_embeddings"] = appearance.detach().cpu()
    if optimizer is not None:
        ckpt["optimizer_state_dict"] = _portable_optimizer_state(optimizer)
    if scheduler is not None:
        ckpt["scheduler_state_dict"] = {k: _float(v) for k, v in scheduler.state_dict().items()}
    if generator is not None:
        ckpt["generator_state"] = generator.get_state()
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


def restore_training_state(path: str, model, table, optimizer, scheduler,
                           generator: Optional[torch.Generator] = None) -> int:
    """Put the training state of checkpoint ``path`` back into ``model``,
    the appearance ``table``, ``optimizer`` (Adam), ``scheduler`` (StepLR)
    and ``generator``, each on the device it lies on, and return the
    checkpoint's iteration.  Adam keeps its own ``capturable`` setting and
    rate type: on the card its step counts come back as device tensors and
    its rate as a device tensor.  A checkpoint without ``generator_state``
    leaves the generator as it is."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(ckpt["model_state_dict"])
    if table is not None:
        with torch.no_grad():
            table.copy_(ckpt["appearance_embeddings"])
    saved = ckpt["optimizer_state_dict"]
    groups = []
    for g, now in zip(saved["param_groups"], optimizer.param_groups):
        g = {**g, "capturable": now["capturable"]}
        for key in ("lr", "initial_lr"):
            if key in g and isinstance(now.get(key), torch.Tensor):
                g[key] = torch.tensor(float(g[key]), device=now[key].device)
        groups.append(g)
    optimizer.load_state_dict({"state": saved["state"], "param_groups": groups})
    scheduler.load_state_dict(ckpt["scheduler_state_dict"])
    if generator is not None and "generator_state" in ckpt:
        generator.set_state(ckpt["generator_state"])
    return int(ckpt["iteration"])


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
