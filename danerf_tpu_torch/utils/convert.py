"""Parameter conversion (counterpart of danerf_tpu.utils.convert).

Reference checkpoints (``checkpoint_*.pt``) hold a dict with
``model_state_dict`` (keys ``pts_linears.{i}.{weight,bias}``,
``density_head.*``, ``dir_linear.*``, ``appearance_projection.*``,
``rgb_linear.*``), optional ``appearance_embeddings``, plus optimizer state /
loss / psnr / iteration.  The port's ``NeRF`` module uses those keys, so such
a state dict loads as it is.

The JAX package stores Linear weights as (in, out) in a pytree
``{"trunk": [{"w","b"}...], "density", "dir", "rgb", "appearance_proj"}``;
torch stores (out, in).  ``params_from_jax`` and ``params_to_jax`` transpose
between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_HEADS = (("density", "density_head"), ("dir", "dir_linear"),
          ("rgb", "rgb_linear"), ("appearance_proj", "appearance_projection"))


def params_from_jax(params: dict) -> dict:
    """JAX param pytree (numpy arrays, (in, out) weights) -> state_dict."""
    sd = {}

    def put(prefix, p):
        sd[f"{prefix}.weight"] = torch.tensor(np.asarray(p["w"], np.float32).T)
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))

    for i, layer in enumerate(params["trunk"]):
        put(f"pts_linears.{i}", layer)
    for jax_name, ref_name in _HEADS:
        if jax_name in params:
            put(ref_name, params[jax_name])
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """state_dict -> JAX param pytree of numpy arrays (inverse of
    params_from_jax)."""

    def get(prefix):
        return {"w": state_dict[f"{prefix}.weight"].detach().cpu().numpy().T.copy(),
                "b": state_dict[f"{prefix}.bias"].detach().cpu().numpy().copy()}

    trunk = []
    while f"pts_linears.{len(trunk)}.weight" in state_dict:
        trunk.append(get(f"pts_linears.{len(trunk)}"))
    out = {"trunk": trunk}
    for jax_name, ref_name in _HEADS:
        if f"{ref_name}.weight" in state_dict:
            out[jax_name] = get(ref_name)
    return out


def load_reference_checkpoint(path: str) -> Tuple[dict, Optional[torch.Tensor], dict]:
    """Load a reference-format ``.pt`` checkpoint.

    The file is a pickle written by ``torch.save`` (the reference trainer's
    format, which includes optimizer state), so it is read with
    ``weights_only=False``: load only checkpoints you trust.

    Returns (model_state_dict, appearance_embeddings | None, metadata).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: torch.as_tensor(v).detach().to(torch.float32)
          for k, v in ckpt["model_state_dict"].items()}
    emb = ckpt.get("appearance_embeddings")
    if emb is not None:
        emb = torch.as_tensor(emb).detach().to(torch.float32)
    meta = {k: ckpt[k] for k in ("loss", "psnr", "iteration") if k in ckpt}
    return sd, emb, meta
