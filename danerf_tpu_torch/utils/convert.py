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


def read_params_npz(path: str) -> dict:
    """A JAX param tree saved as an ``.npz`` of its leaves under their
    dotted names (``model.trunk.0.w``, ``model.density.b``,
    ``appearance``) -> that tree of numpy arrays, a trunk as a list:
    ``{"model": {"trunk": [{"w", "b"}, ...], "density": ...},
    "appearance": (N, E)}``.  Numpy only: the file is data."""
    tree: dict = {}
    with np.load(path) as z:
        for name in z.files:
            *parents, leaf = name.split(".")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = z[name]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


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


def jax_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in JAX's tree order
    (``jax.tree_util.tree_leaves``): dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def unflatten_like(flat, tree):
    """A flat vector (optax.flatten's state) in the shapes of ``tree``'s
    leaves, in JAX's tree order: a tree of the same structure."""
    flat = np.asarray(flat)
    leaves = jax_leaves(tree)
    sizes = [int(np.size(x)) for x in leaves]
    if sum(sizes) != flat.size:
        raise ValueError(f"a flat optimizer state of {flat.size} values does not fit "
                         f"parameters of {sum(sizes)}")
    parts = iter(np.split(flat, np.cumsum(sizes)[:-1]))

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(parts).reshape(np.shape(node))

    return build(tree)


def jax_moments(flat, params: dict, names, with_table: bool) -> list:
    """One of Adam's moments, optax's flat vector over the JAX ``params``
    (``{"model", "appearance"?}``), as the port's optimizer holds it: a
    tensor per module parameter ``names`` (transposed like
    ``params_from_jax``), then the table's when ``with_table``."""
    tree = unflatten_like(flat, params)
    sd = params_from_jax(tree["model"])
    out = [sd[n].clone() for n in names]
    if with_table:
        out.append(torch.tensor(np.asarray(tree["appearance"], np.float32)))
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
