"""The reference's inits in the port's model, and the born-dead probe
(the port's counterpart of ``benchmarks/jax_reference.py:51-119``).

- ``sample_torch_init(cfg, n_images, seed)``: a genuine reference init
  (torch's default Linear init, then the N(0, 1) appearance table), drawn
  on the CPU by ``torch_reference.reference_init``, as ``{name: ndarray}``.
- ``params_from_reference(init, cfg)``: that snapshot as the port's
  ``NeRF`` state dict and appearance table (the JAX ``torch_init_to_params``
  followed by ``utils/convert.params_from_jax``: the same arrays under the
  port's names); ``model_from_reference`` builds the module from it.
- ``density_alive_probe``: the max sigma of the port's ``NeRF`` module in
  f32 over a fixed probe set (``default_rng(0)``, the first two views,
  1024 rays x 16 depths, dirs -z); 0.0 under ReLU means the density head is
  born dead.  The study applies it to every arm.

There is no mirror here.  The JAX study ran the reference arm through a JAX
mirror of the torch trainer (``train_mirror``) because torch on its host's
CPU took hours a seed; on the card the reference arm is
``torch_reference.train_reference`` itself.
"""

from __future__ import annotations

import numpy as np
import torch

from danerf_tpu_torch.benchmarks.torch_reference import (export_init, ray_grid,
                                                         rays_from_c2w, reference_init)

# reference module name -> the port's NeRF module name, in params_from_jax's order
_NAMES = (("density", "density_head"), ("dir_layer", "dir_linear"),
          ("rgb_layer", "rgb_linear"), ("app_proj", "appearance_projection"))


def sample_torch_init(cfg, n_images: int, seed: int) -> dict:
    """A reference init for ``seed`` as {name: np.ndarray}
    (``export_init`` of ``reference_init``)."""
    return export_init(*reference_init(cfg, n_images, seed))


def params_from_reference(init: dict, cfg):
    """(state_dict of the port's ``NeRF``, appearance table or None) holding
    the arrays of an ``export_init`` snapshot."""
    sd = {}
    for i in range(cfg.num_layers):
        for part in ("weight", "bias"):
            sd[f"pts_linears.{i}.{part}"] = torch.tensor(init[f"layers.{i}.{part}"])
    for ref, port in _NAMES:
        if f"{ref}.weight" in init:
            for part in ("weight", "bias"):
                sd[f"{port}.{part}"] = torch.tensor(init[f"{ref}.{part}"])
    table = init.get("appearance_embeddings")
    return sd, None if table is None else torch.tensor(table)


def model_from_reference(init: dict, cfg, device):
    """The port's ``NeRF`` module and appearance table (an ``nn.Parameter``,
    or None) on ``device``, started from a reference init."""
    from danerf_tpu_torch.models.nerf import NeRF

    sd, table = params_from_reference(init, cfg)
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(sd)
    model = model.to(device)
    if cfg.use_appearance and table is not None:
        return model, torch.nn.Parameter(table.to(device))
    return model, None


def probe_points(images_shape, c2ws, focal, near: float, far: float, n_probe: int = 1024,
                 n_z: int = 16) -> np.ndarray:
    """The fixed probe set: ``n_probe // 2`` pixels of each of the first two
    views drawn by ``default_rng(0)``, ``n_z`` evenly spaced depths each;
    (n_probe * n_z, 3) float32."""
    n_images, height, width = images_shape[:3]
    cam = ray_grid(height, width, focal)
    rng = np.random.default_rng(0)  # probe set is fixed across all seeds/arms
    pts = []
    for i in range(min(2, n_images)):
        ro, rd = rays_from_c2w(cam, torch.tensor(np.asarray(c2ws[i], np.float32)))
        sel = rng.choice(height * width, n_probe // 2, replace=False)
        z = np.linspace(near, far, n_z, dtype=np.float32)
        p = (ro[sel].numpy()[:, None, :]
             + rd[sel].numpy()[:, None, :] * z[None, :, None])
        pts.append(p.reshape(-1, 3))
    return np.concatenate(pts)


@torch.no_grad()
def density_alive_probe(model, cfg, images_shape, c2ws, focal, n_probe: int = 1024,
                        n_z: int = 16) -> float:
    """Max sigma of ``model`` (the port's ``NeRF``) in f32 over the probe
    set, on the module's device.

    == 0.0 (under ReLU) means the density head is BORN DEAD: every visible
    pre-activation is negative, the relu gate zeroes every gradient, and
    training never moves.  Applied to every arm so dead seeds are excluded
    symmetrically.
    """
    from danerf_tpu_torch.models.nerf import NeRF

    dev = next(model.parameters()).device
    probe = NeRF(cfg.replace(use_bf16=False), torch.Generator().manual_seed(0)).to(dev)
    probe.load_state_dict(model.state_dict())
    pts = torch.from_numpy(probe_points(images_shape, c2ws, focal, cfg.near, cfg.far,
                                        n_probe, n_z)).to(dev)
    dirs = torch.zeros_like(pts)
    dirs[..., 2] = -1.0
    _, sigma = probe(pts, dirs, None)
    return float(sigma.max())
