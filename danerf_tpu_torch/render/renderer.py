"""Volume renderer (counterpart of danerf_tpu/render/renderer.py):
stratified coarse pass, inverse-CDF importance pass, alpha compositing.

``render_rays`` has the two routes of the JAX function:
- the reference route (``fused_composite=False``): the module's forward at
  every sample, ``composite``, and ``combine_z``'s sorted union for the fine
  pass;
- the kernel route (``fused_composite=True``): K2 marches the coarse samples
  and returns their field, ``sample_pdf`` draws the importance depths, and K5
  evaluates the field only there and composites the rank-merged union (the
  plain versions on CPU tensors).  Under autograd the backward runs K6 for
  the fine pass and K3 for the coarse one (K3 alone without a fine pass).

``render_frame`` renders a whole frame as a Python loop over chunks of rays;
the last chunk may be short (the kernels mask the ragged tile).
"""

from __future__ import annotations

from typing import Optional

import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.ops.composite import composite
from danerf_tpu_torch.ops.rays import generate_rays
from danerf_tpu_torch.ops.sampling import (combine_z, ray_aabb_bounds,
                                           sample_pdf, sample_stratified)


def _eval_field(model, pts, rays_d, appearance_embedding, t):
    """The module's forward on (R, S, 3) points with per-ray dirs/embeddings."""
    dirs = rays_d[..., None, :].expand(pts.shape)
    emb = None
    if appearance_embedding is not None:
        emb = appearance_embedding[..., None, :].expand(
            pts.shape[:-1] + (appearance_embedding.shape[-1],))
    tt = None if t is None else t[..., None, :].expand(pts.shape[:-1] + (t.shape[-1],))
    return model(pts, dirs, emb, tt)


def render_rays(model, cfg: NeRFConfig, rays_o: torch.Tensor, rays_d: torch.Tensor,
                appearance_embedding: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None, n_samples: Optional[int] = None,
                n_importance: Optional[int] = None, perturb: bool = True,
                background_color=None, fused_composite: bool = False,
                generator: Optional[torch.Generator] = None, packed=None,
                draws=None) -> dict:
    """Render a batch of rays.

    Args:
        model: the ``NeRF`` module.
        rays_o, rays_d: (R, 3); directions are normalized here.
        appearance_embedding: optional (R, app_dim); t: optional (R, 1).
        n_samples / n_importance: overrides of cfg (render presets).
        perturb: jitter the stratified bins and the importance uniforms,
            drawn from ``generator``.
        background_color: optional (3,).
        fused_composite: take the kernel route.
        packed: ``pack_params`` output to reuse across calls (kernel route).
        draws: optional (stratified, importance) jitter tensors of U[0,1)
            draws, (R, n_samples) and (R, n_importance), used instead of
            drawing from ``generator``.

    Returns:
        dict rgb (R, 3), depth (R,), acc (R,), weights (R, S_total),
        z_vals (R, S_total), plus coarse_rgb / coarse_depth when a fine pass
        ran.
    """
    if n_samples is None:
        n_samples = cfg.num_samples
    if n_importance is None:
        n_importance = cfg.num_importance

    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near, far = cfg.near, cfg.far
    if cfg.scene_aabb is not None:
        box = cfg.scene_aabb
        near, far = ray_aabb_bounds(rays_o, rays_d, box[:3], box[3:], cfg.near, cfg.far)

    r_strat, r_imp = (generator, generator) if draws is None else draws
    z_coarse, pts = sample_stratified(rays_o, rays_d, near, far, n_samples,
                                      perturb=perturb, rand=r_strat)
    bg = (None if background_color is None
          else torch.as_tensor(background_color, dtype=torch.float32, device=rays_o.device))

    def add_bg(out):
        if bg is not None:
            out["rgb"] = out["rgb"] + (1.0 - out["acc"][..., None]) * bg
        return out

    if fused_composite:
        from danerf_tpu_torch.kernels.fused_render import (
            _prepare, fused_render_rays_coarse_field, fused_render_rays_eval,
            fused_render_rays_merged)

        # pack once for both passes; the module goes along so that, under
        # autograd, the gradients reach its parameters (K3, K6)
        if packed is None:
            packed = _prepare(model, cfg, rays_o, appearance_embedding)[0]
        if n_importance <= 0:
            out = add_bg(fused_render_rays_eval(model, cfg, rays_o, rays_d, z_coarse,
                                                appearance_embedding, t, packed))
            out["z_vals"] = z_coarse
            return out
        coarse = fused_render_rays_coarse_field(model, cfg, rays_o, rays_d, z_coarse,
                                                appearance_embedding, t, packed)
        z_fine = sample_pdf(z_coarse, coarse["weights"].detach(), n_importance,
                            perturb=perturb, rand=r_imp)
        fine = add_bg(fused_render_rays_merged(model, cfg, rays_o, rays_d, z_coarse,
                                               coarse["field"], z_fine.detach(),
                                               appearance_embedding, t, packed))
        fine["coarse_rgb"] = add_bg(coarse)["rgb"]
        fine["coarse_depth"] = coarse["depth"]
        return fine

    rgb, sigma = _eval_field(model, pts, rays_d, appearance_embedding, t)
    coarse = composite(rgb, sigma, z_coarse, bg)
    if n_importance <= 0:
        coarse["z_vals"] = z_coarse
        return coarse

    z_fine = sample_pdf(z_coarse, coarse["weights"].detach(), n_importance,
                        perturb=perturb, rand=r_imp)
    z_all, pts_all = combine_z(rays_o, rays_d, z_coarse, z_fine.detach())
    rgb, sigma = _eval_field(model, pts_all, rays_d, appearance_embedding, t)
    fine = composite(rgb, sigma, z_all, bg)
    fine["z_vals"] = z_all
    fine["coarse_rgb"] = coarse["rgb"]
    fine["coarse_depth"] = coarse["depth"]
    return fine


@torch.no_grad()
def render_frame(model, cfg: NeRFConfig, c2w, height: int, width: int, focal,
                 appearance_embedding=None, n_samples: Optional[int] = None,
                 n_importance: Optional[int] = None, perturb: bool = False,
                 chunk: Optional[int] = None, t=None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
    """Render a (height, width) frame from camera matrix ``c2w``.

    The model and embedding are moved to ``device`` (CUDA unless the caller
    asks for the CPU; CUDA on a host without it raises).  With
    ``cfg.use_kernels`` the chunks take the kernel route, with the weights
    packed once for the frame.  Returns (rgb [H,W,3] in [0,1], depth [H,W],
    acc [H,W]) on ``device``.
    """
    from danerf_tpu_torch.kernels.fused_mlp import pack_params

    dev = resolve_device(device)
    model = model.to(dev)
    if n_samples is None:
        n_samples = cfg.num_samples
    if n_importance is None:
        n_importance = cfg.num_importance
    if chunk is None:
        chunk = cfg.render_chunk
    n_rays = height * width

    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    rays_o, rays_d = generate_rays(height, width, focal, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    emb = None
    if cfg.use_appearance and appearance_embedding is not None:
        emb = torch.as_tensor(appearance_embedding, dtype=torch.float32,
                              device=dev).reshape(1, -1)
    if cfg.use_time and t is None:
        t = 0.0
    bg = (1.0, 1.0, 1.0) if cfg.white_background else None
    packed = (pack_params(model, cfg, appearance=emb is not None)
              if cfg.use_kernels else None)

    rgb, depth, acc = [], [], []
    for start in range(0, n_rays, chunk):
        ro, rd = rays_o[start:start + chunk], rays_d[start:start + chunk]
        n = ro.shape[0]
        e = None if emb is None else emb.expand(n, -1)
        tt = None if t is None else torch.full((n, 1), float(t), device=dev)
        out = render_rays(model, cfg, ro, rd, e, t=tt, n_samples=n_samples,
                          n_importance=n_importance, perturb=perturb,
                          background_color=bg, fused_composite=cfg.use_kernels,
                          generator=generator, packed=packed)
        rgb.append(out["rgb"])
        depth.append(out["depth"])
        acc.append(out["acc"])
    return (torch.cat(rgb).reshape(height, width, 3),
            torch.cat(depth).reshape(height, width),
            torch.cat(acc).reshape(height, width))
