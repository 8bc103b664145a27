"""Sigma -> alpha volume compositing with expected depth (counterpart of
danerf_tpu.ops.composite): 1e-3 tail distance, ``alpha = 1 - exp(-sigma *
dist)``, transmittance = exclusive cumprod of ``1 - alpha + 1e-10``,
``depth = sum(w z) / (sum(w) + 1e-10)``.
"""

from __future__ import annotations

import torch


def composite(rgb, sigma, z_vals, background_color=None):
    """Composite per-sample radiance into per-ray rgb/depth.

    Args:
        rgb: (..., S, 3); sigma: (..., S) or (..., S, 1); z_vals: (..., S).
        background_color: optional (3,) colour behind the ray, weighted by
            the residual transmittance.

    Returns:
        dict rgb (..., 3), depth (...,), acc (...,), weights (..., S).
    """
    if sigma.dim() == rgb.dim():
        sigma = sigma[..., 0]
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e-3)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth_map = torch.sum(weights * z_vals, dim=-1) / (acc + 1e-10)
    if background_color is not None:
        bg = torch.as_tensor(background_color, dtype=rgb_map.dtype,
                             device=rgb_map.device)
        rgb_map = rgb_map + (1.0 - acc[..., None]) * bg
    return {"rgb": rgb_map, "depth": depth_map, "acc": acc, "weights": weights}
