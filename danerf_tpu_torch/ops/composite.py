"""Sigma -> alpha volume compositing with expected depth (counterpart of
danerf_tpu.ops.composite): 1e-3 tail distance, ``alpha = 1 - exp(-sigma *
dist)``, transmittance = exclusive cumprod of ``1 - alpha + 1e-10``,
``depth = sum(w z) / (sum(w) + 1e-10)``.
"""

from __future__ import annotations

import torch


def device_vector(values, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A short vector (a colour, a box corner) as a ``dtype`` tensor on
    ``like``'s device, made by fills on that device: ``torch.as_tensor`` of a
    tuple copies from the host, which a captured training step may not do.
    A tensor is moved as it is."""
    if isinstance(values, torch.Tensor):
        return values.to(device=like.device, dtype=dtype)
    return torch.stack([like.new_full((), float(v), dtype=dtype) for v in values])


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis for factors that are never 0.
    Its gradient is ``torch.cumprod``'s for such factors, the reversed
    cumulative sum of output x grad over the input, but without the test for
    a zero factor that ``torch.cumprod``'s backward makes with a host sync,
    which a captured training step may not do."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


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
    # every factor is >= 1e-10: alpha lies in [0, 1]
    trans = _PositiveCumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1))[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth_map = torch.sum(weights * z_vals, dim=-1) / (acc + 1e-10)
    if background_color is not None:
        bg = device_vector(background_color, rgb_map, rgb_map.dtype)
        rgb_map = rgb_map + (1.0 - acc[..., None]) * bg
    return {"rgb": rgb_map, "depth": depth_map, "acc": acc, "weights": weights}
