"""Point sampling along rays (counterpart of danerf_tpu.ops.sampling):
stratified bins and inverse-CDF importance sampling.

Random draws come from an explicit ``torch.Generator`` or are passed in as
tensors; the tests pass in JAX's own draws so both packages see the same
numbers.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from danerf_tpu_torch.ops.composite import device_vector

Rand = Union[torch.Tensor, torch.Generator, None]


def _uniform(rand: Rand, shape, like: torch.Tensor) -> torch.Tensor:
    """U[0,1) of ``shape``: the given tensor, or a draw from the generator."""
    if isinstance(rand, torch.Tensor):
        if tuple(rand.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(rand.shape)}, expected {tuple(shape)}")
        return rand.to(device=like.device, dtype=like.dtype)
    return torch.rand(shape, generator=rand, device=like.device, dtype=like.dtype)


def ray_aabb_bounds(rays_o, rays_d, aabb_min, aabb_max, near, far):
    """Tighten per-ray [near, far] to the ray's overlap with an axis-aligned
    box (slab method).  Misses park in a thin band at the far plane so the
    sample count stays fixed.  Returns t_near, t_far of shape (..., 1)."""
    aabb_min = device_vector(aabb_min, rays_o, rays_o.dtype)
    aabb_max = device_vector(aabb_max, rays_o, rays_o.dtype)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-10,
                              torch.full_like(rays_d, 1e-10), rays_d)
    t0 = (aabb_min - rays_o) * inv_d
    t1 = (aabb_max - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    t_far = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    hit = t_far > t_near.clamp_min(0.0)
    t_near = t_near.clamp(near, far)
    t_far = t_far.clamp(near, far)
    t_near = torch.where(hit, t_near, torch.full_like(t_near, far - 1e-3))
    t_far = torch.where(hit, torch.maximum(t_far, t_near + 1e-4),
                        torch.full_like(t_far, far))
    return t_near, t_far


def sample_stratified(rays_o, rays_d, near, far, n_samples: int,
                      perturb: bool = True, rand: Rand = None):
    """``n_samples`` depths per ray in [near, far], jittered within their bins
    when ``perturb``.

    Args:
        near, far: scalars or (..., 1) per-ray bounds.
        rand: the jitter: a (..., n_samples) tensor of U[0,1) draws, or a
            ``torch.Generator`` to draw it from.

    Returns:
        z_vals (..., n_samples); pts (..., n_samples, 3).
    """
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                            device=rays_o.device)
    z_vals = near + t_vals * (far - near)
    z_vals = torch.broadcast_to(z_vals, rays_o.shape[:-1] + (n_samples,))
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * _uniform(rand, z_vals.shape, z_vals)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return z_vals, pts


def importance_uniforms(batch_shape, n_importance: int, perturb: bool = True,
                        rand: Rand = None, dtype=torch.float32, device=None):
    """The stratified uniforms ``u`` that sample_pdf inverts the CDF at:
    strictly increasing along the last axis, so sample_pdf's output is
    sorted."""
    u = torch.linspace(0.0, 1.0, n_importance + 1, dtype=dtype, device=device)[:-1]
    u = torch.broadcast_to(u, tuple(batch_shape) + (n_importance,))
    if perturb:
        return u + _uniform(rand, u.shape, u) / n_importance
    return u + 0.5 / n_importance


def sample_pdf(z_vals, weights, n_importance: int, perturb: bool = True,
               u: Optional[torch.Tensor] = None, rand: Rand = None):
    """Inverse-CDF importance sampling of new depths.

    Bracketing follows the JAX package exactly: the index is
    ``searchsorted(cdf, u, right=False)``; ``cdf_above`` is +max-float when u
    lies past the last CDF value, ``z_above`` is clamped into range, and a
    bracket narrower than 1e-5 gets a denominator of 1.

    Args:
        z_vals: (..., n) coarse depths (sorted); weights: (..., n).
        u: optional pre-drawn (..., n_importance) uniforms (overrides
            ``perturb``/``rand``).

    Returns:
        z_fine: (..., n_importance), sorted when u is increasing.
    """
    dtype = z_vals.dtype
    weights = weights + 1e-5
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(weights, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()

    if u is None:
        u = importance_uniforms(cdf.shape[:-1], n_importance, perturb, rand,
                                dtype, z_vals.device)
    u = u.to(dtype).contiguous()

    n_cdf = cdf.shape[-1]
    n_z = z_vals.shape[-1]
    inds = torch.searchsorted(cdf, u, right=False)          # #{cdf < u}
    big = torch.finfo(dtype).max
    cdf_below = torch.gather(cdf, -1, (inds - 1).clamp_min(0))
    cdf_above = torch.where(inds < n_cdf,
                            torch.gather(cdf, -1, inds.clamp_max(n_cdf - 1)),
                            torch.full_like(u, big))
    z_below = torch.gather(z_vals, -1, (inds.clamp_max(n_z) - 1).clamp_min(0))
    z_above = torch.gather(z_vals, -1, inds.clamp_max(n_z - 1))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return z_below + t * (z_above - z_below)


def combine_z(rays_o, rays_d, z_coarse, z_fine):
    """Merge coarse + fine depths, sort, and return positions."""
    z_combined, _ = torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_combined[..., :, None]
    return z_combined, pts
