"""Fused ray-march and merged-composite rendering (counterpart of
danerf_tpu/kernels/fused_render.py).

Two kernels, each with a plain PyTorch version of the same function:

- K2, ``csrc/march.cu`` / ``march_plain``: encode o + z*d, run the field and
  composite, per tile of rays; optionally also return the per-sample field
  ``(R, 4, S)`` = [r, g, b, sigma] for the fine pass to reuse.
- K5, ``csrc/merged.cu`` / ``merged_plain``: field at the importance depths
  only, stable rank merge with the coarse samples (coarse first on ties),
  composite over Sc + Sf.

The public functions keep the JAX package's signatures and output layouts.
They dispatch on the device of the rays: CUDA tensors launch the kernel,
CPU tensors take the plain version; nothing falls back from one to the
other.  The route is inference-only (no backward kernel yet): called where autograd
would need gradients of the parameters or embeddings, it raises.

``params`` is the ``NeRF`` module, or its ``pack_params`` output to skip
re-packing per call.  ``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import _build
from danerf_tpu_torch.kernels.fused_mlp import (PackedParams, encode_plain,
                                                field_from_enc_plain,
                                                kernel_meta, pack_params)
from danerf_tpu_torch.ops.composite import composite

LAUNCHES = {"march": 0, "merged": 0}

# Max abs error allowed between a kernel and its plain version on the same
# inputs (field_sigma: relative to max(1, |sigma|)).  Both round to bf16 at the
# same points and sum in f32 in another order, so an activation on a bf16
# rounding boundary can round apart by one ulp; on the H100 that shows as
# ~1e-5 in rgb/acc/weights/depth and ~3e-4 in the per-sample field.  Each
# limit keeps an order of magnitude above that and stays below a typical
# value of what it compares (a weight averages ~0.014 at 64 samples and
# ~0.007 at 128), so a misplaced or missing weight fails.  The merged depths
# are a permutation of the inputs and must match exactly.
PLAIN_TOL = {"rgb": 2e-3, "acc": 2e-3, "weights": 1e-3, "depth": 5e-3,
             "field_rgb": 5e-3, "field_sigma": 5e-3, "z_vals": 0.0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- plain

def _field_at(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, t):
    """Field at depths z (R, S) along each ray: rgb (R, S, 3), sigma (R, S)."""
    r, s = z.shape
    enc_x = encode_plain(o, cfg.pos_enc_levels, d, z)
    if t is not None:
        enc_t = encode_plain(t, cfg.time_enc_levels)
        enc_x = torch.cat([enc_x, enc_t[:, None, :].expand(r, s, -1)], dim=-1)
    enc_d = encode_plain(d, cfg.dir_enc_levels)[:, None, :].expand(r, s, -1)
    emb_f = emb[:, None, :].expand(r, s, -1)
    rgb, sigma = field_from_enc_plain(cfg, enc_x.reshape(r * s, -1),
                                      enc_d.reshape(r * s, -1),
                                      emb_f.reshape(r * s, -1), packed)
    return rgb.view(r, s, 3), sigma.view(r, s)


def march_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, t=None,
                want_field: bool = False) -> dict:
    """Plain version of K2: rgb (R,3), depth, acc (R,), weights (R,S)
    [, field (R,4,S)]."""
    rgb, sigma = _field_at(packed, cfg, o, d, emb, z, t)
    out = composite(rgb, sigma, z)
    if want_field:
        out["field"] = torch.cat([rgb.transpose(1, 2), sigma[:, None, :]], dim=1)
    return out


def merged_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c,
                 field_c, z_f, t=None) -> dict:
    """Plain version of K5: rgb (R,3), depth, acc (R,), weights and z_vals
    (R, Sc+Sf) in merged order."""
    rgb_f, sigma_f = _field_at(packed, cfg, o, d, emb, z_f, t)
    z_all, perm = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1, stable=True)
    rgb_all = torch.gather(torch.cat([field_c[:, :3].transpose(1, 2), rgb_f], dim=1),
                           1, perm[..., None].expand(-1, -1, 3))
    sigma_all = torch.gather(torch.cat([field_c[:, 3], sigma_f], dim=1), 1, perm)
    out = composite(rgb_all, sigma_all, z_all)
    out["z_vals"] = z_all
    return out


# ---------------------------------------------------------------- kernels

def _check_kernel_cfg(cfg: NeRFConfig, t) -> None:
    if not cfg.use_bf16:
        raise NotImplementedError("use_bf16=False is not yet ported to the CUDA kernels")
    if cfg.use_time or t is not None:
        raise NotImplementedError("use_time is not yet ported to the CUDA kernels")


def _f32(x: torch.Tensor, device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, expected {device}")
    return x.to(torch.float32).contiguous()


def _meta(packed: PackedParams, cfg: NeRFConfig):
    m = kernel_meta(packed, cfg)
    return (ctypes.c_longlong * len(m))(*m), len(m)


def _check_packed(packed: PackedParams, device) -> None:
    if packed.device != device or packed.mats.dtype != torch.bfloat16:
        raise ValueError(f"packed params must be bf16 on {device}; got "
                         f"{packed.mats.dtype} on {packed.device}")


def march_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z,
               want_field: bool = False) -> dict:
    """Launch K2 on the current stream; outputs as march_plain's."""
    _check_kernel_cfg(cfg, None)
    dev = z.device
    _check_packed(packed, dev)
    o, d, emb, z = (_f32(x, dev) for x in (o, d, emb, z))
    r, s = z.shape
    lib = _build.load("march")
    rgb = torch.empty(r, 3, device=dev)
    depth = torch.empty(r, device=dev)
    acc = torch.empty(r, device=dev)
    w = torch.empty(r, s, device=dev)
    field = torch.empty(r, 4, s, device=dev) if want_field else None
    meta, n_meta = _meta(packed, cfg)
    code = lib.danerf_march(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z.data_ptr(), r, s, emb.shape[-1],
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), w.data_ptr(),
        None if field is None else field.data_ptr(),
        packed.mats.data_ptr(), packed.vecs.data_ptr(), meta, n_meta,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "march")
    LAUNCHES["march"] += 1
    out = {"rgb": rgb, "depth": depth, "acc": acc, "weights": w}
    if want_field:
        out["field"] = field
    return out


def merged_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c,
                field_c, z_f) -> dict:
    """Launch K5 on the current stream; outputs as merged_plain's."""
    _check_kernel_cfg(cfg, None)
    dev = z_f.device
    _check_packed(packed, dev)
    o, d, emb, z_c, field_c, z_f = (_f32(x, dev) for x in (o, d, emb, z_c, field_c, z_f))
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    if tuple(field_c.shape) != (r, 4, sc):
        raise ValueError(f"field_coarse of shape {tuple(field_c.shape)}, expected {(r, 4, sc)}")
    lib = _build.load("merged")
    rgb = torch.empty(r, 3, device=dev)
    depth = torch.empty(r, device=dev)
    acc = torch.empty(r, device=dev)
    w = torch.empty(r, sc + sf, device=dev)
    z_all = torch.empty(r, sc + sf, device=dev)
    meta, n_meta = _meta(packed, cfg)
    code = lib.danerf_merged(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z_c.data_ptr(), field_c.data_ptr(),
        z_f.data_ptr(), r, sc, sf, emb.shape[-1],
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), w.data_ptr(), z_all.data_ptr(),
        packed.mats.data_ptr(), packed.vecs.data_ptr(), meta, n_meta,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "merged")
    LAUNCHES["merged"] += 1
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": w, "z_vals": z_all}


# ---------------------------------------------------------------- public

def _prepare(params, cfg: NeRFConfig, rays_o, appearance_embedding):
    """(packed, emb) for a call: refuse autograd, pack the module if
    needed, zero embedding when none is given (its projection is packed as
    zeros, matching nerf_apply skipping the term)."""
    grads = torch.is_grad_enabled() and (
        (isinstance(params, torch.nn.Module)
         and any(p.requires_grad for p in params.parameters()))
        or (appearance_embedding is not None and appearance_embedding.requires_grad))
    if grads:
        raise RuntimeError("the fused render route is inference-only (no backward kernel "
                           "yet); call it under torch.no_grad()")
    if isinstance(params, PackedParams):
        packed = params
        if appearance_embedding is None and packed.has_appearance:
            raise ValueError("params were packed with appearance=True but no "
                             "appearance_embedding was given")
    else:
        packed = pack_params(params, cfg, appearance=appearance_embedding is not None,
                             device=rays_o.device)
    r = rays_o.shape[0]
    if appearance_embedding is None:
        emb = torch.zeros(r, cfg.appearance_dim, device=rays_o.device)
    else:
        emb = appearance_embedding.to(torch.float32)
    return packed, emb


def _route(rays_o) -> str:
    if rays_o.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {rays_o.device}")
    return rays_o.device.type


def _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, want_field):
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
    if _route(rays_o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return march_cuda(packed, cfg, rays_o, rays_d, emb, z_vals, want_field)
    return march_plain(packed, cfg, rays_o.float(), rays_d.float(), emb, z_vals.float(),
                       None if t is None else t.float(), want_field)


def fused_render_rays_eval(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                           appearance_embedding=None, t=None) -> dict:
    """Sample -> encode -> MLP -> composite over a ray batch.

    rays_o, rays_d: (R, 3), rays_d unit-norm; z_vals: (R, S) sorted.
    Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, S).
    """
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, False)


def fused_render_rays_coarse_field(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                                   appearance_embedding=None, t=None) -> dict:
    """As fused_render_rays_eval, plus "field": the per-sample
    [r, g, b, sigma] as (R, 4, S) for fused_render_rays_merged."""
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, True)


def fused_render_rays_merged(params, cfg: NeRFConfig, rays_o, rays_d, z_coarse,
                             field_coarse, z_fine, appearance_embedding=None,
                             t=None) -> dict:
    """Hierarchical fine pass without re-evaluating the coarse samples.

    z_coarse (R, Sc) and z_fine (R, Sf) must each be sorted per ray;
    field_coarse is fused_render_rays_coarse_field's (R, 4, Sc) output.
    Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, Sc+Sf) and
    z_vals (R, Sc+Sf) in merged (sorted) order.
    """
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
    if _route(rays_o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return merged_cuda(packed, cfg, rays_o, rays_d, emb, z_coarse, field_coarse, z_fine)
    return merged_plain(packed, cfg, rays_o.float(), rays_d.float(), emb,
                        z_coarse.float(), field_coarse.float(), z_fine.float(),
                        None if t is None else t.float())
