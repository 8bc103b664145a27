"""Fused ray-march, merged-composite and training kernels (counterpart of
danerf_tpu/kernels/fused_render.py).

Four kernels, each with a plain PyTorch version of the same function:

- K2, ``csrc/march.cu`` / ``march_plain``: encode o + z*d, run the field and
  composite, per tile of rays; optionally also return the per-sample field
  ``(R, 4, S)`` = [r, g, b, sigma] for the fine pass to reuse.
- K3, ``csrc/march_bwd.cu`` / ``march_bwd_plain``: the VJP of K2 -- recompute
  the field, transpose the composite, add the field's own cotangent, run the
  transposed MLP; parameter gradients summed over the rays, ``demb`` per ray.
- K4, ``csrc/merged_train.cu`` / ``merged_train_plain``: the hierarchical
  fine pass of training -- field at the importance depths, rank merge,
  composite, the MSE against the target and its whole backward in one call;
  returns the loss, the fine-side gradients, ``demb`` and the coarse field's
  cotangent ``g_field (R, 4, Sc)``.
- K5, ``csrc/merged.cu`` / ``merged_plain``: K4's forward half, for
  rendering: field at the importance depths only, stable rank merge with the
  coarse samples (coarse first on ties), composite over Sc + Sf.

The public functions keep the JAX package's signatures and output layouts.
They dispatch on the device of the rays: CUDA tensors launch the kernel,
CPU tensors take the plain version; nothing falls back from one to the
other.  Gradients reach the module's parameters through two
``torch.autograd.Function``s, never through the packed (detached) copy:
``MarchFn`` (K2 forward, K3 backward) and ``MergedTrainLossFn`` (K4).
``fused_render_rays_merged`` has no backward kernel yet (K6) and raises
under autograd.

``params`` is the ``NeRF`` module, or its ``pack_params`` output to skip
re-packing per call (inference only).  ``LAUNCHES`` counts kernel launches
per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import _build
from danerf_tpu_torch.kernels.fused_mlp import (PackedGrads, PackedParams,
                                                encode_plain, field_bwd_plain,
                                                field_from_enc_plain,
                                                kernel_meta, pack_params,
                                                transposed_mats, unpack_grads)
from danerf_tpu_torch.ops.composite import composite

LAUNCHES = {"march": 0, "merged": 0, "march_bwd": 0, "merged_train": 0}

# Max abs error allowed between a kernel and its plain version on the same
# inputs (field_sigma: relative to max(1, |sigma|)).  Both round to bf16 at the
# same points and sum in f32 in another order, so an activation on a bf16
# rounding boundary can round apart by one ulp; on the H100 that shows as
# ~1e-5 in rgb/acc/weights/depth and ~3e-4 in the per-sample field.  Each
# limit keeps an order of magnitude above that and stays below a typical
# value of what it compares (a weight averages ~0.014 at 64 samples and
# ~0.007 at 128), so a misplaced or missing weight fails.  The merged depths
# are a permutation of the inputs and must match exactly.
#
# The backward kernels (K3, K4): ``grad_rel`` bounds each parameter
# gradient's relative Frobenius error ||g_kernel - g_plain|| / ||g_plain||;
# the rest are max abs errors: K3's demb under O(1) cotangents, and K4's
# demb, g_field and loss, whose cotangents carry the MSE's 2 / (3 R) (so
# demb_k4 and g_field sit near 1e-5 at R = 1024).  Each limit is about 10x
# the error measured on the H100 and far below what a lost or doubled
# block of rays does at 37 rays (PERF.md gives both).
PLAIN_TOL = {"rgb": 2e-3, "acc": 2e-3, "weights": 1e-3, "depth": 5e-3,
             "field_rgb": 5e-3, "field_sigma": 5e-3, "z_vals": 0.0,
             "grad_rel": 6e-2, "demb": 3e-4, "demb_k4": 2e-7, "g_field": 1e-8,
             "loss": 3e-7}


def grad_rel_errors(got: PackedGrads, want: PackedGrads, model) -> dict:
    """{parameter name: ||got - want|| / ||want||}, the measure PLAIN_TOL's
    ``grad_rel`` bounds (parameters whose gradient is zero are skipped)."""
    g, w = unpack_grads(got, model), unpack_grads(want, model)
    return {n: float((g[n].float() - w[n].float()).norm() / w[n].float().norm())
            for n in w if float(w[n].norm()) > 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- plain

def _enc_at(cfg: NeRFConfig, o, d, emb, z, t):
    """Flat per-sample kernel inputs at depths z (R, S): enc_x, enc_d, emb."""
    r, s = z.shape
    enc_x = encode_plain(o, cfg.pos_enc_levels, d, z)
    if t is not None:
        enc_t = encode_plain(t, cfg.time_enc_levels)
        enc_x = torch.cat([enc_x, enc_t[:, None, :].expand(r, s, -1)], dim=-1)
    enc_d = encode_plain(d, cfg.dir_enc_levels)[:, None, :].expand(r, s, -1)
    emb_f = emb[:, None, :].expand(r, s, -1)
    return (enc_x.reshape(r * s, -1), enc_d.reshape(r * s, -1),
            emb_f.reshape(r * s, -1))


def _field_at(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, t):
    """Field at depths z (R, S) along each ray: rgb (R, S, 3), sigma (R, S)."""
    r, s = z.shape
    rgb, sigma = field_from_enc_plain(cfg, *_enc_at(cfg, o, d, emb, z, t), packed)
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


def _merge(z_c, field_c, z_f, rgb_f, sigma_f):
    """Stable merge of the sorted coarse and fine samples (coarse first on
    ties): z_all (R, Sa), rgb (R, Sa, 3), sigma (R, Sa), and the
    permutation ``perm`` (R, Sa) into the concatenation [coarse, fine]."""
    z_all, perm = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1, stable=True)
    rgb_all = torch.gather(torch.cat([field_c[:, :3].transpose(1, 2), rgb_f], dim=1),
                           1, perm[..., None].expand(-1, -1, 3))
    sigma_all = torch.gather(torch.cat([field_c[:, 3], sigma_f], dim=1), 1, perm)
    return z_all, rgb_all, sigma_all, perm


def merged_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c,
                 field_c, z_f, t=None) -> dict:
    """Plain version of K5: rgb (R,3), depth, acc (R,), weights and z_vals
    (R, Sc+Sf) in merged order."""
    rgb_f, sigma_f = _field_at(packed, cfg, o, d, emb, z_f, t)
    z_all, rgb_all, sigma_all, _ = _merge(z_c, field_c, z_f, rgb_f, sigma_f)
    out = composite(rgb_all, sigma_all, z_all)
    out["z_vals"] = z_all
    return out


def composite_bwd_plain(g_rgbmap, g_depth, g_acc, g_w_in, rgb, sigma, z):
    """Transpose of ``composite`` (``_composite_bwd_lanes``): given the
    cotangents of rgb (R,3), depth, acc (R,) and weights (R,S), returns
    (g_rgb (R,S,3), g_sigma (R,S)).

    g_w = g_w_in + g_rgbmap . rgb_s + g_depth (z_s - depth)/(acc + 1e-10) + g_acc;
    g_alpha = g_w T - (sum_{s' > s} g_w alpha T) / (1 - alpha + 1e-10);
    g_sigma = g_alpha (1 - alpha) dist; g_rgb_s = w_s g_rgbmap.
    """
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e-3)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    w = alpha * trans
    acc = w.sum(-1)
    depth = (w * z).sum(-1) / (acc + 1e-10)
    g_w = (g_w_in + (g_rgbmap[:, None, :] * rgb).sum(-1)
           + g_depth[:, None] * (z - depth[:, None]) / (acc[:, None] + 1e-10)
           + g_acc[:, None])
    u = g_w * alpha * trans
    after = torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1]) - u
    g_alpha = g_w * trans - after / (1.0 - alpha + 1e-10)
    return w[..., None] * g_rgbmap[:, None, :], g_alpha * (1.0 - alpha) * dists


def march_bwd_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, g_rgb, g_depth,
                    g_acc, g_w, g_field=None, t=None):
    """Plain version of K3, the VJP of K2: recompute the field at z, run the
    composite's transpose, add ``g_field`` (R,4,S) when given, run the
    transposed MLP.  Returns (PackedGrads summed over the rays, demb (R,E))."""
    r, s = z.shape
    enc_x, enc_d, emb_f = _enc_at(cfg, o, d, emb, z, t)
    rgb, sigma, res = field_from_enc_plain(cfg, enc_x, enc_d, emb_f, packed, want_res=True)
    g_rgb_s, g_sig_s = composite_bwd_plain(g_rgb, g_depth, g_acc, g_w, rgb.view(r, s, 3),
                                           sigma.view(r, s), z)
    if g_field is not None:
        g_rgb_s = g_rgb_s + g_field[:, :3].transpose(1, 2)
        g_sig_s = g_sig_s + g_field[:, 3]
    grads, demb = field_bwd_plain(cfg, packed, res, emb_f, g_rgb_s.reshape(r * s, 3),
                                  g_sig_s.reshape(r * s, 1))
    return grads, demb.view(r, s, -1).sum(1)


def merged_train_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                       target, t=None):
    """Plain version of K4: fine field at z_f, stable merge, composite, the
    MSE against ``target`` over the R rays, and its backward.

    Returns (mse, PackedGrads of the fine side, demb (R,E), g_field
    (R,4,Sc)), the cotangent of the coarse field for the coarse VJP."""
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    enc_x, enc_d, emb_f = _enc_at(cfg, o, d, emb, z_f, t)
    rgb_f, sigma_f, res = field_from_enc_plain(cfg, enc_x, enc_d, emb_f, packed, want_res=True)
    z_all, rgb_all, sigma_all, perm = _merge(z_c, field_c, z_f, rgb_f.view(r, sf, 3),
                                             sigma_f.view(r, sf))
    rgb_map = composite(rgb_all, sigma_all, z_all)["rgb"]
    inv_denom = 1.0 / (r * 3.0)
    diff = rgb_map - target
    mse = (diff * diff).sum() * inv_denom
    zero = torch.zeros(r, device=z_c.device)
    g_rgb_all, g_sig_all = composite_bwd_plain(2.0 * inv_denom * diff, zero, zero,
                                               torch.zeros_like(z_all), rgb_all, sigma_all,
                                               z_all)
    # un-permute: the inverse of the merge's gather
    g_rgb_cat = torch.zeros_like(g_rgb_all).scatter_(1, perm[..., None].expand(-1, -1, 3),
                                                     g_rgb_all)
    g_sig_cat = torch.zeros_like(g_sig_all).scatter_(1, perm, g_sig_all)
    g_field = torch.cat([g_rgb_cat[:, :sc].transpose(1, 2), g_sig_cat[:, None, :sc]], dim=1)
    grads, demb = field_bwd_plain(cfg, packed, res, emb_f, g_rgb_cat[:, sc:].reshape(-1, 3),
                                  g_sig_cat[:, sc:].reshape(-1, 1))
    return mse, grads, demb.view(r, sf, -1).sum(1), g_field


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


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


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
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), w.data_ptr(), _ptr(field),
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


def _bwd_common(lib, packed: PackedParams, cfg: NeRFConfig, r: int, s_tile: int, dev):
    """Shared set-up of the backward launches: layout records, the
    transposed weights, the zeroed gradient buffers and the scratch that
    holds the residuals of one pass (sized by the library)."""
    meta, n_meta = _meta(packed, cfg)
    mats_t, offs_t = transposed_mats(packed, cfg)
    meta_t = (ctypes.c_longlong * len(offs_t))(*offs_t)
    n_vecs = packed.vecs.numel()
    nbytes = lib.danerf_bwd_scratch_bytes(meta, n_meta, r, s_tile, n_vecs)
    if nbytes < 0:
        _build.check(lib, int(nbytes), "backward scratch size")
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    grads = PackedGrads.zeros(packed)
    return (meta, n_meta, mats_t, meta_t, len(offs_t), scratch, n_vecs, grads)


def march_bwd_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, g_rgb, g_depth,
                   g_acc, g_w, g_field=None):
    """Launch K3 on the current stream; outputs as march_bwd_plain's."""
    _check_kernel_cfg(cfg, None)
    dev = z.device
    _check_packed(packed, dev)
    o, d, emb, z, g_rgb, g_depth, g_acc, g_w = (
        _f32(x, dev) for x in (o, d, emb, z, g_rgb, g_depth, g_acc, g_w))
    r, s = z.shape
    if g_field is not None:
        g_field = _f32(g_field, dev)
        if tuple(g_field.shape) != (r, 4, s):
            raise ValueError(f"g_field of shape {tuple(g_field.shape)}, expected {(r, 4, s)}")
    lib = _build.load("march_bwd")
    meta, n_meta, mats_t, meta_t, n_meta_t, scratch, n_vecs, grads = _bwd_common(
        lib, packed, cfg, r, s, dev)
    demb = torch.empty(r, emb.shape[-1], device=dev)
    code = lib.danerf_march_bwd(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z.data_ptr(), r, s, emb.shape[-1],
        g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(), g_w.data_ptr(),
        _ptr(g_field), grads.mats.data_ptr(), grads.vecs.data_ptr(), demb.data_ptr(),
        packed.mats.data_ptr(), packed.vecs.data_ptr(), meta, n_meta,
        mats_t.data_ptr(), meta_t, n_meta_t, scratch.data_ptr(), scratch.numel(), n_vecs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "march_bwd")
    LAUNCHES["march_bwd"] += 1
    return grads, demb


def merged_train_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                      target):
    """Launch K4 on the current stream; outputs as merged_train_plain's."""
    _check_kernel_cfg(cfg, None)
    dev = z_f.device
    _check_packed(packed, dev)
    o, d, emb, z_c, field_c, z_f, target = (
        _f32(x, dev) for x in (o, d, emb, z_c, field_c, z_f, target))
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    if tuple(field_c.shape) != (r, 4, sc):
        raise ValueError(f"field_coarse of shape {tuple(field_c.shape)}, expected {(r, 4, sc)}")
    lib = _build.load("merged_train")
    meta, n_meta, mats_t, meta_t, n_meta_t, scratch, n_vecs, grads = _bwd_common(
        lib, packed, cfg, r, sf, dev)
    demb = torch.empty(r, emb.shape[-1], device=dev)
    g_field = torch.empty(r, 4, sc, device=dev)
    loss = torch.zeros((), device=dev)
    code = lib.danerf_merged_train(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z_c.data_ptr(), field_c.data_ptr(),
        z_f.data_ptr(), target.data_ptr(), r, sc, sf, emb.shape[-1],
        grads.mats.data_ptr(), grads.vecs.data_ptr(), demb.data_ptr(), g_field.data_ptr(),
        loss.data_ptr(), packed.mats.data_ptr(), packed.vecs.data_ptr(), meta, n_meta,
        mats_t.data_ptr(), meta_t, n_meta_t, scratch.data_ptr(), scratch.numel(), n_vecs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "merged_train")
    LAUNCHES["merged_train"] += 1
    return loss, grads, demb, g_field


# ---------------------------------------------------------------- routes

def _route(rays_o) -> str:
    if rays_o.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {rays_o.device}")
    return rays_o.device.type


def _march_fwd(packed, cfg, o, d, emb, z, t, want_field):
    if _route(o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return march_cuda(packed, cfg, o, d, emb, z, want_field)
    return march_plain(packed, cfg, o.float(), d.float(), emb, z.float(),
                       None if t is None else t.float(), want_field)


def _march_bwd(packed, cfg, o, d, emb, z, t, cot):
    if _route(o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return march_bwd_cuda(packed, cfg, o, d, emb, z, *cot)
    return march_bwd_plain(packed, cfg, o.float(), d.float(), emb, z.float(), *cot,
                           t=None if t is None else t.float())


def _merged_train(packed, cfg, o, d, emb, z_c, field_c, z_f, target, t):
    if _route(o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return merged_train_cuda(packed, cfg, o, d, emb, z_c, field_c, z_f, target)
    return merged_train_plain(packed, cfg, o.float(), d.float(), emb, z_c.float(),
                              field_c.float(), z_f.float(), target.float(),
                              None if t is None else t.float())


class MarchFn(torch.autograd.Function):
    """K2 forward, K3 backward.  The module's parameters are explicit
    inputs (``*params``, in ``model.named_parameters()`` order with their
    ``names``) so that autograd routes the gradients to them; ``packed`` is
    the detached kernel copy of the same weights.  Outputs rgb, depth, acc,
    weights [, field]; the rays, z and t are data and get no gradient."""

    @staticmethod
    def forward(ctx, cfg, packed, names, want_field, o, d, emb, z, t, *params):
        out = _march_fwd(packed, cfg, o, d, emb, z, t, want_field)
        ctx.cfg, ctx.packed, ctx.names, ctx.want_field = cfg, packed, names, want_field
        ctx.save_for_backward(o, d, emb, z, t, *params)
        keys = ("rgb", "depth", "acc", "weights") + (("field",) if want_field else ())
        return tuple(out[k] for k in keys)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_w, g_field=None):
        o, d, emb, z, t, *params = ctx.saved_tensors
        cot = (g_rgb, g_depth, g_acc, g_w, g_field if ctx.want_field else None)
        grads, demb = _march_bwd(ctx.packed, ctx.cfg, o, d, emb, z, t, cot)
        by_name = unpack_grads(grads, zip(ctx.names, params))
        return (None, None, None, None, None, None, demb, None, None,
                *(by_name[n] for n in ctx.names))


class MergedTrainLossFn(torch.autograd.Function):
    """K4: the fine MSE of hierarchical training.  ``forward`` runs the
    kernel, which computes the loss and all of its gradients in one pass
    (the merged forward is never recomputed), returns the loss and keeps
    the gradients; ``backward(g)`` hands out g times them for the
    parameters, ``emb`` and the coarse field ``field_c``."""

    @staticmethod
    def forward(ctx, cfg, packed, names, o, d, emb, z_c, field_c, z_f, target, t, *params):
        mse, grads, demb, g_field = _merged_train(packed, cfg, o, d, emb, z_c, field_c, z_f,
                                                  target, t)
        ctx.names = names
        ctx.grads = unpack_grads(grads, zip(names, params))
        ctx.demb, ctx.g_field = demb, g_field
        return mse

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, None, None, g * ctx.demb, None, g * ctx.g_field, None,
                None, None, *(g * ctx.grads[n] for n in ctx.names))


def module_params(model):
    """(names, tensors) of the module's parameters, as MarchFn and
    MergedTrainLossFn take them."""
    named = list(model.named_parameters())
    return tuple(n for n, _ in named), tuple(p for _, p in named)


# ---------------------------------------------------------------- public

def _needs_grad(params, emb) -> bool:
    return torch.is_grad_enabled() and (
        (isinstance(params, torch.nn.Module)
         and any(p.requires_grad for p in params.parameters()))
        or (emb is not None and emb.requires_grad))


def _prepare(params, cfg: NeRFConfig, rays_o, appearance_embedding):
    """(packed, emb) for a call: pack the module if needed, zero embedding
    when none is given (its projection is packed as zeros, matching
    nerf_apply skipping the term)."""
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


def _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, want_field):
    if not _needs_grad(params, appearance_embedding):
        packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
        return _march_fwd(packed, cfg, rays_o, rays_d, emb, z_vals, t, want_field)
    if not isinstance(params, torch.nn.Module):
        raise ValueError("differentiating the march needs the NeRF module, not packed params")
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
    names, tensors = module_params(params)
    outs = MarchFn.apply(cfg, packed, names, want_field, rays_o, rays_d, emb, z_vals, t,
                         *tensors)
    keys = ("rgb", "depth", "acc", "weights") + (("field",) if want_field else ())
    return dict(zip(keys, outs))


def fused_render_rays_eval(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                           appearance_embedding=None, t=None) -> dict:
    """Sample -> encode -> MLP -> composite over a ray batch.

    rays_o, rays_d: (R, 3), rays_d unit-norm; z_vals: (R, S) sorted.
    Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, S).
    Differentiable in the module's parameters and the embedding (K3).
    """
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, False)


def fused_render_rays_coarse_field(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                                   appearance_embedding=None, t=None) -> dict:
    """As fused_render_rays_eval, plus "field": the per-sample
    [r, g, b, sigma] as (R, 4, S) for fused_render_rays_merged.
    Differentiable; the field's cotangent flows back through K3 too."""
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, True)


def fused_render_rays_merged(params, cfg: NeRFConfig, rays_o, rays_d, z_coarse,
                             field_coarse, z_fine, appearance_embedding=None,
                             t=None) -> dict:
    """Hierarchical fine pass without re-evaluating the coarse samples.

    z_coarse (R, Sc) and z_fine (R, Sf) must each be sorted per ray;
    field_coarse is fused_render_rays_coarse_field's (R, 4, Sc) output.
    Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, Sc+Sf) and
    z_vals (R, Sc+Sf) in merged (sorted) order.  Inference only: its
    backward is kernel K6 (``_merged_bwd_kernel``), not yet ported.
    """
    if _needs_grad(params, appearance_embedding) or (
            torch.is_grad_enabled() and field_coarse.requires_grad):
        raise RuntimeError("fused_render_rays_merged has no backward yet (kernel K6, "
                           "_merged_bwd_kernel, is not yet ported); call it under "
                           "torch.no_grad(), or train through fused_hier_train_loss_grads")
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
    if _route(rays_o) == "cuda":
        _check_kernel_cfg(cfg, t)
        return merged_cuda(packed, cfg, rays_o, rays_d, emb, z_coarse, field_coarse, z_fine)
    return merged_plain(packed, cfg, rays_o.float(), rays_d.float(), emb,
                        z_coarse.float(), field_coarse.float(), z_fine.float(),
                        None if t is None else t.float())


def fused_hier_train_loss_grads(params, cfg: NeRFConfig, rays_o, rays_d, z_coarse,
                                field_coarse, z_fine, target, appearance_embedding=None,
                                t=None):
    """Single-pass fine stage of hierarchical training (K4).

    Returns (mse_fine, {parameter name: fine-side gradient}, demb (R,E),
    g_field (R,4,Sc)); the caller feeds ``g_field`` (plus the coarse rgb
    loss cotangent) to the coarse pass's VJP so that the total gradient is
    that of mse(merged) + w * mse(coarse).  ``params`` is the module.
    """
    with torch.no_grad():
        packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
        mse, grads, demb, g_field = _merged_train(packed, cfg, rays_o, rays_d, emb, z_coarse,
                                                  field_coarse, z_fine, target, t)
    return mse, unpack_grads(grads, params), demb, g_field
