"""Fused ray-march, merged-composite and training kernels (counterpart of
danerf_tpu/kernels/fused_render.py).

Seven kernels, each with a plain PyTorch version of the same function:

- K2, ``csrc/march.cu`` / ``march_plain``: encode o + z*d, run the field and
  composite, per tile of rays; optionally also return the per-sample field
  ``(R, 4, S)`` = [r, g, b, sigma] for the fine pass to reuse.
- K3, ``csrc/march_bwd.cu`` / ``march_bwd_plain``: the VJP of K2 -- recompute
  the field, transpose the composite, add the field's own cotangent, run the
  transposed MLP; parameter gradients summed over the rays, ``demb`` per ray.
- K7, ``csrc/march_train.cu`` / ``march_train_plain``: coarse-only training
  -- K2's march, the MSE against the target and K3's backward in one call;
  returns the loss, the gradients and ``demb``.
- K5, ``csrc/merged.cu`` / ``merged_plain``: the hierarchical fine pass for
  rendering: field at the importance depths only, stable rank merge with
  the coarse samples (coarse first on ties), composite over Sc + Sf.
- K6, ``csrc/merged_bwd.cu`` / ``merged_bwd_plain``: the VJP of K5 --
  recompute the fine field and the merge, transpose the composite under
  the cotangents of rgb, depth, acc and the merged weights, un-permute to
  the coarse field's cotangent ``g_field (R, 4, Sc)`` and the fine rows, run
  their transposed MLP.
- K4, ``csrc/merged_train.cu`` / ``merged_train_plain``: the hierarchical
  fine pass of training -- K5's forward, the MSE against the target and
  K6's backward in one call; returns the loss, the fine-side gradients,
  ``demb`` and ``g_field``.
- K2 and K5 in f32 (``use_bf16=False``): ``csrc/march_f32.cu`` and
  ``csrc/merged_f32.cu`` on ``csrc/field_f32_sm90.cuh``'s tensor-core tile,
  the same functions with every product formed to f32 accuracy by 3xTF32
  (the operands split into TF32 halves, ``fused_mlp.split_tf32``);
  ``march_cuda`` and ``merged_cuda`` launch them when ``cfg.use_bf16`` is
  off (held to ``PLAIN_TOL_F32``).
- K3, K7, K4 and K6 in f32: ``csrc/march_bwd_f32.cu``,
  ``csrc/march_train_f32.cu``, ``csrc/merged_train_f32.cu`` and
  ``csrc/merged_bwd_f32.cu`` on ``csrc/field_bwd_f32_sm90.cuh``'s
  tensor-core tile (3xTF32 products on the relu gates of an f32 gate
  pass); ``march_bwd_cuda``, ``march_train_cuda``,
  ``merged_train_cuda`` and ``merged_bwd_cuda`` launch them when
  ``cfg.use_bf16`` is off (held to ``PLAIN_TOL_F32_BWD``); so does
  ``hier_onepass_cuda`` with K9's, ``csrc/hier_onepass_f32.cu``, on the
  tensor-core tile too (its coarse and fine row sets in launches of their
  own, each row set's gates from its own gate pass).
- K9, ``csrc/hier_onepass.cu`` / ``hier_onepass_plain``: the whole
  hierarchical training step in one call -- K2's march at the coarse depths
  keeping its field and residuals, the inverse CDF of its weights at the
  given uniforms ``u``, K4's fine pass with the fine MSE, and the backward
  of both passes, the coarse one on the kept residuals (no recompute);
  returns both MSEs, the gradients of mse_f + coarse_loss_weight x mse_c
  and ``demb``.

The public functions keep the JAX package's signatures and output layouts.
They dispatch on the device of the rays: CUDA tensors launch the kernel,
CPU tensors take the plain version; nothing falls back from one to the
other.  With ``cfg.use_time`` each takes the rays' times ``t`` (R, 1) and
launches its kernel's has_time variant: the encoded time joins the encoded
position at the first layer and at each skip (``csrc/field.cuh``); the
time gets no gradient, as in the JAX package.  Gradients reach the
module's parameters through ``torch.autograd.Function``s, never through
the packed (detached) copy:
``MarchFn`` (K2 forward, K3 backward), ``MergedFn`` (K5 forward, K6
backward), and the one-pass losses ``MarchTrainLossFn`` (K7),
``MergedTrainLossFn`` (K4) and ``HierOnepassLossFn`` (K9).

``params`` is the ``NeRF`` module, or its ``pack_params`` output to skip
re-packing per call (inference only; the differentiable calls take the
module and, optionally, ``packed``).  ``LAUNCHES`` counts kernel launches
per kernel, these seven and K1/K8 (``fused_mlp``, where it lives with the
launch helpers these wrappers share).
"""

from __future__ import annotations

from typing import Optional

import torch

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import _build
# LAUNCHES, reset_launch_counts and module_params are also used from here
from danerf_tpu_torch.kernels.fused_mlp import (  # noqa: F401
    LAUNCHES, PackedGrads, PackedParams, _arg, _check_packed, _check_time, _f32,
    _f32_opt, _launch_bwd, _meta, _route, _rows_f32, _time_arg, encode_plain, field_bwd_plain,
    field_from_enc_plain, fwd_weights, module_params, pack_params, reset_launch_counts,
    unpack_grads)
from danerf_tpu_torch.ops.composite import composite
from danerf_tpu_torch.ops.sampling import sample_pdf

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
# The backward kernels (K3, K4, K6, K7): ``grad_rel`` bounds each parameter
# gradient's relative Frobenius error ||g_kernel - g_plain|| / ||g_plain||;
# the rest are max abs errors: demb under O(1) cotangents (K3, K6), K6's
# g_field under O(1) cotangents (values up to ~0.3), and the demb, g_field
# and loss of the one-pass losses, whose cotangents carry the MSE's
# 2 / (3 R) (demb_k4 for K4 and K7, g_field for K4: values near 1e-5 at
# R = 1024).  Each limit is about 10x the error measured on the H100 and
# far below what a lost or doubled block of rays does at 37 rays (PERF.md
# gives both).
#
# K1 (the per-sample field) is held to field_rgb / field_sigma, as K2's
# field output.  K8: grad_rel, and demb_k8 for its per-row demb under O(1)
# cotangents (values up to ~0.2): a row whose bf16(d_pre_rgb) or
# bf16(d_happ) rounds apart between the two sum orders moves its demb by
# ~1e-4, and at 131,072 rows some do (2.6e-4 measured; 4e-8 at 2,400
# rows), how many depending on the data, so the limit is 4e-3, still ~30x
# below the demb of a lost tile (~0.13).
#
# K9 (the one-kernel step): grad_rel, and loss_k9 for each of its two MSEs,
# demb_k9 for its demb.  Beyond K4's roundings, K9 inverts the CDF of its
# own coarse weights, which differ from the plain version's by ~1e-5 (the
# bf16 field, as K2's weights do), so its importance depths and with them
# the fine MSE move a little further: 8.9e-8 in a loss and 5.7e-8 in demb at
# 37 rays on the H100, hence 1e-6 and 6e-7; two lost rays of a CTA at 37
# rays move a loss by ~5e-3 and leave out demb values of ~1e-3.
PLAIN_TOL = {"rgb": 2e-3, "acc": 2e-3, "weights": 1e-3, "depth": 5e-3,
             "field_rgb": 5e-3, "field_sigma": 5e-3, "z_vals": 0.0,
             "grad_rel": 6e-2, "demb": 3e-4, "demb_k4": 2e-7, "g_field": 1e-8,
             "g_field_k6": 1e-5, "loss": 3e-7, "demb_k8": 4e-3, "loss_k9": 1e-6,
             "demb_k9": 6e-7}

# The f32 variants of K2, K5 and K1 (use_bf16=False, csrc/field_f32.cuh)
# against their plain versions in f32 on the same inputs, with TF32 off on
# the card (torch.backends.cuda.matmul.allow_tf32 = False: the plain
# version's matmuls in full f32).  Nothing rounds below f32 in either; the
# sums run in another order (one FFMA chain a thread over K, against the
# library's blocked products), ~1 ulp a sum: on the H100 at every shape up
# to a 65,536-ray chunk and 131,072 rows, with and without time, rgb 4.5e-7,
# acc 8.9e-7, weights 1.2e-7, depth 1.2e-6 (divided by acc), the field's rgb
# 2.4e-7 and sigma 6e-8.  Each limit is 5-17x that, and the bf16 kernels'
# errors against the same f32 plain outputs pass the rgb, depth and field
# limits at every shape (at least 2.2e-5, 2.3e-5 and 8.3e-5), so a tile that
# rounds to bf16 anywhere fails (chip_smoke.py also asks the f32 error to
# be 16x below the bf16 kernel's: F32_GAIN).
PLAIN_TOL_F32 = {"rgb": 3e-6, "acc": 5e-6, "weights": 1e-6, "depth": 1e-5,
                 "field_rgb": 3e-6, "field_sigma": 1e-6, "z_vals": 0.0}

# The f32 variants of K3, K4, K6 and K7 (use_bf16=False,
# csrc/field_bwd_f32_sm90.cuh: 3xTF32 products on the relu gates of an f32
# gate pass) against their plain versions in f32 on the same inputs, TF32
# off on the card; keys as PLAIN_TOL's.  Nothing rounds below f32 in either
# (3xTF32 keeps each product to ~2^-22): the gradients differ by the order
# of their f32 sums (over up to 65,536 rows here) and by the forward's
# ~1-ulp differences (PLAIN_TOL_F32), which a relu gate or the composite
# can carry into a row's cotangents.  Expected: each gradient's relative Frobenius error
# near 1e-6 (limit 1e-4), demb under O(1) cotangents (values up to ~1) near
# 1e-7 (1e-5), K6's g_field (values up to ~0.3) near 3e-8 (3e-6); under the
# MSE's 2 / (3 R) (values near 1e-5 at R = 1024, 1e-3 at 37 rays) demb and
# g_field near 1e-11 (3e-9) and the loss (~0.1) near 1e-8 (1e-7).  Each
# limit is ~100x that, set before the kernels first ran on the card; the
# bf16 kernels' errors against the same f32 plain outputs (grad_rel ~1e-3 to
# 1e-2, PLAIN_TOL) stay far above them, and chip_smoke.py asks each f32
# kernel's error to be F32_GAIN (16) times below the bf16 kernel's.  On the
# H100 the four sat on their first, FFMA tile at grad_rel 6e-7 to 1.3e-5,
# demb 7.5e-8, K6's g_field 8.1e-8, demb and g_field under the MSE 1.1e-10,
# the loss 1.5e-8; on the 3xTF32 tile (the tensor cores' truncating sums)
# K3 and K4 at grad_rel 1.3e-5 to 8.6e-5, K6 and K7 at 1.2e-5 to 2.0e-5,
# K6's demb 4.5e-8 and g_field 1.4e-7, K7's demb 2.3e-10 and loss 6.7e-8.
# One thing the limits do not cover: a relu gate whose pre-activation is within
# an f32 rounding of 0 flips between two f32 evaluations of the same
# function, and moves a 37-ray batch's gradients by up to ~5e-3 (the time
# model at 37 rays on the H100: the plain version on the card against the
# plain version on the CPU, 2.4e-4 to 4.8e-3 in five cases, where the kernel
# is 0.9e-6 to 1.9e-6 from the CPU's).  So where a kernel's gradients are off
# the card's plain version by more than grad_rel, it is held to the plain
# version on the CPU (another summation order) instead, and both gaps are
# reported (chip_smoke.py cpu_referee, tests/test_torch_cuda.py _held32).
#
# step_grad_rel: a whole f32 training step through the kernels against the
# same step through the plain versions.  On the hierarchical paths each
# route draws its importance depths from its own coarse weights, which are
# an f32 rounding apart (PLAIN_TOL_F32's weights), and the first layer's
# gradient, over the encoding's 2^9 columns, moves with them: 4.9e-4 to
# 1.9e-3 on the H100 (64 + 64, white background, use_time; coarse-only, which
# draws none, 3.6e-7).  1e-2 keeps 5x above that; the bf16 kernels against
# the same f32 plain outputs sit at 2e-2 to 1.4e-1.
#
# K8's f32 variant takes grad_rel and demb (its per-row demb under O(1)
# cotangents, values up to ~0.17): on the H100 5.7e-7 to 1.1e-5 and up to
# 8.9e-8 from 37 to 131,072 rows, with and without time.  K9's f32 variant
# takes loss for both MSEs (up to 1.5e-8) and demb_k4 for its demb under
# the MSE's 2 / (3R) (up to 6.4e-10), but its gradients grad_rel_k9: like
# the f32 hierarchical step, it draws its importance depths from its own
# f32 coarse weights, and the first layer's gradient moved by up to 1.6e-3
# from the card's plain version at 37 rays and 2.3e-3 from the CPU's, which
# are themselves 2.6e-3 apart (2.1e-4 to 5.8e-4 at 1024 rays).  1e-2,
# step_grad_rel's limit for the same cause, keeps 4x above that; a lost ray
# of 37 moves a gradient by ~3e-2.  It does not separate the bf16 K9, whose
# gradients sit 9.1e-3 to 8.4e-2 from the same f32 plain outputs: its demb
# (9.9e-8 to 2.8e-6) fails demb_k4, and F32_GAIN asks the f32 error to be 16x
# below it (38x measured).
PLAIN_TOL_F32_BWD = {"grad_rel": 1e-4, "demb": 1e-5, "demb_k4": 3e-9, "g_field": 3e-9,
                     "g_field_k6": 3e-6, "loss": 1e-7, "step_grad_rel": 1e-2,
                     "grad_rel_k9": 1e-2}


def grad_rel_errors(got: PackedGrads, want: PackedGrads, model) -> dict:
    """{parameter name: ||got - want|| / ||want||}, the measure PLAIN_TOL's
    ``grad_rel`` bounds (parameters whose gradient is zero are skipped)."""
    g, w = unpack_grads(got, model), unpack_grads(want, model)
    return {n: float((g[n].float() - w[n].float()).norm() / w[n].float().norm())
            for n in w if float(w[n].norm()) > 0}


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


def _zeros_for_none(cot, r: int, n: int, device):
    """(g_rgb, g_depth, g_acc, g_w) with each None (an output nothing used)
    replaced by zeros, as the kernels read a null cotangent."""
    shapes = ((r, 3), (r,), (r,), (r, n))
    return tuple(torch.zeros(sh, device=device) if c is None else c.float()
                 for c, sh in zip(cot, shapes))


def _mse_cotangents(target, r: int, n: int):
    """The cotangents of the MSE over the R rays, as a function of the
    composite's output (K4, K7): rgb 2 (rgb - target) / (3R), none else."""
    inv_denom = 1.0 / (r * 3.0)
    zero = torch.zeros(r, device=target.device)
    return lambda out: (2.0 * inv_denom * (out["rgb"] - target), zero, zero,
                        torch.zeros(r, n, device=target.device))


def _mse(rgb, target):
    diff = rgb - target
    return (diff * diff).sum() * (1.0 / (target.shape[0] * 3.0))


def _march_vjp_plain(packed, cfg, o, d, emb, z, t, cotangents, g_field=None):
    """Shared by K3's and K7's plain versions: the field at z, the
    composite, its transpose under ``cotangents(out)`` = (g_rgb, g_depth,
    g_acc, g_w), ``g_field`` (R,4,S) when given, the transposed MLP.
    Returns (the composite's output, PackedGrads, demb (R,E))."""
    r, s = z.shape
    enc_x, enc_d, emb_f = _enc_at(cfg, o, d, emb, z, t)
    rgb, sigma, res = field_from_enc_plain(cfg, enc_x, enc_d, emb_f, packed, want_res=True)
    rgb, sigma = rgb.view(r, s, 3), sigma.view(r, s)
    out = composite(rgb, sigma, z)
    g_rgb_s, g_sig_s = composite_bwd_plain(*cotangents(out), rgb, sigma, z)
    if g_field is not None:
        g_rgb_s = g_rgb_s + g_field[:, :3].transpose(1, 2)
        g_sig_s = g_sig_s + g_field[:, 3]
    grads, demb = field_bwd_plain(cfg, packed, res, emb_f, g_rgb_s.reshape(r * s, 3),
                                  g_sig_s.reshape(r * s, 1))
    return out, grads, demb.view(r, s, -1).sum(1)


def march_bwd_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, g_rgb, g_depth,
                    g_acc, g_w, g_field=None, t=None):
    """Plain version of K3, the VJP of K2: recompute the field at z, run the
    composite's transpose, add ``g_field`` (R,4,S) when given, run the
    transposed MLP.  A cotangent may be None (zeros).  Returns (PackedGrads
    summed over the rays, demb (R,E))."""
    cot = _zeros_for_none((g_rgb, g_depth, g_acc, g_w), *z.shape, z.device)
    _, grads, demb = _march_vjp_plain(packed, cfg, o, d, emb, z, t, lambda out: cot, g_field)
    return grads, demb


def march_train_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, target, t=None):
    """Plain version of K7: the field at z, the composite, the MSE against
    ``target`` over the R rays and its backward.  Returns (mse, PackedGrads,
    demb (R,E))."""
    out, grads, demb = _march_vjp_plain(packed, cfg, o, d, emb, z, t,
                                        _mse_cotangents(target, *z.shape))
    return _mse(out["rgb"], target), grads, demb


def _merged_vjp_plain(packed, cfg, o, d, emb, z_c, field_c, z_f, t, cotangents):
    """Shared by K4's and K6's plain versions: the fine field at z_f, the
    stable merge, the composite, its transpose under ``cotangents(out)``
    (merged order), the un-permute and the fine rows' transposed MLP.
    Returns (the composite's output, PackedGrads of the fine side, demb
    (R,E), g_field (R,4,Sc))."""
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    enc_x, enc_d, emb_f = _enc_at(cfg, o, d, emb, z_f, t)
    rgb_f, sigma_f, res = field_from_enc_plain(cfg, enc_x, enc_d, emb_f, packed, want_res=True)
    z_all, rgb_all, sigma_all, perm = _merge(z_c, field_c, z_f, rgb_f.view(r, sf, 3),
                                             sigma_f.view(r, sf))
    out = composite(rgb_all, sigma_all, z_all)
    g_rgb_all, g_sig_all = composite_bwd_plain(*cotangents(out), rgb_all, sigma_all, z_all)
    # un-permute: the inverse of the merge's gather
    g_rgb_cat = torch.zeros_like(g_rgb_all).scatter_(1, perm[..., None].expand(-1, -1, 3),
                                                     g_rgb_all)
    g_sig_cat = torch.zeros_like(g_sig_all).scatter_(1, perm, g_sig_all)
    g_field = torch.cat([g_rgb_cat[:, :sc].transpose(1, 2), g_sig_cat[:, None, :sc]], dim=1)
    grads, demb = field_bwd_plain(cfg, packed, res, emb_f, g_rgb_cat[:, sc:].reshape(-1, 3),
                                  g_sig_cat[:, sc:].reshape(-1, 1))
    return out, grads, demb.view(r, sf, -1).sum(1), g_field


def merged_train_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                       target, t=None):
    """Plain version of K4: fine field at z_f, stable merge, composite, the
    MSE against ``target`` over the R rays, and its backward.

    Returns (mse, PackedGrads of the fine side, demb (R,E), g_field
    (R,4,Sc)), the cotangent of the coarse field for the coarse VJP."""
    n = z_c.shape[-1] + z_f.shape[-1]
    out, grads, demb, g_field = _merged_vjp_plain(packed, cfg, o, d, emb, z_c, field_c, z_f, t,
                                                  _mse_cotangents(target, z_c.shape[0], n))
    return _mse(out["rgb"], target), grads, demb, g_field


def merged_bwd_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                     g_rgb, g_depth, g_acc, g_w, t=None):
    """Plain version of K6, the VJP of K5: the cotangents of rgb (R,3),
    depth, acc (R,) and the merged weights (R, Sc+Sf), each possibly None
    (zeros).  Returns (PackedGrads of the fine side, demb (R,E), g_field
    (R,4,Sc))."""
    r = z_c.shape[0]
    cot = _zeros_for_none((g_rgb, g_depth, g_acc, g_w), r, z_c.shape[-1] + z_f.shape[-1],
                          z_c.device)
    _, grads, demb, g_field = _merged_vjp_plain(packed, cfg, o, d, emb, z_c, field_c, z_f, t,
                                                lambda out: cot)
    return grads, demb, g_field


def hier_onepass_plain(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, u, target,
                       t=None):
    """Plain version of K9, the whole hierarchical training step: K2's
    march at z_c (R, Sc) with its field, ``sample_pdf`` of its weights at the
    uniforms u (R, Sf), K4's fine pass with the fine MSE and its backward,
    then K3's backward of the coarse pass under coarse_loss_weight x the
    coarse MSE's cotangent plus K4's coarse-field cotangent.  It recomputes
    the coarse forward, which K9 does not.

    Returns (mse_f, mse_c, PackedGrads of mse_f + coarse_loss_weight x
    mse_c, demb (R,E))."""
    coarse = march_plain(packed, cfg, o, d, emb, z_c, t, want_field=True)
    z_f = sample_pdf(z_c, coarse["weights"], u.shape[-1], u=u)
    mse_f, grads_f, demb_f, g_field = merged_train_plain(packed, cfg, o, d, emb, z_c,
                                                         coarse["field"], z_f, target, t)
    g_rgb_c = (2.0 * cfg.coarse_loss_weight / (z_c.shape[0] * 3.0)) * (coarse["rgb"] - target)
    grads_c, demb_c = march_bwd_plain(packed, cfg, o, d, emb, z_c, g_rgb_c, None, None, None,
                                      g_field, t=t)
    grads = PackedGrads(grads_f.mats + grads_c.mats, grads_f.vecs + grads_c.vecs, packed)
    return mse_f, _mse(coarse["rgb"], target), grads, demb_f + demb_c


# ---------------------------------------------------------------- kernels

def _check_field(field_c, r: int, sc: int) -> None:
    if tuple(field_c.shape) != (r, 4, sc):
        raise ValueError(f"field_coarse of shape {tuple(field_c.shape)}, expected {(r, 4, sc)}")


def march_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, t=None,
               want_field: bool = False) -> dict:
    """Launch K2 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as march_plain's."""
    dev = z.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z = (_f32(x, dev) for x in (o, d, emb, z))
    r, s = z.shape
    t = _time_arg(cfg, t, r, dev)
    name, weights = fwd_weights(packed, cfg, "march")
    lib = _build.load(name)
    rgb = torch.empty(r, 3, device=dev)
    depth = torch.empty(r, device=dev)
    acc = torch.empty(r, device=dev)
    w = torch.empty(r, s, device=dev)
    field = torch.empty(r, 4, s, device=dev) if want_field else None
    meta, n_meta = _meta(packed, cfg)
    code = getattr(lib, f"danerf_{name}")(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z.data_ptr(), _arg(t), r, s, emb.shape[-1],
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), w.data_ptr(), _arg(field),
        *(x.data_ptr() for x in weights), packed.vecs.data_ptr(), meta, n_meta,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    out = {"rgb": rgb, "depth": depth, "acc": acc, "weights": w}
    if want_field:
        out["field"] = field
    return out


def merged_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c,
                field_c, z_f, t=None) -> dict:
    """Launch K5 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as merged_plain's."""
    dev = z_f.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z_c, field_c, z_f = (_f32(x, dev) for x in (o, d, emb, z_c, field_c, z_f))
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    _check_field(field_c, r, sc)
    t = _time_arg(cfg, t, r, dev)
    name, weights = fwd_weights(packed, cfg, "merged")
    lib = _build.load(name)
    rgb = torch.empty(r, 3, device=dev)
    depth = torch.empty(r, device=dev)
    acc = torch.empty(r, device=dev)
    w = torch.empty(r, sc + sf, device=dev)
    z_all = torch.empty(r, sc + sf, device=dev)
    meta, n_meta = _meta(packed, cfg)
    code = getattr(lib, f"danerf_{name}")(
        o.data_ptr(), d.data_ptr(), emb.data_ptr(), z_c.data_ptr(), field_c.data_ptr(),
        z_f.data_ptr(), _arg(t), r, sc, sf, emb.shape[-1],
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), w.data_ptr(), z_all.data_ptr(),
        *(x.data_ptr() for x in weights), packed.vecs.data_ptr(), meta, n_meta,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": w, "z_vals": z_all}


def _opt_f32(x: Optional[torch.Tensor], device, shape) -> Optional[torch.Tensor]:
    """An optional cotangent as the kernels take it: f32, contiguous, of
    ``shape``; None stays None (the kernel reads a null pointer as zeros)."""
    if x is None:
        return None
    x = _f32(x, device)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"cotangent of shape {tuple(x.shape)}, expected {tuple(shape)}")
    return x


def march_bwd_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, g_rgb, g_depth,
                   g_acc, g_w, g_field=None, t=None):
    """Launch K3 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as march_bwd_plain's (a None cotangent is
    passed as a null pointer, which the kernel reads as zeros)."""
    dev = z.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z = (_f32(x, dev) for x in (o, d, emb, z))
    r, s = z.shape
    t = _time_arg(cfg, t, r, dev)
    cot = (_opt_f32(x, dev, sh) for x, sh in zip((g_rgb, g_depth, g_acc, g_w, g_field),
                                                 ((r, 3), (r,), (r,), (r, s), (r, 4, s))))
    demb = torch.empty(r, emb.shape[-1], device=dev)
    grads = _launch_bwd("march_bwd", packed, cfg, r, s,
                        (o, d, emb, z, t, r, s, emb.shape[-1], *cot), (demb,))
    return grads, demb


def march_train_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z, target, t=None):
    """Launch K7 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as march_train_plain's."""
    dev = z.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z, target = (_f32(x, dev) for x in (o, d, emb, z, target))
    r, s = z.shape
    t = _time_arg(cfg, t, r, dev)
    demb = torch.empty(r, emb.shape[-1], device=dev)
    loss = torch.zeros((), device=dev)
    grads = _launch_bwd("march_train", packed, cfg, r, s,
                        (o, d, emb, z, target, t, r, s, emb.shape[-1]), (demb, loss))
    return loss, grads, demb


def merged_train_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                      target, t=None):
    """Launch K4 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as merged_train_plain's."""
    dev = z_f.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z_c, field_c, z_f, target = (
        _f32(x, dev) for x in (o, d, emb, z_c, field_c, z_f, target))
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    _check_field(field_c, r, sc)
    t = _time_arg(cfg, t, r, dev)
    demb = torch.empty(r, emb.shape[-1], device=dev)
    g_field = torch.empty(r, 4, sc, device=dev)
    loss = torch.zeros((), device=dev)
    grads = _launch_bwd("merged_train", packed, cfg, r, sf,
                        (o, d, emb, z_c, field_c, z_f, target, t, r, sc, sf, emb.shape[-1]),
                        (demb, g_field, loss))
    return loss, grads, demb, g_field


def merged_bwd_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, field_c, z_f,
                    g_rgb, g_depth, g_acc, g_w, t=None):
    """Launch K6 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as merged_bwd_plain's (a None cotangent is
    passed as a null pointer, which the kernel reads as zeros)."""
    dev = z_f.device
    _check_packed(packed, dev, cfg)
    o, d, emb, z_c, field_c, z_f = (_f32(x, dev) for x in (o, d, emb, z_c, field_c, z_f))
    r, sc = z_c.shape
    sf = z_f.shape[-1]
    _check_field(field_c, r, sc)
    t = _time_arg(cfg, t, r, dev)
    cot = (_opt_f32(x, dev, sh) for x, sh in zip((g_rgb, g_depth, g_acc, g_w),
                                                 ((r, 3), (r,), (r,), (r, sc + sf))))
    demb = torch.empty(r, emb.shape[-1], device=dev)
    g_field = torch.empty(r, 4, sc, device=dev)
    grads = _launch_bwd("merged_bwd", packed, cfg, r, sf,
                        (o, d, emb, z_c, field_c, z_f, t, r, sc, sf, emb.shape[-1], *cot),
                        (demb, g_field))
    return grads, demb, g_field


def hier_onepass_cuda(packed: PackedParams, cfg: NeRFConfig, o, d, emb, z_c, u, target,
                      t=None):
    """Launch K9 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as hier_onepass_plain's."""
    dev = z_c.device
    _check_packed(packed, dev, cfg)
    o, d, emb, target = _rows_f32(dev, {"o": 3, "d": 3, "emb": cfg.appearance_dim, "target": 3},
                                  o=o, d=d, emb=emb, target=target)
    z_c, u = _f32(z_c, dev), _f32(u, dev)
    r = o.shape[0]
    if z_c.dim() != 2 or u.dim() != 2 or z_c.shape[0] != r or u.shape[0] != r:
        raise ValueError(f"z_c of shape {tuple(z_c.shape)} and u of shape {tuple(u.shape)}, "
                         f"expected ({r}, num_samples) and ({r}, num_importance)")
    sc, sf = z_c.shape[1], u.shape[1]
    t = _time_arg(cfg, t, r, dev)
    demb = torch.empty(r, emb.shape[-1], device=dev)
    loss = torch.zeros(2, device=dev)
    grads = _launch_bwd("hier_onepass", packed, cfg, r, max(sc, sf),
                        (o, d, emb, z_c, u, target, t, r, sc, sf, emb.shape[-1],
                         float(cfg.coarse_loss_weight)), (demb, loss))
    return loss[0], loss[1], grads, demb


# ---------------------------------------------------------------- routes

def _march_fwd(packed, cfg, o, d, emb, z, t, want_field):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return march_cuda(packed, cfg, o, d, emb, z, t, want_field)
    return march_plain(packed, cfg, o.float(), d.float(), emb, z.float(), _f32_opt(t),
                       want_field)


def _march_bwd(packed, cfg, o, d, emb, z, t, cot):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, t=t)
    return march_bwd_plain(packed, cfg, o.float(), d.float(), emb, z.float(), *cot,
                           t=_f32_opt(t))


def _march_train(packed, cfg, o, d, emb, z, target, t):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return march_train_cuda(packed, cfg, o, d, emb, z, target, t)
    return march_train_plain(packed, cfg, o.float(), d.float(), emb, z.float(), target.float(),
                             _f32_opt(t))


def _merged_fwd(packed, cfg, o, d, emb, z_c, field_c, z_f, t):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return merged_cuda(packed, cfg, o, d, emb, z_c, field_c, z_f, t)
    return merged_plain(packed, cfg, o.float(), d.float(), emb, z_c.float(), field_c.float(),
                        z_f.float(), _f32_opt(t))


def _merged_bwd(packed, cfg, o, d, emb, z_c, field_c, z_f, t, cot):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return merged_bwd_cuda(packed, cfg, o, d, emb, z_c, field_c, z_f, *cot, t=t)
    return merged_bwd_plain(packed, cfg, o.float(), d.float(), emb, z_c.float(),
                            field_c.float(), z_f.float(), *cot, t=_f32_opt(t))


def _merged_train(packed, cfg, o, d, emb, z_c, field_c, z_f, target, t):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return merged_train_cuda(packed, cfg, o, d, emb, z_c, field_c, z_f, target, t)
    return merged_train_plain(packed, cfg, o.float(), d.float(), emb, z_c.float(),
                              field_c.float(), z_f.float(), target.float(), _f32_opt(t))


def _hier_onepass(packed, cfg, o, d, emb, z_c, u, target, t):
    _check_time(cfg, t)
    if _route(o) == "cuda":
        return hier_onepass_cuda(packed, cfg, o, d, emb, z_c, u, target, t)
    return hier_onepass_plain(packed, cfg, o.float(), d.float(), emb, z_c.float(), u.float(),
                              target.float(), _f32_opt(t))


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


class MergedFn(torch.autograd.Function):
    """K5 forward, K6 backward: the counterpart of ``_hier_apply``'s custom
    VJP.  Inputs as MarchFn's, plus the coarse field ``field_c`` (R,4,Sc),
    which gets its cotangent back (for the coarse pass's K3).  Outputs rgb,
    depth, acc, weights and z_vals in merged order; z_vals, the rays and
    the depths are data and get no gradient.  An output that nothing used
    gets no cotangent (None), which K6 reads as zeros."""

    @staticmethod
    def forward(ctx, cfg, packed, names, o, d, emb, z_c, field_c, z_f, t, *params):
        out = _merged_fwd(packed, cfg, o, d, emb, z_c, field_c, z_f, t)
        ctx.cfg, ctx.packed, ctx.names = cfg, packed, names
        ctx.save_for_backward(o, d, emb, z_c, field_c, z_f, t, *params)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out["z_vals"])
        return tuple(out[k] for k in ("rgb", "depth", "acc", "weights", "z_vals"))

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_w, _g_z):
        o, d, emb, z_c, field_c, z_f, t, *params = ctx.saved_tensors
        grads, demb, g_field = _merged_bwd(ctx.packed, ctx.cfg, o, d, emb, z_c, field_c, z_f, t,
                                           (g_rgb, g_depth, g_acc, g_w))
        by_name = unpack_grads(grads, zip(ctx.names, params))
        return (None, None, None, None, None, demb, None, g_field, None, None,
                *(by_name[n] for n in ctx.names))


class MarchTrainLossFn(torch.autograd.Function):
    """K7: the MSE of coarse-only training.  As MergedTrainLossFn: the
    kernel computes the loss and all of its gradients in ``forward``;
    ``backward(g)`` hands out g times them for the parameters and ``emb``."""

    @staticmethod
    def forward(ctx, cfg, packed, names, o, d, emb, z, target, t, *params):
        mse, grads, demb = _march_train(packed, cfg, o, d, emb, z, target, t)
        ctx.names = names
        ctx.grads = unpack_grads(grads, zip(names, params))
        ctx.demb = demb
        return mse

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, None, None, g * ctx.demb, None, None, None,
                *(g * ctx.grads[n] for n in ctx.names))


class HierOnepassLossFn(torch.autograd.Function):
    """K9: the loss of hierarchical training, mse_f + coarse_loss_weight x
    mse_c.  ``forward`` runs the kernel once, which computes both MSEs and
    all of their gradients, keeps the gradients and returns (the weighted
    loss, mse_f, mse_c), the last two not differentiable; ``backward(g)``
    hands out g times the kept gradients for the parameters and ``emb``.
    The rays, z_c, the uniforms u, the target and t are data."""

    @staticmethod
    def forward(ctx, cfg, packed, names, o, d, emb, z_c, u, target, t, *params):
        mse_f, mse_c, grads, demb = _hier_onepass(packed, cfg, o, d, emb, z_c, u, target, t)
        ctx.names = names
        ctx.grads = unpack_grads(grads, zip(names, params))
        ctx.demb = demb
        ctx.mark_non_differentiable(mse_f, mse_c)
        return mse_f + cfg.coarse_loss_weight * mse_c, mse_f, mse_c

    @staticmethod
    def backward(ctx, g, _g_f, _g_c):
        return (None, None, None, None, None, g * ctx.demb, None, None, None, None,
                *(g * ctx.grads[n] for n in ctx.names))


# ---------------------------------------------------------------- public

def _needs_grad(params, emb) -> bool:
    return torch.is_grad_enabled() and (
        (isinstance(params, torch.nn.Module)
         and any(p.requires_grad for p in params.parameters()))
        or (emb is not None and emb.requires_grad))


def _prepare(params, cfg: NeRFConfig, rays_o, appearance_embedding, packed=None):
    """(packed, emb) for a call: ``packed`` when given, else ``params`` if
    it is packed, else the module packed here; a zero embedding when none is
    given (its projection is packed as zeros, matching nerf_apply skipping
    the term)."""
    if packed is None:
        packed = params if isinstance(params, PackedParams) else pack_params(
            params, cfg, appearance=appearance_embedding is not None, device=rays_o.device)
    if appearance_embedding is None and packed.has_appearance:
        raise ValueError("params were packed with appearance=True but no "
                         "appearance_embedding was given")
    r = rays_o.shape[0]
    if appearance_embedding is None:
        emb = torch.zeros(r, cfg.appearance_dim, device=rays_o.device)
    else:
        emb = appearance_embedding.to(torch.float32)
    return packed, emb


def _module_params(params, what: str):
    if not isinstance(params, torch.nn.Module):
        raise ValueError(f"differentiating {what} needs the NeRF module, not packed params")
    return module_params(params)


def _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, want_field, packed):
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding, packed)
    if not _needs_grad(params, appearance_embedding):
        return _march_fwd(packed, cfg, rays_o, rays_d, emb, z_vals, t, want_field)
    names, tensors = _module_params(params, "the march")
    outs = MarchFn.apply(cfg, packed, names, want_field, rays_o, rays_d, emb, z_vals, t,
                         *tensors)
    keys = ("rgb", "depth", "acc", "weights") + (("field",) if want_field else ())
    return dict(zip(keys, outs))


def fused_render_rays_eval(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                           appearance_embedding=None, t=None, packed=None) -> dict:
    """Sample -> encode -> MLP -> composite over a ray batch.

    rays_o, rays_d: (R, 3), rays_d unit-norm; z_vals: (R, S) sorted.
    ``packed``: the module's pack_params output, to reuse across calls.
    Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, S).
    Differentiable in the module's parameters and the embedding (K3).
    """
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, False, packed)


def fused_render_rays_coarse_field(params, cfg: NeRFConfig, rays_o, rays_d, z_vals,
                                   appearance_embedding=None, t=None, packed=None) -> dict:
    """As fused_render_rays_eval, plus "field": the per-sample
    [r, g, b, sigma] as (R, 4, S) for fused_render_rays_merged.
    Differentiable; the field's cotangent flows back through K3 too."""
    return _march(params, cfg, rays_o, rays_d, z_vals, appearance_embedding, t, True, packed)


def fused_render_rays_merged(params, cfg: NeRFConfig, rays_o, rays_d, z_coarse,
                             field_coarse, z_fine, appearance_embedding=None,
                             t=None, packed=None) -> dict:
    """Hierarchical fine pass without re-evaluating the coarse samples.

    z_coarse (R, Sc) and z_fine (R, Sf) must each be sorted per ray;
    field_coarse is fused_render_rays_coarse_field's (R, 4, Sc) output
    (keep it attached: the fine composite's gradient flows back through
    it).  Returns dict rgb (R, 3), depth (R,), acc (R,), weights (R, Sc+Sf)
    and z_vals (R, Sc+Sf) in merged (sorted) order.  Differentiable in the
    module's parameters, the embedding and field_coarse (K6).
    """
    packed, emb = _prepare(params, cfg, rays_o, appearance_embedding, packed)
    if not (_needs_grad(params, appearance_embedding)
            or (torch.is_grad_enabled() and field_coarse.requires_grad)):
        return _merged_fwd(packed, cfg, rays_o, rays_d, emb, z_coarse, field_coarse, z_fine, t)
    names, tensors = _module_params(params, "the merged composite")
    outs = MergedFn.apply(cfg, packed, names, rays_o, rays_d, emb, z_coarse, field_coarse,
                          z_fine, t, *tensors)
    return dict(zip(("rgb", "depth", "acc", "weights", "z_vals"), outs))


def fused_train_loss_grads(params, cfg: NeRFConfig, rays_o, rays_d, z_vals, target,
                           appearance_embedding=None, t=None):
    """Single-pass coarse training core (K7): the MSE of the march against
    ``target`` and all of its gradients in one kernel.

    rays_d unit-norm; z_vals (R, S) sorted.  Returns (mse, {parameter name:
    gradient}, demb (R,E)), the per-ray embedding cotangent that the caller
    scatter-adds into the table.  ``params`` is the module.
    """
    with torch.no_grad():
        packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
        mse, grads, demb = _march_train(packed, cfg, rays_o, rays_d, emb, z_vals, target, t)
    return mse, unpack_grads(grads, params), demb


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


def fused_hier_onepass_train(params, cfg: NeRFConfig, rays_o, rays_d, z_coarse, u, target,
                             appearance_embedding=None, t=None):
    """The whole hierarchical training step in one kernel (K9).

    z_coarse (R, Sc) sorted stratified depths; u (R, Sf) the uniforms of
    ``ops.sampling.importance_uniforms`` (increasing per ray), at which the
    kernel inverts the coarse weights' CDF; target (R, 3).  Returns
    (mse_fine, mse_coarse, {parameter name: gradient of mse_fine +
    coarse_loss_weight x mse_coarse}, demb (R,E)).  ``params`` is the
    module."""
    with torch.no_grad():
        packed, emb = _prepare(params, cfg, rays_o, appearance_embedding)
        mse_f, mse_c, grads, demb = _hier_onepass(packed, cfg, rays_o, rays_d, emb, z_coarse, u,
                                                  target, t)
    return mse_f, mse_c, unpack_grads(grads, params), demb
