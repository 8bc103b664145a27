"""The field MLP as the kernels see it (counterpart of
danerf_tpu/kernels/fused_mlp.py).

- ``pack_params`` packs the module's weights once per render into the layout
  the CUDA kernels read: every matrix (out, K) row-major in the compute dtype
  (bf16 under ``use_bf16``) with K zero-padded to a multiple of 16, so the
  tensor-core loops need no ragged-K handling; biases and the density head's
  weight stay f32.
- ``encode_plain`` and ``field_from_enc_plain`` are the plain PyTorch
  versions of the kernels' shared device code (``csrc/field.cuh``), the
  counterparts of ``_encode``/``_field_from_enc``: activations held in the
  compute dtype, the density head as an f32 multiply-and-sum over the bf16
  trunk output, and ``happ = relu(hdir_pre) + emb @ Wapp + bapp`` in f32
  before the rgb matmul.

The encoding here is the kernels' form, ``y = 2^i o + z (2^i d)`` then
``sin(y + phase)``, not ``nerf_apply``'s ``sin(2^i (o + z d))``: the two
differ by f32 rounding that sin amplifies at 2^9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from danerf_tpu_torch.config import NeRFConfig

_HALF_PI = torch.tensor(math.pi / 2, dtype=torch.float32).item()  # f32-rounded


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _align(n: int) -> int:
    return -(-n // 64) * 64


@dataclasses.dataclass(frozen=True)
class PackedParams:
    """Weights in kernel layout.

    mats: 1-D, compute dtype; each matrix (out, K padded to 16) row-major.
    vecs: 1-D f32; biases and the density head's (hidden,) weight.
    mat_at / vec_at: name -> (offset, shape).
    """
    mats: torch.Tensor
    vecs: torch.Tensor
    mat_at: Dict[str, Tuple[int, Tuple[int, ...]]]
    vec_at: Dict[str, Tuple[int, Tuple[int, ...]]]
    num_layers: int
    has_appearance: bool

    def mat(self, name: str) -> torch.Tensor:
        off, shape = self.mat_at[name]
        return self.mats[off:off + math.prod(shape)].view(shape)

    def vec(self, name: str) -> torch.Tensor:
        off, shape = self.vec_at[name]
        return self.vecs[off:off + math.prod(shape)].view(shape)

    @property
    def device(self) -> torch.device:
        return self.mats.device


def enc_widths(cfg: NeRFConfig) -> Tuple[int, int]:
    """Padded widths (kx, kd) of the position (+time) and direction
    encodings."""
    pos_in = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
    return _pad16(pos_in), _pad16(cfg.dir_enc_dim)


def pack_params(model, cfg: NeRFConfig, appearance: bool = True,
                device=None) -> PackedParams:
    """Pack a ``NeRF`` module's weights for the kernels and their plain
    versions.  With ``appearance=False`` (rendering without an embedding)
    the appearance projection is packed as zeros, which matches
    ``nerf_apply`` skipping the term."""
    cdt = torch.bfloat16 if cfg.use_bf16 else torch.float32
    dev = model.density_head.weight.device if device is None else torch.device(device)
    kx, kd = enc_widths(cfg)
    hid, half = cfg.hidden_dim, cfg.hidden_dim // 2
    mats, vecs = [], []
    mat_at, vec_at = {}, {}
    n_mat = n_vec = 0

    def add_mat(name, w, k_pad):
        nonlocal n_mat
        w = w.detach().to(torch.float32)
        buf = torch.zeros(_align(w.shape[0] * k_pad), dtype=torch.float32, device=w.device)
        buf[:w.shape[0] * k_pad].view(w.shape[0], k_pad)[:, :w.shape[1]] = w
        mats.append(buf)
        mat_at[name] = (n_mat, (w.shape[0], k_pad))
        n_mat += buf.numel()

    def add_vec(name, v):
        nonlocal n_vec
        v = v.detach().to(torch.float32).reshape(-1)
        buf = torch.zeros(_align(v.numel()), dtype=torch.float32, device=v.device)
        buf[:v.numel()] = v
        vecs.append(buf)
        vec_at[name] = (n_vec, (v.numel(),))
        n_vec += buf.numel()

    for i, layer in enumerate(model.pts_linears):
        if i == 0:
            k_pad = kx
        elif i in cfg.skip_connect_layers:
            k_pad = hid + kx
        else:
            k_pad = hid
        add_mat(f"w{i}", layer.weight, k_pad)
        add_vec(f"b{i}", layer.bias)
    add_vec("wd", model.density_head.weight)
    add_vec("bd", model.density_head.bias)
    add_mat("wdir", model.dir_linear.weight, hid + kd)
    add_vec("bdir", model.dir_linear.bias)
    app = model.appearance_projection
    use_app = appearance and app is not None
    add_mat("wapp", app.weight if use_app else torch.zeros(half, cfg.appearance_dim),
            cfg.appearance_dim)
    add_vec("bapp", app.bias if use_app else torch.zeros(half))
    add_mat("wrgb", model.rgb_linear.weight, half)
    add_vec("brgb", model.rgb_linear.bias)
    return PackedParams(
        mats=torch.cat([m.to(dev) for m in mats]).to(cdt),
        vecs=torch.cat([v.to(dev) for v in vecs]),
        mat_at=mat_at, vec_at=vec_at, num_layers=len(model.pts_linears),
        has_appearance=use_app)


def kernel_meta(packed: PackedParams, cfg: NeRFConfig) -> Tuple[int, ...]:
    """The integer layout record the CUDA kernels parse (csrc/field.cuh
    ``parse_meta``)."""
    kx, kd = enc_widths(cfg)
    skip_mask = sum(1 << i for i in cfg.skip_connect_layers if 0 < i < packed.num_layers)
    L = packed.num_layers
    head = [L, skip_mask, cfg.pos_enc_levels, cfg.dir_enc_levels, kx, kd,
            cfg.hidden_dim, int(cfg.density_activation == "softplus"),
            cfg.appearance_dim]
    w_off = [packed.mat_at[f"w{i}"][0] for i in range(L)]
    b_off = [packed.vec_at[f"b{i}"][0] for i in range(L)]
    tail = [packed.vec_at["wd"][0], packed.vec_at["bd"][0],
            packed.mat_at["wdir"][0], packed.vec_at["bdir"][0],
            packed.mat_at["wapp"][0], packed.vec_at["bapp"][0],
            packed.mat_at["wrgb"][0], packed.vec_at["brgb"][0]]
    return tuple(head + w_off + b_off + tail)


def transposed_mats(packed: PackedParams, cfg: NeRFConfig):
    """The hidden-input block of each trunk layer after the first, and of the
    dir layer, transposed: W[:, :hidden]^T as (hidden, out) row-major bf16,
    which the backward kernels read as the B operand of d_in = d_pre @ W
    (csrc/field_bwd.cuh).  Returns (flat tensor, offsets): one offset per
    trunk layer (-1 for layer 0, whose d_in is not formed) and one for the
    dir layer."""
    hid = cfg.hidden_dim
    parts, offs, n = [], [-1], 0
    names = [f"w{i}" for i in range(1, packed.num_layers)] + ["wdir"]
    for name in names:
        t = packed.mat(name)[:, :hid].t().contiguous().reshape(-1)
        offs.append(n)
        parts.append(t)
        n += t.numel()
    return torch.cat(parts), tuple(offs)


def _enc_cols(levels: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per output column of the encoding: input index, frequency, phase,
    is-input flag (the constants of the JAX package's ``_encode_consts``)."""
    src, freq, phase, is_in = list(range(dim)), [1.0] * dim, [0.0] * dim, [True] * dim
    for i in range(levels):
        for p in (0.0, _HALF_PI):
            src += list(range(dim))
            freq += [2.0 ** i] * dim
            phase += [p] * dim
            is_in += [False] * dim
    return (torch.tensor(src, device=device), torch.tensor(freq, device=device),
            torch.tensor(phase, device=device), torch.tensor(is_in, device=device))


def encode_plain(x: torch.Tensor, levels: int, d: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoding in the kernels' form: of ``x`` (R, k), giving (R, k(1+2L));
    or, with ``d`` (R, k) and ``z`` (R, S), of x + z*d, giving
    (R, S, k(1+2L)) without materializing the points."""
    src, freq, phase, is_in = _enc_cols(levels, x.shape[-1], x.device)
    y = x[..., src] * freq                     # x @ M: one nonzero per column
    if z is not None:
        y = y[:, None, :] + z[..., None] * (d[..., src] * freq)[:, None, :]
    return torch.where(is_in, y, torch.sin(y + phase))


def _dot(a: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """a @ w^T with inputs in the compute dtype and f32 accumulation (the
    products of bf16 values are exact in f32)."""
    return F.linear(a.to(cdt).to(torch.float32), w.to(torch.float32))


def field_from_enc_plain(cfg: NeRFConfig, enc_x: torch.Tensor, enc_d: torch.Tensor,
                         emb: torch.Tensor, packed: PackedParams, want_res: bool = False):
    """Trunk + heads on encoded inputs, the plain version of the kernels'
    ``field_tile``.

    enc_x: (N, pos_in), enc_d: (N, dir_enc), emb: (N, E) f32.
    Returns rgb (N, 3) and sigma (N, 1); with ``want_res`` also the
    residuals of ``_field_from_enc`` that ``field_bwd_plain`` reads: layer
    inputs ``ins`` and relu ``gates``, ``sigma_pre``, ``dcat``, ``dir_gate``,
    ``happ`` (compute dtype) and ``rgb``.
    """
    cdt = torch.bfloat16 if cfg.use_bf16 else torch.float32
    kx, kd = enc_widths(cfg)
    enc_x = F.pad(enc_x, (0, kx - enc_x.shape[-1])).to(cdt)
    enc_d = F.pad(enc_d, (0, kd - enc_d.shape[-1])).to(cdt)
    h = enc_x
    ins, gates = [], []
    for i in range(packed.num_layers):
        if i in cfg.skip_connect_layers and i > 0:
            h = torch.cat([h, enc_x], dim=-1)
        ins.append(h)
        pre = _dot(h, packed.mat(f"w{i}"), cdt) + packed.vec(f"b{i}")
        gates.append(pre > 0)
        h = F.relu(pre).to(cdt)
    sigma_pre = torch.sum(h.to(torch.float32) * packed.vec("wd"), dim=-1,
                          keepdim=True) + packed.vec("bd")
    sigma = F.softplus(sigma_pre) if cfg.density_activation == "softplus" else F.relu(sigma_pre)
    dcat = torch.cat([h, enc_d], dim=-1)
    hdir_pre = _dot(dcat, packed.mat("wdir"), cdt) + packed.vec("bdir")
    happ = F.relu(hdir_pre) + _dot(emb, packed.mat("wapp"), cdt) + packed.vec("bapp")
    rgb = torch.sigmoid(_dot(happ, packed.mat("wrgb"), cdt) + packed.vec("brgb"))
    if not want_res:
        return rgb, sigma
    res = dict(ins=ins, gates=gates, h_last=h, sigma_pre=sigma_pre, dcat=dcat,
               dir_gate=hdir_pre > 0, happ=happ.to(cdt), rgb=rgb)
    return rgb, sigma, res


# ---------------------------------------------------------------- backward

@dataclasses.dataclass(frozen=True)
class PackedGrads:
    """f32 gradients in the layout of ``packed``: ``mats`` as
    ``packed.mats`` (K padding included), ``vecs`` as ``packed.vecs``.  The
    backward kernels write this layout; ``unpack_grads`` turns it into one
    tensor per module parameter."""
    mats: torch.Tensor
    vecs: torch.Tensor
    packed: PackedParams

    def mat(self, name: str) -> torch.Tensor:
        off, shape = self.packed.mat_at[name]
        return self.mats[off:off + math.prod(shape)].view(shape)

    def vec(self, name: str) -> torch.Tensor:
        off, shape = self.packed.vec_at[name]
        return self.vecs[off:off + math.prod(shape)].view(shape)

    @staticmethod
    def zeros(packed: PackedParams) -> "PackedGrads":
        dev = packed.device
        return PackedGrads(torch.zeros(packed.mats.numel(), device=dev),
                           torch.zeros(packed.vecs.numel(), device=dev), packed)


def _dW(g: torch.Tensor, a: torch.Tensor, cdt) -> torch.Tensor:
    """Weight gradient g^T @ a in the (out, K) layout: both operands rounded
    to the compute dtype, f32 accumulation (the JAX kernels' ``dotT_a``)."""
    return g.to(cdt).to(torch.float32).t() @ a.to(cdt).to(torch.float32)


def _dX(g: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """Input cotangent g @ W for W (out, K): ``dot_wT``'s rounding."""
    return g.to(cdt).to(torch.float32) @ w.to(torch.float32)


def field_bwd_plain(cfg: NeRFConfig, packed: PackedParams, res: dict, emb: torch.Tensor,
                    g_rgb: torch.Tensor, g_sigma: torch.Tensor):
    """Transposed MLP chain from ``field_from_enc_plain``'s residuals, step
    for step ``_field_bwd_from_res`` (the shared device code of the backward
    kernels, ``csrc/field_bwd.cuh``).

    g_rgb (N, 3), g_sigma (N, 1) f32.  Returns (PackedGrads summed over the
    N rows, demb (N, E)).  Upstream cotangents of the data inputs (the
    enc_x tail of a skip layer, the enc_d tail of the dir layer, the first
    layer's input) are not formed.
    """
    cdt = torch.bfloat16 if cfg.use_bf16 else torch.float32
    hid = cfg.hidden_dim
    out = PackedGrads.zeros(packed)

    d_pre_rgb = g_rgb * res["rgb"] * (1.0 - res["rgb"])
    out.mat("wrgb").copy_(_dW(d_pre_rgb, res["happ"], cdt))
    out.vec("brgb").copy_(d_pre_rgb.sum(0))
    d_happ = _dX(d_pre_rgb, packed.mat("wrgb"), cdt)

    out.mat("wapp").copy_(_dW(d_happ, emb, cdt))
    out.vec("bapp").copy_(d_happ.sum(0))
    demb = _dX(d_happ, packed.mat("wapp"), cdt)

    d_hdir_pre = torch.where(res["dir_gate"], d_happ, 0.0)
    out.mat("wdir").copy_(_dW(d_hdir_pre, res["dcat"], cdt))
    out.vec("bdir").copy_(d_hdir_pre.sum(0))
    d_h = _dX(d_hdir_pre, packed.mat("wdir"), cdt)[:, :hid]

    if cfg.density_activation == "softplus":
        d_sigma_pre = g_sigma * torch.sigmoid(res["sigma_pre"])
    else:
        d_sigma_pre = g_sigma * (res["sigma_pre"] > 0)
    out.vec("wd").copy_((res["h_last"].to(torch.float32) * d_sigma_pre).sum(0))
    out.vec("bd").copy_(d_sigma_pre.sum(0))
    d_h = d_h + d_sigma_pre * packed.vec("wd")

    for i in range(packed.num_layers - 1, -1, -1):
        d_pre = torch.where(res["gates"][i], d_h, 0.0)
        out.mat(f"w{i}").copy_(_dW(d_pre, res["ins"][i], cdt))
        out.vec(f"b{i}").copy_(d_pre.sum(0))
        if i > 0:
            d_h = _dX(d_pre, packed.mat(f"w{i}"), cdt)[:, :hid]
    return out, demb


def _param_slot(name: str):
    """(kind, packed name) of a ``NeRF`` parameter name."""
    mod, kind = name.rsplit(".", 1)
    if mod.startswith("pts_linears."):
        i = mod.split(".")[1]
        return ("mat", f"w{i}") if kind == "weight" else ("vec", f"b{i}")
    base = {"density_head": "d", "dir_linear": "dir", "appearance_projection": "app",
            "rgb_linear": "rgb"}[mod]
    if base == "d":
        return ("vec", "wd") if kind == "weight" else ("vec", "bd")
    return ("mat", f"w{base}") if kind == "weight" else ("vec", f"b{base}")


def unpack_grads(grads: PackedGrads, model) -> Dict[str, torch.Tensor]:
    """Packed-layout f32 gradients -> {parameter name: gradient} for every
    parameter of ``model`` (a ``NeRF`` module, or its (name, parameter)
    pairs), in its (out, in) shape with the K padding sliced off.  A
    projection packed as zeros (no embedding given) gets zeros, as the JAX
    package zeroes the gradient of a skipped term."""
    named = model.named_parameters() if isinstance(model, torch.nn.Module) else model
    out = {}
    for name, p in named:
        kind, slot = _param_slot(name)
        if slot in ("wapp", "bapp") and not grads.packed.has_appearance:
            out[name] = torch.zeros_like(p)
            continue
        g = grads.mat(slot) if kind == "mat" else grads.vec(slot)
        if p.dim() == 2:
            g = g.reshape(-1, g.shape[-1]) if kind == "mat" else g.reshape(p.shape)
            g = g[:p.shape[0], :p.shape[1]]
        else:
            g = g[:p.shape[0]]
        out[name] = g.to(p.dtype).reshape(p.shape)
    return out


def params_from_jax_module(params: dict, cfg: NeRFConfig, device="cpu"):
    """A ``NeRF`` module holding a JAX param pytree (numpy arrays), for
    running the JAX package's weights through the kernels."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.convert import params_from_jax

    sd = params_from_jax(params)
    model = NeRF(cfg.replace(use_appearance="appearance_proj" in params))
    model.load_state_dict(sd)
    return model.to(device)
