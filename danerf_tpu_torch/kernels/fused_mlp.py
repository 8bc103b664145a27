"""The field MLP as the kernels see it (counterpart of
danerf_tpu/kernels/fused_mlp.py).

- ``pack_params`` packs the module's weights once per render into the layout
  the CUDA kernels read: every matrix (out, K) row-major in the compute dtype
  (bf16 under ``use_bf16``) with K zero-padded to a multiple of 16, so the
  tensor-core loops need no ragged-K handling; biases and the density head's
  weight stay f32.
- ``encode_plain`` and ``field_from_enc_plain`` are the plain PyTorch
  versions of the kernels' field (``csrc/field_sm90.cuh``), the
  counterparts of ``_encode``/``_field_from_enc``: activations held in the
  compute dtype, the density head as an f32 multiply-and-sum over the bf16
  trunk output, and ``happ = relu(hdir_pre) + emb @ Wapp + bapp`` in f32
  before the rgb matmul.

- K1, ``csrc/mlp_fwd.cu`` / ``fused_fwd_plain``: the field on flat points,
  each row with its own point, direction and embedding (``_fwd_kernel``).
- K8, ``csrc/mlp_bwd.cu`` / ``fused_bwd_plain``: its VJP (``_bwd_kernel``):
  recompute, transposed chain, parameter gradients summed over the rows,
  ``demb`` per row.
- ``fused_nerf_apply``: the counterpart of the JAX function, a drop-in for
  the module's forward; ``FieldFn`` routes its gradients (K1 forward, K8
  backward).  CUDA tensors launch the kernels, CPU tensors take the plain
  versions.

Both configurations of the JAX kernels: bf16 (``use_bf16``, the default)
and f32.  The forward kernels K1, K2 and K5 take f32 through variants of
their own (``mlp_fwd_f32.cu``, ``march_f32.cu``, ``merged_f32.cu``) on
``csrc/field_f32_sm90.cuh``'s tensor-core tile, which reads the weights
split into TF32 halves (``split_tf32``, ``PackedParams.mats_tf32``) and, for
its heads and the appearance term, as packed (``fwd_weights``); the
backward kernels K3, K4, K6, K7, K8 and K9 through theirs on
``csrc/field_bwd_f32_sm90.cuh``'s tensor-core tile
(``march_bwd_f32.cu``, ``merged_train_f32.cu``, ``merged_bwd_f32.cu``,
``march_train_f32.cu``, ``mlp_bwd_f32.cu``, ``hier_onepass_f32.cu``),
which read the forward's split weights, the transposed chain's
(``mats_kn`` split, ``PackedParams.mats_kn_tf32``) and, for the relu gates
of an f32 forward on the CUDA cores (their gate pass, ``csrc/field_f32.cuh``),
``mats_kn`` (``bwd_weights``).

The encoding here is the kernels' form, ``y = 2^i o + z (2^i d)`` then
``sin(y + phase)``, not ``nerf_apply``'s ``sin(2^i (o + z d))``: the two
differ by f32 rounding that sin amplifies at 2^9.  (K1 encodes its points
as ``2^i x``, as the JAX kernel does.)

The launch helpers shared with ``fused_render.py`` live here too, with
``LAUNCHES``, the count of launches per kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import _build

_HALF_PI = torch.tensor(math.pi / 2, dtype=torch.float32).item()  # f32-rounded

LAUNCHES = {"march": 0, "merged": 0, "march_bwd": 0, "merged_train": 0,
            "march_train": 0, "merged_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0, "hier_onepass": 0,
            "march_f32": 0, "merged_f32": 0, "mlp_fwd_f32": 0, "march_bwd_f32": 0,
            "merged_train_f32": 0, "march_train_f32": 0, "merged_bwd_f32": 0,
            "mlp_bwd_f32": 0, "hier_onepass_f32": 0}

# The s_tile of a backward call whose tiles hold 128 independent rows (K8
# and its f32 variant; csrc/field_bwd.cuh ROW_TILES), not rays of s samples.
ROW_TILES = 0


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    mats_kn: without ``use_bf16``, the weights of the f32 backward
    kernels' gate pass on ``csrc/field_f32.cuh``: each matrix transposed,
    W^T (K, out) row-major at W's own offset, so that a K slice of it is
    one contiguous run; None under ``use_bf16``.
    mats_tf32: without ``use_bf16``, the weights of the f32 kernels on the
    tensor cores (K1, K2 and K5, ``csrc/field_f32_sm90.cuh``; the forward
    of K3, K4 and K6-K9, ``csrc/field_bwd_f32_sm90.cuh``): (2,
    mats.numel()), ``mats`` split by ``split_tf32`` into hi (row 0) and lo
    (row 1), each in ``mats``' layout; None under ``use_bf16``.
    mats_kn_tf32: without ``use_bf16``, the transposed chain's weights of
    the f32 K3, K4 and K6-K9: ``mats_kn`` split the same way, (2,
    mats.numel()); None under ``use_bf16``.
    """
    mats: torch.Tensor
    vecs: torch.Tensor
    mat_at: Dict[str, Tuple[int, Tuple[int, ...]]]
    vec_at: Dict[str, Tuple[int, Tuple[int, ...]]]
    num_layers: int
    has_appearance: bool
    mats_kn: Optional[torch.Tensor] = None
    mats_tf32: Optional[torch.Tensor] = None
    mats_kn_tf32: Optional[torch.Tensor] = None

    def mat(self, name: str) -> torch.Tensor:
        off, shape = self.mat_at[name]
        return self.mats[off:off + math.prod(shape)].view(shape)

    def vec(self, name: str) -> torch.Tensor:
        off, shape = self.vec_at[name]
        return self.vecs[off:off + math.prod(shape)].view(shape)

    @property
    def device(self) -> torch.device:
        return self.mats.device


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``x`` for 3xTF32 products: hi rounds x to TF32 as
    ``cvt.rna.tf32.f32`` does (to nearest on the bit pattern, ties away from
    zero: the low 13 mantissa bits become zero), lo rounds x - hi, which is
    exact in f32, the same way; |x - hi - lo| <= 2^-22 |x| for |x| >=
    2^-100.  Device ops only, so a captured step splits in its graph."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


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
    # zeros made on the device: a captured step packs with no host copy
    add_mat("wapp", app.weight if use_app else torch.zeros(half, cfg.appearance_dim, device=dev),
            cfg.appearance_dim)
    add_vec("bapp", app.bias if use_app else torch.zeros(half, device=dev))
    add_mat("wrgb", model.rgb_linear.weight, half)
    add_vec("brgb", model.rgb_linear.bias)
    flat = torch.cat([m.to(dev) for m in mats])
    kn = split = split_kn = None
    if not cfg.use_bf16:
        kn = torch.zeros_like(flat)
        for off, (n, k) in mat_at.values():
            kn[off:off + n * k].view(k, n).copy_(flat[off:off + n * k].view(n, k).t())
        split = torch.stack(split_tf32(flat))
        split_kn = torch.stack(split_tf32(kn))
    return PackedParams(
        mats=flat.to(cdt), vecs=torch.cat([v.to(dev) for v in vecs]),
        mat_at=mat_at, vec_at=vec_at, num_layers=len(model.pts_linears),
        has_appearance=use_app, mats_kn=kn, mats_tf32=split, mats_kn_tf32=split_kn)


def kernel_meta(packed: PackedParams, cfg: NeRFConfig) -> Tuple[int, ...]:
    """The integer layout record the CUDA kernels parse (csrc/field.cuh
    ``parse_meta``): a head of ten values, the trunk layers' weight
    and bias offsets, and the heads' offsets.  The head's last value is the
    number of time encoding levels, -1 without ``use_time``."""
    kx, kd = enc_widths(cfg)
    skip_mask = sum(1 << i for i in cfg.skip_connect_layers if 0 < i < packed.num_layers)
    L = packed.num_layers
    head = [L, skip_mask, cfg.pos_enc_levels, cfg.dir_enc_levels, kx, kd,
            cfg.hidden_dim, int(cfg.density_activation == "softplus"),
            cfg.appearance_dim, cfg.time_enc_levels if cfg.use_time else -1]
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
    (csrc/field_bwd_sm90.cuh streams the trunk blocks, which lie one after
    the other, as one matrix); and the appearance projection transposed, (E,
    half), the B operand of K8's per-row demb = d_happ @ Wapp.  Returns
    (flat tensor, offsets): one offset per trunk layer (-1 for layer 0,
    whose d_in is not formed), one for the dir layer and one for Wapp^T."""
    hid = cfg.hidden_dim
    parts, offs, n = [], [-1], 0
    blocks = [packed.mat(f"w{i}")[:, :hid] for i in range(1, packed.num_layers)]
    blocks += [packed.mat("wdir")[:, :hid], packed.mat("wapp")]
    for w in blocks:
        t = w.t().contiguous().reshape(-1)
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
    ``field_tile90``.

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
    for step ``_field_bwd_from_res`` (the backward kernels' tile,
    ``csrc/field_bwd_sm90.cuh``).

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


def module_params(model):
    """(names, tensors) of the module's parameters, as the autograd
    Functions take them."""
    named = list(model.named_parameters())
    return tuple(n for n, _ in named), tuple(p for _, p in named)


# ---------------------------------------------------------------- launching

def _check_time(cfg: NeRFConfig, t) -> None:
    """A time input exactly when the config has time columns."""
    if cfg.use_time and t is None:
        raise ValueError("cfg.use_time=True requires a time input t")
    if t is not None and not cfg.use_time:
        raise ValueError("a time input t was given, but cfg.use_time is False: the layout "
                         "has no time columns")


def _time_arg(cfg: NeRFConfig, t, n: int, device) -> Optional[torch.Tensor]:
    """The kernels' time input: None without ``use_time`` (a null pointer),
    else t (n, 1) or (n,) as a contiguous f32 (n,) tensor."""
    _check_time(cfg, t)
    if t is None:
        return None
    t = _f32(t, device)
    if tuple(t.shape) not in ((n,), (n, 1)):
        raise ValueError(f"t of shape {tuple(t.shape)}, expected {(n, 1)}")
    return t.reshape(n)


def _f32(x: torch.Tensor, device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, expected {device}")
    return x.to(torch.float32).contiguous()


def _f32_opt(t):
    return None if t is None else t.float()


def _meta(packed: PackedParams, cfg: NeRFConfig):
    m = kernel_meta(packed, cfg)
    return (ctypes.c_longlong * len(m))(*m), len(m)


def _check_packed(packed: PackedParams, device, cfg: NeRFConfig) -> None:
    """Weights packed on ``device`` in the compute dtype ``cfg`` implies:
    bf16 under ``use_bf16``, else f32."""
    want = torch.bfloat16 if cfg.use_bf16 else torch.float32
    if packed.device != device or packed.mats.dtype != want:
        raise ValueError(f"packed params must be {want} on {device} (use_bf16="
                         f"{cfg.use_bf16}); got {packed.mats.dtype} on {packed.device}")


def fwd_weights(packed: PackedParams, cfg: NeRFConfig, name: str):
    """(library name, its weight tensors in the order its C entry takes
    them) of forward kernel ``name``: the bf16 kernel on the packed weights;
    without ``use_bf16`` its f32 variant (K1, K2 and K5) on the packed f32
    weights and their TF32 halves (``mats_tf32``: hi, lo)."""
    if cfg.use_bf16:
        return name, (packed.mats,)
    return f"{name}_f32", (packed.mats, packed.mats_tf32[0], packed.mats_tf32[1])


# The backward kernels whose f32 variants run on the tensor cores by
# 3xTF32 (csrc/field_bwd_f32_sm90.cuh): all six, K3, K4, K6, K7, K8 and K9.
TF32_BWD = ("march_bwd", "merged_train", "merged_bwd", "march_train", "mlp_bwd",
            "hier_onepass")


def bwd_weights(packed: PackedParams, cfg: NeRFConfig, name: str):
    """(library name, weights, chain weights, their offsets) of backward
    kernel ``name``, the weights and chain weights as tuples of tensors in
    the order its C entry takes them: the bf16 kernel on the packed weights
    and their transposed hidden blocks (``transposed_mats``); without
    ``use_bf16`` its f32 variant (every backward kernel, ``TF32_BWD``) on
    the packed f32 weights, their TF32 halves (``mats_tf32``: hi, lo) and
    the weights transposed (``mats_kn``, their gate pass's), the chain on
    ``mats_kn_tf32``'s (hi, lo), each block at its own offset (-1 for layer
    0, the trunk layers 1.., the dir layer, the appearance projection)."""
    if cfg.use_bf16:
        flat, offs = transposed_mats(packed, cfg)
        return name, (packed.mats,), (flat,), offs
    if name not in TF32_BWD:
        raise ValueError(f"no backward kernel {name!r}")
    offs = ((-1,) + tuple(packed.mat_at[f"w{i}"][0] for i in range(1, packed.num_layers))
            + (packed.mat_at["wdir"][0], packed.mat_at["wapp"][0]))
    return (f"{name}_f32",
            (packed.mats, packed.mats_tf32[0], packed.mats_tf32[1], packed.mats_kn),
            (packed.mats_kn_tf32[0], packed.mats_kn_tf32[1]), offs)


def _arg(x):
    """A C argument: a tensor's pointer, None (a null pointer) or an int."""
    return x.data_ptr() if isinstance(x, torch.Tensor) else x


def _route(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _launch_bwd(name: str, packed: PackedParams, cfg: NeRFConfig, r: int, s_tile: int,
                inputs, outputs) -> PackedGrads:
    """Launch backward kernel ``name`` (its f32 variant without
    ``cfg.use_bf16``) on the current stream, whose C entry takes
    ``inputs``, the zeroed gradient buffers, ``outputs``, and then what every
    backward entry takes: the weights and their layout records, the chain's
    weights (``bwd_weights``), and the scratch that holds the residuals of
    one pass (sized by the library for r rays of s_tile samples a tile row,
    or r rows for s_tile = ROW_TILES; K9: both of its row sets, s_tile =
    max(Sc, Sf)).  Returns the gradients (PackedGrads, summed over the
    rays)."""
    dev = packed.device
    name, mats, mats_t, offs_t = bwd_weights(packed, cfg, name)
    lib = _build.load(name)
    meta, n_meta = _meta(packed, cfg)
    meta_t = (ctypes.c_longlong * len(offs_t))(*offs_t)
    n_vecs = packed.vecs.numel()
    size_fn = getattr(lib, _build.SCRATCH_FN.get(name, "danerf_bwd_scratch_bytes"))
    nbytes = size_fn(meta, n_meta, r, s_tile, n_vecs)
    if nbytes < 0:
        _build.check(lib, int(nbytes), "backward scratch size")
    scratch = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)
    grads = PackedGrads.zeros(packed)
    code = getattr(lib, f"danerf_{name}")(
        *(_arg(x) for x in inputs), grads.mats.data_ptr(), grads.vecs.data_ptr(),
        *(_arg(x) for x in outputs), *(m.data_ptr() for m in mats), packed.vecs.data_ptr(),
        meta, n_meta, *(m.data_ptr() for m in mats_t), meta_t, len(offs_t), scratch.data_ptr(),
        scratch.numel(), n_vecs, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return grads


# ---------------------------------------------------------------- K1, K8

def _encode_points(cfg: NeRFConfig, x, d, t):
    """(enc_x, enc_d) of flat points x, directions d (N,3) [and times t
    (N,1), appended to enc_x]: the JAX kernel's ``_encode`` of each."""
    enc_x = encode_plain(x, cfg.pos_enc_levels)
    if t is not None:
        enc_x = torch.cat([enc_x, encode_plain(t, cfg.time_enc_levels)], dim=-1)
    return enc_x, encode_plain(d, cfg.dir_enc_levels)


def fused_fwd_plain(packed: PackedParams, cfg: NeRFConfig, x, d, emb, t=None):
    """Plain version of K1 (``_forward_tile``): rgb (N,3), sigma (N,1) of
    flat points x, directions d (N,3) and embeddings emb (N,E)."""
    return field_from_enc_plain(cfg, *_encode_points(cfg, x, d, t), emb, packed)


def fused_bwd_plain(packed: PackedParams, cfg: NeRFConfig, x, d, emb, g_rgb, g_sigma, t=None):
    """Plain version of K8 (``_bwd_kernel``): recompute the field at the
    rows, then the transposed chain under g_rgb (N,3) and g_sigma (N,1) or
    (N,).  Returns (PackedGrads summed over the N rows, demb (N,E) per
    row)."""
    enc_x, enc_d = _encode_points(cfg, x, d, t)
    _, _, res = field_from_enc_plain(cfg, enc_x, enc_d, emb, packed, want_res=True)
    return field_bwd_plain(cfg, packed, res, emb, g_rgb, g_sigma.reshape(-1, 1))


def _rows_f32(dev, n_cols, **tensors):
    """The kernels' per-row inputs: f32, contiguous, on ``dev``, each (N,
    n_cols[name]) with one N."""
    out = [_f32(x, dev) for x in tensors.values()]
    n = out[0].shape[0]
    for (name, _), x in zip(tensors.items(), out):
        if tuple(x.shape) != (n, n_cols[name]):
            raise ValueError(f"{name} of shape {tuple(x.shape)}, expected {(n, n_cols[name])}")
    return out


def fused_fwd_cuda(packed: PackedParams, cfg: NeRFConfig, x, d, emb, t=None):
    """Launch K1 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as fused_fwd_plain's."""
    dev = x.device
    _check_packed(packed, dev, cfg)
    x, d, emb = _rows_f32(dev, {"x": 3, "d": 3, "emb": cfg.appearance_dim}, x=x, d=d, emb=emb)
    n = x.shape[0]
    t = _time_arg(cfg, t, n, dev)
    rgb = torch.empty(n, 3, device=dev)
    sigma = torch.empty(n, 1, device=dev)
    meta, n_meta = _meta(packed, cfg)
    if emb.data_ptr() % 16:  # both kernels read the embeddings 16 bytes at a time
        emb = emb.clone()
    if not cfg.use_bf16:
        name, weights = fwd_weights(packed, cfg, "mlp_fwd")
        lib = _build.load(name)
        code = getattr(lib, f"danerf_{name}")(
            x.data_ptr(), d.data_ptr(), emb.data_ptr(), _arg(t), n, emb.shape[-1],
            rgb.data_ptr(), sigma.data_ptr(), *(w.data_ptr() for w in weights),
            packed.vecs.data_ptr(), meta, n_meta, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, code, name)
        LAUNCHES[name] += 1
        return rgb, sigma
    lib = _build.load("mlp_fwd")
    # the rows' bf16 embeddings, which the kernel's encoders stash for its
    # appearance product
    scratch = torch.empty(max(lib.danerf_mlp_fwd_scratch_bytes(n, emb.shape[-1]), 1),
                          dtype=torch.uint8, device=dev)
    code = lib.danerf_mlp_fwd(
        x.data_ptr(), d.data_ptr(), emb.data_ptr(), _arg(t), n, emb.shape[-1], rgb.data_ptr(),
        sigma.data_ptr(), packed.mats.data_ptr(), packed.vecs.data_ptr(), meta, n_meta,
        scratch.data_ptr(), scratch.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "mlp_fwd")
    LAUNCHES["mlp_fwd"] += 1
    return rgb, sigma


def fused_bwd_cuda(packed: PackedParams, cfg: NeRFConfig, x, d, emb, g_rgb, g_sigma, t=None):
    """Launch K8 on the current stream (its f32 variant without
    ``cfg.use_bf16``); outputs as fused_bwd_plain's."""
    dev = x.device
    _check_packed(packed, dev, cfg)
    e = cfg.appearance_dim
    x, d, emb, g_rgb, g_sigma = _rows_f32(
        dev, {"x": 3, "d": 3, "emb": e, "g_rgb": 3, "g_sigma": 1},
        x=x, d=d, emb=emb, g_rgb=g_rgb, g_sigma=g_sigma.reshape(-1, 1))
    n = x.shape[0]
    t = _time_arg(cfg, t, n, dev)
    if not cfg.use_bf16 and emb.data_ptr() % 16:  # the f32 tile reads each row's 16 bytes at a time
        emb = emb.clone()
    demb = torch.empty(n, e, device=dev)
    grads = _launch_bwd("mlp_bwd", packed, cfg, n, ROW_TILES,
                        (x, d, emb, t, n, e, g_rgb, g_sigma), (demb,))
    return grads, demb


def _field_fwd(packed, cfg, x, d, emb, t):
    _check_time(cfg, t)
    if _route(x) == "cuda":
        return fused_fwd_cuda(packed, cfg, x, d, emb, t)
    return fused_fwd_plain(packed, cfg, x.float(), d.float(), emb.float(), _f32_opt(t))


def _field_bwd(packed, cfg, x, d, emb, t, g_rgb, g_sigma):
    _check_time(cfg, t)
    if _route(x) == "cuda":
        return fused_bwd_cuda(packed, cfg, x, d, emb, g_rgb, g_sigma, t)
    return fused_bwd_plain(packed, cfg, x.float(), d.float(), emb.float(), g_rgb.float(),
                           g_sigma.float(), _f32_opt(t))


class FieldFn(torch.autograd.Function):
    """K1 forward, K8 backward: the counterpart of ``_fused_apply``'s custom
    VJP.  The module's parameters are explicit inputs (``*params``, in
    ``model.named_parameters()`` order with their ``names``) so that
    autograd routes the gradients to them; ``packed`` is the detached kernel
    copy of the same weights.  Outputs rgb (N,3) and sigma (N,1); the
    points, directions and times are data and get no gradient, the
    embedding gets demb (N,E)."""

    @staticmethod
    def forward(ctx, cfg, packed, names, x, d, emb, t, *params):
        rgb, sigma = _field_fwd(packed, cfg, x, d, emb, t)
        ctx.cfg, ctx.packed, ctx.names = cfg, packed, names
        ctx.save_for_backward(x, d, emb, t, *params)
        return rgb, sigma

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        x, d, emb, t, *params = ctx.saved_tensors
        grads, demb = _field_bwd(ctx.packed, ctx.cfg, x, d, emb, t, g_rgb, g_sigma)
        by_name = unpack_grads(grads, zip(ctx.names, params))
        return (None, None, None, None, None, demb, None, *(by_name[n] for n in ctx.names))


def fused_nerf_apply(model, cfg: NeRFConfig, x, d, appearance_embedding=None, t=None,
                     packed: Optional[PackedParams] = None):
    """Drop-in for the module's forward on points (counterpart of
    danerf_tpu's ``fused_nerf_apply``): K1, and K8 under autograd, on CUDA
    tensors (their has_time variants with ``cfg.use_time``); their plain
    versions on CPU tensors.

    x: (..., 3); d (..., 3) and appearance_embedding (..., E) are broadcast
    to x's leading shape; without an embedding the projection is packed as
    zeros (the module skips the term).  t: (..., 1) when ``cfg.use_time``.
    ``model`` is the ``NeRF`` module; ``packed`` its pack_params output, to
    reuse across calls.  Returns rgb (..., 3), sigma (...).
    """
    if cfg.use_time and t is None:
        raise ValueError("cfg.use_time=True requires a time input t")
    lead = x.shape[:-1]
    xf = x.reshape(-1, 3).float()
    df = d.expand(x.shape).reshape(-1, 3).float()
    if appearance_embedding is None:
        ef = torch.zeros(xf.shape[0], cfg.appearance_dim, device=x.device)
    else:
        e = appearance_embedding.shape[-1]
        ef = appearance_embedding.expand(lead + (e,)).reshape(-1, e).float()
    tf = t.expand(lead + (1,)).reshape(-1, 1).float() if cfg.use_time else None
    if packed is None:
        packed = pack_params(model, cfg, appearance=appearance_embedding is not None,
                             device=x.device)
    if appearance_embedding is None and packed.has_appearance:
        raise ValueError("params were packed with appearance=True but no "
                         "appearance_embedding was given")
    if torch.is_grad_enabled() and (ef.requires_grad
                                    or any(p.requires_grad for p in model.parameters())):
        names, tensors = module_params(model)
        rgb, sigma = FieldFn.apply(cfg, packed, names, xf, df, ef, tf, *tensors)
    else:
        rgb, sigma = _field_fwd(packed, cfg, xf, df, ef, tf)
    return rgb.reshape(*lead, 3), sigma.reshape(lead)


def params_from_jax_module(params: dict, cfg: NeRFConfig, device="cuda"):
    """A ``NeRF`` module holding a JAX param pytree (numpy arrays), for
    running the JAX package's weights through the kernels; on the card
    unless the caller asks for the CPU (raises without CUDA,
    ``resolve_device``)."""
    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.models.nerf import NeRF

    device = resolve_device(device)
    from danerf_tpu_torch.utils.convert import params_from_jax

    sd = params_from_jax(params)
    model = NeRF(cfg.replace(use_appearance="appearance_proj" in params))
    model.load_state_dict(sd)
    return model.to(device)
