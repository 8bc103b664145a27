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
                         emb: torch.Tensor, packed: PackedParams):
    """Trunk + heads on encoded inputs, the plain version of the kernels'
    ``field_tile``.

    enc_x: (N, pos_in), enc_d: (N, dir_enc), emb: (N, E) f32.
    Returns rgb (N, 3) and sigma (N, 1).
    """
    cdt = torch.bfloat16 if cfg.use_bf16 else torch.float32
    kx, kd = enc_widths(cfg)
    enc_x = F.pad(enc_x, (0, kx - enc_x.shape[-1])).to(cdt)
    enc_d = F.pad(enc_d, (0, kd - enc_d.shape[-1])).to(cdt)
    h = enc_x
    for i in range(packed.num_layers):
        if i in cfg.skip_connect_layers and i > 0:
            h = torch.cat([h, enc_x], dim=-1)
        h = F.relu(_dot(h, packed.mat(f"w{i}"), cdt) + packed.vec(f"b{i}")).to(cdt)
    sigma_pre = torch.sum(h.to(torch.float32) * packed.vec("wd"), dim=-1,
                          keepdim=True) + packed.vec("bd")
    sigma = F.softplus(sigma_pre) if cfg.density_activation == "softplus" else F.relu(sigma_pre)
    hdir = F.relu(_dot(torch.cat([h, enc_d], dim=-1), packed.mat("wdir"), cdt)
                  + packed.vec("bdir"))
    happ = hdir + _dot(emb, packed.mat("wapp"), cdt) + packed.vec("bapp")
    rgb = torch.sigmoid(_dot(happ, packed.mat("wrgb"), cdt) + packed.vec("brgb"))
    return rgb, sigma


def params_from_jax_module(params: dict, cfg: NeRFConfig, device="cpu"):
    """A ``NeRF`` module holding a JAX param pytree (numpy arrays), for
    running the JAX package's weights through the kernels."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.convert import params_from_jax

    sd = params_from_jax(params)
    model = NeRF(cfg.replace(use_appearance="appearance_proj" in params))
    model.load_state_dict(sd)
    return model.to(device)
