"""The NeRF-W MLP as an ``nn.Module`` (counterpart of danerf_tpu.models.nerf).

8x256 ReLU trunk with the encoded position concatenated back in before each
layer of ``skip_connect_layers``; density head Linear(hidden, 1) -> ReLU or
softplus; direction branch Linear(hidden + dir_enc, hidden//2) -> ReLU; the
per-image appearance embedding projected by Linear(app_dim, hidden//2) and
ADDED to the direction feature; rgb head Linear(hidden//2, 3) -> sigmoid.
With ``use_time`` the encoded time is concatenated to the encoded position at
the input and at every skip.

``state_dict`` keys are the reference checkpoint's (``pts_linears.{i}``,
``density_head``, ``dir_linear``, ``appearance_projection``, ``rgb_linear``),
so reference ``.pt`` files load as they are.

Numerics follow ``nerf_apply``: with ``use_bf16`` each matmul takes
bf16-rounded inputs and accumulates in f32 (computed here as an f32 matmul of
the rounded values, whose products are exact in f32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.ops.encoding import positional_encoding


def _linear(layer: nn.Linear, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ W^T + b with inputs rounded to ``compute_dtype``, f32 accumulate."""
    w = layer.weight.to(compute_dtype).to(torch.float32)
    return F.linear(x.to(compute_dtype).to(torch.float32), w) + layer.bias


class NeRF(nn.Module):
    def __init__(self, cfg: NeRFConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        pos_in = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
        layers = []
        in_dim = pos_in
        for i in range(cfg.num_layers):
            if i in cfg.skip_connect_layers and i > 0:
                in_dim = cfg.hidden_dim + pos_in
            layers.append(nn.Linear(in_dim, cfg.hidden_dim))
            in_dim = cfg.hidden_dim
        self.pts_linears = nn.ModuleList(layers)
        self.density_head = nn.Linear(cfg.hidden_dim, 1)
        self.dir_linear = nn.Linear(cfg.hidden_dim + cfg.dir_enc_dim, cfg.hidden_dim // 2)
        self.appearance_projection = (
            nn.Linear(cfg.appearance_dim, cfg.hidden_dim // 2) if cfg.use_appearance else None)
        self.rgb_linear = nn.Linear(cfg.hidden_dim // 2, 3)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(+-1/sqrt(in)) for every weight and bias (torch.nn.Linear's
        default bound), plus ``density_bias_init`` on the density bias."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
        if self.cfg.density_bias_init:
            self.density_head.bias += self.cfg.density_bias_init

    def forward(self, x: torch.Tensor, d: torch.Tensor,
                appearance_embedding: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None):
        """Field at positions ``x`` (..., 3) with unit view dirs ``d``.

        Returns rgb (..., 3) in [0, 1] and sigma (...,) >= 0.
        """
        cfg = self.cfg
        cdt = torch.bfloat16 if cfg.use_bf16 else torch.float32
        enc_x = positional_encoding(x, cfg.pos_enc_levels)
        enc_d = positional_encoding(d, cfg.dir_enc_levels)
        if cfg.use_time:
            if t is None:
                raise ValueError("cfg.use_time=True requires a time input t")
            enc_x = torch.cat([enc_x, positional_encoding(t, cfg.time_enc_levels)], dim=-1)

        h = self._trunk(enc_x, cdt)
        act = F.softplus if cfg.density_activation == "softplus" else F.relu
        sigma = act(_linear(self.density_head, h, cdt))[..., 0]

        h_dir = F.relu(_linear(self.dir_linear, torch.cat([h, enc_d], dim=-1), cdt))
        if self.appearance_projection is not None and appearance_embedding is not None:
            h_dir = h_dir + _linear(self.appearance_projection, appearance_embedding, cdt)
        rgb = torch.sigmoid(_linear(self.rgb_linear, h_dir, cdt))
        return rgb, sigma

    def _trunk(self, enc_x: torch.Tensor, cdt) -> torch.Tensor:
        """The ReLU trunk on the encoded input, which re-enters at each skip
        layer."""
        h = enc_x
        for i, layer in enumerate(self.pts_linears):
            if i in self.cfg.skip_connect_layers and i > 0:
                h = torch.cat([h, enc_x], dim=-1)
            h = F.relu(_linear(layer, h, cdt))
        return h


def init_appearance_embeddings(num_images: int, appearance_dim: int,
                               generator: Optional[torch.Generator] = None,
                               device=None) -> torch.Tensor:
    """Per-image N(0, 1) appearance embeddings, an (N, E) f32 table
    (reference src/dataset.py:81-83)."""
    return torch.randn(num_images, appearance_dim, generator=generator, device=device)
