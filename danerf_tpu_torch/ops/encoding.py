"""Sinusoidal positional encoding (counterpart of danerf_tpu.ops.encoding).

``gamma(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]``
with the input prepended when ``include_input``.  Feature order defines the
column layout of the first MLP weight matrix.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_frequencies: int,
                        include_input: bool = True) -> torch.Tensor:
    """Encode ``x`` of shape (..., D) to (..., D * (2L + include_input));
    per frequency the order is [sin(f x), cos(f x)] over all D dims."""
    if num_frequencies == 0:
        return x if include_input else x[..., :0]
    freqs = 2.0 ** torch.arange(num_frequencies, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]                      # (..., L, D)
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)  # (..., L, 2, D)
    flat = sc.reshape(*x.shape[:-1], num_frequencies * 2 * x.shape[-1])
    if include_input:
        return torch.cat([x, flat], dim=-1)
    return flat
