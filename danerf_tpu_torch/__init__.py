"""danerf_tpu_torch — the PyTorch/CUDA port of danerf_tpu (NeRF-W with
depth-aware shader effects) for NVIDIA Hopper.

Plain tensor code is PyTorch; the kernels of rendering (ray march, merged
composite) and of training (ray-march backward, merged fine pass with its
loss and backward) are hand-written CUDA C++ for ``sm_90a`` under
``kernels/csrc/``, built with ``nvcc`` on first use.  Module and function names follow ``danerf_tpu`` so a
reader can find each counterpart.  This package imports neither JAX nor
``danerf_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; asking for CUDA on a host without it raises instead of falling back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Raises RuntimeError when a CUDA device is requested and CUDA is absent:
    the port never carries on silently on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available on this "
            "host; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
