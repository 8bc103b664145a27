"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.
Nothing here builds or imports a GPU toolchain at import time."""
