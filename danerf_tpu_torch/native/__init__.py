"""The native shader tool's bridge (counterpart of danerf_tpu.native)."""

from danerf_tpu_torch.native.bridge import ShaderBridge, ensure_built

__all__ = ["ShaderBridge", "ensure_built"]
