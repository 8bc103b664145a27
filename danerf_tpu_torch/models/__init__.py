from danerf_tpu_torch.models.nerf import NeRF

__all__ = ["NeRF"]
