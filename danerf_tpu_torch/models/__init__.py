from danerf_tpu_torch.models.nerf import NeRF, init_appearance_embeddings, nerf_param_count

__all__ = ["NeRF", "init_appearance_embeddings", "nerf_param_count"]
