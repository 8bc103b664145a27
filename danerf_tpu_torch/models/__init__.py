from danerf_tpu_torch.models.nerf import NeRF, init_appearance_embeddings

__all__ = ["NeRF", "init_appearance_embeddings"]
