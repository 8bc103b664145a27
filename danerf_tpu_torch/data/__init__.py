from danerf_tpu_torch.data.dataset import (RayDataset, SceneIntrinsics, load_dataset,
                                           sample_ray_batch, scene_intrinsics)

__all__ = ["RayDataset", "SceneIntrinsics", "load_dataset", "sample_ray_batch",
           "scene_intrinsics"]
