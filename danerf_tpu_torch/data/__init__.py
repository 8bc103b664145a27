from danerf_tpu_torch.data.dataset import SceneIntrinsics, load_dataset

__all__ = ["SceneIntrinsics", "load_dataset"]
