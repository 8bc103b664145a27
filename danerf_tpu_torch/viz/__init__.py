from danerf_tpu_torch.viz.depth import colorize_depth, normalize_depth
from danerf_tpu_torch.viz.paths import camera_path, scene_center_up
from danerf_tpu_torch.viz.png import write_png

__all__ = ["colorize_depth", "normalize_depth", "camera_path", "scene_center_up",
           "write_png"]
