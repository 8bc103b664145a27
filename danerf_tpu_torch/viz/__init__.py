from danerf_tpu_torch.viz.depth import colorize_depth, depth_to_gray_u8, normalize_depth
from danerf_tpu_torch.viz.paths import (aligned_spiral_path, alignment_matrix, camera_path,
                                        scene_center_up)
from danerf_tpu_torch.viz.png import write_png
from danerf_tpu_torch.viz.video import create_video_from_images

__all__ = ["colorize_depth", "depth_to_gray_u8", "normalize_depth", "aligned_spiral_path",
           "alignment_matrix", "camera_path", "scene_center_up", "write_png",
           "create_video_from_images"]
