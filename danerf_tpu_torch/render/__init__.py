from danerf_tpu_torch.render.frames import render_aligned_spiral, render_path
from danerf_tpu_torch.render.renderer import render_frame, render_rays

__all__ = ["render_aligned_spiral", "render_path", "render_frame", "render_rays"]
