from danerf_tpu_torch.ops.composite import composite
from danerf_tpu_torch.ops.encoding import positional_encoding
from danerf_tpu_torch.ops.rays import generate_rays, look_at_c2w
from danerf_tpu_torch.ops.sampling import (combine_z, importance_uniforms,
                                           ray_aabb_bounds, sample_pdf,
                                           sample_stratified)

__all__ = ["composite", "positional_encoding",
           "generate_rays", "look_at_c2w", "combine_z", "importance_uniforms",
           "ray_aabb_bounds", "sample_pdf", "sample_stratified"]
