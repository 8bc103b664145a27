from danerf_tpu_torch.fx.effects import EFFECTS, apply_effect, default_params
from danerf_tpu_torch.fx.batch import apply_effect_to_frames

__all__ = ["EFFECTS", "apply_effect", "default_params", "apply_effect_to_frames"]
