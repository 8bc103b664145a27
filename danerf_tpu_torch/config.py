"""Frozen configuration: the counterpart of ``danerf_tpu/config.py``.

The fields and defaults equal the JAX package's ``NeRFConfig``, except that
the TPU knobs ``use_pallas`` and ``fused_composite2d`` become one switch,
``use_kernels``: route rendering and training through the hand-written CUDA
kernels (on CUDA tensors; their plain PyTorch versions on CPU tensors).
``use_fused_train`` keeps the JAX meaning: with ``use_kernels``, training
goes through the fused ray-march kernels (K2-K7); off, through the
per-sample field kernels (K1 forward, K8 backward) with plain compositing.
``use_hier_onepass`` keeps the JAX meaning and default (off): hierarchical
training in one kernel a step (K9) instead of K2, K4 and K3; like the JAX
config, it warns when the switch is set where no route takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    # --- dataset ---
    dataset_type: str = "nerf_synthetic"
    dataset_path: str = "data/nerf_synthetic"
    scene: str = "lego"

    # --- model ---
    hidden_dim: int = 256
    num_layers: int = 8
    skip_connect_layers: Tuple[int, ...] = (4,)
    num_samples: int = 64        # coarse samples per ray
    num_importance: int = 64     # fine (importance) samples per ray

    # --- density head ---
    density_activation: str = "relu"       # "relu" | "softplus"
    density_bias_init: float = 0.0

    # --- appearance embedding ---
    use_appearance: bool = True
    appearance_dim: int = 32

    # --- time-conditioned variant ---
    use_time: bool = False
    time_enc_levels: int = 6

    # --- training ---
    batch_size: int = 1024
    learning_rate: float = 5e-4
    num_iterations: int = 30000
    scheduler_step_size: int = 10000
    scheduler_gamma: float = 0.5
    warmup_batch_size: int = 64
    warmup_iters: int = 5

    # --- scene bounds ---
    near: float = 2.0
    far: float = 6.0
    scene_aabb: "tuple | None" = None

    # --- loss ---
    coarse_loss_weight: float = 1.0

    # --- encodings ---
    pos_enc_levels: int = 10
    dir_enc_levels: int = 4

    # --- device ---
    # bf16 matmul inputs with f32 accumulation (the JAX package's use_bf16).
    use_bf16: bool = True
    # Hand-written kernels for rendering and training (else the module's
    # forward and autograd: the reference route, --no_pallas).
    use_kernels: bool = True
    # Training through the fused ray-march kernels (K2-K7, per-ray HBM I/O);
    # False: the per-sample field kernels K1/K8 with plain compositing
    # (render_rays with fused_composite=False).  Needs use_kernels.
    use_fused_train: bool = True
    # Hierarchical training as one kernel launch a step (K9: coarse march,
    # inverse CDF in the kernel, merged fine pass, both MSE terms and the
    # whole backward, the coarse forward never recomputed) instead of K2, K4
    # and K3.  Off by default, as in the JAX package; taken only where the
    # one-pass route serves the config (trainer.use_onepass) with a fine pass.
    use_hier_onepass: bool = False
    # Recompute the module's forward in the backward instead of keeping its
    # activations (torch.utils.checkpoint); the reference route only.
    remat: bool = False
    white_background: bool = False
    mesh_data: int = 1
    mesh_model: int = 1

    # --- rendering ---
    render_chunk: int = 65536    # rays per kernel call when rendering frames

    def __post_init__(self):
        # use_hier_onepass takes effect only on the one-pass training route
        # with a fine pass (train.trainer.use_onepass): warn instead of
        # silently training through other kernels
        if self.use_hier_onepass and not (
                self.use_kernels and self.use_fused_train
                and self.num_importance > 0 and not self.use_time):
            import warnings

            warnings.warn(
                "use_hier_onepass=True is ignored: it requires use_kernels, "
                "use_fused_train, num_importance>0 and use_time=False "
                "(train/trainer.py use_onepass)", stacklevel=2)

    # --- derived dims ---
    @property
    def pos_enc_dim(self) -> int:
        return 3 * (1 + 2 * self.pos_enc_levels)

    @property
    def dir_enc_dim(self) -> int:
        return 3 * (1 + 2 * self.dir_enc_levels)

    @property
    def time_enc_dim(self) -> int:
        return 1 * (1 + 2 * self.time_enc_levels)

    def replace(self, **kw) -> "NeRFConfig":
        return dataclasses.replace(self, **kw)


# Quality presets for frame rendering (the JAX package's RENDER_PRESETS).
RENDER_PRESETS = {
    # name: (samples_scale, chunk, perturb, use_importance)
    "preview": dict(samples_scale=0.5, chunk=65536, perturb=False, importance=False),
    "medium": dict(samples_scale=1.0, chunk=65536, perturb=True, importance=True),
    "high": dict(samples_scale=1.0, chunk=32768, perturb=True, importance=True),
}
