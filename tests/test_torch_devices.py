"""The port's entry points run on the card unless the caller asks for the CPU:
``RayDataset.device_arrays`` and ``params_from_jax_module`` default to
``"cuda"`` and, without CUDA, raise instead of carrying on on the CPU;
``device="cpu"`` puts their tensors on the CPU."""

import numpy as np
import pytest
import torch

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.utils.convert import params_to_jax

SMALL = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8)


def _pool(**kw):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(2, 4, 5, 3), dtype=np.uint8)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ds = RayDataset(imgs, imgs[..., 0], c2ws, 5.0, 2.0, 6.0)
    return ds.device_arrays(True, **kw)["images"]


def _module(**kw):
    sd = NeRF(SMALL, torch.Generator().manual_seed(0)).state_dict()
    params = params_to_jax(sd)
    return next(params_from_jax_module(params, SMALL, **kw).parameters())


@pytest.mark.parametrize("make", [_pool, _module], ids=["device_arrays", "params_from_jax_module"])
def test_entry_point_defaults_to_the_card(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert make(device="cpu").device.type == "cpu"
