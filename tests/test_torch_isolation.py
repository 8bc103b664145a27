"""danerf_tpu_torch stands alone: it imports neither JAX nor danerf_tpu
(it renders a frame, a frame of a time-conditioned model at two times, and
takes a 64 + 64, a coarse-only, a per-sample and a time-conditioned
training step with both blocked), and
asking it for CUDA on a host without CUDA raises instead of falling back to
the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "danerf_tpu"):
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import danerf_tpu_torch
for m in pkgutil.walk_packages(danerf_tpu_torch.__path__, "danerf_tpu_torch."):
    importlib.import_module(m.name)

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.render.renderer import render_frame
from danerf_tpu_torch.viz.paths import camera_path

cfg = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
                 num_samples=8, num_importance=4)
model = NeRF(cfg, torch.Generator().manual_seed(0))
c2w = camera_path("circle", 2, "lego")[0]
rgb, depth, acc = render_frame(model, cfg, c2w, 6, 5, 6.0, device="cpu")
assert rgb.shape == (6, 5, 3) and bool(torch.isfinite(depth).all())
assert torch.cuda.is_available() is False
try:
    render_frame(model, cfg, c2w, 6, 5, 6.0, device="cuda")
except RuntimeError as e:
    assert "CUDA is not available" in str(e), e
else:
    raise AssertionError("device='cuda' did not raise on a host without CUDA")
# one training step on the kernel route (the plain K2/K3/K4 on the CPU)
from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step
import numpy as np
ds = RayDataset(np.full((2, 6, 5, 3), 128, np.uint8), np.full((2, 6, 5), 255, np.uint8),
                np.stack([np.asarray(camera_path("circle", 2, "lego")[0])] * 2), 6.0, 2.0, 6.0)
model, table = init_model(cfg, 2, 0, "cpu")
opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
m = train_step(model, table, opt, sched, ds.device_arrays(device="cpu"), cfg, 6, 5, 6.0, 4,
               torch.Generator().manual_seed(0))
assert bool(torch.isfinite(m["loss"])) and table.grad is not None
# and one coarse-only step (the plain K7)
coarse = cfg.replace(num_importance=0)
model, table = init_model(coarse, 2, 0, "cpu")
opt, sched = make_optimizer(coarse, list(model.parameters()) + [table])
m = train_step(model, table, opt, sched, ds.device_arrays(device="cpu"), coarse, 6, 5, 6.0, 4,
               torch.Generator().manual_seed(0))
assert bool(torch.isfinite(m["loss"])) and set(m) == {"loss", "psnr", "mse"}
# and one step of the per-sample route (the plain K1/K8)
per_sample = cfg.replace(use_fused_train=False)
model, table = init_model(per_sample, 2, 0, "cpu")
opt, sched = make_optimizer(per_sample, list(model.parameters()) + [table])
m = train_step(model, table, opt, sched, ds.device_arrays(device="cpu"), per_sample, 6, 5, 6.0, 4,
               torch.Generator().manual_seed(0))
assert bool(torch.isfinite(m["loss"])) and "coarse_mse" in m
# a use_time render at two times and a use_time step (the plain has_time
# K2/K5 forward, K6/K3 backward)
timed = cfg.replace(use_time=True)
model, table = init_model(timed, 2, 0, "cpu")
with torch.no_grad():
    rgb0, _, _ = render_frame(model, timed, c2w, 6, 5, 6.0, t=0.0, device="cpu")
    rgb1, depth1, _ = render_frame(model, timed, c2w, 6, 5, 6.0, t=1.0, device="cpu")
assert bool(torch.isfinite(depth1).all()) and not torch.equal(rgb0, rgb1)
ds.times = np.array([0.0, 1.0], np.float32)
opt, sched = make_optimizer(timed, list(model.parameters()) + [table])
m = train_step(model, table, opt, sched, ds.device_arrays(device="cpu"), timed, 6, 5, 6.0, 4,
               torch.Generator().manual_seed(0))
assert bool(torch.isfinite(m["loss"])) and "coarse_mse" in m
assert not any(k.split(".")[0] in ("jax", "danerf_tpu") for k in sys.modules)
print("ISOLATED-OK")
'''


def test_imports_and_renders_without_jax():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def test_sources_name_no_jax_module():
    pattern = re.compile(r"^\s*(import jax|from jax|import danerf_tpu\b(?!_torch)"
                         r"|from danerf_tpu[. ](?!_torch))", re.M)
    files = list((ROOT / "danerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_kernel_sources_present():
    """Each kernel of the slice has its CUDA source; the package lists them."""
    from danerf_tpu_torch.kernels import _build

    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "field' in src and "replaces" in src.lower()
    assert {m.name for m in pkgutil.iter_modules([str(_build.CSRC.parent)])} >= {
        "fused_mlp", "fused_render", "_build"}
