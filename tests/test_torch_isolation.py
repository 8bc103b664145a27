"""danerf_tpu_torch stands alone: it imports neither JAX nor danerf_tpu, and
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
        assert "field.cuh" in src and "replaces" in src.lower()
    assert {m.name for m in pkgutil.iter_modules([str(_build.CSRC.parent)])} >= {
        "fused_mlp", "fused_render", "_build"}
