"""danerf_tpu_torch stands alone: it imports neither JAX nor danerf_tpu,
nor an imaging library (it renders a frame, a frame of a time-conditioned
model at two times, and takes a 64 + 64, a coarse-only, a per-sample and a
time-conditioned training step, runs the training loop with a resume,
computes SSIM, applies an effect, renders an aligned-spiral frame with
its video, fits and scores through ``evaluate`` and ``eval``, loads a
custom scene of a JPEG and a PNG frame and a Blender scene downscaled by
8, and in a one-rank gloo group renders a sharded frame and trains on a
mesh (``parallel/``), with JAX, danerf_tpu, OpenCV, PIL and matplotlib
blocked), and
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
        if name.split(".")[0] in ("jax", "jaxlib", "danerf_tpu", "cv2", "PIL", "matplotlib"):
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
# the training loop (2 steps a call, a checkpoint at 2 with its validation
# render, the curves, a resume to 5) and SSIM on the host and the device
import os, tempfile
from danerf_tpu_torch.train.metrics import ssim, ssim_device
from danerf_tpu_torch.train.trainer import train
ds.times = None
loop = cfg.replace(batch_size=4, warmup_iters=1)
with tempfile.TemporaryDirectory() as tmp:
    train(loop, ds, save_dir=tmp, num_iterations=4, checkpoint_every=2, device="cpu",
          progress=False, steps_per_call=2)
    _, _, log = train(loop, ds, save_dir=tmp, num_iterations=5, device="cpu", progress=False,
                      resume=True)
    assert [r["step"] for r in log.history] == [5]
    assert all(os.path.exists(os.path.join(tmp, f))
               for f in ("render_000002.png", "training_curves.png"))
img = torch.rand(12, 12, 3)
assert abs(ssim(img.numpy(), img.numpy()) - 1) < 1e-9
assert abs(float(ssim_device(img, img)) - 1) < 1e-5
# an effect with depth, a spiral frame with its grayscale depth, the AVI writer
from danerf_tpu_torch.fx import apply_effect
from danerf_tpu_torch.render.frames import render_aligned_spiral
from danerf_tpu_torch.viz.video import read_avi
out = apply_effect("Toon Shader", torch.randint(0, 256, (9, 7, 3), dtype=torch.uint8),
                   torch.rand(9, 7))
assert out.dtype == torch.uint8 and out.shape == (9, 7, 3)
with tempfile.TemporaryDirectory() as tmp:
    model0 = NeRF(cfg, torch.Generator().manual_seed(0))
    render_aligned_spiral(model0, cfg, tmp, num_frames=1, height=6, width=5, device="cpu")
    assert os.path.exists(os.path.join(tmp, "depth_0000.png"))
    frames, fps = read_avi(os.path.join(tmp, "lego_spiral.avi"))
    assert frames.shape == (1, 6, 5, 3) and fps == 60
# evaluation: the fit (the plain K2/K5 forward, K6/K3 backward) and the
# score, through evaluate() and `eval`; the loaders: a custom scene of a
# JPEG and a PNG frame, the Blender loader with a Lanczos downscale
from danerf_tpu_torch.train.evaluate import evaluate
ds.times = None
model0 = NeRF(cfg, torch.Generator().manual_seed(0))
res = evaluate(model0, cfg, ds, optimize_embeddings=True, opt_steps=2, device="cpu")
assert res["protocol"].startswith("left-half") and np.isfinite(res["psnr"])
import json, shutil
from danerf_tpu_torch.cli.main import main as cli_main
from danerf_tpu_torch.config import NeRFConfig as Cfg
from danerf_tpu_torch.data.blender import load_blender_scene
from danerf_tpu_torch.data.dataset import load_dataset
from danerf_tpu_torch.viz.png import write_png
with tempfile.TemporaryDirectory() as tmp:
    shutil.copy(os.path.join("tests", "data_torch", "frame.jpg"), os.path.join(tmp, "a.jpg"))
    rgb = np.random.default_rng(0).integers(0, 256, (149, 203, 3), dtype=np.uint8)
    write_png(os.path.join(tmp, "b.png"), rgb)
    frames = [{"file_path": n, "transform_matrix": np.eye(4).tolist()}
              for n in ("a.jpg", "b.png", "a.jpg")]
    with open(os.path.join(tmp, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    custom = load_dataset(Cfg(dataset_type="custom", dataset_path=tmp), "train")
    assert custom.images.shape == (2, 149, 203, 3)
    assert np.array_equal(custom.images[1], rgb)
    os.makedirs(os.path.join(tmp, "blend", "train"))
    write_png(os.path.join(tmp, "blend", "train", "r_0.png"), rgb)
    with open(os.path.join(tmp, "blend", "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": [{"file_path": "./train/r_0",
                                                      "transform_matrix": np.eye(4).tolist()}]}, f)
    small = load_blender_scene(os.path.join(tmp, "blend"), downscale=8)
    assert small.images.shape == (1, 18, 25, 3)
    from danerf_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(os.path.join(tmp, "m.pt"), model0, torch.zeros(1, cfg.appearance_dim))
    import danerf_tpu_torch.config as config_mod
    config_mod.NeRFConfig = lambda **kw: cfg.replace(**kw)
    out = cli_main(["eval", "--checkpoint", os.path.join(tmp, "m.pt"), "--dataset_path",
                    tmp, "--scene", "blend", "--split", "train", "--device", "cpu"])
    assert out["n_views"] == 1 and np.isfinite(out["psnr"])
# parallel/: a one-rank gloo group, the sharded frame against the unsharded
# one, and train(mesh=) for 2 steps
import socket
import torch.distributed as dist
from danerf_tpu_torch.parallel import make_mesh, process_slice
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
mesh = make_mesh(device="cpu")
assert mesh.shape == {"data": 1, "model": 1} and process_slice(5) == slice(0, 5)
a = render_frame(model0, cfg, c2w, 6, 5, 6.0, device="cpu", mesh=mesh)
b = render_frame(model0, cfg, c2w, 6, 5, 6.0, device="cpu")
assert all(torch.equal(x, y) for x, y in zip(a, b))
with tempfile.TemporaryDirectory() as tmp:
    _, _, log = train(loop, ds, save_dir=tmp, num_iterations=2, device="cpu", progress=False,
                      mesh=mesh)
    assert [r["step"] for r in log.history] == [1, 2]
dist.destroy_process_group()
assert not any(k.split(".")[0] in ("jax", "danerf_tpu", "cv2", "PIL", "matplotlib")
               for k in sys.modules)
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


def test_sources_import_no_imaging_library():
    """The card's machine has no imaging library: the port reads and writes
    PNGs and AVIs itself, with no optional import of one either."""
    pattern = re.compile(r"^\s*(import (cv2|PIL|matplotlib)|from (cv2|PIL|matplotlib)\b)", re.M)
    files = list((ROOT / "danerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())] == []


def test_kernel_sources_present():
    """Each kernel of the slice has its CUDA source; the package lists them."""
    from danerf_tpu_torch.kernels import _build

    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "field' in src and "replaces" in src.lower()
    assert {m.name for m in pkgutil.iter_modules([str(_build.CSRC.parent)])} >= {
        "fused_mlp", "fused_render", "_build"}
