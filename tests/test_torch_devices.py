"""The port's entry points run on the card unless the caller asks for the CPU:
``RayDataset.device_arrays``, ``params_from_jax_module``, ``evaluate``, the
``eval`` subcommand, ``parallel.initialize_distributed`` and
``parallel.make_mesh`` and, on numpy input, ``fx.apply_effect`` and
``fx.apply_effect_to_frames`` default to
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


def _effect(**kw):
    from danerf_tpu_torch.fx import apply_effect

    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    return apply_effect("Toon Shader", img, np.linspace(0, 1, 30).reshape(6, 5), **kw)


def _frames(tmp_path, **kw):
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.fx import apply_effect_to_frames
    from danerf_tpu_torch.viz.png import write_png

    src = tmp_path / "in"
    src.mkdir(exist_ok=True)
    write_png(str(src / "frame_0000.png"), np.full((6, 5, 3), 100, np.uint8))
    (out,) = apply_effect_to_frames(str(src), str(tmp_path / "out" / "x"), "Sepia",
                                    make_video=False, skip_existing=False, **kw)
    return torch.from_numpy(read_png(out))


@pytest.mark.parametrize("which", ["apply_effect", "apply_effect_to_frames"])
def test_effects_default_to_the_card(tmp_path, which):
    run = _effect if which == "apply_effect" else (lambda **kw: _frames(tmp_path, **kw))
    if torch.cuda.is_available():
        run()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    out = run(device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (6, 5, 3) and out.device.type == "cpu"


def _evaluate(tmp_path, **kw):
    from danerf_tpu_torch.train.evaluate import evaluate

    cfg = SMALL.replace(num_samples=8, num_importance=4)
    rng = np.random.default_rng(0)
    c2ws = np.eye(4, dtype=np.float32)[None].copy()
    c2ws[0, 2, 3] = 4.0
    ds = RayDataset(rng.integers(0, 256, (1, 6, 8, 3), dtype=np.uint8),
                    np.full((1, 6, 8), 255, np.uint8), c2ws, 5.0, 2.0, 6.0)
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    return evaluate(model, cfg, ds, optimize_embeddings=True, opt_steps=1, **kw)


def _eval_cli(tmp_path, **kw):
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "m.pt")
    save_checkpoint(ckpt, NeRF(NeRFConfig(), torch.Generator().manual_seed(0)),
                    torch.zeros(1, 32))
    argv = ["eval", "--checkpoint", ckpt, "--dataset_path", str(tmp_path / "none"),
            "--max_views", "1", "--num_importance", "0"]
    if "device" in kw:
        argv += ["--device", kw["device"]]
    return main(argv)


@pytest.mark.parametrize("which", ["evaluate", "eval"])
def test_evaluation_defaults_to_the_card(tmp_path, which):
    """``evaluate`` and ``eval`` run on the card unless the CPU is asked for;
    without CUDA the default raises before any work."""
    run = _evaluate if which == "evaluate" else _eval_cli
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(tmp_path)
    if which == "evaluate":     # (the CLI on the CPU at full width is left to test_torch_eval)
        out = run(tmp_path, device="cpu")
        assert out["n_views"] == 1 and np.isfinite(out["psnr"])


@pytest.mark.parametrize("which", ["initialize_distributed", "make_mesh"])
def test_parallel_defaults_to_the_card(monkeypatch, which):
    """Without CUDA, ``initialize_distributed`` (a multi-process call) and
    ``make_mesh`` raise before joining or using any group; with
    ``device="cpu"`` the first joins gloo, and the second then asks for a
    process group."""
    import torch.distributed as dist

    from danerf_tpu_torch.parallel import initialize_distributed, make_mesh

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append(a))
    run = {"initialize_distributed": lambda **kw: initialize_distributed("127.0.0.1:1", 2, 0,
                                                                         **kw),
           "make_mesh": lambda **kw: make_mesh(**kw)}[which]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
    assert calls == []
    if which == "initialize_distributed":
        assert run(device="cpu") is True and calls == [("gloo",)]
    else:
        with pytest.raises(RuntimeError, match="initialized process group"):
            run(device="cpu")
