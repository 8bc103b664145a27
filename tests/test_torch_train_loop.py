"""The rest of the training loop against danerf_tpu on the CPU: resume,
several steps a call, the validation render, SSIM, the training curves,
profiling, the workspace helpers and per-ray image draws.

Small config (hidden 32, 2 layers, 8 + 4 samples, 16-ray batches, two
warm-up steps) on the procedural scene at 12x10 (its time-varying form at
8x8 under use_time).

Tolerances.  Resume and chunking compare one package with itself on the
same arithmetic: bit for bit, each run on one thread (``_one_thread``).
SSIM: the host versions are the same float64 formula, so 1e-12; the device
versions sum the f32 window products in another order (a matmul against
JAX's stacked slices), so 1e-5.  The validation render runs both
packages' reference route (f32 module forward, perturb off, JAX params
carried across): rgb within 1e-4 before the u8 cast, so at most 1 u8 level
apart after it (2 allowed); the depth half is viridis of the min-max
normalised depth, where a depth within 1e-4 of a colour-bin edge can land
one bin over, so 99% of its pixels must be identical.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu_torch.config import NeRFConfig

torch.set_num_threads(2)

SMALL = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
             num_samples=8, num_importance=4, warmup_iters=2, batch_size=16,
             density_bias_init=0.5, scheduler_step_size=5)


def _scene(use_time=False):
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene, make_time_varying_scene

    if use_time:
        return make_time_varying_scene(n_images=4, height=8, width=8, n_samples=16)
    return make_synthetic_scene(n_images=4, height=12, width=10, n_samples=16)


def _train(save, ds, cfg, **kw):
    from danerf_tpu_torch.train.trainer import train

    return train(cfg, ds, save_dir=str(save), device="cpu", progress=False,
                 log_path=os.path.join(save, "metrics.jsonl"), **kw)


def _rows(save, first=1):
    """metrics.jsonl rows from step ``first`` on, without the wall-clock stamp."""
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "t"} for r in rows if r["step"] >= first]


@contextlib.contextmanager
def _one_thread():
    """Run the block on one intra-op thread.  PyTorch computes sin and the
    like on the CPU through MKL's vector math, split across its OpenMP
    threads, and the first such call in a process, made from two threads at
    once, can take another MKL code path for one thread's share: the first
    training run of a fresh process then differs from a second one in the
    last bits from step 1 (``[no_time]`` failed in 2 of 169 fresh worker
    processes on a loaded 8-core host; the encoding of its first step,
    recomputed in a fresh process, differed in 9 of 200 on two threads, 0
    of 200 on one, 0 of 200 with ``MKL_CBWR=COMPATIBLE``).  On one thread
    every call agrees."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _state(ckpt):
    return torch.load(ckpt, map_location="cpu", weights_only=False)


def _assert_same_state(a, b):
    """Two checkpoints' module, table, Adam, StepLR and generator, bit for bit."""
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    assert torch.equal(a["appearance_embeddings"], b["appearance_embeddings"])
    sa, sb = a["optimizer_state_dict"], b["optimizer_state_dict"]
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a["scheduler_state_dict"] == b["scheduler_state_dict"]
    assert torch.equal(a["generator_state"], b["generator_state"])
    assert a["iteration"] == b["iteration"]


@pytest.mark.parametrize("use_time,use_bf16", [(False, True), (True, True), (False, False),
                                               (True, False)],
                         ids=["no_time", "use_time", "f32_no_time", "f32_use_time"])
def test_resume_equals_the_straight_run(tmp_path, use_time, use_bf16):
    """12 steps straight equal 8 steps, then resume=True to 12, bit for bit:
    the module, table, Adam's moments and counts, StepLR (its step size 5,
    so both runs cross two rate changes), the generator, and the rows of
    steps 9-12; the resumed run's first row is step 9.  In both kernel
    configurations (use_bf16=False: the f32 plain versions of K2, K4, K3,
    and of K5, K6 under use_time)."""
    cfg = NeRFConfig(**SMALL, use_time=use_time, use_bf16=use_bf16)
    ds = _scene(use_time)
    straight, split = tmp_path / "straight", tmp_path / "split"
    with _one_thread():
        _train(straight, ds, cfg, num_iterations=12, checkpoint_every=4)
        _train(split, ds, cfg, num_iterations=8, checkpoint_every=4)
        model, table, logger = _train(split, ds, cfg, num_iterations=12, checkpoint_every=4,
                                      resume=True)
    assert logger.history[0]["step"] == 9
    assert [r["step"] for r in _rows(split)] == list(range(1, 13))
    assert _rows(split, 9) == _rows(straight, 9)
    a = _state(straight / "checkpoint_final.pt")
    _assert_same_state(a, _state(split / "checkpoint_final.pt"))
    assert a["scheduler_state_dict"]["last_epoch"] == 12
    assert a["optimizer_state_dict"]["param_groups"][0]["lr"] == pytest.approx(
        cfg.learning_rate * cfg.scheduler_gamma ** 2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, a["model_state_dict"][k]), k


def _steps_per_call_runs(tmp_path, cfg):
    """steps_per_call 1, 3 and 10 over 23 steps with a checkpoint every 7
    (chunks never cross one, so 3 and 10 run short chunks singly): the same
    parameters, table and Adam state bit for bit, and the same rows, one a
    step."""
    ds = _scene()
    runs = {}
    for k in (1, 3, 10):
        with _one_thread():
            _train(tmp_path / f"k{k}", ds, cfg, num_iterations=23, checkpoint_every=7,
                   steps_per_call=k, eval_every=0)
        runs[k] = tmp_path / f"k{k}"
    assert [r["step"] for r in _rows(runs[1])] == list(range(1, 24))
    for k in (3, 10):
        assert _rows(runs[k]) == _rows(runs[1]), k
        _assert_same_state(_state(runs[1] / "checkpoint_final.pt"),
                           _state(runs[k] / "checkpoint_final.pt"))
        assert sorted(p.name for p in runs[k].glob("checkpoint_*.pt")) == [
            "checkpoint_000007.pt", "checkpoint_000014.pt", "checkpoint_000021.pt",
            "checkpoint_final.pt"]


def test_steps_per_call_gives_the_same_run(tmp_path):
    """_steps_per_call_runs on the default (bf16) configuration."""
    _steps_per_call_runs(tmp_path, NeRFConfig(**SMALL))


@pytest.mark.parametrize("over", [{}, {"num_importance": 0}],
                         ids=["hier", "coarse_only"])
def test_steps_per_call_gives_the_same_run_f32(tmp_path, over):
    """_steps_per_call_runs with use_bf16=False (the f32 plain versions of
    K2, K4, K3; coarse-only: of K7)."""
    _steps_per_call_runs(tmp_path, NeRFConfig(**{**SMALL, **over}, use_bf16=False))


def test_make_train_step_rows(tmp_path):
    """make_train_step's callable returns one entry a step per metric, with
    the metrics train_step returns, and StepLR stepped once a step."""
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, make_train_step

    cfg = NeRFConfig(**SMALL)
    ds = _scene()
    model, table = init_model(cfg, ds.n_images, 0, "cpu")
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    step = make_train_step(model, table, opt, sched, ds.device_arrays(device="cpu"), cfg,
                           ds.height, ds.width, ds.focal, generator=torch.Generator(),
                           steps_per_call=3)
    m = step()
    assert list(m) == ["loss", "psnr", "mse", "coarse_mse"]
    assert all(v.shape == (3,) and bool(torch.isfinite(v).all()) for v in m.values())
    assert sched.last_epoch == 3


def test_validation_render_matches_jax(tmp_path, capsys):
    """render_000004.png of the port against the one the JAX trainer's
    _save_validation_render writes, from the same JAX parameters and table
    on both packages' reference route; a render that raises is printed."""
    from danerf_tpu.config import NeRFConfig as JaxConfig
    from danerf_tpu.data.dataset import RayDataset as JaxDataset
    from danerf_tpu.models import init_appearance_embeddings, init_nerf_params
    from danerf_tpu.train import trainer as j_trainer
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
    from danerf_tpu_torch.render import renderer
    from danerf_tpu_torch.train.trainer import _save_validation_render

    over = {k: v for k, v in SMALL.items() if k in ("hidden_dim", "num_layers",
                                                    "skip_connect_layers", "appearance_dim",
                                                    "num_samples", "num_importance",
                                                    "density_bias_init")}
    jcfg = JaxConfig(**over, use_bf16=False, use_pallas=False)
    cfg = NeRFConfig(**over, use_bf16=False, use_kernels=False)
    ds = _scene()
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(0), jcfg))
    app = np.asarray(init_appearance_embeddings(jax.random.key(1), ds.n_images,
                                                cfg.appearance_dim))
    jds = JaxDataset(ds.images, ds.alphas, ds.c2ws, ds.focal, ds.near, ds.far)
    state = j_trainer.TrainState({"model": params, "appearance": jnp.asarray(app)}, None,
                                 jnp.asarray(4), jax.random.key(0))
    (tmp_path / "jax").mkdir()
    j_trainer._save_validation_render(state, jcfg, jds, str(tmp_path / "jax"), 4)
    model = params_from_jax_module(params, cfg, device="cpu")
    table = torch.nn.Parameter(torch.tensor(app))
    _save_validation_render(model, table, cfg, ds, str(tmp_path), 4, "cpu")

    got, want = read_png(str(tmp_path / "render_000004.png")), read_png(
        str(tmp_path / "jax" / "render_000004.png"))
    assert got.shape == want.shape == (12, 20, 3)
    rgb_diff = np.abs(got[:, :10].astype(int) - want[:, :10].astype(int))
    assert rgb_diff.max() <= 2
    assert (got[:, 10:] == want[:, 10:]).all(-1).mean() >= 0.99

    def broken(*a, **k):
        raise RuntimeError("no device")

    capsys.readouterr()
    renderer_frame = renderer.render_frame
    try:
        renderer.render_frame = broken
        _save_validation_render(model, table, cfg, ds, str(tmp_path), 8, "cpu")
    finally:
        renderer.render_frame = renderer_frame
    assert "validation render failed at step 8: no device" in capsys.readouterr().out
    assert not (tmp_path / "render_000008.png").exists()


_SSIM_CASES = {"rgb_32x40": (32, 40, 3), "rgb_8x8_global_window": (8, 8, 3),
               "gray_24x20": (24, 20)}


@pytest.mark.parametrize("shape", list(_SSIM_CASES.values()), ids=list(_SSIM_CASES))
def test_ssim_matches_jax(shape):
    """ssim against danerf_tpu.train.metrics.ssim (1e-12) on seeded images,
    a noisy copy of one against it."""
    from danerf_tpu.train.metrics import ssim as j_ssim
    from danerf_tpu_torch.train.metrics import ssim

    rng = np.random.default_rng(0)
    a = rng.random(shape)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1)
    got = ssim(a, b)
    assert abs(got - j_ssim(a, b)) <= 1e-12
    assert 0.0 < got < 1.0 and ssim(a, a) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("shape", list(_SSIM_CASES.values()), ids=list(_SSIM_CASES))
def test_ssim_device_matches_jax(shape):
    """ssim_device (torch, f32) against danerf_tpu.train.metrics.ssim_device
    (1e-5), and against the host ssim within f32 rounding."""
    from danerf_tpu.train.metrics import ssim_device as j_ssim_device
    from danerf_tpu_torch.train.metrics import ssim, ssim_device

    rng = np.random.default_rng(1)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    got = ssim_device(torch.tensor(a), torch.tensor(b))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - float(j_ssim_device(jnp.asarray(a), jnp.asarray(b)))) <= 1e-5
    assert abs(float(got) - ssim(a, b)) <= 1e-5


def test_training_curves_png(tmp_path):
    """training_curves.png decodes to two 400x500 panels; on a falling loss
    series the drawn loss line falls from left to right (and the rising
    PSNR line rises)."""
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.curves import LINE, write_training_curves

    loss = np.exp(-np.linspace(0, 3, 50))
    history = [{"step": i + 1, "loss": float(v), "psnr": float(-10 * np.log10(v))}
               for i, v in enumerate(loss)]
    path = str(tmp_path / "training_curves.png")
    write_training_curves(path, history)
    img = read_png(path)
    assert img.shape == (400, 1000, 3)

    def line_rows(panel, cols):
        rows, cs = np.nonzero((panel[:, cols] == LINE).all(-1))
        return rows.mean()

    left, right = slice(80, 130), slice(430, 480)
    loss_panel, psnr_panel = img[:, :500], img[:, 500:]
    assert line_rows(loss_panel, left) < line_rows(loss_panel, right) - 100
    assert line_rows(psnr_panel, left) > line_rows(psnr_panel, right) + 100


def test_profiling_utilities(tmp_path):
    """trace writes a Chrome trace of its block into its directory; timeit
    and ThroughputMeter count calls and rays."""
    from danerf_tpu_torch.utils.profiling import ThroughputMeter, timeit, trace

    calls = []
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace_file,) = (tmp_path / "prof").glob("trace_*.json")
    assert "traceEvents" in json.loads(trace_file.read_text())
    assert timeit(lambda: calls.append(1), iters=4, warmup=2) >= 0.0 and len(calls) == 6
    meter = ThroughputMeter(window=3)
    for _ in range(5):
        meter.update(1024)
    assert meter.rays_per_sec > 0 and len(meter._events) == 3


def test_dirs_match_jax(tmp_path):
    """ensure_directories makes the JAX package's directories;
    list_checkpoints maps each checkpoints_* directory to its newest
    checkpoint as the JAX one does (.pt files here, Orbax directories
    there, side by side in one tree)."""
    from danerf_tpu.utils import dirs as j_dirs
    from danerf_tpu_torch.utils import dirs

    made = dirs.ensure_directories(str(tmp_path))
    assert [os.path.relpath(p, tmp_path) for p in made] == [
        os.path.relpath(p, tmp_path) for p in j_dirs.ensure_directories(str(tmp_path))]
    assert all(os.path.isdir(p) for p in made)
    for scene, names in {"lego": ["checkpoint_000004", "checkpoint_000012"],
                         "hotdog": ["checkpoint_000004", "checkpoint_final"],
                         "": ["checkpoint_000007"]}.items():
        d = tmp_path / ("checkpoints_" + scene if scene else "checkpoints")
        for n in names:
            (d / n).mkdir(parents=True)
            (d / n / "meta.json").write_text("{}")
            (d / f"{n}.pt").write_bytes(b"")
    (tmp_path / "checkpoints_empty").mkdir()
    want = j_dirs.list_checkpoints(str(tmp_path))
    got = dirs.list_checkpoints(str(tmp_path))
    assert set(want) == {"lego", "hotdog", "checkpoints"}
    assert got == {k: v + ".pt" for k, v in want.items()}


def test_sample_ray_batch_per_ray_images():
    """single_image=False: each ray its own image.  The JAX sampler's own
    draws (its key split, per-ray randint) passed in as img_idx/pix_idx give
    its batch; the port's own draws give per-ray indices over all images."""
    from danerf_tpu.config import NeRFConfig as JaxConfig
    from danerf_tpu.data.dataset import RayDataset as JaxDataset
    from danerf_tpu.data.dataset import sample_ray_batch as j_sample
    from danerf_tpu_torch.data.dataset import sample_ray_batch

    cfg = NeRFConfig(**SMALL)
    ds = _scene()
    jds = JaxDataset(ds.images, ds.alphas, ds.c2ws, ds.focal, ds.near, ds.far)
    key, n = jax.random.key(3), 64
    want = j_sample(key, jds.device_arrays(), JaxConfig(), ds.height, ds.width, ds.focal,
                    batch_size=n, single_image=False)
    k_img, k_pix = jax.random.split(key)
    img = np.asarray(jax.random.randint(k_img, (n,), 0, ds.n_images))
    pix = np.asarray(jax.random.randint(k_pix, (n,), 0, ds.height * ds.width))
    pool = ds.device_arrays(device="cpu")
    got = sample_ray_batch(pool, cfg, ds.height, ds.width, ds.focal, n,
                           img_idx=torch.tensor(img), pix_idx=torch.tensor(pix),
                           single_image=False)
    for k in ("rays_o", "rays_d", "rgb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    assert np.array_equal(got["img_idx"].numpy(), np.asarray(want["img_idx"]))
    drawn = sample_ray_batch(pool, cfg, ds.height, ds.width, ds.focal, 256,
                             torch.Generator().manual_seed(0), single_image=False)
    assert drawn["img_idx"].shape == (256,)
    assert set(drawn["img_idx"].tolist()) == set(range(ds.n_images))
    one = sample_ray_batch(pool, cfg, ds.height, ds.width, ds.focal, 256,
                           torch.Generator().manual_seed(0))
    assert len(set(one["img_idx"].tolist())) == 1


def test_checkpoint_reads_with_and_without_generator_state(tmp_path):
    """load_reference_checkpoint reads a checkpoint with generator_state and
    one without it (the reference's own files); restore_training_state
    leaves the generator alone without it."""
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer
    from danerf_tpu_torch.utils.checkpoint import restore_training_state, save_checkpoint
    from danerf_tpu_torch.utils.convert import load_reference_checkpoint

    cfg = NeRFConfig(**SMALL)
    model, table = init_model(cfg, 4, 0, "cpu")
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    gen = torch.Generator().manual_seed(5)
    with_gen = save_checkpoint(str(tmp_path / "a.pt"), model, table, opt, sched, 3,
                               generator=gen)
    without = save_checkpoint(str(tmp_path / "b.pt"), model, table, opt, sched, 3)
    for path in (with_gen, without):
        sd, emb, meta = load_reference_checkpoint(path)
        assert meta["iteration"] == 3 and torch.equal(emb, table.detach())
        assert set(sd) == set(model.state_dict())
    assert "generator_state" in _state(with_gen) and "generator_state" not in _state(without)
    other = torch.Generator().manual_seed(9)
    before = other.get_state()
    assert restore_training_state(without, model, table, opt, sched, other) == 3
    assert torch.equal(other.get_state(), before)
    restore_training_state(with_gen, model, table, opt, sched, other)
    assert torch.equal(other.get_state(), gen.get_state())


def test_composite_cumprod_gradient_is_torch_cumprod():
    """The transmittance's cumulative product (composite's
    _PositiveCumprod), whose backward makes no host sync so that a captured
    step can run it: value and gradient equal torch.cumprod's bit for bit
    on factors in [1e-10, 1], the range 1 - alpha + 1e-10 takes."""
    from danerf_tpu_torch.ops.composite import _PositiveCumprod

    g = torch.Generator().manual_seed(0)
    x = torch.rand(6, 4, 17, generator=g)
    x[0, 0, 3], x[1, 2, 5], x[2, 1, 0] = 1e-10, 1.0, 1e-10
    x.requires_grad_(True)
    cot = torch.randn(6, 4, 17, generator=g)
    want = torch.cumprod(x, -1)
    got = _PositiveCumprod.apply(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, cot)[0], torch.autograd.grad(want, x, cot)[0])
