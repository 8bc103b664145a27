"""The port's rendering slice end to end against danerf_tpu on the CPU:
render_rays on its three routes, render_frame with a ragged last chunk, the
render CLI writing its files, and the viridis table and PNG writer.

The JAX side's kernel route runs its Pallas kernels in interpret mode.
Params come from the JAX package's init (converted with params_from_jax);
camera and rays from seeded numpy values.  perturb=False throughout, so
neither side draws random numbers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.models import init_nerf_params
from danerf_tpu.render.renderer import render_frame as j_render_frame
from danerf_tpu.render.renderer import render_rays as j_render_rays
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
from danerf_tpu_torch.render.renderer import render_frame, render_rays
from danerf_tpu_torch.viz.paths import camera_path

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5, num_samples=16, num_importance=8, use_bf16=False)

# f32 on both sides.  The two routes of one package agree to summation
# order; between packages the coarse weights differ in the last f32 bits,
# which moves the importance depths by as much and the fine composite by
# less than 1e-4.
ATOL = 1e-4


def _setup(seed=0, **over):
    jcfg = JaxConfig(**SMALL, **over)
    cfg = NeRFConfig(**SMALL, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu").requires_grad_(False)
    return jcfg, cfg, params, model


def _rays(n, cfg, seed=1):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    emb = rng.normal(size=(n, cfg.appearance_dim)).astype(np.float32)
    return o, d, emb


# route: (fused_composite, the port's use_kernels, JAX use_pallas).  The
# fused route runs the ray-march kernels whatever use_pallas says; the
# per-sample route runs K1 under use_kernels / use_pallas and the module's
# forward (nerf_apply) without.
ROUTES = {"kernel_route": (True, True, False), "reference_route": (False, False, False),
          "per_sample_kernel_route": (False, True, True)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("bg", [None, (1.0, 1.0, 1.0)], ids=["black", "white"])
def test_render_rays_matches(route, bg):
    fused, use_kernels, use_pallas = ROUTES[route]
    jcfg, cfg, params, model = _setup()
    jcfg, cfg = jcfg.replace(use_pallas=use_pallas), cfg.replace(use_kernels=use_kernels)
    o, d, emb = _rays(24, cfg)
    want = j_render_rays(params, jcfg, jax.random.key(0), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(emb), perturb=False, background_color=bg,
                         fused_composite=fused)
    got = render_rays(model, cfg, torch.tensor(o), torch.tensor(d), torch.tensor(emb),
                      perturb=False, background_color=bg, fused_composite=fused)
    assert got["weights"].shape == (24, 24) and got["z_vals"].shape == (24, 24)
    assert float(got["acc"].mean()) > 0.1
    for k in ("rgb", "depth", "acc", "weights", "z_vals", "coarse_rgb", "coarse_depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=ATOL, err_msg=k)


def test_render_frame_ragged_chunks_matches():
    """12x10 = 120 rays in chunks of 48: the last chunk holds 24 rays."""
    jcfg, cfg, params, model = _setup()
    c2w = camera_path("circle", 3, "lego")[1]
    emb = np.random.default_rng(2).normal(size=cfg.appearance_dim).astype(np.float32)
    rgb_j, depth_j, acc_j = j_render_frame(params, jcfg.replace(use_pallas=True),
                                           jax.random.key(0), c2w, 12, 10, 11.0,
                                           appearance_embedding=jnp.asarray(emb),
                                           chunk=48)
    rgb, depth, acc = render_frame(model, cfg, c2w, 12, 10, 11.0,
                                   appearance_embedding=torch.tensor(emb), chunk=48,
                                   device="cpu")
    assert rgb.shape == (12, 10, 3) and depth.shape == (12, 10)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=ATOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), atol=ATOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=ATOL)


def _checkpoint(tmp_path):
    from danerf_tpu_torch.models.nerf import NeRF

    model = NeRF(NeRFConfig(density_bias_init=0.5), torch.Generator().manual_seed(0))
    path = tmp_path / "model.pt"
    torch.save({"model_state_dict": model.state_dict(),
                "appearance_embeddings": torch.randn(2, 32), "iteration": 3}, path)
    return str(path)


def test_cli_render_writes_frames(tmp_path):
    from danerf_tpu_torch.cli.main import main
    from danerf_tpu_torch.kernels import fused_render as fr

    out = tmp_path / "out"
    fr.reset_launch_counts()
    written = main(["render", "--checkpoint", _checkpoint(tmp_path), "--output_dir",
                    str(out), "--frames", "1", "--width", "8", "--height", "8",
                    "--quality", "medium", "--save_depth", "--device", "cpu",
                    "--dataset_path", str(tmp_path / "no_data")])
    assert written == [str(out / "rgb_000.png")]
    assert not any(fr.LAUNCHES.values())   # CPU tensors take the plain versions
    for name in ("rgb_000.png", "depth_000.png"):
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    depth = np.load(out / "raw" / "depth_000.npy")
    assert depth.shape == (8, 8) and np.isfinite(depth).all()


# The time flags are ported (tests/test_torch_cli.py renders with them):
# beside an unported flag, the refusal names only that flag.
@pytest.mark.parametrize("flags", [["--effect", "fog"], ["--use_time", "--effect", "fog"],
                                   ["--animate_time", "--create_video"],
                                   ["--time", "0.5", "--mesh_data", "2"],
                                   ["--mesh_data", "2"], ["--create_video"]])
def test_cli_refuses_flags_not_yet_ported(tmp_path, flags):
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(NotImplementedError, match="not yet ported") as err:
        main(["render", "--checkpoint", str(tmp_path / "m.pt"), "--device", "cpu", *flags])
    assert "time" not in str(err.value)


def test_cli_refuses_orbax_checkpoint_dir(tmp_path):
    from danerf_tpu_torch.cli.main import main

    with pytest.raises(NotImplementedError, match="Orbax"):
        main(["render", "--checkpoint", str(tmp_path), "--device", "cpu"])


def test_scene_intrinsics_match_load_dataset(tmp_path):
    """Width and focal as the JAX loaders give them: the procedural scene's
    constants, and a Blender scene's header."""
    from danerf_tpu.data import load_dataset as j_load
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.data import load_dataset, scene_intrinsics

    cfg = NeRFConfig(dataset_path=str(tmp_path / "none"))
    info = scene_intrinsics(cfg)
    assert info.width == 100
    np.testing.assert_allclose(info.focal, 0.5 * 100 / np.tan(0.5 * 0.6911))

    ds = make_synthetic_scene(n_images=2, height=16, width=24, n_samples=8)
    save_blender_scene(ds, str(tmp_path / "lego"), split="train")
    jds = j_load(JaxConfig(dataset_path=str(tmp_path), scene="lego"))
    cfg = NeRFConfig(dataset_path=str(tmp_path), scene="lego")
    info = scene_intrinsics(cfg)
    assert info.width == jds.width == load_dataset(cfg).width == 24
    np.testing.assert_allclose(info.focal, jds.focal, rtol=1e-6)


def test_viridis_table_matches_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    from danerf_tpu_torch.viz.depth import colorize_depth, normalize_depth

    depth = np.random.default_rng(0).random((17, 23)).astype(np.float32) * 4 + 2
    depth[0, 0], depth[0, 1] = 2.0, 6.0   # both ends of the table
    want = (matplotlib.colormaps["viridis"](normalize_depth(depth))[..., :3] * 255
            ).astype(np.uint8)
    np.testing.assert_array_equal(colorize_depth(depth), want)
    from danerf_tpu.viz.depth import colorize_depth as j_colorize

    np.testing.assert_array_equal(colorize_depth(depth), j_colorize(depth))


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4)], ids=["rgb", "gray"])
def test_png_writer_round_trips(tmp_path, shape):
    Image = pytest.importorskip("PIL.Image")
    from danerf_tpu_torch.viz.png import write_png

    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    path = os.path.join(tmp_path, "x.png")
    write_png(path, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
