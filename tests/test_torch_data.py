"""The training slice's data path against danerf_tpu on the CPU: the
procedural scene (byte-identical), the Blender loader on a scene written by
the JAX package's writer, the port's PNG decoder against Pillow on every
colour type and scanline filter, and ``sample_ray_batch`` given JAX's own
draws.  Sizes are tiny (2 images of 16x16)."""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu_torch.config import NeRFConfig

torch.set_num_threads(2)


def test_synthetic_scene_is_byte_identical():
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_make
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    kw = dict(n_images=2, height=16, width=16, n_samples=32)
    want = j_make(backend="numpy", **kw)
    got = make_synthetic_scene(**kw)
    for k in ("images", "alphas", "c2ws"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.focal == want.focal and (got.near, got.far) == (want.near, want.far)


def _png_bytes(img: np.ndarray, filters) -> bytes:
    """PNG of uint8 (H, W[, C]) with row y filtered by filters[y % len]."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    x = img.reshape(h, w * ch).astype(np.int32)
    rows, prev = [], np.zeros(w * ch, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = x[y]
        a = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_decoder_matches_pillow(tmp_path, channels):
    Image = pytest.importorskip("PIL.Image")
    from danerf_tpu_torch.data.png import read_png

    rng = np.random.default_rng(channels)
    shape = (11, 9) if channels == 1 else (11, 9, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img, filters=[0, 1, 2, 3, 4]))    # every filter, row by row
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
    # Pillow's own encoder (adaptive filters)
    Image.fromarray(img).save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_png(path), np.asarray(im))


@pytest.mark.parametrize("filters", [[0], [2], [1], [0, 1, 2], [1, 4]],
                         ids=["none", "up", "sub", "none_sub_up", "sub_paeth"])
def test_png_decoder_row_filters(tmp_path, filters):
    """Rows filtered with None, Sub and Up only are undone a row at a time
    (the port's own writer uses None); with Average or Paeth in the mix,
    along the anti-diagonals: both give the image back."""
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.png import write_png

    img = np.random.default_rng(7).integers(0, 256, size=(13, 10, 3), dtype=np.uint8)
    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img, filters=filters))
    np.testing.assert_array_equal(read_png(path), img)
    write_png(path, img[..., 0])
    np.testing.assert_array_equal(read_png(path), img[..., 0])


def test_png_decoder_refuses_unsupported(tmp_path):
    from danerf_tpu_torch.data.png import read_png

    data = bytearray(_png_bytes(np.zeros((2, 2, 3), np.uint8), [0]))
    data[24] = 16                                       # bit depth byte of IHDR
    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="unsupported"):
        read_png(path)


@pytest.mark.parametrize("rgba", [True, False], ids=["rgba", "rgb"])
def test_blender_loader_matches_jax(tmp_path, rgba):
    Image = pytest.importorskip("PIL.Image")
    from danerf_tpu.data.blender import load_blender_scene as j_load
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_make
    from danerf_tpu_torch.data.blender import load_blender_scene

    ds = j_make(n_images=2, height=16, width=16, n_samples=16)
    save_blender_scene(ds, str(tmp_path), split="train")
    if not rgba:   # rewrite the frames as RGB: the loader fills alpha with 255
        for i in range(ds.n_images):
            Image.fromarray(ds.images[i]).save(os.path.join(tmp_path, "train", f"r_{i}.png"))
    want = j_load(str(tmp_path), split="train")
    got = load_blender_scene(str(tmp_path), split="train")
    for k in ("images", "alphas", "c2ws"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.focal == pytest.approx(want.focal, rel=1e-12)
    # downscale > 1: PIL's Lanczos resize (premultiplied under an alpha)
    want = j_load(str(tmp_path), split="train", downscale=2)
    got = load_blender_scene(str(tmp_path), split="train", downscale=2)
    for k in ("images", "alphas", "c2ws"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.focal == pytest.approx(want.focal, rel=1e-12)


def test_sample_ray_batch_matches_jax_draws():
    from danerf_tpu.data.dataset import sample_ray_batch as j_sample
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_make
    from danerf_tpu_torch.data.dataset import RayDataset, sample_ray_batch

    ds = j_make(n_images=3, height=8, width=10, n_samples=8)
    jcfg, cfg = JaxConfig(), NeRFConfig()
    jpool = ds.device_arrays(white_background=True)
    t_ds = RayDataset(ds.images, ds.alphas, ds.c2ws, ds.focal, ds.near, ds.far)
    pool = t_ds.device_arrays(white_background=True, device="cpu")
    np.testing.assert_array_equal(pool["images"].numpy(), np.asarray(jpool["images"]))
    key = jax.random.key(5)
    want = j_sample(key, jpool, jcfg, 8, 10, ds.focal, batch_size=16)
    k_img, k_pix = jax.random.split(key)
    img = int(jax.random.randint(k_img, (), 0, 3))
    pix = torch.tensor(np.asarray(jax.random.randint(k_pix, (16,), 0, 80)))
    got = sample_ray_batch(pool, cfg, 8, 10, ds.focal, batch_size=16, img_idx=img, pix_idx=pix)
    for k in ("rays_o", "rays_d", "rgb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["img_idx"].numpy(), np.asarray(want["img_idx"]))
    g = torch.Generator().manual_seed(0)
    drawn = sample_ray_batch(pool, cfg, 8, 10, ds.focal, batch_size=7, generator=g)
    assert drawn["rays_o"].shape == (7, 3) and len(set(drawn["img_idx"].tolist())) == 1


def test_rays_for_pixels_matches_jax():
    from danerf_tpu.ops.rays import rays_for_pixels as j_rays
    from danerf_tpu_torch.ops.rays import rays_for_pixels

    rng = np.random.default_rng(0)
    pix = rng.integers(0, 12 * 7, size=9)
    c2w = rng.normal(size=(9, 4, 4)).astype(np.float32)
    for cam in (c2w, c2w[0]):
        want = j_rays(jnp.asarray(pix), jnp.asarray(cam), 12, 7, 9.5)
        got = rays_for_pixels(torch.tensor(pix), torch.tensor(cam), 12, 7, 9.5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_load_dataset_reads_blender_scene(tmp_path):
    """load_dataset picks the Blender scene when its transforms file exists,
    and the custom loader for another dataset_type."""
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.viz.png import write_png

    scene = tmp_path / "tiny"
    (scene / "train").mkdir(parents=True)
    img = np.random.default_rng(0).integers(0, 256, size=(6, 5, 3), dtype=np.uint8)
    write_png(str(scene / "train" / "r_0.png"), img)
    (scene / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": [{"file_path": "./train/r_0",
                                            "transform_matrix": np.eye(4).tolist()}]}))
    ds = load_dataset(NeRFConfig(dataset_path=str(tmp_path), scene="tiny"))
    np.testing.assert_array_equal(ds.images[0], img)
    assert (ds.alphas == 255).all() and ds.focal == pytest.approx(2.5 / np.tan(0.35))
    # another dataset_type: the custom loader (transforms.json beside the frames)
    (scene / "train" / "transforms.json").write_text(json.dumps(
        {"fl_x": 7.0, "frames": [{"file_path": "r_0.png", "transform_matrix": np.eye(4).tolist()}
                                 for _ in range(2)]}))
    ds = load_dataset(NeRFConfig(dataset_type="custom", dataset_path=str(scene / "train")))
    np.testing.assert_array_equal(ds.images, img[None])
    assert (ds.alphas == 255).all() and ds.focal == 7.0
