"""The port's loaders against PIL and danerf_tpu on the CPU: the baseline
JPEG decoder (``data/jpeg.py``) against PIL's (libjpeg-turbo) on JPEGs PIL
writes in the test (4:4:4, 4:2:2, 4:2:0 and gray; sizes that are not a
multiple of the MCU; with and without a restart interval; qualities 50 and
95) and its refusals; the Lanczos downscale (``data/resize.py``) against
``Image.resize(..., Image.LANCZOS)`` (gray, gray + alpha, RGB, RGBA; by 2, 4
and 8); the custom loader against ``danerf_tpu.data.custom`` on a JPEG
scene and a PNG scene; ``load_blender_scene(downscale=2, 4, 8)`` against
the JAX loader on RGB and RGBA scenes; and the committed fixtures of
``chip_smoke.py``'s loaders phase against their PIL digests.

Tolerance: none.  Every decoded and resized pixel equals PIL's: the decoder
copies libjpeg's integer IDCT, fancy upsampling and colour tables, the
resize Pillow's fixed-point coefficients and premultiplied alpha.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

DATA = os.path.join(os.path.dirname(__file__), "data_torch")


def _picture(h, w, seed=0):
    """A smooth pattern with noise: JPEG blocks with many AC terms."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("restart", [False, True], ids=["no_restart", "restart"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", [(16, 16), (37, 53), (9, 3)], ids=["16x16", "37x53", "9x3"])
@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["4:4:4", "4:2:2", "4:2:0"])
def test_jpeg_matches_pil(sampling, size, quality, restart):
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    kw = {"restart_marker_blocks": 2} if restart else {}
    data = _jpeg(_picture(*size), quality=quality, subsampling=sampling, **kw)
    assert (b"\xff\xdd" in data) == restart                  # DRI
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("size", [(16, 16), (37, 53)], ids=["16x16", "37x53"])
def test_jpeg_gray_matches_pil(size):
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    data = _jpeg(_picture(*size)[..., 1], quality=75, restart_marker_rows=1)
    got = decode_jpeg(data)
    assert got.shape == size + (3,)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def test_jpeg_read_from_a_file_and_its_size(tmp_path):
    from danerf_tpu_torch.data.jpeg import jpeg_size, read_jpeg

    data = _jpeg(_picture(30, 41), quality=80)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_jpeg(str(path)), _pil_rgb(data))
    assert jpeg_size(data) == (30, 41)


def _patched_sof(data: bytes, marker=None, precision=None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("case,match", [("progressive", "progressive"), ("cmyk", "CMYK"),
                                        ("arithmetic", "arithmetic"), ("12-bit", "12-bit")])
def test_jpeg_refusals(case, match):
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    img = _picture(16, 24)
    if case == "progressive":
        data = _jpeg(img, progressive=True)
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif case == "arithmetic":
        data = _patched_sof(_jpeg(img), marker=0xC9)
    else:
        data = _patched_sof(_jpeg(img), precision=12)
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


def _rgba_picture(h, w, seed=1):
    img = _picture(h, w, seed)
    y, x = np.mgrid[0:h, 0:w]
    alpha = np.clip(255 * (1.3 - np.hypot(x - w / 2, y - h / 2) / (0.4 * max(h, w))), 0, 255)
    return np.concatenate([img, alpha.astype(np.uint8)[..., None]], -1)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_lanczos_matches_pil(mode, k):
    from danerf_tpu_torch.data.resize import lanczos_resize

    rgba = _rgba_picture(61, 45)
    arr = {"L": rgba[..., 0], "LA": rgba[..., [0, 3]], "RGB": rgba[..., :3], "RGBA": rgba}[mode]
    im = Image.fromarray(np.ascontiguousarray(arr), mode)
    want = np.asarray(im.resize((45 // k, 61 // k), Image.LANCZOS))
    np.testing.assert_array_equal(lanczos_resize(arr, 45 // k, 61 // k), want)


def _custom_scene(root, fmt, meta_above):
    """Three frames (two to train on, the last to validate on) of a custom
    scene in ``root/images``, as JPEG or RGBA PNG files, and its
    transforms.json above the image directory or in it."""
    images = root / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(3)
    frames = []
    for i in range(3):
        name = f"f{i}.{'jpg' if fmt == 'jpeg' else 'png'}"
        if fmt == "jpeg":
            (images / name).write_bytes(_jpeg(_picture(20, 28, seed=i), quality=85,
                                              subsampling=2))
        else:
            Image.fromarray(_rgba_picture(20, 28, seed=i), "RGBA").save(images / name)
        frames.append({"file_path": name,
                       "transform_matrix": rng.normal(size=(4, 4)).tolist()})
    meta = {"frames": frames, **({"camera_angle_x": 0.8} if fmt == "jpeg"
                                 else {"fl_x": 31.5, "w": 28})}
    (root / "transforms.json" if meta_above else images / "transforms.json").write_text(
        json.dumps(meta))
    return str(images)


@pytest.mark.parametrize("fmt,meta_above", [("jpeg", True), ("png", False)],
                         ids=["jpeg-meta_above", "png-meta_beside"])
def test_custom_scene_matches_jax(tmp_path, fmt, meta_above):
    from danerf_tpu.data.custom import load_custom_scene as j_load
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.custom import load_custom_scene
    from danerf_tpu_torch.data.dataset import load_dataset, scene_intrinsics

    path = _custom_scene(tmp_path, fmt, meta_above)
    for split, n in (("train", 2), ("val", 1)):
        want = j_load(path, split=split)
        got = load_custom_scene(path, split=split)
        assert got.n_images == n
        for k in ("images", "alphas", "c2ws"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.focal == want.focal
        cfg = NeRFConfig(dataset_type="custom", dataset_path=path)
        np.testing.assert_array_equal(load_dataset(cfg, split).images, want.images)
        info = scene_intrinsics(cfg, split)
        assert (info.width, info.focal) == (want.width, want.focal)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("rgba", [True, False], ids=["rgba", "rgb"])
def test_blender_downscale_matches_jax(tmp_path, rgba, k):
    from danerf_tpu.data.blender import load_blender_scene as j_load
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_make
    from danerf_tpu_torch.data.blender import load_blender_scene

    ds = j_make(n_images=2, height=40, width=48, n_samples=16)
    save_blender_scene(ds, str(tmp_path), split="train")
    if not rgba:
        for i in range(ds.n_images):
            Image.fromarray(ds.images[i]).save(os.path.join(tmp_path, "train", f"r_{i}.png"))
    else:   # a partial alpha, so the premultiplied resize shows
        for i in range(ds.n_images):
            Image.fromarray(_rgba_picture(40, 48, seed=i), "RGBA").save(
                os.path.join(tmp_path, "train", f"r_{i}.png"))
    for meta_key in ("camera_angle_x", "fl_x"):
        if meta_key == "fl_x":
            p = os.path.join(tmp_path, "transforms_train.json")
            meta = json.load(open(p))
            meta["fl_x"] = 0.5 * 48 / np.tan(0.5 * meta.pop("camera_angle_x"))
            json.dump(meta, open(p, "w"))
        want = j_load(str(tmp_path), split="train", downscale=k)
        got = load_blender_scene(str(tmp_path), split="train", downscale=k)
        assert got.images.shape == (2, 40 // k, 48 // k, 3)
        for key in ("images", "alphas", "c2ws"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        assert got.focal == pytest.approx(want.focal, rel=1e-12), meta_key


def _digest(a):
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def test_fixtures_match_their_pil_digests():
    """The fixtures chip_smoke.py decodes and downscales on the card's
    machine (which has no PIL), against the digests of PIL's output stored
    beside them, computed again here with PIL."""
    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.data.resize import lanczos_resize

    with open(os.path.join(DATA, "pil_digests.json")) as f:
        stored = json.load(f)
    jpg, png = os.path.join(DATA, "frame.jpg"), os.path.join(DATA, "frame_rgba.png")
    with Image.open(jpg) as im:
        assert _digest(np.asarray(im.convert("RGB"))) == stored["frame.jpg"]
    with Image.open(png) as im:
        pil_small = np.asarray(im.resize((im.width // 8, im.height // 8), Image.LANCZOS))
    assert _digest(pil_small) == stored["frame_rgba.png lanczos 8"]
    assert _digest(read_jpeg(jpg)) == stored["frame.jpg"]
    arr = read_png(png)
    assert _digest(lanczos_resize(arr, arr.shape[1] // 8, arr.shape[0] // 8)) == \
        stored["frame_rgba.png lanczos 8"]
    assert b"\xff\xdd" in open(jpg, "rb").read()             # a restart interval
    assert sum(os.path.getsize(os.path.join(DATA, n)) for n in os.listdir(DATA)) < 400_000
