"""The port's loaders against PIL and danerf_tpu on the CPU: the JPEG
decoder (``data/jpeg.py``) against PIL's (libjpeg-turbo) on JPEGs PIL
writes in the test, baseline and progressive (4:4:4, 4:2:2, 4:2:0 and gray;
sizes that are not a multiple of the MCU; with and without a restart
interval; qualities 50 and 95; optimized tables; a quantization table
redefined after the first scan) and its refusals; the PNG decoder
(``data/png.py``) against ``Image.open`` and ``convert("RGB")`` on every
colour type and bit depth PIL reads, plain and Adam7, with tRNS, at sizes
whose Adam7 passes are empty; the Lanczos downscale (``data/resize.py``)
against ``Image.resize(..., Image.LANCZOS)`` (gray, gray + alpha, RGB,
RGBA; by 2, 4 and 8); the custom loader against ``danerf_tpu.data.custom``
on JPEG, progressive JPEG and PNG scenes; ``load_blender_scene(downscale=2,
4, 8)`` against the JAX loader (or, where the JAX loader takes PIL's
palette indices, bool or 16-bit gray array, against PIL's ``convert``);
``preview_from_files`` and the video encoder on JPEGs; and the committed
fixtures of ``chip_smoke.py``'s loaders phase against their PIL digests.

Tolerance: none.  Every decoded and resized pixel equals PIL's: the decoder
copies libjpeg's integer IDCT, fancy upsampling and colour tables, the
resize Pillow's fixed-point coefficients and premultiplied alpha.
"""

import hashlib
import io
import json
import os
import struct
import zlib

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


# baseline ids as they were; progressive ones beside them
@pytest.mark.parametrize("restart,progressive",
                         [(False, False), (True, False), (False, True), (True, True)],
                         ids=["no_restart", "restart", "no_restart-progressive",
                              "restart-progressive"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", [(16, 16), (37, 53), (9, 3)], ids=["16x16", "37x53", "9x3"])
@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["4:4:4", "4:2:2", "4:2:0"])
def test_jpeg_matches_pil(sampling, size, quality, restart, progressive):
    """Progressive: PIL's script (jpeg_simple_progression: interleaved DC
    scans, one-component AC bands, two refinements of luma, one of chroma),
    each scan with its own optimized Huffman tables."""
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    kw = {"restart_marker_blocks": 2} if restart else {}
    data = _jpeg(_picture(*size), quality=quality, subsampling=sampling,
                 progressive=progressive, **kw)
    assert (b"\xff\xdd" in data) == restart                  # DRI
    assert (b"\xff\xc2" in data) == progressive              # SOF2
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("size,progressive",
                         [((16, 16), False), ((37, 53), False), ((16, 16), True),
                          ((37, 53), True)],
                         ids=["16x16", "37x53", "16x16-progressive", "37x53-progressive"])
def test_jpeg_gray_matches_pil(size, progressive):
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    data = _jpeg(_picture(*size)[..., 1], quality=75, restart_marker_rows=1,
                 progressive=progressive)
    got = decode_jpeg(data)
    assert got.shape == size + (3,)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def test_jpeg_progressive_optimized_matches_pil():
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    data = _jpeg(_picture(37, 53, seed=4), quality=85, subsampling=1, progressive=True,
                 optimize=True)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def test_jpeg_progressive_decodes_what_was_refused():
    """The picture the decoder refused as progressive before it read SOF2."""
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    data = _jpeg(_picture(16, 24), progressive=True)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def _scans(data: bytes):
    """The offsets of a JPEG's SOS markers."""
    out, i = [], data.index(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def test_jpeg_quantization_latched_at_first_scan():
    """A DQT that redefines the luma table after the first scan: libjpeg
    latched each component's table at its first scan, so the new table
    changes nothing."""
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    data = _jpeg(_picture(37, 53, seed=5), quality=80, subsampling=2, progressive=True)
    second = _scans(data)[1]
    dqt = b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + bytes(range(1, 65))
    patched = data[:second] + dqt + data[second:]
    got = decode_jpeg(patched)
    np.testing.assert_array_equal(got, _pil_rgb(patched))
    np.testing.assert_array_equal(got, decode_jpeg(data))


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


@pytest.mark.parametrize("case,match", [
    ("lossless", "lossless"), ("hierarchical", "hierarchical"), ("cmyk", "CMYK"),
    ("arithmetic", "arithmetic"), ("12-bit", "12-bit"),
    ("sequential_spectral", "spectral selection"),
    ("truncated_scan", "corrupt JPEG data"), ("truncated_eoi", "corrupt JPEG data"),
    ("early_stop", "smooths")])
def test_jpeg_refusals(case, match):
    """Every refusal names its feature.  ``early_stop``: PIL's progressive
    script without its last scan (luma's last bit), which libjpeg would
    show with its blocks smoothed."""
    from danerf_tpu_torch.data.jpeg import decode_jpeg

    img = _picture(16, 24)
    prog = _jpeg(_picture(37, 53), quality=90, progressive=True)
    if case == "lossless":
        data = _patched_sof(_jpeg(img), marker=0xC3)
    elif case == "hierarchical":
        data = _patched_sof(_jpeg(img), marker=0xC5)
    elif case == "sequential_spectral":
        data = bytearray(_jpeg(img))
        sos = data.index(b"\xff\xda")
        data[sos + 4 + 2 * 3 + 2] = 62                      # Se of a baseline scan
        data = bytes(data)
    elif case == "truncated_scan":
        data = prog[:_scans(prog)[-1] + 40]
    elif case == "truncated_eoi":
        data = prog[:-2]
    elif case == "early_stop":
        data = prog[:_scans(prog)[-1]] + b"\xff\xd9"
        with Image.open(io.BytesIO(data)) as im:           # PIL reads it, smoothed
            assert np.asarray(im.convert("RGB")).shape == (37, 53, 3)
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


# ---------------------------------------------------------------- PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Scanlines (uint8 (n, rowbytes)) with row y filtered by filters[y % len]."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, cur in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """(n, m) samples as the bytes of n scanlines: big-endian at 16 bits,
    packed from the high bit below 8."""
    n, m = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(n, 2 * m)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(n, m * depth), axis=1)


def _png_bytes(samples, ctype, depth, adam7=False, plte=None, trns=None,
               filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of raw samples (H, W[, C]) of any colour type and bit depth,
    plain or Adam7 (each pass filtered on its own; an empty pass writes
    nothing), with PLTE and tRNS chunks where given.  PIL writes neither
    Adam7 nor 16-bit RGB."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    ch = _PNG_CHANNELS[ctype]
    s = samples.reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    if adam7:
        raw = b"".join(_filtered(_packed(p.reshape(p.shape[0], -1), depth), bpp, filters)
                       for p in (s[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7)
                       if p.shape[0] and p.shape[1])
    else:
        raw = _filtered(_packed(s.reshape(h, -1), depth), bpp, filters)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, int(adam7)))
    if plte is not None:
        out += chunk(b"PLTE", bytes(np.asarray(plte, np.uint8)))
    if trns is not None:
        out += chunk(b"tRNS", bytes(np.asarray(trns, np.uint8)))
    return out + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")


def _png_case(ctype, depth, h, w, trns, seed=0, **kw) -> bytes:
    """Random samples of a colour type and depth; a palette of 2**depth
    entries (200 at 8 bits, so some indices fall past it) and, with
    ``trns``, a tRNS of three entries fewer (a gray or RGB tRNS: one colour,
    which PIL's array ignores)."""
    rng = np.random.default_rng(seed)
    if ctype == 3:
        n = 200 if depth == 8 else 1 << depth
        idx = rng.integers(0, min(256, 1 << depth), (h, w))
        return _png_bytes(idx, 3, depth, plte=rng.integers(0, 256, 3 * n),
                          trns=rng.integers(0, 256, max(1, n - 3)) if trns else None, **kw)
    samples = rng.integers(0, 1 << depth, (h, w, _PNG_CHANNELS[ctype]))
    extra = {"trns": [0, 7] * (3 if ctype == 2 else 1)} if trns else {}
    return _png_bytes(samples, ctype, depth, **extra, **kw)


# (colour type, bit depth, tRNS): every combination PIL reads
PNG_KINDS = [(0, 1, False), (0, 2, False), (0, 4, False), (0, 8, False), (0, 8, True),
             (0, 16, False), (2, 8, False), (2, 8, True), (2, 16, False),
             (3, 1, True), (3, 2, True), (3, 4, True), (3, 8, True), (3, 8, False),
             (4, 8, False), (4, 16, False), (6, 8, False), (6, 16, False)]
PNG_SIZES = [(1, 1), (1, 9), (9, 1), (3, 9), (9, 3), (13, 10)]


def _png_id(kind):
    ctype, depth, trns = kind
    name = {0: "gray", 2: "rgb", 3: "palette", 4: "gray_alpha", 6: "rgba"}[ctype]
    return f"{name}{depth}" + ("-trns" if trns else "")


@pytest.mark.parametrize("adam7", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", PNG_KINDS, ids=[_png_id(k) for k in PNG_KINDS])
def test_png_matches_pil(tmp_path, kind, adam7):
    """``read_png`` against PIL's opened array (a palette against
    ``convert("RGBA")``, or ``"RGB"`` without tRNS; 1-bit gray against
    ``convert("L")``) and ``read_rgb`` against ``convert("RGB")``, at sizes
    where up to six of Adam7's passes are empty, every scanline filter."""
    from danerf_tpu_torch.data.custom import read_rgb
    from danerf_tpu_torch.data.png import read_png

    ctype, depth, trns = kind
    for h, w in PNG_SIZES:
        path = str(tmp_path / f"x{h}_{w}.png")
        with open(path, "wb") as f:
            f.write(_png_case(ctype, depth, h, w, trns, seed=h * 16 + w, adam7=adam7))
        with Image.open(path) as im:
            if im.mode == "P":
                opened = im.convert("RGBA" if trns else "RGB")
            elif im.mode == "1":
                opened = im.convert("L")
            else:
                opened = im
            want, want_rgb = np.asarray(opened), np.asarray(im.convert("RGB"))
        got = read_png(path)
        assert got.dtype == want.dtype, (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(read_rgb(path), want_rgb, err_msg=f"{h}x{w}")


def test_png_refuses_what_pil_refuses(tmp_path):
    """Bit depths and colour types outside the PNG specification."""
    from danerf_tpu_torch.data.png import read_png

    for ctype, depth in ((2, 4), (3, 16), (5, 8), (6, 1)):
        data = bytearray(_png_bytes(np.zeros((2, 2, 3), np.uint8), 2, 8))
        data[24], data[25] = depth, ctype
        path = str(tmp_path / "x.png")
        with open(path, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(ValueError, match="unsupported PNG"):
            read_png(path)


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
    scene in ``root/images``, as JPEG (``progressive``: progressive JPEG,
    one of them gray) or RGBA PNG files (``odd_png``: a palette with tRNS,
    16-bit RGB and Adam7 RGB), and its transforms.json above the image
    directory or in it."""
    images = root / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(3)
    frames = []
    for i in range(3):
        name = f"f{i}.{'jpg' if fmt in ('jpeg', 'progressive') else 'png'}"
        pic = _picture(20, 28, seed=i)
        if fmt == "jpeg":
            (images / name).write_bytes(_jpeg(pic, quality=85, subsampling=2))
        elif fmt == "progressive":
            (images / name).write_bytes(_jpeg(pic[..., 0] if i == 1 else pic, quality=85,
                                              subsampling=2, progressive=True))
        elif fmt == "odd_png":
            (images / name).write_bytes([
                _png_case(3, 8, 20, 28, trns=True, seed=i),
                _png_bytes(pic.astype(np.uint32) * 256 + 0x80, 2, 16),
                _png_bytes(pic, 2, 8, adam7=True)][i])
        else:
            Image.fromarray(_rgba_picture(20, 28, seed=i), "RGBA").save(images / name)
        frames.append({"file_path": name,
                       "transform_matrix": rng.normal(size=(4, 4)).tolist()})
    meta = {"frames": frames, **({"camera_angle_x": 0.8} if fmt in ("jpeg", "progressive")
                                 else {"fl_x": 31.5, "w": 28})}
    (root / "transforms.json" if meta_above else images / "transforms.json").write_text(
        json.dumps(meta))
    return str(images)


@pytest.mark.parametrize("fmt,meta_above", [("jpeg", True), ("png", False),
                                            ("progressive", True), ("odd_png", False)],
                         ids=["jpeg-meta_above", "png-meta_beside", "progressive-meta_above",
                              "odd_png-meta_beside"])
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


def _blender_frame(kind, i, h, w):
    """Frame i of a Blender test scene of ``kind``: the PNG's bytes."""
    rgba = _rgba_picture(h, w, seed=i)
    if kind == "rgba16":
        return _png_bytes(rgba.astype(np.uint32) * 256 + 0xA5, 6, 16)
    if kind == "adam7_rgba":
        return _png_bytes(rgba, 6, 8, adam7=True)
    if kind == "gray2":
        return _png_bytes(rgba[..., 1] >> 6, 0, 2)
    if kind == "gray1":
        return _png_bytes(rgba[..., 1] >> 7, 0, 1, adam7=i == 1)
    if kind == "gray16":
        return _png_bytes(rgba[..., 1].astype(np.uint32) * 3, 0, 16)
    return _png_case(3, 8, h, w, trns=True, seed=i, adam7=i == 1)       # palette_trns


# rgba and rgb as they were (frames written by PIL); the kinds after them by
# _png_bytes: 16-bit RGBA, Adam7 RGBA and 2-bit gray against the JAX loader;
# a palette with tRNS and 1-bit gray against PIL's convert, where the JAX
# loader takes the palette indices or a bool array; 16-bit gray refused
BLENDER_KINDS = ["rgba", "rgb", "rgba16", "adam7_rgba", "gray2", "palette_trns", "gray1",
                 "gray16"]


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("kind", BLENDER_KINDS)
def test_blender_downscale_matches_jax(tmp_path, kind, k):
    from danerf_tpu.data.blender import load_blender_scene as j_load
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu.data.synthetic import make_synthetic_scene as j_make
    from danerf_tpu_torch.data.blender import load_blender_scene

    ds = j_make(n_images=2, height=40, width=48, n_samples=16)
    save_blender_scene(ds, str(tmp_path), split="train")
    frames = [os.path.join(tmp_path, "train", f"r_{i}.png") for i in range(ds.n_images)]
    for i, path in enumerate(frames):
        if kind == "rgb":
            Image.fromarray(ds.images[i]).save(path)
        elif kind == "rgba":   # a partial alpha, so the premultiplied resize shows
            Image.fromarray(_rgba_picture(40, 48, seed=i), "RGBA").save(path)
        else:
            with open(path, "wb") as f:
                f.write(_blender_frame(kind, i, 40, 48))
    if kind == "gray16":
        with pytest.raises(ValueError, match="16-bit gray"):
            load_blender_scene(str(tmp_path), split="train", downscale=k)
        return
    for meta_key in ("camera_angle_x", "fl_x"):
        if meta_key == "fl_x":
            p = os.path.join(tmp_path, "transforms_train.json")
            meta = json.load(open(p))
            meta["fl_x"] = 0.5 * 48 / np.tan(0.5 * meta.pop("camera_angle_x"))
            json.dump(meta, open(p, "w"))
        got = load_blender_scene(str(tmp_path), split="train", downscale=k)
        assert got.images.shape == (2, 40 // k, 48 // k, 3)
        if kind in ("palette_trns", "gray1"):
            want = []
            for path in frames:
                with Image.open(path) as im:
                    conv = im.convert("RGBA" if kind == "palette_trns" else "L")
                    want.append(np.asarray(conv.resize((48 // k, 40 // k), Image.LANCZOS)))
            want = np.stack(want)
            if kind == "gray1":
                want = np.concatenate([np.repeat(want[..., None], 3, -1),
                                       np.full(want.shape + (1,), 255, np.uint8)], -1)
            np.testing.assert_array_equal(got.images, want[..., :3])
            np.testing.assert_array_equal(got.alphas, want[..., 3])
            assert kind == "gray1" or (got.alphas < 255).any()
            continue
        want = j_load(str(tmp_path), split="train", downscale=k)
        for key in ("images", "alphas", "c2ws"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        assert got.focal == pytest.approx(want.focal, rel=1e-12), meta_key


def _natural(h, w, seed=0, octaves=9):
    """A landscape-like picture: a sky over a horizon and ground, textured
    by fractal noise (octaves of bicubic-upsampled Gaussian grids)."""
    rng = np.random.default_rng(seed)
    field = np.zeros((3, h, w), np.float32)
    for o in range(1, octaves + 1):
        n = 2 ** o + 1
        for c in range(3):
            g = Image.fromarray(rng.normal(size=(n, n)).astype(np.float32), "F")
            field[c] += np.asarray(g.resize((w, h), Image.BICUBIC)) * 0.72 ** o
    y = np.linspace(0, 1, h)[:, None]
    sky = np.stack([120 + 80 * (1 - y), 160 + 70 * (1 - y), 215 + 35 * (1 - y)])
    ground = np.stack([85 + 0 * y, 105 + 0 * y, 55 + 0 * y])
    t = 1 / (1 + np.exp(-(y - 0.5 - 0.1 * field[0]) * 30))
    img = sky * (1 - t) + ground * t + field * (12 + 50 * t)
    return np.clip(img.transpose(1, 2, 0), 0, 255).astype(np.uint8)


def fixture_bytes(name: str) -> bytes:
    """How each fixture of tests/data_torch/ beside frame.jpg and
    frame_rgba.png was made (Pillow 12.1.0, libjpeg-turbo; the PNGs by
    ``_png_bytes``).  The loaders phase of chip_smoke.py decodes each on the
    card's host, which has no PIL, against the digests of PIL's pixels in
    pil_digests.json."""
    with Image.open(os.path.join(DATA, "frame.jpg")) as im:
        frame = np.asarray(im.convert("RGB"))
    h, w = frame.shape[:2]
    if name == "frame_progressive.jpg":      # 4:2:0 with a restart interval
        return _jpeg(frame, quality=90, subsampling=2, progressive=True,
                     restart_marker_blocks=3)
    if name == "gray_progressive.jpg":
        return _jpeg(np.asarray(Image.fromarray(frame).convert("L")), quality=85,
                     progressive=True)
    if name in ("picture_800.jpg", "picture_800_progressive.jpg"):
        return _jpeg(_natural(800, 800), quality=85, subsampling=2,
                     progressive=name.endswith("progressive.jpg"))
    smooth = _natural(h, w, seed=2, octaves=4) & 0xF0      # posterized: small PNGs
    if name == "palette_trns.png":           # 4-bit, 16 colours, 12 of them translucent
        q = Image.fromarray(smooth).quantize(16)
        plte = np.asarray(q.getpalette()[:48], np.uint8)
        return _png_bytes(np.asarray(q), 3, 4, plte=plte, trns=np.arange(12) * 20 + 15,
                          filters=(1,))
    if name == "rgba16.png":                 # 16-bit RGBA, alpha a disc
        yy, xx = np.mgrid[0:h, 0:w]
        alpha = np.clip(255 * (1.4 - np.hypot(xx - w / 2, yy - h / 2) / (0.4 * w)), 0, 255)
        rgba = np.concatenate([(smooth.astype(np.uint32) << 8) | 0xC3,   # PIL keeps the high byte
                               (alpha.astype(np.uint32)[..., None] & 0xF0) * 257], axis=-1)
        return _png_bytes(rgba, 6, 16, filters=(4,))
    if name == "adam7_rgb.png":
        return _png_bytes(smooth, 2, 8, adam7=True, filters=(0, 1, 2, 3, 4))
    if name == "gray2.png":
        return _png_bytes(np.asarray(Image.fromarray(smooth).convert("L")) >> 6, 0, 2,
                          filters=(2,))
    raise KeyError(name)


NEW_FIXTURES = ("frame_progressive.jpg", "gray_progressive.jpg", "picture_800.jpg",
                "picture_800_progressive.jpg", "palette_trns.png", "rgba16.png",
                "adam7_rgb.png", "gray2.png")


def _digest(a):
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def pil_pixels(name: str) -> dict:
    """PIL's pixels of a new fixture, by digest key: ``name`` the array
    ``read_png`` gives (PIL's opened mode; a palette with tRNS as
    ``convert("RGBA")``), for a JPEG ``convert("RGB")``; ``name + " rgb"``
    (PNGs) ``convert("RGB")``, what ``read_rgb`` gives."""
    with Image.open(os.path.join(DATA, name)) as im:
        rgb = np.asarray(im.convert("RGB"))
        if name.endswith(".jpg"):
            return {name: rgb}
        opened = np.asarray(im.convert("RGBA") if im.mode == "P" else im)
    return {name: opened, f"{name} rgb": rgb}


def test_fixtures_match_their_pil_digests():
    """The fixtures chip_smoke.py decodes and downscales on the card's
    machine (which has no PIL), against the digests of PIL's output stored
    beside them, computed again here with PIL; the port's decoders give
    the same digests."""
    from danerf_tpu_torch.data.custom import read_rgb
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
    for name in NEW_FIXTURES:
        path = os.path.join(DATA, name)
        for key, want in pil_pixels(name).items():
            assert _digest(want) == stored[key], key
        if name.endswith(".jpg"):
            assert _digest(read_jpeg(path)) == stored[name], name
        else:
            assert _digest(read_png(path)) == stored[name], name
            assert _digest(read_rgb(path)) == stored[f"{name} rgb"], name
    head = open(os.path.join(DATA, "frame_progressive.jpg"), "rb").read()
    assert b"\xff\xc2" in head and b"\xff\xdd" in head     # progressive, restarts
    assert os.path.getsize(os.path.join(DATA, "picture_800_progressive.jpg")) < 200_000
    assert sum(os.path.getsize(os.path.join(DATA, n)) for n in os.listdir(DATA)) < 400_000


@pytest.mark.parametrize("picture", ["progressive_jpeg", "gray_jpeg"])
def test_preview_reads_a_jpeg_as_pil(tmp_path, picture):
    """``preview_from_files`` on a JPEG (the JAX preview reads any picture
    PIL opens): the previews of PIL's RGB pixels.  A gray JPEG gives RGB,
    where the JAX preview's ``np.asarray(img)[..., :3]`` slices the width
    of PIL's 2-D array."""
    import torch

    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.fx.preview import preview_from_files, render_previews

    torch.set_num_threads(2)
    pic = _picture(24, 20, seed=6)
    data = _jpeg(pic[..., 0] if picture == "gray_jpeg" else pic, quality=90,
                 progressive=True)
    (tmp_path / "in.jpg").write_bytes(data)
    spec = {"effects": [{"name": "Fog", "sweep": {"fog_start": [0.0, 0.4]}},
                        {"name": "Toon Shader"}]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    got = preview_from_files(str(tmp_path / "in.jpg"), None, str(tmp_path / "spec.json"),
                             str(tmp_path / "port"), device="cpu")
    want = render_previews(_pil_rgb(data), None, spec, str(tmp_path / "pil"), device="cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_png(g), read_png(w))


def test_video_reads_jpeg_frames_as_pil(tmp_path):
    """``create_video_from_images`` over JPEG frames (the JAX encoder reads
    any ``--pattern`` through ``cv2.imread``, which decodes these JPEGs as
    PIL does), baseline and progressive: the AVI holds the encoding of
    PIL's pixels."""
    from danerf_tpu_torch.viz import mpeg4
    from danerf_tpu_torch.viz.video import create_video_from_images, read_video

    datas = [_jpeg(_picture(18, 26, seed=i), quality=80, subsampling=2, progressive=i == 1)
             for i in range(2)]
    for i, data in enumerate(datas):
        (tmp_path / f"frame_{i:04d}.jpg").write_bytes(data)
    out = str(tmp_path / "v.avi")
    assert create_video_from_images(str(tmp_path), out, pattern="frame_*.jpg", fps=5)
    frames, fps = read_video(out)
    assert fps == 5
    enc = mpeg4.Encoder(26, 18, 5, idct="xvid")
    for frame, data in zip(frames, datas):
        enc.encode(_pil_rgb(data))
        np.testing.assert_array_equal(frame, mpeg4.yuv420_to_rgb(*enc.reconstruction()))


def test_sizes_from_headers_of_progressive_and_png_files():
    """``jpeg_size`` reads SOF2, ``image_width`` a JPEG's or PNG's header,
    on every new fixture."""
    from danerf_tpu_torch.data.custom import image_width
    from danerf_tpu_torch.data.jpeg import jpeg_size

    for name in NEW_FIXTURES:
        path = os.path.join(DATA, name)
        with Image.open(path) as im:
            size = im.size
        assert image_width(path) == size[0], name
        if name.endswith(".jpg"):
            assert jpeg_size(open(path, "rb").read()) == (size[1], size[0]), name
