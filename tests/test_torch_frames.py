"""The port's rendering drivers and video against danerf_tpu on the CPU:
the aligned spiral's camera path, ``depth_to_gray_u8``,
``render_aligned_spiral`` and ``render_path(effect="Fog",
quality="preview")`` on a tiny model whose JAX params go through
``params_from_jax``, and the video writer (MPEG-4 Part 2, the JAX file
names) read back by a RIFF parser written here, by the port's
``read_video`` and by OpenCV where it imports: a video holds the encoder's
reconstruction of its frames (``_reconstruction``), which
``tests/test_torch_video.py`` holds against FFmpeg's decoding.

The JAX side's kernel route runs its Pallas kernels in interpret mode, the
port's the kernels' plain versions (f32 both).  Between packages the
rendered colour differs by ~1e-4 at most (``tests/test_torch_render.py``),
so a quantised frame may differ by 1 uint8 level: the frames are held to
1 level at every pixel, the raw depth to 1e-4.
"""

import os
import struct

import jax
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.data.png import read_png
from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module

torch.set_num_threads(2)

SMALL = dict(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
             density_bias_init=0.5, num_samples=8, num_importance=4, use_bf16=False,
             scene="chair")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(**SMALL, use_pallas=True)
    cfg = NeRFConfig(**SMALL)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(0), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu").requires_grad_(False)
    emb = np.random.default_rng(2).normal(size=cfg.appearance_dim).astype(np.float32)
    return jcfg, cfg, params, model, emb


def _reconstruction(images, fps=30, idct="simple"):
    """The RGB frames a video of ``images`` decodes to: the encoder's
    reconstruction, as ``read_video`` converts it."""
    from danerf_tpu_torch.viz import mpeg4

    enc = mpeg4.Encoder(images[0].shape[1], images[0].shape[0], fps, idct=idct)
    out = []
    for img in images:
        enc.encode(img)
        out.append(mpeg4.yuv420_to_rgb(*enc.reconstruction()))
    return np.stack(out)


def _levels(got, want, tag):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and diff.max() <= 1, f"{tag}: {diff.max()} levels"


# ------------------------------------------------------------- paths, depth

@pytest.mark.parametrize("axis", ["x", "y", "z", "none"])
def test_alignment_matrix_matches_jax(axis):
    from danerf_tpu.viz.paths import alignment_matrix as j_alignment
    from danerf_tpu_torch.viz.paths import alignment_matrix

    np.testing.assert_allclose(alignment_matrix(axis), j_alignment(axis), rtol=0, atol=1e-12)


@pytest.mark.parametrize("scene", ["chair", "lego"])
@pytest.mark.parametrize("axis", ["x", "y", "z", "none"])
def test_aligned_spiral_path_matches_jax(axis, scene):
    from danerf_tpu.viz.paths import aligned_spiral_path as j_path
    from danerf_tpu_torch.viz.paths import aligned_spiral_path

    got = aligned_spiral_path(13, loops=1.5, rotation_axis=axis, scene=scene, radius=3.5)
    want = j_path(13, loops=1.5, rotation_axis=axis, scene=scene, radius=3.5)
    assert got.shape == (13, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_depth_to_gray_u8_matches_jax():
    from danerf_tpu.viz.depth import depth_to_gray_u8 as j_gray
    from danerf_tpu_torch.viz.depth import depth_to_gray_u8

    depth = np.random.default_rng(0).random((17, 23)).astype(np.float32) * 3 + 2
    got = depth_to_gray_u8(depth)
    assert got.dtype == np.uint8 and got.max() == 254
    np.testing.assert_array_equal(got, j_gray(depth))


# ------------------------------------------------------------- drivers

def test_render_aligned_spiral_matches_jax(tiny, tmp_path):
    """11 frames at 12x10: frame_NNNN.png, a grayscale depth on frames 0 and
    10 only, and the port's chair_spiral.mp4 (the JAX name) holding the
    frames."""
    from danerf_tpu.render.frames import render_aligned_spiral as j_spiral
    from danerf_tpu_torch.render.frames import render_aligned_spiral
    from danerf_tpu_torch.viz.video import read_video

    jcfg, cfg, params, model, emb = tiny
    kw = dict(num_frames=11, height=12, width=10, focal=11.0, loops=1.0)
    want = j_spiral(params, jcfg, str(tmp_path / "jax"), appearance_embedding=emb,
                    make_video=False, **kw)
    got = render_aligned_spiral(model, cfg, str(tmp_path / "port"), appearance_embedding=emb,
                                fps=24, device="cpu", **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax") + ["chair_spiral.mp4"])
    assert [n for n in names if n.startswith("depth")] == ["depth_0000.png", "depth_0010.png"]
    for name in (n for n in names if n.endswith(".png")):
        _levels(read_png(str(tmp_path / "port" / name)), read_png(str(tmp_path / "jax" / name)),
                name)
    frames, fps = read_video(str(tmp_path / "port" / "chair_spiral.mp4"))
    assert fps == 24 and frames.shape == (11, 12, 10, 3)
    np.testing.assert_array_equal(frames, _reconstruction([read_png(p) for p in got], 24))


def test_render_path_fog_matches_jax(tiny, tmp_path):
    """render_path(effect="Fog", quality="preview") against the JAX driver:
    two frames, the same file names, the fogged frames within 1 level, the
    raw depth within 1e-4, and the viridis depth PNG the port's own
    colouring of its raw depth; the port's video, chair_render.mp4 (the JAX
    name), holds the fogged frames."""
    from danerf_tpu.render.frames import render_path as j_render_path
    from danerf_tpu_torch.render.frames import render_path
    from danerf_tpu_torch.viz.depth import colorize_depth
    from danerf_tpu_torch.viz.video import read_video

    jcfg, cfg, params, model, emb = tiny
    kw = dict(num_frames=2, quality="preview", width=16, height=16, effect="Fog",
              save_depth=True, camera_path_kind="spiral")
    want = j_render_path(params, jcfg, str(tmp_path / "jax"), appearance_embedding=emb, **kw)
    got = render_path(model, cfg, str(tmp_path / "port"), appearance_embedding=emb,
                      make_video=True, fps=12, device="cpu", **kw)
    assert [os.path.basename(p) for p in got] == ["rgb_000.png", "rgb_001.png"]
    assert [os.path.basename(p) for p in want] == ["rgb_000.png", "rgb_001.png"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax") + ["chair_render.mp4"])
    for i in range(2):
        port_rgb = read_png(str(tmp_path / "port" / f"rgb_{i:03d}.png"))
        _levels(port_rgb, read_png(str(tmp_path / "jax" / f"rgb_{i:03d}.png")), f"rgb {i}")
        assert port_rgb.min() >= 178   # fog: at most 30% of the scene shows through
        depth = np.load(tmp_path / "port" / "raw" / f"depth_{i:03d}.npy")
        np.testing.assert_allclose(depth, np.load(tmp_path / "jax" / "raw" / f"depth_{i:03d}.npy"),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / f"depth_{i:03d}.png")),
                                      colorize_depth(depth))
    frames, fps = read_video(str(tmp_path / "port" / "chair_render.mp4"))
    assert fps == 12
    np.testing.assert_array_equal(frames, _reconstruction([read_png(p) for p in got], 12))


def test_render_path_effect_noise_from_the_frame_generator(tiny, tmp_path):
    """A noise effect's frame i is apply_effect of the unaffected frame and
    its normalised depth with a generator seeded seed * FRAME_SEED_STRIDE +
    10_000 + i; raw_output skips the effect, as in the JAX package."""
    from danerf_tpu_torch.fx.effects import apply_effect
    from danerf_tpu_torch.render.frames import (EFFECT_SEED_OFFSET, FRAME_SEED_STRIDE,
                                                render_path)

    _, cfg, _, model, emb = tiny
    kw = dict(num_frames=2, quality="preview", width=10, height=8, appearance_embedding=emb,
              save_depth=True, seed=3, device="cpu")
    plain = render_path(model, cfg, str(tmp_path / "plain"), **kw)
    holo = render_path(model, cfg, str(tmp_path / "holo"), effect="Hologram", **kw)
    raw = render_path(model, cfg, str(tmp_path / "raw"), effect="Hologram", raw_output=True,
                      **kw)
    for i in range(2):
        depth = torch.from_numpy(np.load(tmp_path / "plain" / "raw" / f"depth_{i:03d}.npy"))
        norm = (depth - depth.min()) / (depth.max() - depth.min() + 1e-6)
        gen = torch.Generator().manual_seed(3 * FRAME_SEED_STRIDE + EFFECT_SEED_OFFSET + i)
        want = apply_effect("Hologram", torch.from_numpy(read_png(plain[i])), norm, generator=gen)
        np.testing.assert_array_equal(read_png(holo[i]), want.numpy())
        np.testing.assert_array_equal(read_png(raw[i]), read_png(plain[i]))
    assert not np.array_equal(read_png(holo[0]), read_png(plain[0]))


# ------------------------------------------------------------- video

def _parse_avi(path):
    """A RIFF walk independent of the port's reader: the headers' fields,
    the frame chunks in file order and the idx1 entries."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    out = {"frames": [], "movi": None}

    def walk(pos, end):
        while pos < end:
            tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if tag == b"LIST":
                if data[pos + 8:pos + 12] == b"movi":
                    out["movi"] = pos + 8
                walk(pos + 12, pos + 8 + size)
            elif tag == b"avih":
                out["avih"] = struct.unpack("<14I", data[pos + 8:pos + 64])
            elif tag == b"strh":
                out["strh"] = struct.unpack("<4s4sIHHIIIIIIII4h", data[pos + 8:pos + 64])
            elif tag == b"strf":
                out["strf"] = struct.unpack("<IiiHH4sIiiII", data[pos + 8:pos + 48])
            elif tag == b"00dc":
                out["frames"].append((pos, data[pos + 8:pos + 8 + size]))
            elif tag == b"idx1":
                out["idx1"] = [struct.unpack("<4sIII", data[p:p + 16])
                               for p in range(pos + 8, pos + 8 + size, 16)]
            pos += 8 + size + (size & 1)

    walk(12, len(data))
    return out


def _write_frames(d, n, size, gray=False):
    from danerf_tpu_torch.viz.png import write_png

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    imgs = []
    for i in range(n):
        img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        if gray and i == 1:
            img = np.repeat(img[..., :1], 3, axis=2)
            write_png(os.path.join(d, f"frame_{i:04d}.png"), img[..., 0])
        else:
            write_png(os.path.join(d, f"frame_{i:04d}.png"), img)
        imgs.append(img)
    return imgs


def test_avi_frames_equal_the_pngs(tmp_path, capsys):
    """An odd width (13) and a grayscale frame into an .avi: the headers say
    XVID (MPEG-4 Part 2) frames of 13x11 at the fps, one 00dc chunk a frame
    holding the encoder's VOP (the stream's headers before the first), idx1
    pointing at each chunk with the key-frame flag on the I-VOP only, and
    the port's reader gives the encoder's reconstruction of the PNGs.  A
    name the JAX package does not know (.webm) becomes .mp4 and the path is
    printed; no match returns False."""
    from danerf_tpu_torch.viz import mpeg4
    from danerf_tpu_torch.viz.video import create_video_from_images, read_video

    imgs = _write_frames(str(tmp_path / "in"), 3, (11, 13), gray=True)
    path = tmp_path / "v" / "out.avi"
    assert create_video_from_images(str(tmp_path / "in"), str(path), pattern="frame_*.png",
                                    fps=7)
    assert str(path) in capsys.readouterr().out
    avi = _parse_avi(str(path))
    assert avi["avih"][4] == 3 and avi["avih"][8:10] == (13, 11)
    assert avi["strh"][:2] == (b"vids", b"XVID") and avi["strh"][6:8] == (1, 7)
    assert avi["strf"][1:6] == (13, 11, 1, 24, b"XVID")
    enc = mpeg4.Encoder(13, 11, 7, idct="xvid")
    vops = [enc.encode(img)[0] for img in imgs]
    vops[0] = enc.headers + vops[0]
    assert len(avi["frames"]) == 3 and len(avi["idx1"]) == 3
    for (pos, raw), entry, vop, key in zip(avi["frames"], avi["idx1"], vops, (1, 0, 0)):
        assert entry[0] == b"00dc" and avi["movi"] + entry[2] == pos and entry[3] == len(raw)
        assert raw == vop and entry[1] == 0x10 * key
    frames, fps = read_video(str(path))
    assert fps == 7
    np.testing.assert_array_equal(frames, _reconstruction(imgs, 7, "xvid"))
    assert create_video_from_images(str(tmp_path / "in"), str(tmp_path / "v" / "w.webm"),
                                    pattern="frame_*.png")
    assert str(tmp_path / "v" / "w.mp4") in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "v")) == ["out.avi", "w.mp4"]
    assert not create_video_from_images(str(tmp_path / "in"), str(tmp_path / "x.avi"),
                                        pattern="nomatch_*.png")


def test_avi_reads_in_opencv(tmp_path):
    """OpenCV's FFmpeg backend reads the file: the frame count and rate, and
    its decoded Y plane is the encoder's reconstruction at every pixel."""
    cv2 = pytest.importorskip("cv2")
    from danerf_tpu_torch.viz import mpeg4
    from danerf_tpu_torch.viz.video import create_video_from_images

    imgs = _write_frames(str(tmp_path / "in"), 4, (16, 20))
    create_video_from_images(str(tmp_path / "in"), str(tmp_path / "v.avi"),
                             pattern="frame_*.png", fps=10)
    cap = cv2.VideoCapture(str(tmp_path / "v.avi"))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4 and cap.get(cv2.CAP_PROP_FPS) == 10
    cap.release()
    cap = cv2.VideoCapture(str(tmp_path / "v.avi"), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_CONVERT_RGB, 0])
    enc = mpeg4.Encoder(20, 16, 10, idct="xvid")
    for img in imgs:
        enc.encode(img)
        ok, y = cap.read()
        assert ok
        np.testing.assert_array_equal(y.reshape(16, 20), enc.reconstruction()[0])
    assert not cap.read()[0]
    cap.release()


@pytest.mark.parametrize("resolution", [(20, 9), (7, 5), (26, 22)],
                         ids=["up_x_down_y", "down", "up_2x"])
def test_avi_resize_matches_cv2(tmp_path, resolution):
    """resolution= resizes as cv2.resize's INTER_LINEAR (within 1 level),
    and the video holds those resized frames."""
    cv2 = pytest.importorskip("cv2")
    from danerf_tpu_torch.viz.video import create_video_from_images, read_video, resize_bilinear

    imgs = _write_frames(str(tmp_path / "in"), 2, (11, 13))
    create_video_from_images(str(tmp_path / "in"), str(tmp_path / "v.avi"),
                             pattern="frame_*.png", resolution=resolution)
    frames, _ = read_video(str(tmp_path / "v.avi"))
    assert frames.shape == (2, resolution[1], resolution[0], 3)
    resized = [resize_bilinear(img, resolution) for img in imgs]
    for got, img in zip(resized, imgs):
        _levels(got, cv2.resize(img, resolution), f"resize {resolution}")
    np.testing.assert_array_equal(frames, _reconstruction(resized, 30, "xvid"))


def test_avi_refuses_more_than_4gib(tmp_path, monkeypatch):
    """A frame that would take the AVI past RIFF's 32-bit size (the limit
    lowered here) is refused by name, and the partial file removed."""
    from danerf_tpu_torch.viz import mux
    from danerf_tpu_torch.viz.video import create_video_from_images

    monkeypatch.setattr(mux, "RIFF_MAX", 3000)
    _write_frames(str(tmp_path / "in"), 4, (32, 32))
    path = tmp_path / "big.avi"
    with pytest.raises(ValueError, match="4 GiB"):
        create_video_from_images(str(tmp_path / "in"), str(path), pattern="frame_*.png")
    assert not path.exists()
