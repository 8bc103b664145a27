"""The port's video against OpenCV, which the JAX package writes and reads
its videos with: ``viz/mpeg4.py`` (MPEG-4 Part 2), ``viz/mux.py`` (MP4,
MOV, Matroska, AVI), ``viz/video.py`` and the frame reader
``data/images.read_cv2`` (``cv2.imread``).

OpenCV is the referee in two exact modes of ``cv2.VideoCapture``:
``CAP_PROP_FORMAT = -1`` hands over each demuxed packet, which must be the
encoder's VOP; ``CAP_PROP_CONVERT_RGB = 0`` hands over FFmpeg's decoded Y
plane, which must equal the encoder's reconstruction at every pixel (the
simple IDCT for mp4v, XviD's for an XVID AVI).  Crafted coefficient blocks
and vectors reach every VLC entry and every escape mode, so a changed
entry fails here.  Two sequences of 26 frames, a moving pattern and a
spiral rendered by a small model, are held against the JAX package's own
files of the same PNGs: the I-VOP every 12th frame, the mean RGB PSNR at
least the JAX file's minus 0.5 dB and at most twice its bytes.
"""

import os
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from danerf_tpu_torch.data.images import read_cv2  # noqa: E402
from danerf_tpu_torch.viz import mpeg4, mux  # noqa: E402
from danerf_tpu_torch.viz.video import (VideoWriter, create_video_from_images,  # noqa: E402
                                        decode_video, read_video, video_path)

EXTS = (".mp4", ".mov", ".mkv", ".avi")


def _pattern(h, w, n, seed=0):
    """A moving picture: smooth waves drifting, a sliding ramp, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    noise = rng.integers(-12, 13, (h + n, w + 2 * n, 3))
    out = []
    for t in range(n):
        r = 128 + 90 * np.sin((xx + 2 * t) / 7.0) * np.cos((yy - t) / 5.0)
        g = ((xx + 3 * t) % 48) * 5
        b = 60 + 2 * yy + 30 * np.sin((xx - yy + t) / 4.0)
        img = np.stack([r, g, b], -1) + noise[t:t + h, 2 * t:2 * t + w]
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _encode(frames, fps=30, idct="simple"):
    enc = mpeg4.Encoder(frames[0].shape[1], frames[0].shape[0], fps, idct=idct)
    packets, keys, planes = [], [], []
    for f in frames:
        p, k = enc.encode(f)
        packets.append(p)
        keys.append(k)
        planes.append(enc.reconstruction())
    return enc.headers, packets, keys, planes


def _write(path, frames, fps=30):
    with VideoWriter(str(path), frames[0].shape[1], frames[0].shape[0], fps) as v:
        for f in frames:
            v.write(f)


def _cv2_packets(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        out.append(p.tobytes())
    cap.release()
    return out


def _cv2_y(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])
    out = []
    while True:
        ok, y = cap.read()
        if not ok:
            break
        out.append(y.reshape(y.shape[0], -1))
    cap.release()
    return out


def _cv2_rgb(path):
    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[..., ::-1])
    cap.release()
    return out, fps


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _signature(path, ext):
    data = open(path, "rb").read()
    if ext == ".mp4":
        assert data[4:12] == b"ftypisom" and b"mp4v" in data and b"esds" in data
    elif ext == ".mov":
        assert data[4:12] == b"ftypqt  " and b"mp4v" in data
    elif ext == ".mkv":
        assert data[:4] == b"\x1a\x45\xdf\xa3" and b"V_MPEG4/ISO/SP" in data
    else:
        assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
        assert data.count(b"XVID") == 2                      # strh handler, strf compression
    return data


# ------------------------------------------------------------- containers

@pytest.mark.parametrize("size", [(24, 40), (11, 13)], ids=["24x40", "11x13"])
@pytest.mark.parametrize("ext", EXTS)
def test_container_packets_and_y_plane_equal_the_encoder(tmp_path, ext, size):
    """26 frames: the file's container and codec tag, one cv2 packet a frame
    equal to the encoder's VOP (the AVI's first led by the headers), cv2's
    frame rate, the I-VOP every 12th frame in the container's index, cv2's
    decoded Y plane equal to the reconstruction at every pixel, and the
    port's reader equal to it plane for plane."""
    frames = _pattern(*size, 26)
    path = tmp_path / f"v{ext}"
    _write(path, frames)
    _signature(path, ext)
    headers, vops, keys, planes = _encode(frames, idct="xvid" if ext == ".avi" else "simple")
    assert keys == [i % 12 == 0 for i in range(26)]
    want = [headers + vops[0]] + vops[1:] if ext == ".avi" else vops
    assert _cv2_packets(path) == want
    got_headers, got, got_keys, fps, _ = mux.demux(str(path))
    assert got == want and got_keys == keys and fps == 30
    assert got_headers == (b"" if ext == ".avi" else headers)
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FPS) == 30
    cap.release()
    ys = _cv2_y(path)
    assert len(ys) == 26
    for i, (y, p) in enumerate(zip(ys, planes)):
        np.testing.assert_array_equal(y, p[0], err_msg=f"frame {i}")
    mine, mine_keys, _ = decode_video(str(path))
    assert mine_keys == keys
    for p, q in zip(mine, planes):
        for a, b in zip(p, q):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_fractional_frame_rate_and_time_base(tmp_path, ext):
    """NTSC's 30000/1001 fps in the VOL's 16-bit fields and the container,
    over 40 frames, past one second of modulo_time_base."""
    frames = _pattern(16, 16, 40, seed=3)
    path = tmp_path / f"v{ext}"
    _write(path, frames, fps=30000 / 1001)
    assert mpeg4.frame_rate(30000 / 1001) == (30000, 1001)
    assert mpeg4.frame_rate(29.97) == (2997, 100)
    cap = cv2.VideoCapture(str(path))
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 30000 / 1001) < 1e-6
    cap.release()
    assert len(_cv2_y(path)) == 40
    assert abs(read_video(str(path))[1] - 30000 / 1001) < 1e-9


def test_mp4_offsets_past_32_bits_use_co64(tmp_path, monkeypatch):
    """An MP4 whose data runs past the 32-bit limit (lowered here) indexes
    its samples with co64, which cv2 reads."""
    monkeypatch.setattr(mux, "RIFF_MAX", 1000)
    frames = _pattern(16, 32, 14, seed=4)
    path = tmp_path / "v.mp4"
    _write(path, frames)
    data = open(path, "rb").read()
    assert b"co64" in data and b"stco" not in data
    _, vops, _, planes = _encode(frames)
    assert _cv2_packets(path) == vops
    for y, p in zip(_cv2_y(path), planes):
        np.testing.assert_array_equal(y, p[0])


def test_avi_past_riff_limit_is_refused_and_removed(tmp_path, monkeypatch):
    """The AVI writer refuses, by name, a frame that would take the file
    past RIFF's 32-bit size (lowered here), and the partial file goes."""
    monkeypatch.setattr(mux, "RIFF_MAX", 4000)
    frames = _pattern(32, 32, 30, seed=5)
    path = tmp_path / "v.avi"
    with pytest.raises(ValueError, match="4 GiB"):
        _write(path, frames)
    assert not path.exists()


@pytest.mark.parametrize("name,written", [
    ("v.mp4", "v.mp4"), ("v.MOV", "v.MOV"), ("v.mkv", "v.mkv"), ("v.avi", "v.avi"),
    ("v.webm", "v.mp4"), ("v", "v.mp4"), ("v.AVI", "v.AVI")])
def test_output_names_and_containers_as_jax(tmp_path, name, written):
    """The name the JAX package writes for each --output, the container
    its extension picks, and cv2 reading both files."""
    from danerf_tpu.viz.video import create_video_from_images as jax_video

    src = tmp_path / "in"
    os.makedirs(src)
    for i, f in enumerate(_pattern(16, 16, 3, seed=6)):
        cv2.imwrite(str(src / f"rgb_{i:03d}.png"), f[..., ::-1])
    assert jax_video(str(src), str(tmp_path / "jax" / name))
    assert create_video_from_images(str(src), str(tmp_path / "port" / name))
    assert os.listdir(tmp_path / "jax") == os.listdir(tmp_path / "port") == [written]
    assert video_path(name) == written
    ext = os.path.splitext(written)[1].lower()
    _signature(tmp_path / "port" / written, ext)
    jax_data = open(tmp_path / "jax" / written, "rb").read()
    port_data = open(tmp_path / "port" / written, "rb").read()
    head = slice(4, 12) if ext in (".mp4", ".mov") else slice(0, 4)
    assert jax_data[head] == port_data[head]
    assert len(_cv2_rgb(tmp_path / "port" / written)[0]) == 3


# ------------------------------------------------------------- VLC tables

def _level_blocks(table, seed):
    """(n, 64) levels in natural order, one block for each entry of
    ``table`` and for escapes of each mode (last 0 and 1; either sign):
    an event of the entry, then, for last 0, a last event after it."""
    rng = np.random.default_rng(seed)
    start = 1 if table is mpeg4.INTRA else 0
    events = list(table.entries)
    for last in (0, 1):
        lmax, rmax = table.lmax[last], table.rmax[last]
        for r in (r for r in range(64) if lmax[r] > 0):            # escape 1
            events += [(last, r, 2 * int(lmax[r])), (last, r, int(lmax[r]) + 1)]
        for lv in (lv for lv in range(1, mpeg4.MAX_LEVEL + 1) if rmax[lv] >= 0):   # escape 2
            events += [(last, 2 * int(rmax[lv]) + 1, lv), (last, int(rmax[lv]) + 1, lv)]
        events += [(last, 0, 300), (last, 59, 2), (last, 0, 127), (last, 40, 33)]   # escape 3
    blocks = []
    for last, run, level in events:
        if start + run + (0 if last else 1) > 63:
            continue
        z = np.zeros(64, np.int64)
        s = 1 if rng.random() < 0.5 else -1
        z[start + run] = s * level
        if not last:
            z[start + run + 1] = -s
        blocks.append(z[np.argsort(mpeg4.ZIGZAG)])
    return np.stack(blocks)


def _craft(blocks, n, start):
    """(n, 6, 64) levels: ``blocks`` in the luma blocks of the first
    macroblocks, then 64 macroblocks whose coded-block patterns run through
    0..63 (one level in each coded block), then none."""
    lv = np.zeros((n, 6, 64), np.int64)
    k = -(-len(blocks) // 4)
    flat = np.zeros((4 * k, 64), np.int64)
    flat[:len(blocks)] = blocks
    lv[:k, :4] = flat.reshape(k, 4, 64)
    for p in range(64):
        for b in range(6):
            if (p >> (5 - b)) & 1:
                lv[k + p, b, start + b % 5] = 1 + b
    return lv


def _modes(levels, start, table):
    """How many events of (n, 6, 64) levels code directly and by each
    escape."""
    _, _, code, length = mpeg4._events(mpeg4._zigzag(levels.reshape(-1, 64)), start, table)
    esc = (code >> np.maximum(length - 7, 0)) == mpeg4.ESCAPE[0]
    mode = np.where(esc, (code >> np.maximum(length - 9, 0)) & 3, -1)
    return {"direct": int((~esc).sum()), "esc1": int((esc & (mode < 2)).sum()),
            "esc2": int((esc & (mode == 2)).sum()), "esc3": int((esc & (mode == 3)).sum())}


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_every_vlc_entry_and_escape_decodes_in_cv2(tmp_path, ext):
    """Crafted levels and vectors through both VOP kinds: every intra and
    inter TCOEF entry and all three escape modes (last 0 and 1), in luma
    blocks; the four intra and four inter MCBPC entries and all sixteen
    CBPY entries of each kind; dct_dc_size 0-8 for luma and chroma (9-12
    need a DC step past 255, which dc_scaler 8 cannot make); every MVD
    value -32..31 in x and y; not_coded macroblocks, and coded ones with no
    levels.  cv2's Y plane equals the reconstruction of each VOP, and so
    does the port's decoder."""
    mbw, mbh = 66, 3
    n = mbw * mbh
    enc = mpeg4.Encoder(16 * mbw, 16 * mbh, 30, idct="xvid" if ext == ".avi" else "simple")
    rng = np.random.default_rng(7)

    lv = _craft(_level_blocks(mpeg4.INTRA, 1), n, 1)
    lv[..., 0] = rng.integers(0, 256, (n, 6))
    diff = np.abs(lv[..., 0] - mpeg4.dc_predict(lv[..., 0], mbh, mbw))
    for part in (diff[:, :4], diff[:, 4:]):
        assert {int(d).bit_length() for d in part.ravel()} == set(range(9))
    modes = _modes(lv, 1, mpeg4.INTRA)
    assert min(modes.values()) > 0, modes
    vops, planes = [enc.code_intra(lv)], [enc.reconstruction()]

    lp = _craft(_level_blocks(mpeg4.INTER, 2), n, 0)
    assert not np.any(lp[-5:])                                  # not_coded at the end
    modes = _modes(lp, 0, mpeg4.INTER)
    assert min(modes.values()) > 0, modes
    enc.index, enc.rounding = 1, 1
    vops.append(enc.code_inter(lp, np.zeros((n, 2), np.int64)))
    planes.append(enc.reconstruction())

    # every MVD value along the first row (its predictor: the left vector);
    # no levels, so cbpc 0 and CBPY's inter entry for none coded
    d = np.arange(-32, 32)
    mv = np.zeros((n, 2), np.int64)
    mv[1:65, 0] = mpeg4.wrap_mvd(np.cumsum(d))
    mv[1:65, 1] = mpeg4.wrap_mvd(np.cumsum(d[::-1]))
    mv[65:] = rng.integers(-32, 32, (n - 65, 2))
    got = mpeg4.wrap_mvd(mv - mpeg4.mv_predict(mv, mbh, mbw))
    assert set(got[1:65, 0]) == set(got[1:65, 1]) == set(d)
    enc.index, enc.rounding = 2, 0
    vops.append(enc.code_inter(np.zeros((n, 6, 64), np.int64), mv))
    planes.append(enc.reconstruction())

    path = tmp_path / f"vlc{ext}"
    w = mux.open_writer(str(path), enc.headers, enc.width, enc.height, 30)
    for i, v in enumerate(vops):
        w.add(v, i == 0)
    w.close()
    ys = _cv2_y(path)
    assert len(ys) == 3
    for i, (y, p) in enumerate(zip(ys, planes)):
        np.testing.assert_array_equal(y, p[0], err_msg=f"VOP {i}")
    mine, _, _ = decode_video(str(path))
    for p, q in zip(mine, planes):
        for a, b in zip(p, q):
            np.testing.assert_array_equal(a, b)


def test_the_tables_are_prefix_codes_of_their_lengths():
    """Each table is a prefix code, and its Kraft sum pins its lengths; the
    two TCOEF tables share one code set, the escape beside it."""
    def kraft(codes):
        return sum(2.0 ** -n for _, n in codes)

    def prefix_free(codes):
        words = sorted(format(c, f"0{n}b") for c, n in codes)
        return len(set(words)) == len(words) and all(
            not b.startswith(a) for a, b in zip(words, words[1:]))

    for t in (mpeg4.INTRA_VLC, mpeg4.INTER_VLC):
        assert prefix_free(t + (mpeg4.ESCAPE,))
        assert kraft(t + (mpeg4.ESCAPE,)) == 1 - 2 ** -9
    assert sorted(mpeg4.INTRA_VLC) == sorted(mpeg4.INTER_VLC)
    assert prefix_free(mpeg4.CBPY) and kraft(mpeg4.CBPY) == 1 - 2 ** -5
    assert prefix_free(mpeg4.DC_LUM) and kraft(mpeg4.DC_LUM) == 1 - 2 ** -11
    assert prefix_free(mpeg4.DC_CHROM) and kraft(mpeg4.DC_CHROM) == 1 - 2 ** -12
    signed = [mpeg4.MVD[0]] + [(c << 1 | s, n + 1) for c, n in mpeg4.MVD[1:] for s in (0, 1)]
    assert prefix_free(signed) and kraft(signed) == 1 - 2 ** -11


# ------------------------------------------------------------- decoder

@pytest.mark.parametrize("bit,name", [(81, "interlace"), (82, "OBMC"), (83, "sprites"),
                                      (84, "not_8_bit"), (85, "quant_type 1"),
                                      (86, "complexity estimation"), (87, "resync markers"),
                                      (88, "data partitioning"), (89, "scalability")])
def test_decoder_refuses_other_tools_by_name(bit, name):
    """A VOL with one tool the encoder never uses switched on is refused,
    naming it."""
    head = bytearray(mpeg4.stream_headers(32, 16, 30))
    at = head.find(b"\x00\x00\x01\x20") + 4
    head[at + bit // 8] ^= 0x80 >> (bit % 8)
    with pytest.raises(ValueError, match=name):
        mpeg4.parse_vol(bytes(head))


def test_decoder_refuses_b_vops_and_other_quantisers():
    frames = _pattern(16, 32, 2, seed=8)
    headers, vops, _, _ = _encode(frames)
    b = bytearray(vops[1])
    b[4] = (b[4] & 0x3F) | 0x80
    with pytest.raises(ValueError, match="B-VOPs"):
        mpeg4.decode_stream(headers, [vops[0], bytes(b)])
    with pytest.raises(ValueError, match="P-VOP before any I-VOP"):
        mpeg4.decode_stream(headers, [vops[1]])


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_reader_decodes_opencvs_own_files_or_refuses_by_name(tmp_path, ext):
    """The JAX package's own file (OpenCV's encoder: user data, GOV
    headers, its AVI's headers in every I-VOP's chunk): the port's reader
    gives cv2's Y plane at every pixel while the stream stays in the subset
    the port writes (the simple IDCT for the AVI too, as its user data
    names libavcodec), and refuses it by name where noise covers a third
    of a frame, which OpenCV codes with intra macroblocks in a P-VOP."""
    from danerf_tpu.viz.video import create_video_from_images as jax_video

    cut = _pattern(32, 48, 3, seed=13)
    cut.append(cut[-1].copy())
    cut[-1][:, :16] = np.random.default_rng(14).integers(0, 256, (32, 16, 3), dtype=np.uint8)
    for name, frames in (("smooth", _pattern(32, 48, 14, seed=13)), ("cut", cut)):
        src = tmp_path / name
        os.makedirs(src)
        for i, f in enumerate(frames):
            cv2.imwrite(str(src / f"rgb_{i:03d}.png"), f[..., ::-1])
        path = tmp_path / f"{name}{ext}"
        assert jax_video(str(src), str(path))
        if name == "cut":
            with pytest.raises(ValueError, match="intra macroblocks in a P-VOP are not read"):
                read_video(str(path))
            continue
        planes, keys, _ = decode_video(str(path))
        assert keys == [i % 12 == 0 for i in range(len(frames))]
        ys = _cv2_y(path)
        assert len(ys) == len(planes) == len(frames)
        for y, p in zip(ys, planes):
            np.testing.assert_array_equal(y, p[0])


# ------------------------------------------------------------- sequences

def _against_jax(tmp_path, frames, ext):
    """Write the PNGs; the JAX package's file and the port's of them; the
    cv2-decoded mean RGB PSNR of each against the PNGs and their bytes."""
    from danerf_tpu.viz.video import create_video_from_images as jax_video

    src = tmp_path / "png"
    os.makedirs(src, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(str(src / f"rgb_{i:03d}.png"), f[..., ::-1])
    out = {}
    for who, fn in (("jax", jax_video), ("port", create_video_from_images)):
        path = tmp_path / who / f"v{ext}"
        assert fn(str(src), str(path))
        dec, fps = _cv2_rgb(path)
        assert len(dec) == len(frames) and fps == 30
        out[who] = (np.mean([_psnr(d, f) for d, f in zip(dec, frames)]), os.path.getsize(path),
                    path)
    return out


def _hold(out, frames):
    port, jax = out["port"], out["jax"]
    assert port[0] >= jax[0] - 0.5, (port[0], jax[0])
    assert port[1] <= 2 * jax[1], (port[1], jax[1])
    planes, keys, _ = decode_video(str(port[2]))
    assert keys == [i % 12 == 0 for i in range(len(frames))]
    _, _, _, want = _encode(frames, idct="xvid" if port[2].suffix == ".avi" else "simple")
    for p, q in zip(planes, want):
        np.testing.assert_array_equal(p[0], q[0])


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_moving_pattern_quality_and_size_against_jax(tmp_path, ext):
    """26 frames of a moving pattern at 64x96."""
    frames = _pattern(64, 96, 26, seed=9)
    _hold(_against_jax(tmp_path, frames, ext), frames)


def test_spiral_quality_and_size_against_jax(tmp_path):
    """A 26-frame aligned spiral at 48x64 rendered by a small model (two
    layers of 32), its video against the JAX file of its PNGs."""
    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.render.frames import render_aligned_spiral

    torch.manual_seed(0)
    cfg = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,), appearance_dim=8,
                     density_bias_init=0.5, num_samples=8, num_importance=4, use_bf16=False,
                     scene="chair")
    model = NeRF(cfg, torch.Generator().manual_seed(0)).requires_grad_(False)
    paths = render_aligned_spiral(model, cfg, str(tmp_path / "spiral"), num_frames=26,
                                  height=48, width=64, focal=60.0, loops=1.0, fps=30,
                                  device="cpu")
    assert (tmp_path / "spiral" / "chair_spiral.mp4").exists()
    frames = [read_png(p) for p in paths]
    assert np.std(np.stack(frames).astype(np.float64)) > 1.0
    _hold(_against_jax(tmp_path, frames, ".mp4"), frames)


# ------------------------------------------------------------- frames as cv2.imread

def _png(path, arr, ctype, depth, chunks=()):
    import zlib

    h, w = arr.shape[:2]
    dt = ">u2" if depth == 16 else np.uint8
    rows = arr.reshape(h, -1).astype(dt)
    raw = b"".join(b"\0" + rows[y].tobytes() for y in range(h))

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    body = b"".join(chunk(t, d) for t, d in chunks)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                  ctype, 0, 0, 0))
                + body + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _exif(orientation):
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + bytes(4)
    return b"II*\0" + struct.pack("<I", 8) + ifd


def _case_files(d):
    """{name: path} of the frames each rule of ``read_cv2`` covers."""
    from PIL import Image

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
    v16 = rng.integers(0, 65536, (10, 14), dtype=np.uint16)
    files = {}

    def add(name, fn):
        p = os.path.join(d, name)
        fn(p)
        files[name] = p

    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        add(f"exif{o}.jpg", lambda p: Image.fromarray(img).save(p, "JPEG", exif=exif.tobytes(),
                                                                 quality=90))
        add(f"exif{o}.png", lambda p: _png(p, img, 2, 8, [(b"eXIf", _exif(o))]))
        add(f"exif{o}.tif", lambda p: Image.fromarray(img).save(p, "TIFF", exif=exif.tobytes()))
    for o in (3, 6):
        exif = Image.Exif()
        exif[0x0112] = o
        add(f"exif{o}.webp", lambda p: Image.fromarray(img).save(p, "WEBP", lossless=True,
                                                                  exif=exif.tobytes()))
    add("gray16.png", lambda p: _png(p, v16, 0, 16))
    add("rgb16.png", lambda p: _png(p, np.stack([v16, v16[::-1], v16 ^ 0x5555], -1), 2, 16))
    add("gray_alpha16.png", lambda p: _png(p, np.stack([v16, v16[:, ::-1]], -1), 4, 16))
    add("rgba16.png", lambda p: _png(p, np.stack([v16] * 3 + [v16[::-1]], -1), 6, 16))
    add("gray_alpha.png", lambda p: _png(p, np.stack([img[..., 0], img[..., 1]], -1), 4, 8))
    add("rgba.png", lambda p: _png(p, np.concatenate([img, img[..., :1]], -1), 6, 8))
    add("gray.png", lambda p: _png(p, img[..., 0], 0, 8))
    pal = (np.arange(12 * 3) * 7 % 256).astype(np.uint8)
    add("palette_trns.png", lambda p: _png(p, (img[..., 0] % 12), 3, 8,
                                           [(b"PLTE", pal.tobytes()),
                                            (b"tRNS", bytes([0, 128, 255, 20]))]))
    add("gray16.tif", lambda p: Image.fromarray(v16).save(p, "TIFF"))
    add("rgba.tif", lambda p: Image.fromarray(np.concatenate([img, img[..., 2:]], -1),
                                              "RGBA").save(p, "TIFF"))
    add("gray_alpha.tif", lambda p: Image.fromarray(img[..., :2].copy(), "LA").save(p, "TIFF"))
    add("gray16.pgm", lambda p: open(p, "wb").write(b"P5\n14 10\n65535\n"
                                                    + v16.astype(">u2").tobytes()))
    add("maxval1000.pgm", lambda p: open(p, "wb").write(
        b"P5\n14 10\n1000\n" + (v16 % 1001).astype(">u2").tobytes()))
    add("maxval100.ppm", lambda p: open(p, "wb").write(b"P6\n14 10\n100\n" + img.tobytes()))
    add("plain3.ppm", lambda p: open(p, "w").write(
        "P3\n14 10\n3\n" + " ".join(str(v % 4) for v in img.ravel()) + "\n"))
    add("plain1000.pgm", lambda p: open(p, "w").write(
        "P2\n14 10\n1000\n" + " ".join(str(v % 1001) for v in v16.ravel()) + "\n"))
    add("bitmap.pbm", lambda p: open(p, "w").write(
        "P1\n14 10\n" + " ".join(str(v & 1) for v in img[..., 0].ravel()) + "\n"))
    add("float.pfm", lambda p: open(p, "wb").write(
        b"Pf\n14 10\n-1.0\n" + (v16 / 300.0).astype("<f4").tobytes()))
    gif = Image.fromarray(img[..., 0] % 5, "P")
    gif.putpalette([10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110, 120, 130, 140, 150])
    add("transparent.gif", lambda p: gif.save(p, transparency=2))
    add("frame.bmp", lambda p: Image.fromarray(img).save(p, "BMP"))

    def bmp16(p, masks):
        raw = (v16[::-1] & (0x7FFF if masks is None else 0xFFFF)).astype("<u2").tobytes()
        extra = b"" if masks is None else struct.pack("<3I", *masks)
        off = 54 + len(extra)
        head = struct.pack("<2sIHHI", b"BM", off + len(raw), 0, 0, off) + struct.pack(
            "<IiiHHIIiiII", 40, 14, 10, 1, 16, 0 if masks is None else 3, len(raw), 0, 0, 0, 0)
        open(p, "wb").write(head + extra + raw)

    add("rgb555.bmp", lambda p: bmp16(p, None))
    add("rgb565.bmp", lambda p: bmp16(p, (0xF800, 0x7E0, 0x1F)))
    add("lossy.webp", lambda p: Image.fromarray(img).save(p, "WEBP", quality=60))
    add("not_an_image.png", lambda p: open(p, "w").write("no pixels here"))
    add("truncated.png", lambda p: open(p, "wb").write(open(files["rgba.png"], "rb").read()[:60]))
    return files


_CASES = ([f"exif{o}.{e}" for o in range(1, 9) for e in ("jpg", "png", "tif")]
          + ["exif3.webp", "exif6.webp", "gray16.png", "rgb16.png", "gray_alpha16.png",
             "rgba16.png", "gray_alpha.png", "rgba.png", "gray.png", "palette_trns.png",
             "gray16.tif", "rgba.tif", "gray_alpha.tif", "gray16.pgm", "maxval1000.pgm",
             "maxval100.ppm", "plain3.ppm", "plain1000.pgm", "bitmap.pbm", "float.pfm",
             "transparent.gif", "frame.bmp", "rgb555.bmp", "rgb565.bmp", "lossy.webp",
             "not_an_image.png", "truncated.png"])


@pytest.fixture(scope="module")
def case_files(tmp_path_factory):
    return _case_files(str(tmp_path_factory.mktemp("cv2_cases")))


@pytest.mark.parametrize("name", _CASES)
def test_read_cv2_equals_cv2_imread(case_files, name):
    """``read_cv2`` is ``cv2.imread`` in RGB, or None where it is None."""
    path = case_files[name]
    want = cv2.imread(path)
    got = read_cv2(path)
    if want is None:
        assert got is None
        return
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_read_cv2_raises_where_cv2_reads_what_the_port_does_not(tmp_path):
    """JPEG 2000 (cv2 reads it through OpenJPEG): raised by name, here and
    in the video, never skipped."""
    path = str(tmp_path / "frame_0000.jp2")
    assert cv2.imwrite(path, np.full((64, 64, 3), 90, np.uint8))
    assert cv2.imread(path) is not None
    with pytest.raises(ValueError, match="JPEG 2000"):
        read_cv2(path)
    with pytest.raises(ValueError, match="JPEG 2000"):
        create_video_from_images(str(tmp_path), str(tmp_path / "v.mp4"), pattern="frame_*")


@pytest.mark.parametrize("bad", ["first", "middle"])
def test_unreadable_frames_are_skipped_as_jax(tmp_path, bad):
    """An unreadable file in the sequence is skipped by both packages; as
    the first file, both return False and write nothing."""
    from danerf_tpu.viz.video import create_video_from_images as jax_video

    src = tmp_path / "in"
    os.makedirs(src)
    for i, f in enumerate(_pattern(16, 16, 4, seed=12)):
        cv2.imwrite(str(src / f"rgb_{i:03d}.png"), f[..., ::-1])
    at = 0 if bad == "first" else 2
    (src / f"rgb_{at:03d}.png").write_bytes(b"not a png")
    j = jax_video(str(src), str(tmp_path / "jax.mp4"))
    p = create_video_from_images(str(src), str(tmp_path / "port.mp4"))
    assert j == p == (bad != "first")
    if p:
        assert len(_cv2_rgb(tmp_path / "port.mp4")[0]) == len(_cv2_rgb(tmp_path / "jax.mp4")[0])
        assert read_video(str(tmp_path / "port.mp4"))[0].shape[0] == 3
    else:
        assert not os.path.exists(tmp_path / "port.mp4")


def test_video_frames_read_as_cv2_reads_them(tmp_path, case_files):
    """A sequence of EXIF-rotated JPEGs and 16-bit PNGs: the video holds the
    encoding of cv2's pixels, not PIL's."""
    from danerf_tpu_torch.data.images import read_rgb

    src = tmp_path / "in"
    os.makedirs(src)
    names = ["exif6.jpg", "exif6.png", "exif8.jpg"]
    for i, n in enumerate(names):
        (src / f"f_{i}{os.path.splitext(n)[1]}").write_bytes(open(case_files[n], "rb").read())
    assert create_video_from_images(str(src), str(tmp_path / "v.mp4"), pattern="f_*")
    want = [cv2.imread(str(p))[..., ::-1] for p in sorted(src.iterdir())]
    assert want[0].shape == (14, 10, 3) and read_rgb(str(src / "f_0.jpg")).shape == (10, 14, 3)
    _, _, _, planes = _encode(want)
    got, _, _ = decode_video(str(tmp_path / "v.mp4"))
    for p, q in zip(got, planes):
        np.testing.assert_array_equal(p[0], q[0])


def _smooth_800(t):
    """An 800x800 frame of slow waves, frame t of a drifting sequence."""
    yy, xx = np.mgrid[0:800, 0:800].astype(np.float64)
    r = 128 + 100 * np.sin((xx + 3 * t) / 61.0) * np.cos((yy - 2 * t) / 47.0)
    g = 100 + 80 * np.cos((xx - yy + 4 * t) / 90.0)
    b = 90 + 0.1 * yy + 20 * np.sin(xx / 13.0 + t / 5)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


if __name__ == "__main__":
    # The figures PERF.md quotes for this host: each sequence's mean RGB
    # PSNR and bytes against the JAX file of the same PNGs, and the
    # encoder's ms a frame at 800x800 (I-VOP, then the mean of 11 P-VOPs).
    import pathlib
    import tempfile
    import time

    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.render.frames import render_aligned_spiral

    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        cfg = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(1,),
                         appearance_dim=8, density_bias_init=0.5, num_samples=8,
                         num_importance=4, use_bf16=False, scene="chair")
        model = NeRF(cfg, torch.Generator().manual_seed(0)).requires_grad_(False)
        spiral = [read_png(p) for p in render_aligned_spiral(
            model, cfg, str(d / "spiral"), num_frames=26, height=48, width=64, focal=60.0,
            loops=1.0, fps=30, make_video=False, device="cpu")]
        for name, frames in (("spiral 64x48", spiral),
                             ("pattern 96x64", _pattern(64, 96, 26, seed=9))):
            for ext in (".mp4", ".avi"):
                out = _against_jax(d / f"{name[:7]}{ext[1:]}", frames, ext)
                print(name, ext, {k: (round(float(v[0]), 3), v[1]) for k, v in out.items()})
    enc = mpeg4.Encoder(800, 800, 30)
    ms = []
    for t in range(12):
        frame = _smooth_800(t)
        t0 = time.perf_counter()
        enc.encode(frame)
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"encoder 800x800: I-VOP {ms[0]:.1f} ms, P-VOP {np.mean(ms[1:]):.1f} ms")
