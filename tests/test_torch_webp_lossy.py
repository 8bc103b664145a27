"""Lossy WebP (``danerf_tpu_torch/data/vp8.py`` behind ``data/webp.py``)
against PIL 12.1 with libwebp 1.6 on the CPU.

Every case writes a file here and holds the port's ``read_array`` against
``np.asarray(Image.open(p))`` (dtype, shape, every byte), ``read_rgb``
against ``convert("RGB")`` and ``image_size`` against PIL's size:

- PIL's writer: quality 0 to 100, methods 0, 4 and 6, sizes from 1x1 to
  149x203, natural, flat and posterized pictures, gray input, RGBA at
  alpha qualities 100, 50 and 0, a VP8X file with ICC and EXIF chunks;
- ALPH chunks built here around PIL's ``VP8 `` payload: raw and VP8L
  (PIL's lossless writer, its header cut off) with each of the four
  filters, the preprocessing bit, and the VP8X alpha flag without an ALPH
  chunk or an ALPH chunk without the flag;
- what PIL's writer has no knob for, made by re-encoding the first
  partition with RFC 6386's boolean encoder after a header field changes
  (the simple loop filter, sharpness, loop-filter deltas, the quantiser
  index, segment levels absolute and relative, the scale bits) and by
  splitting the token partition into 2, 4 and 8 (each row's decisions read
  again here and encoded anew); PIL decodes each file as the referee.

A lossy depth map goes through ``load_depth`` and a custom scene of lossy
frames through the port's loader against the JAX package; every refusal
names its cause, and PIL refuses the same files.

Tolerance: none; every array equals PIL's bit for bit.
"""

import io
import json
import re
import struct

import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image")

from test_torch_images import _natural  # noqa: E402

from danerf_tpu_torch.data import vp8  # noqa: E402

torch.set_num_threads(2)


def _disc(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(255 * (1.4 - np.hypot(xx - w / 2, yy - h / 2) / (0.4 * w)), 0,
                   255).astype(np.uint8)


def _webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunks(data: bytes):
    pos, out = 12, []
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                              for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(w, h, alpha: bool) -> tuple:
    return b"VP8X", bytes([0x10 if alpha else 0, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")


PIC = _natural(37, 23)
NAT = _natural(149, 203, seed=3)
RGBA = np.concatenate([NAT, _disc(149, 203)[..., None]], -1)


def _opened(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im), np.asarray(im.convert("RGB")), im.size


def _assert_reads_as_pil(tmp_path, data: bytes):
    from danerf_tpu_torch.data.images import image_size, read_array, read_rgb

    path = tmp_path / "img.webp"
    path.write_bytes(data)
    want, want_rgb, size = _opened(data)
    got = read_array(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape)
    assert got.tobytes() == want.tobytes()
    rgb = read_rgb(str(path))
    assert rgb.dtype == want_rgb.dtype and rgb.shape == want_rgb.shape
    assert rgb.tobytes() == want_rgb.tobytes()
    assert tuple(image_size(str(path))) == size
    return got


# ------------------------------------------------------------ PIL's writer

PIL_CASES = {
    **{f"quality_{q}": (lambda q=q: _webp(NAT, quality=q)) for q in (0, 25, 50, 80, 95, 100)},
    **{f"method_{m}": (lambda m=m: _webp(NAT, quality=70, method=m)) for m in (0, 4, 6)},
    **{f"size_{h}x{w}_q{q}": (lambda h=h, w=w, q=q: _webp(_natural(h, w, seed=h + q), quality=q))
       for h, w in ((1, 1), (15, 17), (17, 15), (2, 3)) for q in (10, 90)},
    "flat": lambda: _webp(np.full((64, 80, 3), 77, np.uint8), quality=90),
    "posterized": lambda: _webp(_natural(149, 203, seed=5, levels=4), quality=90),
    "posterized_q30": lambda: _webp(_natural(96, 64, seed=6, levels=8), quality=30),
    "gray": lambda: _webp(NAT[..., 1], quality=75),
    **{f"rgba_alpha_quality_{a}": (lambda a=a: _webp(RGBA, quality=80, alpha_quality=a))
       for a in (100, 50, 0)},
    "rgba_noise_alpha": lambda: _webp(np.concatenate(
        [PIC, np.random.default_rng(1).integers(0, 256, (37, 23, 1)).astype(np.uint8)], -1),
        quality=60),
    "rgba_method_0": lambda: _webp(RGBA, quality=40, method=0, alpha_quality=70),
    "rgba_odd_size": lambda: _webp(np.concatenate([_natural(17, 15, 2), _disc(17, 15)[..., None]],
                                                  -1), quality=85),
    "vp8x_icc_exif": lambda: _webp(NAT, quality=80, icc_profile=b"\0" * 40,
                                   exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0"),
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_written_lossy_reads_as_pil(tmp_path, case):
    data = PIL_CASES[case]()
    assert b"VP8 " in data and b"VP8L" not in data
    _assert_reads_as_pil(tmp_path, data)


# ------------------------------------------------------------- ALPH by hand

def _filtered(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters (the inverse of ``WebPUnfilters``):
    the first row from the left (0 before it), the first column from
    above, the rest from the left, from above, or by the clipped
    gradient."""
    a = alpha.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    for y in range(h):
        for x in range(w):
            if method == 0:
                continue
            if y == 0:
                pred[y, x] = a[y, x - 1] if x else 0
            elif x == 0:
                pred[y, x] = a[y - 1, 0]
            elif method == 1:
                pred[y, x] = a[y, x - 1]
            elif method == 2:
                pred[y, x] = a[y - 1, x]
            else:
                pred[y, x] = min(max(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1], 0), 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def _alph_vp8l(plane: np.ndarray) -> bytes:
    """A VP8L image stream without its 5-byte header whose green is
    ``plane`` (PIL's lossless writer)."""
    rgb = np.zeros(plane.shape + (3,), np.uint8)
    rgb[..., 1] = plane
    body = dict(_chunks(_webp(rgb, lossless=True, exact=True)))[b"VP8L"]
    return body[5:]


def _with_alph(rgb, alpha, head, payload, flag=True) -> bytes:
    vp = dict(_chunks(_webp(rgb, quality=80)))[b"VP8 "]
    h, w = alpha.shape
    return _riff([_vp8x(w, h, flag), (b"ALPH", bytes([head]) + payload), (b"VP8 ", vp)])


ALPHA = np.clip(_disc(37, 23).astype(int) + np.random.default_rng(2).integers(-9, 9, (37, 23)),
                0, 255).astype(np.uint8)
ALPH_CASES = {
    **{f"raw_filter_{f}": (lambda f=f: _with_alph(PIC, ALPHA, f << 2,
                                                  _filtered(ALPHA, f).tobytes()))
       for f in range(4)},
    **{f"vp8l_filter_{f}": (lambda f=f: _with_alph(PIC, ALPHA, 1 | f << 2,
                                                   _alph_vp8l(_filtered(ALPHA, f))))
       for f in range(4)},
    "raw_preprocessing_bit": lambda: _with_alph(PIC, ALPHA, 0x10 | 3 << 2,
                                                _filtered(ALPHA, 3).tobytes()),
    "vp8l_preprocessing_bit": lambda: _with_alph(PIC, ALPHA, 0x11, _alph_vp8l(ALPHA)),
    "raw_longer_than_the_image": lambda: _with_alph(PIC, ALPHA, 0, ALPHA.tobytes() + bytes(9)),
    "alph_without_the_vp8x_flag": lambda: _with_alph(PIC, ALPHA, 0, ALPHA.tobytes(), False),
    "vp8x_flag_without_alph": lambda: _riff([_vp8x(23, 37, True), (b"VP8 ", dict(_chunks(
        _webp(PIC, quality=80)))[b"VP8 "])]),
    "vp8x_without_flag_or_alph": lambda: _riff([_vp8x(23, 37, False), (b"VP8 ", dict(_chunks(
        _webp(PIC, quality=80)))[b"VP8 "])]),
}


@pytest.mark.parametrize("case", sorted(ALPH_CASES))
def test_hand_built_alph_reads_as_pil(tmp_path, case):
    got = _assert_reads_as_pil(tmp_path, ALPH_CASES[case]())
    if case.startswith(("raw", "vp8l")):
        np.testing.assert_array_equal(got[..., 3], ALPHA)


# -------------------------------------------- re-encoded first partition

def _bool_encode(decisions) -> bytes:
    """RFC 6386 section 7.3's boolean encoder over (probability, bit)
    pairs, its low end kept as one integer (carries propagate by
    themselves) and written out whole."""
    low, rng, shifts = 0, 255, 0
    for prob, bit in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            low += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            low <<= 1
            shifts += 1
    n = (shifts + 15) // 8
    return (low << (8 * n - 8 - shifts)).to_bytes(n, "big")


class _Trace(vp8._BoolDecoder):
    """The port's boolean decoder, recording each (probability, bit)."""

    def __init__(self, data):
        super().__init__(data)
        self.seq = []

    def bit(self, prob):
        b = super().bit(prob)
        self.seq.append((prob, b))
        return b


def _lit(v, n):
    return [(128, (v >> i) & 1) for i in reversed(range(n))]


def _opt_signed(v, n):
    return [(128, int(v != 0))] + (_lit(abs(v), n) + [(128, int(v < 0))] if v else [])


def _header_bits(h) -> list:
    """The frame header's decisions up to the quantiser deltas, as
    libwebp's encoder writes them (a value is present where it is not 0)."""
    out = [(128, h.colour_space), (128, h.clamping), (128, h.use_segment)]
    if h.use_segment:
        out += [(128, h.update_map), (128, h.update_data)]
        if h.update_data:
            out += [(128, h.absolute_delta)]
            out += [b for q in h.seg_quant for b in _opt_signed(q, 7)]
            out += [b for f in h.seg_filter for b in _opt_signed(f, 6)]
        if h.update_map:
            for p in h.seg_probs:
                out += [(128, int(p != 255))] + (_lit(p, 8) if p != 255 else [])
    out += [(128, h.simple)] + _lit(h.level, 6) + _lit(h.sharpness, 3) + [(128, h.use_lf_delta)]
    if h.use_lf_delta:
        out += [(128, h.update_lf_delta)]
        if h.update_lf_delta:
            out += [b for d in h.ref_lf_delta + h.mode_lf_delta for b in _opt_signed(d, 6)]
    out += _lit(h.log2_parts, 2) + _lit(h.base_q, 7)
    return out + [b for d in h.q_deltas for b in _opt_signed(d, 4)]


def _parsed(chunk: bytes):
    """(header, partition 0's decisions, modes, token partitions, mbw, mbh)."""
    size0 = int.from_bytes(chunk[:3], "little") >> 5
    bd = _Trace(chunk[10:10 + size0])
    hdr = vp8.FrameHeader(bd)
    w, h = vp8.vp8_frame_size(chunk)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    modes = vp8._modes(bd, hdr, mbw, mbh)
    parts = vp8._partitions(chunk, hdr.log2_parts, 10 + size0)
    assert _header_bits(hdr) == bd.seq[:len(_header_bits(hdr))]
    return hdr, bd.seq, modes, parts, mbw, mbh


def _token_rows(parts, hdr, modes, mbw, mbh):
    """Each macroblock row's token decisions, read again here with the
    tracing decoder (section 13's syntax; one token partition)."""
    assert len(parts) == 1
    seg, skip, is4 = modes[:3]
    probs = [[hdr.coef_probs[t, vp8._BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    bd = _Trace(parts[0])
    bit = bd.bit
    rows, top = [], [0] * (9 * mbw)
    for y in range(mbh):
        start, left = len(bd.seq), [0] * 9
        for x in range(mbw):
            mb = y * mbw + x
            if skip[mb]:
                top[9 * x:9 * x + 8] = left[:8] = [0] * 8
                if not is4[mb]:
                    top[9 * x + 8] = left[8] = 0
                continue
            for _, t, first, ti, li, _ in (vp8._I4_BLOCKS if is4[mb] else vp8._I16_BLOCKS):
                n, band = first, probs[t]
                p = band[n][top[9 * x + ti] + left[li]]
                while n < 16 and bit(p[0]):
                    while not bit(p[1]):
                        n += 1
                        if n == 16:
                            break
                        p = band[n][0]
                    if n == 16:
                        break
                    ctx = 1
                    if bit(p[2]):
                        ctx = 2
                        if not bit(p[3]):
                            if bit(p[4]):
                                bit(p[5])
                        elif not bit(p[6]):
                            bit(159) if not bit(p[7]) else (bit(165), bit(145))
                        else:
                            b1 = bit(p[8])
                            for prob in vp8._CAT_PROBS[2 * b1 + bit(p[9 + b1])]:
                                bit(prob)
                    bit(128)
                    n += 1
                    p = band[n][ctx]
                top[9 * x + ti] = left[li] = int(n > first)
        rows.append(bd.seq[start:])
    assert not bd.eof
    return rows


def _rebuild(data: bytes, change=None, log2_parts=None) -> bytes:
    """``data`` (a lossy WebP) with its frame header re-encoded after
    ``change(header)`` and, with ``log2_parts``, its tokens split into that
    many partitions (row y in partition y mod their number)."""
    chunks = _chunks(data)
    at = [t for t, _ in chunks].index(b"VP8 ")
    chunk = chunks[at][1]
    hdr, seq, modes, parts, mbw, mbh = _parsed(chunk)
    rest = seq[len(_header_bits(hdr)):]
    if change:
        change(hdr)
    if log2_parts is not None:
        rows = _token_rows(parts, hdr, modes, mbw, mbh)
        n = 1 << log2_parts
        parts = [_bool_encode([d for r in rows[p::n] for d in r]) for p in range(n)]
        hdr.log2_parts = log2_parts
    part0 = _bool_encode(_header_bits(hdr) + rest)
    tag = (int.from_bytes(chunk[:3], "little") & 0x1F) | (len(part0) << 5)
    new = tag.to_bytes(3, "little") + chunk[3:10] + part0 + \
        b"".join(len(p).to_bytes(3, "little") for p in parts[:-1]) + b"".join(parts)
    chunks[at] = (b"VP8 ", new)
    return _riff(chunks)


BASE = _natural(61, 75, seed=11)     # 4 x 5 macroblocks, 4 segments
TALL = _natural(135, 40, seed=12)    # 9 rows of macroblocks


def _set(**fields):
    def change(h):
        for k, v in fields.items():
            setattr(h, k, v)
    return change


def _uniform(**fields):
    """``_set`` after making every segment take the frame's quantiser and
    filter level (PIL's writer gives each segment absolute values, which
    would hide ``base_q`` and ``level``)."""
    def change(h):
        if h.use_segment:
            h.update_data, h.absolute_delta = 1, 0
            h.seg_quant, h.seg_filter = [0] * 4, [0] * 4
        _set(**fields)(h)
    return change


def _lf_deltas(ref, mode):
    def change(h):
        h.use_lf_delta, h.update_lf_delta = 1, 1
        h.ref_lf_delta, h.mode_lf_delta = [ref, 7, -3, 0], [mode, 0, 11, -5]
    return change


REENCODED = {
    "same_header": lambda: _rebuild(_webp(BASE, quality=60)),
    **{f"simple_filter_level_{lv}_sharpness_{sh}": (
        lambda lv=lv, sh=sh: _rebuild(_webp(BASE, quality=50), _uniform(simple=1, level=lv,
                                                                        sharpness=sh)))
       for lv, sh in ((20, 0), (63, 3), (7, 6), (40, 7))},
    **{f"sharpness_{sh}": (lambda sh=sh: _rebuild(_webp(BASE, quality=40),
                                                   _uniform(sharpness=sh, level=30)))
       for sh in (1, 4, 5, 7)},
    **{f"filter_level_{lv}": (lambda lv=lv: _rebuild(_webp(BASE, quality=40), _uniform(level=lv)))
       for lv in (0, 1, 14, 15, 39, 40, 63)},
    **{f"lf_deltas_ref_{r}_mode_{m}": (lambda r=r, m=m: _rebuild(_webp(BASE, quality=70),
                                                                 _lf_deltas(r, m)))
       for r, m in ((9, -20), (-30, 12), (63, 0), (-63, 63))},
    "lf_deltas_present_not_updated": lambda: _rebuild(_webp(BASE, quality=70),
                                                      _set(use_lf_delta=1, update_lf_delta=0)),
    "lf_deltas_simple_filter": lambda: _rebuild(_webp(BASE, quality=70), lambda h: (
        _lf_deltas(-12, 30)(h), setattr(h, "simple", 1))),
    "segments_relative": lambda: _rebuild(_webp(BASE, quality=60), _set(
        use_segment=1, update_data=1, absolute_delta=0, seg_quant=[-20, 5, 30, -7],
        seg_filter=[10, -40, 3, 60])),
    "segments_absolute_past_the_tables": lambda: _rebuild(_webp(BASE, quality=60), _set(
        use_segment=1, update_data=1, absolute_delta=1, seg_quant=[127, 0, -5, 100],
        seg_filter=[63, 0, -8, 20])),
    "quant_deltas_clipped": lambda: _rebuild(_webp(BASE, quality=60), _uniform(
        base_q=120, q_deltas=[15, -15, 15, 15, -15])),
    "quant_deltas_low": lambda: _rebuild(_webp(BASE, quality=60), _uniform(
        base_q=2, q_deltas=[-15, 3, -15, -15, 15])),
    "colour_space_and_clamping_bits": lambda: _rebuild(_webp(BASE, quality=60), _set(
        colour_space=1, clamping=1)),
    **{f"token_partitions_{1 << k}": (lambda k=k: _rebuild(_webp(TALL, quality=70),
                                                           log2_parts=k)) for k in (0, 1, 2, 3)},
    "token_partitions_8_of_4_rows": lambda: _rebuild(_webp(BASE, quality=70), log2_parts=3),
    "token_partitions_4_simple_filter": lambda: _rebuild(_webp(TALL, quality=30),
                                                         _uniform(simple=1, level=25),
                                                         log2_parts=2),
}


@pytest.mark.parametrize("case", sorted(REENCODED))
def test_reencoded_header_reads_as_pil(tmp_path, case):
    _assert_reads_as_pil(tmp_path, REENCODED[case]())


@pytest.mark.parametrize("base_q", range(0, 128, 7))
def test_every_quantiser_index_reads_as_pil(tmp_path, base_q):
    """Section 14.1's tables, 19 base indices with deltas that reach each
    table's ends (Y2 AC's floor of 8, UV DC's cap at index 117)."""
    _assert_reads_as_pil(tmp_path, _rebuild(_webp(BASE, quality=50), _uniform(
        base_q=base_q, q_deltas=[3, -4, 5, 6, -2])))


def test_scale_bits_are_ignored(tmp_path):
    data = _webp(PIC, quality=80)
    at = data.index(b"VP8 ") + 8
    data = data[:at + 7] + bytes([data[at + 7] | 0xC0]) + data[at + 8:at + 9] + \
        bytes([data[at + 9] | 0x40]) + data[at + 10:]
    _assert_reads_as_pil(tmp_path, data)


# ---------------------------------------------------------------- refusals

def _vp8_of(img, **kw):
    return dict(_chunks(_webp(img, **kw)))[b"VP8 "]


def _tagged(vp, size0=None, first=None):
    bits = int.from_bytes(vp[:3], "little")
    if size0 is not None:
        bits = (bits & 0x1F) | (size0 << 5)
    if first is not None:
        bits = first(bits)
    return bits.to_bytes(3, "little") + vp[3:]


def _alph_case(head, payload=None):
    data = _webp(np.concatenate([PIC, ALPHA[..., None]], -1), quality=80)
    chunks = _chunks(data)
    at = [t for t, _ in chunks].index(b"ALPH")
    body = chunks[at][1]
    chunks[at] = (b"ALPH", (bytes([head]) if head is not None else b"")
                  + (body[1:] if payload is None else payload))
    return _riff(chunks)


VP = _vp8_of(PIC, quality=80)
SIZE0 = int.from_bytes(VP[:3], "little") >> 5
REFUSED = {
    "not_a_key_frame": (lambda: _riff([(b"VP8 ", _tagged(VP, first=lambda b: b | 1))]),
                        "not a key frame"),
    "profile_5": (lambda: _riff([(b"VP8 ", _tagged(VP, first=lambda b: (b & ~0xE) | 10))]),
                  "profile 5"),
    "not_for_display": (lambda: _riff([(b"VP8 ", _tagged(VP, first=lambda b: b & ~0x10))]),
                        "a frame not for display"),
    "bad_start_code": (lambda: _riff([(b"VP8 ", VP[:3] + b"\x9d\x01\x2b" + VP[6:])]),
                       "bad start code"),
    "first_partition_past_the_chunk": (lambda: _riff([(b"VP8 ", VP[:10 + SIZE0 - 2])]),
                                       "bad partition length"),
    "no_token_partition": (lambda: _riff([(b"VP8 ", VP[:10 + SIZE0])]),
                           "an empty token partition"),
    "truncated_token_partition": (lambda: _riff([(b"VP8 ", VP[:10 + SIZE0 + 40])]),
                                  "premature end of a token partition"),
    "truncated_first_partition": (lambda: _riff([(b"VP8 ", _tagged(
        VP[:10] + VP[10:10 + SIZE0 // 2] + VP[10 + SIZE0:], size0=SIZE0 // 2))]),
        "premature end of the first partition"),
    "truncated_segment_header": (lambda: _riff([(b"VP8 ", _tagged(
        VP[:10] + b"\xff" + VP[10 + SIZE0:], size0=1))]), "cannot parse the segment header"),
    "alph_compression_2": (lambda: _alph_case(0x02), "ALPH header 0x02"),
    "alph_compression_3": (lambda: _alph_case(0x03), "ALPH header 0x03"),
    "alph_preprocessing_2": (lambda: _alph_case(0x20), "ALPH header 0x20"),
    "alph_reserved_bits": (lambda: _alph_case(0x40), "ALPH header 0x40"),
    "alph_empty": (lambda: _alph_case(None, b""), "an empty ALPH chunk"),
    "alph_raw_short": (lambda: _alph_case(0x00, bytes(100)), "raw ALPH data shorter"),
    "alph_vp8l_truncated": (lambda: _alph_case(0x01, _alph_vp8l(ALPHA)[:40]),
                            "truncated WebP lossless data"),
    "alph_without_vp8x": (lambda: _riff([(b"ALPH", b"\0" + ALPHA.tobytes()), (b"VP8 ", VP)]),
                          "an ALPH chunk without a VP8X header"),
    "alph_not_before_vp8": (lambda: _riff([_vp8x(23, 37, True), (b"ALPH", b"\0" + ALPHA.tobytes()),
                                           (b"EXIF", b"abcd"), (b"VP8 ", VP)]),
                            "not followed by its VP8 chunk"),
    "canvas_of_another_size": (lambda: _riff([_vp8x(24, 37, False), (b"VP8 ", VP)]),
                               "a 23x37 frame on a 24x37 canvas"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_their_cause(tmp_path, case):
    """Each file PIL (libwebp) refuses too raises ValueError naming the
    cause, from ``read_array``, ``read_rgb`` and the custom loader."""
    from danerf_tpu_torch.data import custom, images

    make, cause = REFUSED[case]
    data = make()
    with pytest.raises(OSError):
        _opened(data)
    path = tmp_path / "img.webp"
    path.write_bytes(data)
    for read in (images.read_array, images.read_rgb, custom.read_rgb):
        with pytest.raises(ValueError, match=re.escape(cause)):
            read(str(path))


def test_bool_encoder_round_trips_through_the_decoder():
    rng = np.random.default_rng(0)
    for n in (1, 7, 500, 5000):
        probs = rng.integers(1, 256, n)
        bits = (rng.integers(0, 256, n) >= probs).astype(int)
        bd = vp8._BoolDecoder(_bool_encode(list(zip(probs.tolist(), bits.tolist()))))
        assert [bd.bit(int(p)) for p in probs] == bits.tolist()
        assert not bd.eof


# ------------------------------------------------- against the JAX package

def test_load_depth_of_a_lossy_webp_equals_the_jax_preview_depth(tmp_path, monkeypatch):
    """A lossy WebP depth map (PIL opens it as RGB; the JAX preview takes
    its first channel over 255) through the JAX ``preview_from_files`` and
    the port's ``load_depth`` and ``preview_from_files``."""
    import danerf_tpu.fx.preview as jprev

    import danerf_tpu_torch.fx.preview as tprev
    from danerf_tpu_torch.fx.batch import load_depth

    depth = tmp_path / "depth.webp"
    depth.write_bytes(_webp(NAT[..., 0], quality=85))
    pic = tmp_path / "pic.png"
    Image.fromarray(_natural(149, 203, seed=9)).save(pic)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"effects": [{"name": "Fog"}]}))
    seen = {}
    monkeypatch.setattr(jprev, "render_previews",
                        lambda image, d, s, out: seen.setdefault("jax", d) is None or [])
    monkeypatch.setattr(tprev, "render_previews",
                        lambda image, d, s, out, device=None: seen.setdefault("port", d)
                        is None or [])
    jprev.preview_from_files(str(pic), str(depth), str(spec), str(tmp_path / "j"))
    tprev.preview_from_files(str(pic), str(depth), str(spec), str(tmp_path / "t"),
                             device="cpu")
    want = seen["jax"]
    got = load_depth(str(depth))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (149, 203)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seen["port"], want)


def test_custom_scene_of_lossy_frames_matches_jax(tmp_path):
    """``load_custom_scene`` and ``load_dataset`` on lossy RGB, RGBA and gray
    WebP frames against the JAX ``load_custom_scene`` (PIL's
    ``convert("RGB")``: alpha dropped)."""
    from danerf_tpu.data.custom import load_custom_scene as j_load
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.custom import load_custom_scene
    from danerf_tpu_torch.data.dataset import load_dataset, scene_intrinsics

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(8)
    pics = [_natural(21, 30, seed=40 + i) for i in range(4)]
    files = {"a.webp": _webp(pics[0], quality=80),
             "b.webp": _webp(np.concatenate([pics[1], _disc(21, 30)[..., None]], -1),
                             quality=60),
             "c.webp": _webp(pics[2][..., 0], quality=95),
             "d.webp": _webp(pics[3], quality=20, method=6)}
    frames = []
    for name, data in files.items():
        (images / name).write_bytes(data)
        frames.append({"file_path": name, "transform_matrix": rng.normal(size=(4, 4)).tolist()})
    (tmp_path / "transforms.json").write_text(json.dumps({"frames": frames,
                                                          "camera_angle_x": 0.7}))
    for split, n in (("train", 3), ("val", 1)):
        want = j_load(str(images), split=split)
        got = load_custom_scene(str(images), split=split)
        assert got.n_images == n
        for k in ("images", "alphas", "c2ws"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.focal == want.focal
        cfg = NeRFConfig(dataset_type="custom", dataset_path=str(images))
        np.testing.assert_array_equal(load_dataset(cfg, split).images, want.images)
        info = scene_intrinsics(cfg, split)
        assert (info.width, info.focal) == (want.width, want.focal)
