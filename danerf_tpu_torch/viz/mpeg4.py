"""MPEG-4 Part 2 Simple Profile video (ISO/IEC 14496-2) in numpy: the codec
of the JAX package's videos, which OpenCV's FFmpeg writer encodes as
``mp4v`` (MP4, MOV, Matroska) or ``XVID`` (AVI).

``Encoder`` turns RGB frames into a stream of the same kind:

- headers: a visual object sequence (profile and level ``0x01``), a visual
  object and a video object layer with ``vop_time_increment_resolution`` =
  the frame rate's denominator, a fixed VOP rate, H.263 quantisation, no
  resync markers and no user data;
- an I-VOP every ``GOP`` frames and P-VOPs between them, all at the fixed
  quantiser ``QUANT`` (the ``vop_quant`` of OpenCV's files);
- I-VOPs: intra DC prediction in the direction of the smaller gradient,
  ``dct_dc_size`` VLCs, ``ac_pred_flag`` 0 and the intra TCOEF table with
  its three escape modes;
- P-VOPs: one half-pel motion vector per macroblock at ``f_code`` 1 (a
  hierarchical search), coded against the median of its neighbours;
  ``not_coded`` macroblocks; chroma vectors derived as the standard says;
  ``vop_rounding_type`` alternating; the inter TCOEF table;
- the reconstruction the decoder makes, kept as the next reference: the
  inverse transform is FFmpeg's integer "simple" IDCT, IEEE 1180 accurate;
- sizes that are not a multiple of 16 padded by edge replication and
  cropped; RGB to YUV 4:2:0 as BT.601 limited range.

Quantisation follows FFmpeg's encoder for H.263 quantisation: intra AC
levels truncated, inter levels with a quarter-step dead zone.  The
bitstream of a VOP is built from (code, length) pairs in numpy and packed
in one pass.  ``decode_stream`` decodes the subset ``Encoder`` writes (user
data and GOV headers skipped: OpenCV's own files decode where they stay in
it); B-VOPs, data partitioning, interlace, quarter-pel, 4MV, f_code above
1, intra or quantiser changes inside a P-VOP, AC prediction and other
tools are refused by name.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

GOP = 12
QUANT = 3
DC_SCALER = 8            # luma and chroma dc_scaler of quantisers 1-4 (Table 7-1)
MV_MARGIN = 32           # reference padding: the vector range (16) and the coarse search

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ------------------------------------------------------------------ tables
# Annex B.  (code, length) without the sign bit, in order of (last, run,
# level); the level count of each (last, run) is its LMAX.
MCBPC_INTRA = ((1, 1), (1, 3), (2, 3), (3, 3))             # mb_type 3, cbpc 0..3
MCBPC_INTER = ((1, 1), (3, 4), (2, 4), (5, 6))             # mb_type 0, cbpc 0..3
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
          (1, 8), (1, 9), (1, 10), (1, 11))
DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
            (1, 9), (1, 10), (1, 11), (1, 12))
MVD = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9),
       (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10),
       (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11),
       (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12))
ESCAPE = (3, 7)

INTRA_LMAX = ((27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1),
              (8, 3, 2, 2, 2, 2, 2) + (1,) * 14)
INTRA_VLC = (
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x21, 11), (0x50, 12), (0x51, 12), (0x52, 12),
    (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9), (0x1f, 9), (0xd, 10), (0x22, 11),
    (0x53, 12), (0x55, 12),
    (0xb, 5), (0x15, 7), (0x1e, 9), (0xc, 10), (0x56, 12),
    (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10),
    (0x10, 6), (0x22, 9), (0xa, 10),
    (0xd, 6), (0x1c, 9), (0x8, 10),
    (0x12, 7), (0x1b, 9), (0x54, 12),
    (0x14, 7), (0x1a, 9), (0x57, 12),
    (0x19, 8), (0x9, 10),
    (0x18, 8), (0x23, 11),
    (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12),
    # last = 1
    (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10), (0x5, 11), (0x4, 11), (0x59, 12),
    (0xf, 6), (0x16, 9), (0x5, 10),
    (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11),
    (0x10, 7), (0x25, 11),
    (0x13, 7), (0x5a, 12),
    (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12))

INTER_LMAX = ((12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2) + (1,) * 16,
              (3, 2) + (1,) * 39)
INTER_VLC = (
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10), (0x21, 11), (0x50, 12),
    (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12),
    (0xd, 5), (0x23, 9), (0xd, 10),
    (0xc, 5), (0x22, 9), (0x52, 12),
    (0xb, 5), (0xc, 10), (0x53, 12),
    (0x13, 6), (0xb, 10), (0x54, 12),
    (0x12, 6), (0xa, 10),
    (0x11, 6), (0x9, 10),
    (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12),
    (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9), (0x1f, 9), (0x1e, 9),
    (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11), (0x56, 12),
    (0x57, 12),
    # last = 1
    (0x7, 4), (0x19, 9), (0x5, 11),
    (0xf, 6), (0x4, 11),
    (0xe, 6), (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8),
    (0x19, 8), (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9),
    (0x17, 9), (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10),
    (0x6, 10), (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11),
    (0x58, 12), (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12),
    (0x5f, 12))

MAX_LEVEL = 32           # the dense tables' level axis (every VLC level is below it)


class _TCoef:
    """One TCOEF table: (last, run, level) of each entry, the dense (2, 64,
    MAX_LEVEL + 1) code and length arrays (length 0: no entry), LMAX and
    RMAX."""

    def __init__(self, vlc, lmax):
        self.entries = [(last, run, level) for last in (0, 1)
                        for run, n in enumerate(lmax[last]) for level in range(1, n + 1)]
        assert len(self.entries) == len(vlc) == 102
        self.code = np.zeros((2, 64, MAX_LEVEL + 1), np.int64)
        self.length = np.zeros((2, 64, MAX_LEVEL + 1), np.int64)
        self.lmax = np.zeros((2, 64), np.int64)
        self.rmax = np.full((2, MAX_LEVEL + 1), -1, np.int64)
        for (last, run, level), (code, n) in zip(self.entries, vlc):
            self.code[last, run, level], self.length[last, run, level] = code, n
            self.lmax[last, run] = max(self.lmax[last, run], level)
            self.rmax[last, level] = max(self.rmax[last, level], run)


INTRA = _TCoef(INTRA_VLC, INTRA_LMAX)
INTER = _TCoef(INTER_VLC, INTER_LMAX)


# ------------------------------------------------------------------ bits

def pack_bits(codes, lengths) -> bytes:
    """The (code, length) pairs, most significant bit first, as bytes; the
    total length must be a multiple of 8."""
    codes = np.asarray(codes, np.int64)
    lengths = np.asarray(lengths, np.int64)
    keep = lengths > 0
    codes, lengths = codes[keep], lengths[keep]
    total = int(lengths.sum())
    if total % 8:
        raise ValueError(f"{total} bits do not fill whole bytes")
    item = np.repeat(np.arange(len(codes)), lengths)
    start = np.cumsum(lengths) - lengths
    shift = lengths[item] - 1 - (np.arange(total) - start[item])
    return np.packbits(((codes[item] >> shift) & 1).astype(np.uint8)).tobytes()


def _stuffing(nbits: int):
    """next_start_code(): a 0 and then ones up to the byte boundary."""
    n = 8 - nbits % 8
    return (1 << (n - 1)) - 1, n


class _Writer:
    """A small bit writer for headers."""

    def __init__(self):
        self.codes, self.lengths = [], []

    def put(self, value: int, n: int):
        self.codes.append(value)
        self.lengths.append(n)

    def bits(self) -> int:
        return sum(self.lengths)

    def stuff(self):
        self.put(*_stuffing(self.bits()))


def frame_rate(fps) -> tuple:
    """(vop_time_increment_resolution, fixed_vop_time_increment) of a frame
    rate: the smallest fraction within 16-bit fields."""
    f = Fraction(fps).limit_denominator(65535)
    if f <= 0 or f.numerator > 65535:
        raise ValueError(f"frame rate {fps} does not fit MPEG-4's 16-bit time fields")
    return f.numerator, f.denominator


def _time_bits(resolution: int) -> int:
    return max(1, (resolution - 1).bit_length())


def stream_headers(width: int, height: int, fps) -> bytes:
    """VOS (profile and level 0x01), VO and VOL, each with its start code."""
    res, inc = frame_rate(fps)
    w = _Writer()
    w.put(0x1B0, 32)
    w.put(0x01, 8)                      # profile_and_level_indication
    w.put(0x1B5, 32)
    w.put(1, 1)                         # is_visual_object_identifier
    w.put(1, 4)                         # visual_object_verid
    w.put(1, 3)                         # visual_object_priority
    w.put(1, 4)                         # visual_object_type: video
    w.put(0, 1)                         # video_signal_type
    w.stuff()
    w.put(0x100, 32)                    # video_object_start_code
    w.put(0x120, 32)                    # video_object_layer_start_code
    w.put(0, 1)                         # random_accessible_vol
    w.put(1, 8)                         # video_object_type_indication: Simple
    w.put(1, 1)                         # is_object_layer_identifier
    w.put(1, 4)                         # video_object_layer_verid
    w.put(1, 3)                         # video_object_layer_priority
    w.put(1, 4)                         # aspect_ratio_info: square
    w.put(1, 1)                         # vol_control_parameters
    w.put(1, 2)                         # chroma_format 4:2:0
    w.put(1, 1)                         # low_delay
    w.put(0, 1)                         # vbv_parameters
    w.put(0, 2)                         # video_object_layer_shape: rectangular
    w.put(1, 1)
    w.put(res, 16)                      # vop_time_increment_resolution
    w.put(1, 1)
    w.put(1, 1)                         # fixed_vop_rate
    w.put(inc, _time_bits(res))         # fixed_vop_time_increment
    w.put(1, 1)
    w.put(width, 13)
    w.put(1, 1)
    w.put(height, 13)
    w.put(1, 1)
    w.put(0, 1)                         # interlaced
    w.put(1, 1)                         # obmc_disable
    w.put(0, 1)                         # sprite_enable
    w.put(0, 1)                         # not_8_bit
    w.put(0, 1)                         # quant_type: H.263
    w.put(1, 1)                         # complexity_estimation_disable
    w.put(1, 1)                         # resync_marker_disable
    w.put(0, 1)                         # data_partitioned
    w.put(0, 1)                         # scalability
    w.stuff()
    return pack_bits(w.codes, w.lengths)


# ------------------------------------------------------------------ colour

def rgb_to_yuv420(rgb: np.ndarray):
    """uint8 (H, W, 3) RGB to BT.601 limited-range Y (H, W) and Cb, Cr
    (ceil(H/2), ceil(W/2)), chroma the mean of each 2x2 block (edge pixels
    repeated on odd sizes)."""
    h, w = rgb.shape[:2]
    a = rgb.astype(np.float32)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    ph, pw = h + (h & 1), w + (w & 1)
    if (ph, pw) != (h, w):
        a = np.pad(a, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    m = (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]) * 0.25
    r, g, b = m[..., 0], m[..., 1], m[..., 2]
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, cb, cr))


def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb_to_yuv420``, each chroma sample repeated over its
    2x2 block: uint8 (H, W, 3)."""
    h, w = y.shape
    c = [np.repeat(np.repeat(p.astype(np.float32) - 128.0, 2, 0), 2, 1)[:h, :w]
         for p in (cb, cr)]
    yy = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    u, v = c[0] * (255.0 / 224.0), c[1] * (255.0 / 224.0)
    r = yy + 1.402 * v
    g = yy - 0.344136 * u - 0.714136 * v
    b = yy + 1.772 * u
    return np.clip(np.rint(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ transform

def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2.0
    c[0] /= np.sqrt(2.0)
    return c


_C = _dct_matrix()
_W = (0, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def fdct(blocks: np.ndarray) -> np.ndarray:
    """Orthonormal 8x8 forward DCT of (..., 8, 8) samples, float64."""
    return _C @ blocks.astype(np.float64) @ _C.T


def _idct_1d(x, rnd, shift):
    """One pass of FFmpeg's simple IDCT over the last axis of int32 x (its
    32-bit sums wrap as C's do): ``rnd`` is the rounding term of the even
    part's W4 product."""
    w1, w2, w3, w4, w5, w6, w7 = _W[1:]
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    a0 = w4 * x0 + np.int32(rnd)
    a1, a2, a3 = a0 + w6 * x2 - w4 * x4 - w2 * x6, a0 - w6 * x2 - w4 * x4 + w2 * x6, \
        a0 - w2 * x2 + w4 * x4 - w6 * x6
    a0 = a0 + w2 * x2 + w4 * x4 + w6 * x6
    b0 = w1 * x1 + w3 * x3 + w5 * x5 + w7 * x7
    b1 = w3 * x1 - w7 * x3 - w1 * x5 - w5 * x7
    b2 = w5 * x1 - w1 * x3 + w7 * x5 + w3 * x7
    b3 = w7 * x1 - w5 * x3 + w3 * x5 - w1 * x7
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                    axis=-1) >> shift


def idct(coef: np.ndarray) -> np.ndarray:
    """FFmpeg's simple IDCT (8-bit: ``ff_simple_idct_int16_8bit``) of int
    (..., 8, 8) coefficients in natural order: rows with a 16-bit store (a
    row of DC alone becomes DC << 3), then columns; int32 samples before
    clipping."""
    x = coef.astype(np.int32)
    rows = _idct_1d(x, 1 << 10, 11).astype(np.int16)
    dc_only = ~np.any(x[..., 1:] != 0, axis=-1)
    rows = np.where(dc_only[..., None], (x[..., :1] * 8).astype(np.int16), rows)
    cols = np.swapaxes(rows.astype(np.int32), -1, -2)
    w4 = _W[4]
    out = _idct_1d(cols, w4 * ((1 << 19) // w4), 20)
    return np.swapaxes(out, -1, -2)


# FFmpeg's XviD IDCT (``ff_xvid_idct``): rows on prescaled tables, columns
# by tangent butterflies; what FFmpeg decodes an XVID-tagged stream with.
_XVID_TAB = {0: (22725, 21407, 19266, 16384, 12873, 8867, 4520),
             1: (31521, 29692, 26722, 22725, 17855, 12299, 6270),
             2: (29692, 27969, 25172, 21407, 16819, 11585, 5906),
             3: (26722, 25172, 22654, 19266, 15137, 10426, 5315)}
_XVID_ROWS = (0, 1, 2, 3, 0, 3, 2, 1)
_XVID_RND = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
_TAN1, _TAN2, _TAN3, _SQRT2 = 0x32EC, 0x6A0A, 0xAB0E, 0x5A82


def _mult(c, x):
    return (np.int32(c) * x) >> 16


def idct_xvid(coef: np.ndarray) -> np.ndarray:
    """FFmpeg's XviD IDCT of int (..., 8, 8) coefficients in natural
    order, the rows stored with 16-bit saturation as its SIMD version packs
    them: int32 samples before clipping."""
    x = coef.astype(np.int32)
    tab = np.array([_XVID_TAB[k] for k in _XVID_ROWS], np.int32)      # (8 rows, 7)
    c1, c2, c3, c4, c5, c6, c7 = (tab[:, i] for i in range(7))
    rnd = np.array(_XVID_RND, np.int32)
    r = [x[..., i] for i in range(8)]                                  # each (..., 8 rows)
    k = c4 * r[0] + rnd
    a0 = k + c2 * r[2] + c4 * r[4] + c6 * r[6]
    a1 = k + c6 * r[2] - c4 * r[4] - c2 * r[6]
    a2 = k - c6 * r[2] - c4 * r[4] + c2 * r[6]
    a3 = k - c2 * r[2] + c4 * r[4] - c6 * r[6]
    b0 = c1 * r[1] + c3 * r[3] + c5 * r[5] + c7 * r[7]
    b1 = c3 * r[1] - c7 * r[3] - c1 * r[5] - c5 * r[7]
    b2 = c5 * r[1] - c1 * r[3] + c7 * r[5] + c3 * r[7]
    b3 = c7 * r[1] - c5 * r[3] + c3 * r[5] - c1 * r[7]
    rows = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                    axis=-1)
    rows = np.clip(rows >> 11, -32768, 32767)                          # (..., 8 rows, 8)
    col = [rows[..., i, :] for i in range(8)]                          # row i of every column
    mm0 = _mult(_TAN1, col[7]) + col[1]
    mm1 = _mult(_TAN1, col[1]) - col[7]
    mm2 = _mult(_TAN3, col[5]) + col[3]
    mm3 = _mult(_TAN3, col[3]) - col[5]
    b0, b3 = mm0 + mm2, mm1 - mm3
    mm0, mm1 = mm0 - mm2, mm1 + mm3
    b1 = 2 * _mult(_SQRT2, mm0 + mm1)
    b2 = 2 * _mult(_SQRT2, mm0 - mm1)
    e3 = _mult(_TAN2, col[6]) + col[2]
    e2 = _mult(_TAN2, col[2]) - col[6]
    s, d = col[0] + col[4], col[0] - col[4]
    a0, a3, a1, a2 = s + e3, s - e3, d + e2, d - e2
    out = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                   axis=-2)
    return (out >> 6).astype(np.int16).astype(np.int32)


IDCTS = {"simple": idct, "xvid": idct_xvid}


def dequantize(levels: np.ndarray, quant: int, intra: bool) -> np.ndarray:
    """H.263 inverse quantisation of (..., 64) levels in natural order, as
    FFmpeg's decoder does it (no saturation); an intra block's DC (index 0)
    is left for the caller."""
    lv = levels.astype(np.int64)
    mag = (2 * np.abs(lv) + 1) * quant - (1 - (quant & 1))
    out = np.where(lv != 0, np.sign(lv) * mag, 0)
    if intra:
        out[..., 0] = lv[..., 0]
    return out


# ------------------------------------------------------------------ planes

class Planes:
    """Y, Cb, Cr of one frame at macroblock-aligned size: ``y`` (16 mbh, 16
    mbw), ``cb``/``cr`` (8 mbh, 8 mbw), int32."""

    def __init__(self, y, cb, cr):
        self.y, self.cb, self.cr = y, cb, cr

    @classmethod
    def from_frame(cls, y, cb, cr, mbh, mbw):
        def pad(p, hh, ww):
            p = p.astype(np.int32)
            return np.pad(p, ((0, hh - p.shape[0]), (0, ww - p.shape[1])), mode="edge")

        return cls(pad(y, 16 * mbh, 16 * mbw), pad(cb, 8 * mbh, 8 * mbw),
                   pad(cr, 8 * mbh, 8 * mbw))

    def crop(self, width, height):
        """uint8 planes of the displayed size: Y (H, W), chroma (ceil(H/2),
        ceil(W/2))."""
        ch, cw = (height + 1) // 2, (width + 1) // 2
        return (self.y[:height, :width].astype(np.uint8), self.cb[:ch, :cw].astype(np.uint8),
                self.cr[:ch, :cw].astype(np.uint8))


def to_blocks(p: Planes, mbh: int, mbw: int) -> np.ndarray:
    """(mbh * mbw, 6, 8, 8): Y0 Y1 Y2 Y3 Cb Cr of each macroblock in raster
    order."""
    y = p.y.reshape(mbh, 2, 8, mbw, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 4, 8, 8)
    c = [q.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(-1, 1, 8, 8)
         for q in (p.cb, p.cr)]
    return np.concatenate([y, *c], axis=1)


def from_blocks(b: np.ndarray, mbh: int, mbw: int) -> Planes:
    y = b[:, :4].reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5)
    c = [b[:, k].reshape(mbh, mbw, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mbh, 8 * mbw)
         for k in (4, 5)]
    return Planes(y.reshape(16 * mbh, 16 * mbw), *c)


def _edge_ref(plane: np.ndarray, valid_h: int, valid_w: int, margin: int) -> np.ndarray:
    """A reference plane for motion compensation: the displayed area,
    repeated outward past the padded size by ``margin`` on every side."""
    hh, ww = plane.shape
    v = plane[:valid_h, :valid_w]
    return np.pad(v, ((margin, margin + hh - valid_h), (margin, margin + ww - valid_w)),
                  mode="edge")


def _hpel_at(p: np.ndarray, fy: int, fx: int, rounding: int) -> np.ndarray:
    """Half-sample interpolation of (n, s + 1, s + 1) patches to (n, s, s)
    at one position: fy, fx are the half-sample flags."""
    a = p[:, :-1, :-1]
    if fy and fx:
        return (a + p[:, :-1, 1:] + p[:, 1:, :-1] + p[:, 1:, 1:] + 2 - rounding) >> 2
    if fy or fx:
        return (a + p[:, fy:p.shape[1] - 1 + fy, fx:p.shape[2] - 1 + fx] + 1 - rounding) >> 1
    return a


def _hpel(p: np.ndarray, fy, fx, rounding: int) -> np.ndarray:
    """As ``_hpel_at`` with a position (fy, fx: (n,) flags) per patch."""
    out = np.empty((p.shape[0], p.shape[1] - 1, p.shape[2] - 1), p.dtype)
    for y in (0, 1):
        for x in (0, 1):
            sel = np.flatnonzero((fy == y) & (fx == x))
            if len(sel):
                out[sel] = _hpel_at(p[sel], y, x, rounding)
    return out


def _gather(ref: np.ndarray, y0: np.ndarray, x0: np.ndarray, size: int) -> np.ndarray:
    """(n, size, size) patches of ``ref`` at the corners (y0, x0)."""
    win = np.lib.stride_tricks.sliding_window_view(ref, (size, size))
    return win[y0, x0]


def chroma_vector(mv: np.ndarray) -> np.ndarray:
    """The chroma vector of a luma vector (half samples), one per
    macroblock: the quarter positions rounded to the half position."""
    return 2 * (mv >> 2) + ((mv & 3) != 0)


def motion_compensate(ref: Planes, mv: np.ndarray, mbh: int, mbw: int, width: int,
                      height: int, rounding: int) -> np.ndarray:
    """The prediction (mbh * mbw, 6, 8, 8) of each macroblock from ``ref``
    with its half-sample vector ``mv`` (n, 2) = (x, y)."""
    m = MV_MARGIN
    n = mbh * mbw
    by, bx = np.divmod(np.arange(n), mbw)
    out = np.empty((n, 6, 8, 8), np.int32)
    yref = _edge_ref(ref.y, *ref.y.shape, m)
    py = _hpel(_gather(yref, m + 16 * by + (mv[:, 1] >> 1), m + 16 * bx + (mv[:, 0] >> 1), 17),
               mv[:, 1] & 1, mv[:, 0] & 1, rounding)
    out[:, :4] = py.reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4).reshape(n, 4, 8, 8)
    cv = chroma_vector(mv)
    for k, plane in ((4, ref.cb), (5, ref.cr)):
        cref = _edge_ref(plane, *plane.shape, m)
        out[:, k] = _hpel(_gather(cref, m + 8 * by + (cv[:, 1] >> 1), m + 8 * bx + (cv[:, 0] >> 1),
                                  9), cv[:, 1] & 1, cv[:, 0] & 1, rounding)
    return out


# ------------------------------------------------------------------ coding

def _zigzag(levels: np.ndarray) -> np.ndarray:
    return levels[..., ZIGZAG]


def _events(zz: np.ndarray, start: int, table: _TCoef):
    """(block index, event index, code, length) of every (last, run, level)
    event of (n, 64) zigzag-ordered levels from position ``start``, each a
    VLC with its sign or one of the three escapes."""
    sub = zz[:, start:]
    blk, pos = np.nonzero(sub)
    level = sub[blk, pos].astype(np.int64)
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, -1, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    last = np.ones(len(blk), np.int64)
    last[:-1] = blk[1:] != blk[:-1]
    ordinal = np.arange(len(blk)) - np.maximum.accumulate(np.where(first, np.arange(len(blk)), 0))
    mag = np.abs(level)
    sign = (level < 0).astype(np.int64)
    capped = np.minimum(mag, MAX_LEVEL)
    # direct
    ln = np.where(mag <= MAX_LEVEL, table.length[last, run, capped], 0)
    code = (table.code[last, run, capped] << 1) | sign
    length = np.where(ln > 0, ln + 1, 0)
    esc_c, esc_n = ESCAPE
    # escape 1: level - LMAX
    l1 = mag - table.lmax[last, run]
    ok1 = (length == 0) & (l1 >= 1) & (l1 <= MAX_LEVEL)
    l1c = np.clip(l1, 0, MAX_LEVEL)
    n1 = np.where(ok1, table.length[last, run, l1c], 0)
    ok1 &= n1 > 0
    code = np.where(ok1, (((esc_c << 1) << n1) | table.code[last, run, l1c]) << 1 | sign, code)
    length = np.where(ok1, esc_n + 1 + n1 + 1, length)
    # escape 2: run - (RMAX + 1)
    rm = table.rmax[last, capped]
    r2 = run - rm - 1
    ok2 = (length == 0) & (mag <= MAX_LEVEL) & (rm >= 0) & (r2 >= 0)
    r2c = np.clip(r2, 0, 63)
    n2 = np.where(ok2, table.length[last, r2c, capped], 0)
    ok2 &= n2 > 0
    code = np.where(ok2, ((((esc_c << 2) | 2) << n2) | table.code[last, r2c, capped]) << 1 | sign,
                    code)
    length = np.where(ok2, esc_n + 2 + n2 + 1, length)
    # escape 3: last, run, level fixed-length
    ok3 = length == 0
    if np.any(ok3 & ((mag > 2047) | (level == 0))):
        raise ValueError("a level outside -2047..2047 cannot be coded")
    fixed = ((((((esc_c << 2) | 3) << 1 | last) << 6 | run) << 1 | 1) << 12
             | (level & 0xFFF)) << 1 | 1
    code = np.where(ok3, fixed, code)
    length = np.where(ok3, esc_n + 2 + 1 + 6 + 1 + 12 + 1, length)
    return blk, ordinal, code, length


def _dc_items(diff: np.ndarray, luma: np.ndarray):
    """dct_dc_size VLC, the differential and its marker, one item each."""
    mag = np.abs(diff)
    size = np.zeros_like(mag)
    nz = mag > 0
    size[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1      # exact for integers
    if np.any(size > 12):
        raise ValueError("a DC differential needs more than 12 bits")
    lum, chrom = np.array(DC_LUM), np.array(DC_CHROM)
    vc = np.where(luma, lum[size, 0], chrom[size, 0])
    vn = np.where(luma, lum[size, 1], chrom[size, 1])
    bits = np.where(diff > 0, diff, diff + (1 << size) - 1)
    code = (vc << size) | np.where(size > 0, bits, 0)
    length = vn + size
    marker = size > 8
    return (code << marker) | marker, length + marker


def dc_predict(dc: np.ndarray, mbh: int, mbw: int) -> np.ndarray:
    """The predicted quantised DC of each block (n, 6) from its left (A),
    above-left (B) and above (C) neighbours: from C when |A - B| < |B - C|,
    else from A; outside the VOP, 1024 / dc_scaler."""
    default = 1024 // DC_SCALER
    out = np.empty_like(dc)
    grid = dc[:, :4].reshape(mbh, mbw, 2, 2).transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
    planes = [(grid, None)] + [(dc[:, k].reshape(mbh, mbw), k) for k in (4, 5)]
    for g, k in planes:
        p = np.pad(g, ((1, 0), (1, 0)), constant_values=default)
        a, b, c = p[1:, :-1], p[:-1, :-1], p[:-1, 1:]
        pred = np.where(np.abs(a - b) < np.abs(b - c), c, a)
        if k is None:
            out[:, :4] = pred.reshape(mbh, 2, mbw, 2).transpose(0, 2, 1, 3).reshape(-1, 4)
        else:
            out[:, k] = pred.reshape(-1)
    return out


def mv_predict(mv: np.ndarray, mbh: int, mbw: int) -> np.ndarray:
    """The median predictor (n, 2) of each macroblock's vector (not-coded
    macroblocks hold 0): the left one in the first row, else the median of
    left, above and above-right, those outside the VOP 0."""
    g = mv.reshape(mbh, mbw, 2)
    p = np.pad(g, ((1, 0), (1, 1), (0, 0)))
    a, b, c = p[1:, :-2], p[:-1, 1:-1], p[:-1, 2:]
    med = np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))
    med[0] = a[0]
    return med.reshape(-1, 2)


def _mvd_items(d: np.ndarray):
    t = np.array(MVD)
    mag = np.abs(d)
    code = np.where(d != 0, (t[mag, 0] << 1) | (d < 0), t[mag, 0])
    return code, t[mag, 1] + (d != 0)


def wrap_mvd(d: np.ndarray) -> np.ndarray:
    return ((d + 32) & 63) - 32


def vop_header(coding: str, index: int, fps, quant: int, rounding: int = 0) -> _Writer:
    res, inc = frame_rate(fps)
    t = index * inc
    seconds = t // res
    prev = ((index - 1) * inc) // res if index > 0 else 0
    w = _Writer()
    w.put(0x1B6, 32)
    w.put(0 if coding == "I" else 1, 2)
    for _ in range(seconds - prev):
        w.put(1, 1)                     # modulo_time_base
    w.put(0, 1)
    w.put(1, 1)
    w.put(t % res, _time_bits(res))     # vop_time_increment
    w.put(1, 1)
    w.put(1, 1)                         # vop_coded
    if coding == "P":
        w.put(rounding, 1)
    w.put(0, 3)                         # intra_dc_vlc_thr
    w.put(quant, 5)
    if coding == "P":
        w.put(1, 3)                     # vop_fcode_forward
    return w


_KEY = 8192


def _assemble(header: _Writer, keys, codes, lengths) -> bytes:
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    codes = np.concatenate([np.asarray(header.codes, np.int64)] + [np.concatenate(codes)[order]])
    lengths = np.concatenate([np.asarray(header.lengths, np.int64)]
                             + [np.concatenate(lengths)[order]])
    stuff = _stuffing(int(lengths.sum()))
    return pack_bits(np.append(codes, stuff[0]), np.append(lengths, stuff[1]))


def code_intra_vop(levels: np.ndarray, index: int, fps, quant: int, mbh: int,
                   mbw: int) -> bytes:
    """An I-VOP of quantised levels (n, 6, 64) in natural order, the DC at
    index 0."""
    n = mbh * mbw
    mb = np.arange(n)
    dc = levels[..., 0].astype(np.int64)
    diff = (dc - dc_predict(dc, mbh, mbw)).reshape(-1)
    dcc, dcn = _dc_items(diff, np.tile(np.arange(6) < 4, n))
    zz = _zigzag(levels.reshape(n * 6, 64))
    coded = np.any(zz[:, 1:] != 0, axis=1).reshape(n, 6)
    cbpc = coded[:, 4] * 2 + coded[:, 5]
    cbpy = coded[:, 0] * 8 + coded[:, 1] * 4 + coded[:, 2] * 2 + coded[:, 3]
    mc, cb = np.array(MCBPC_INTRA), np.array(CBPY)
    blk, ordinal, ec, en = _events(zz, 1, INTRA)
    bmb, bb = np.divmod(np.arange(n * 6), 6)
    emb, eb = np.divmod(blk, 6)
    keys = [mb * _KEY + 1, mb * _KEY + 2, mb * _KEY + 3,
            bmb * _KEY + 16 + bb * 1024, emb * _KEY + 16 + eb * 1024 + 2 + ordinal]
    codes = [mc[cbpc, 0], np.zeros(n, np.int64), cb[cbpy, 0], dcc, ec]
    lengths = [mc[cbpc, 1], np.ones(n, np.int64), cb[cbpy, 1], dcn, en]
    return _assemble(vop_header("I", index, fps, quant), keys, codes, lengths)


def code_inter_vop(levels: np.ndarray, mv: np.ndarray, index: int, fps, quant: int,
                   rounding: int, mbh: int, mbw: int) -> bytes:
    """A P-VOP: levels (n, 6, 64) in natural order, half-sample vectors (n,
    2) = (x, y) in -32..31; a macroblock without levels or vector is
    not_coded."""
    n = mbh * mbw
    mb = np.arange(n)
    zz = _zigzag(levels.reshape(n * 6, 64))
    coded = np.any(zz != 0, axis=1).reshape(n, 6)
    skip = ~np.any(coded, axis=1) & ~np.any(mv != 0, axis=1)
    mv = np.where(skip[:, None], 0, mv)
    cbpc = coded[:, 4] * 2 + coded[:, 5]
    cbpy = 15 - (coded[:, 0] * 8 + coded[:, 1] * 4 + coded[:, 2] * 2 + coded[:, 3])
    mc, cb = np.array(MCBPC_INTER), np.array(CBPY)
    d = wrap_mvd(mv - mv_predict(mv, mbh, mbw))
    xc, xn = _mvd_items(d[:, 0])
    yc, yn = _mvd_items(d[:, 1])
    live = ~skip
    blk, ordinal, ec, en = _events(zz, 0, INTER)
    emb, eb = np.divmod(blk, 6)
    zero = np.zeros(n, np.int64)
    keys = [mb * _KEY, mb * _KEY + 1, mb * _KEY + 3, mb * _KEY + 4, mb * _KEY + 5,
            emb * _KEY + 16 + eb * 1024 + 2 + ordinal]
    codes = [skip.astype(np.int64), mc[cbpc, 0], cb[cbpy, 0], xc, yc, ec]
    lengths = [np.ones(n, np.int64), np.where(live, mc[cbpc, 1], 0),
               np.where(live, cb[cbpy, 1], 0), np.where(live, xn, zero),
               np.where(live, yn, zero), en]
    return _assemble(vop_header("P", index, fps, quant, rounding), keys, codes, lengths)


def reconstruct_intra(levels: np.ndarray, quant: int, mbh: int, mbw: int,
                      transform=idct) -> Planes:
    coef = dequantize(levels, quant, intra=True)
    coef[..., 0] = levels[..., 0].astype(np.int64) * DC_SCALER
    return from_blocks(np.clip(transform(coef.reshape(-1, 6, 8, 8)), 0, 255).astype(np.int32),
                       mbh, mbw)


def reconstruct_inter(levels: np.ndarray, pred: np.ndarray, quant: int, mbh: int,
                      mbw: int, transform=idct) -> Planes:
    """The prediction, plus the residual on the blocks with levels."""
    out = pred.reshape(-1, 8, 8).copy()
    coded = np.flatnonzero(np.any(levels.reshape(-1, 64) != 0, axis=-1))
    res = transform(dequantize(levels.reshape(-1, 64)[coded], quant, intra=False)
                    .reshape(-1, 8, 8))
    out[coded] = np.clip(out[coded] + res, 0, 255)
    return from_blocks(out.reshape(-1, 6, 8, 8), mbh, mbw)


# ------------------------------------------------------------------ search

def _down(p: np.ndarray, f: int) -> np.ndarray:
    """Sums over f x f blocks (f a power of 2)."""
    while f > 1:
        p = p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]
        f //= 2
    return p


def _reach(n_mb: int, size: int, mb: int):
    """Per macroblock along one axis, how far past its last displayed
    sample a prediction may read and stay inside the displayed ``size``
    (unbounded when ``size`` fills the macroblocks)."""
    if size == n_mb * mb:
        return np.full(n_mb, 1 << 20)
    last = np.minimum(mb * np.arange(n_mb) + mb - 1, size - 1)
    return size - 1 - last


def vector_allowed(mv: np.ndarray, mbh: int, mbw: int, width: int, height: int):
    """Whether each macroblock's vector (n, 2) keeps the prediction of its
    displayed samples inside the displayed area, luma and chroma.  Where
    the size is not a multiple of 16, FFmpeg extends an XVID stream's
    reference from the displayed edge (its ``FF_BUG_EDGE``) and an mp4v
    stream's from the macroblock edge; such vectors decode the same in
    both."""
    by, bx = np.divmod(np.arange(mbh * mbw), mbw)
    cv = chroma_vector(mv)
    ok = np.ones(len(mv), bool)
    for k, (n_mb, size, idx) in enumerate(((mbw, width, bx), (mbh, height, by))):
        ok &= (mv[:, k] >> 1) + (mv[:, k] & 1) <= _reach(n_mb, size, 16)[idx]
        ok &= (cv[:, k] >> 1) + (cv[:, k] & 1) <= _reach(n_mb, max(1, size >> 1), 8)[idx]
    return ok


def motion_search(cur: np.ndarray, ref_y: np.ndarray, mbh: int, mbw: int, width: int,
                  height: int, rounding: int) -> np.ndarray:
    """Half-sample vectors (n, 2) = (x, y) in -32..31 that ``vector_allowed``
    accepts: a full search of +-4 at a quarter of the resolution, +-1 at a
    half and at the full, then the eight half-sample neighbours; the zero
    vector is kept unless another saves more than a small bias."""
    m = MV_MARGIN
    n = mbh * mbw
    cur = cur.astype(np.int16)                # samples, and sums of up to 16 of them
    ref = _edge_ref(ref_y.astype(np.int16), *ref_y.shape, m)
    by, bx = np.divmod(np.arange(n), mbw)
    cur_mb = cur.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)

    def allowed(mv):
        return vector_allowed(mv, mbh, mbw, width, height)

    cur4, ref4 = _down(cur, 4), _down(ref, 4)
    m4 = m // 4
    best4 = np.full(n, np.iinfo(np.int64).max)
    vec = np.zeros((n, 2), np.int64)
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            r = ref4[m4 + dy:m4 + dy + 4 * mbh, m4 + dx:m4 + dx + 4 * mbw]
            sad = np.abs(cur4 - r).reshape(mbh, 4, mbw, 4).sum(axis=(1, 3)).reshape(-1)
            sad = sad * 16 + (abs(dx) + abs(dy))
            take = sad < best4
            best4 = np.where(take, sad, best4)
            vec[take] = (dx, dy)
    vec *= 2                                                  # in half-resolution samples
    cur2, ref2 = _down(cur, 2), _down(ref, 2)
    cur2_mb = cur2.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(n, 8, 8)
    vec = _refine(cur2_mb, ref2, m // 2 + 8 * by, m // 2 + 8 * bx, vec, 8, 8, None)
    vec *= 2                                                  # full samples
    vec = np.where(allowed(2 * vec)[:, None], vec, 0)
    vec = _refine(cur_mb, ref, m + 16 * by, m + 16 * bx, vec, 16, 16,
                  lambda c: allowed(2 * c))
    # half samples around the integer vector
    y0, x0 = m + 16 * by + vec[:, 1] - 1, m + 16 * bx + vec[:, 0] - 1
    patch = _gather(ref, y0, x0, 19)
    best = np.full(n, np.iinfo(np.int64).max)
    out = np.zeros((n, 2), np.int64)
    for hy in (-1, 0, 1):
        for hx in (-1, 0, 1):
            ry, rx = hy >> 1, hx >> 1
            p = patch[:, 1 + ry:1 + ry + 17, 1 + rx:1 + rx + 17]
            pred = _hpel_at(p, hy & 1, hx & 1, rounding)
            sad = np.abs(cur_mb - pred).sum(axis=(1, 2))
            mv = 2 * vec + (hx, hy)
            valid = np.all((mv >= -32) & (mv <= 31), axis=1) & allowed(mv)
            sad = np.where(valid, sad, np.iinfo(np.int64).max)
            take = sad < best
            best = np.where(take, sad, best)
            out[take] = mv[take]
    zero = np.abs(cur_mb - _gather(ref, m + 16 * by, m + 16 * bx, 16)).sum(axis=(1, 2))
    keep_zero = zero <= best + 4 * QUANT * 8
    out[keep_zero] = 0
    return out


def _refine(cur_mb, ref, y0, x0, vec, size, limit, allowed):
    """The best of the nine integer vectors around ``vec`` (within
    +-``limit`` and, if given, ``allowed``) by SAD; ``vec`` itself must be
    allowed."""
    n = len(vec)
    best = np.full(n, np.iinfo(np.int64).max)
    out = vec.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand = np.clip(vec + (dx, dy), -limit, limit - 1)
            p = _gather(ref, y0 + cand[:, 1], x0 + cand[:, 0], size)
            sad = np.abs(cur_mb - p).sum(axis=(1, 2)) * 4 + np.abs(cand).sum(axis=1)
            if allowed is not None:
                sad = np.where(allowed(cand), sad, np.iinfo(np.int64).max)
            take = sad < best
            best = np.where(take, sad, best)
            out[take] = cand[take]
    return out


# ------------------------------------------------------------------ encoder

class Encoder:
    """Encodes RGB frames of one size; ``headers`` is VOS + VO + VOL,
    ``encode`` returns (VOP bytes, is I-VOP) and keeps the reconstruction
    in ``reference`` (``reconstruction()`` crops it).  ``idct`` names the
    decoder's inverse transform the reconstruction follows: "simple" for an
    mp4v stream, "xvid" for one FFmpeg takes as XviD's (an XVID fourcc and
    no user data)."""

    def __init__(self, width: int, height: int, fps=30, idct: str = "simple"):
        if not (0 < width < 8192 and 0 < height < 8192):
            raise ValueError(f"{width}x{height}: MPEG-4 sizes are 1..8191")
        self.width, self.height, self.fps = width, height, fps
        self.quant = QUANT
        self.transform = IDCTS[idct]
        self.mbw, self.mbh = (width + 15) // 16, (height + 15) // 16
        self.headers = stream_headers(width, height, fps)
        self.index = 0
        self.reference = None
        self.rounding = 0

    def _planes(self, rgb: np.ndarray) -> Planes:
        if rgb.shape != (self.height, self.width, 3) or rgb.dtype != np.uint8:
            raise ValueError(f"frame {self.index} is {rgb.dtype} {rgb.shape}, expected uint8 "
                             f"{(self.height, self.width, 3)}")
        return Planes.from_frame(*rgb_to_yuv420(rgb), self.mbh, self.mbw)

    def encode(self, rgb: np.ndarray):
        cur = self._planes(rgb)
        key = self.index % GOP == 0
        if key:
            data = self._intra(cur)
        else:
            data = self._inter(cur)
        self.index += 1
        return data, key

    def _intra(self, cur: Planes) -> bytes:
        f = fdct(to_blocks(cur, self.mbh, self.mbw)).reshape(-1, 6, 64)
        levels = np.fix(f / (2 * self.quant)).astype(np.int64)
        levels[..., 0] = np.floor((f[..., 0] + DC_SCALER // 2) / DC_SCALER)
        self.rounding = 0
        return self.code_intra(levels)

    def _inter(self, cur: Planes) -> bytes:
        self.rounding ^= 1
        mv = motion_search(cur.y, self.reference.y, self.mbh, self.mbw, self.width,
                           self.height, self.rounding)
        pred = motion_compensate(self.reference, mv, self.mbh, self.mbw, self.width,
                                 self.height, self.rounding)
        f = fdct(to_blocks(cur, self.mbh, self.mbw) - pred).reshape(-1, 6, 64)
        mag = np.maximum(np.floor(np.abs(f) / (2 * self.quant) - 0.25), 0)
        levels = (np.sign(f) * mag).astype(np.int64)
        return self.code_inter(levels, mv, pred)

    def code_intra(self, levels: np.ndarray) -> bytes:
        """An I-VOP of given levels (n, 6, 64), natural order, quantised DC
        at 0; the reconstruction becomes the reference."""
        data = code_intra_vop(levels, self.index, self.fps, self.quant, self.mbh, self.mbw)
        self.reference = reconstruct_intra(levels, self.quant, self.mbh, self.mbw,
                                           self.transform)
        return data

    def code_inter(self, levels: np.ndarray, mv: np.ndarray, pred=None) -> bytes:
        """A P-VOP of given levels and vectors at ``self.rounding``."""
        if pred is None:
            pred = motion_compensate(self.reference, mv, self.mbh, self.mbw, self.width,
                                     self.height, self.rounding)
        data = code_inter_vop(levels, mv, self.index, self.fps, self.quant, self.rounding,
                              self.mbh, self.mbw)
        self.reference = reconstruct_inter(levels, pred, self.quant, self.mbh, self.mbw,
                                           self.transform)
        return data

    def reconstruction(self):
        """The last frame as the decoder shows it: uint8 Y (H, W), Cb and Cr
        (ceil(H/2), ceil(W/2))."""
        return self.reference.crop(self.width, self.height)


# ------------------------------------------------------------------ decoder

class _Reader:
    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(16)
        self.end = 8 * len(data)
        self.pos = 0

    def peek(self, n: int) -> int:
        byte = self.pos >> 3
        v = int.from_bytes(self.data[byte:byte + 8], "big")
        return (v >> (64 - (self.pos & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def marker(self, what: str):
        if not self.read(1):
            raise ValueError(f"MPEG-4: missing marker bit in {what}")


def _lut(table, bits: int):
    """A lookup of ``bits`` peeked bits: (entry, length), length 0 when no
    code matches."""
    lut = [(-1, 0)] * (1 << bits)
    for i, (code, n) in enumerate(table):
        lo = code << (bits - n)
        for v in range(lo, lo + (1 << (bits - n))):
            lut[v] = (i, n)
    return lut


# the decoder's lookups; MCBPC's with the entries past the four coded ones
_LUTS = dict(
    mcbpc_i=_lut(MCBPC_INTRA + ((1, 4), (1, 6), (2, 6), (3, 6), (1, 9)), 9),
    mcbpc_p=_lut(MCBPC_INTER + ((3, 5), (4, 8), (3, 8), (3, 7), (3, 3), (7, 7), (6, 7), (5, 9),
                                (4, 6), (4, 9), (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8),
                                (1, 9)), 9),
    cbpy=_lut(CBPY, 6), dc_lum=_lut(DC_LUM, 11), dc_chrom=_lut(DC_CHROM, 12), mvd=_lut(MVD, 12),
    intra=_lut(INTRA_VLC + (ESCAPE,), 12), inter=_lut(INTER_VLC + (ESCAPE,), 12))


# the names of those entries past the four coded ones
_MCBPC_I_NAMES = ("intra+q", "intra+q", "intra+q", "intra+q", "stuffing")
_MCBPC_P_NAMES = ("intra", "intra", "intra", "intra", "inter+q", "inter+q", "inter+q",
                  "inter+q", "intra+q", "intra+q", "intra+q", "intra+q", "inter4v", "inter4v",
                  "inter4v", "inter4v", "stuffing")


def _vlc(r: _Reader, lut, bits: int, what: str) -> int:
    i, n = lut[r.peek(bits)]
    if n == 0:
        raise ValueError(f"MPEG-4: no {what} code at bit {r.pos}")
    r.pos += n
    return i


def _tcoef(r: _Reader, table: _TCoef, lut):
    """(last, run, level) of one event."""
    i = _vlc(r, lut, 12, "TCOEF")
    if i < 102:
        last, run, level = table.entries[i]
        return last, run, -level if r.read(1) else level
    mode = r.peek(2)
    if mode < 2:                                   # escape 1: level + LMAX
        r.pos += 1
        last, run, level = table.entries[_vlc(r, lut, 12, "TCOEF")]
        level += int(table.lmax[last, run])
    elif mode == 2:                                # escape 2: run + RMAX + 1
        r.pos += 2
        last, run, level = table.entries[_vlc(r, lut, 12, "TCOEF")]
        run += int(table.rmax[last, level]) + 1
    else:                                          # escape 3
        r.pos += 2
        last, run = r.read(1), r.read(6)
        r.marker("escape 3")
        level = r.read(12)
        level -= (level & 0x800) << 1
        r.marker("escape 3")
        if level == 0:
            raise ValueError("MPEG-4: escape 3 with level 0")
        return last, run, level
    return last, run, -level if r.read(1) else level


def _block(r: _Reader, out: np.ndarray, start: int, table: _TCoef, lut):
    pos = start - 1
    while True:
        last, run, level = _tcoef(r, table, lut)
        pos += run + 1
        if pos > 63:
            raise ValueError("MPEG-4: more than 64 coefficients in a block")
        out[ZIGZAG[pos]] = level
        if last:
            return


class VOL:
    """The fields of a video object layer that decoding needs."""

    def __init__(self, width, height, resolution, increment):
        self.width, self.height = width, height
        self.resolution, self.increment = resolution, increment
        self.mbw, self.mbh = (width + 15) // 16, (height + 15) // 16


def parse_vol(data: bytes) -> VOL:
    """The VOL of a VOS/VO/VOL header (start code 0x12x); any tool outside
    the Simple Profile subset ``Encoder`` writes is refused by name."""
    at = -1
    for code in range(0x20, 0x30):
        at = data.find(bytes((0, 0, 1, code)))
        if at >= 0:
            break
    if at < 0:
        raise ValueError("MPEG-4: no video object layer header")
    r = _Reader(data[at + 4:])
    r.read(1)
    vo_type = r.read(8)
    verid = 1
    if r.read(1):
        verid = r.read(4)
        r.read(3)
    if r.read(4) == 15:
        r.read(16)
    if r.read(1):
        r.read(2)
        r.read(1)
        if r.read(1):
            raise ValueError("MPEG-4: VBV parameters are not read")
    if r.read(2) != 0:
        raise ValueError("MPEG-4: a non-rectangular video object layer is not read")
    r.marker("VOL")
    res = r.read(16)
    r.marker("VOL")
    inc = r.read(_time_bits(res)) if r.read(1) else 1
    r.marker("VOL")
    width = r.read(13)
    r.marker("VOL")
    height = r.read(13)
    r.marker("VOL")
    refused = []
    if r.read(1):
        refused.append("interlace")
    if not r.read(1):
        refused.append("OBMC")
    if r.read(1 if verid == 1 else 2):
        refused.append("sprites")
    if r.read(1):
        refused.append("not_8_bit")
    if r.read(1):
        refused.append("MPEG quantisation (quant_type 1)")
    if verid != 1 and r.read(1):
        refused.append("quarter-sample motion")
    if not r.read(1):
        refused.append("complexity estimation")
    if not r.read(1):
        refused.append("resync markers")
    if r.read(1):
        refused.append("data partitioning")
    if verid != 1 and (r.read(1) | r.read(1)):
        refused.append("newpred or reduced resolution")
    if r.read(1):
        refused.append("scalability")
    if refused:
        raise ValueError(f"MPEG-4: {', '.join(refused)} (object type {vo_type}) is not read")
    return VOL(width, height, res, inc)


class Decoder:
    """Decodes the VOPs ``Encoder`` writes, one packet at a time; each
    ``decode`` returns the frame's Planes (``crop`` for the displayed
    size) and whether it was an I-VOP."""

    def __init__(self, vol: VOL, idct: str = "simple"):
        self.vol = vol
        self.transform = IDCTS[idct]
        self.reference = None

    def decode(self, vop: bytes):
        at = vop.find(b"\x00\x00\x01\xb6")
        if at < 0:
            raise ValueError("MPEG-4: a packet without a VOP")
        v = self.vol
        r = _Reader(vop[at + 4:])
        kind = r.read(2)
        if kind not in (0, 1):
            raise ValueError(f"MPEG-4: {('B', 'S')[kind - 2]}-VOPs are not read")
        while r.read(1):
            pass
        r.marker("VOP")
        r.read(_time_bits(v.resolution))
        r.marker("VOP")
        if not r.read(1):
            raise ValueError("MPEG-4: a not-coded VOP is not read")
        rounding = r.read(1) if kind == 1 else 0
        if r.read(3) != 0:
            raise ValueError("MPEG-4: intra_dc_vlc_thr other than 0 is not read")
        quant = r.read(5)
        if kind == 1 and r.read(3) != 1:
            raise ValueError("MPEG-4: an f_code other than 1 is not read")
        if quant > 4:
            raise ValueError(f"MPEG-4: vop_quant {quant} (dc_scaler other than 8) is not read")
        if kind == 0:
            self.reference = self._intra(r, quant)
            return self.reference, True
        if self.reference is None:
            raise ValueError("MPEG-4: a P-VOP before any I-VOP")
        self.reference = self._inter(r, quant, rounding)
        return self.reference, False

    def _intra(self, r: _Reader, quant: int) -> Planes:
        t = _LUTS
        v = self.vol
        n = v.mbh * v.mbw
        levels = np.zeros((n, 6, 64), np.int64)
        default = 1024 // DC_SCALER
        gy = np.full((2 * v.mbh + 1, 2 * v.mbw + 1), default, np.int64)
        gc = [np.full((v.mbh + 1, v.mbw + 1), default, np.int64) for _ in range(2)]
        for mb in range(n):
            my, mx = divmod(mb, v.mbw)
            i = _vlc(r, t["mcbpc_i"], 9, "MCBPC")
            if i >= 4:
                raise ValueError(f"MPEG-4: {_MCBPC_I_NAMES[i - 4]} macroblocks are not read")
            if r.read(1):
                raise ValueError("MPEG-4: AC prediction is not read")
            cbpy = _vlc(r, t["cbpy"], 6, "CBPY")
            cbp = (cbpy << 2) | i
            for b in range(6):
                if b < 4:
                    g, y, x = gy, 2 * my + (b >> 1) + 1, 2 * mx + (b & 1) + 1
                    size = _vlc(r, t["dc_lum"], 11, "dct_dc_size")
                else:
                    g, y, x = gc[b - 4], my + 1, mx + 1
                    size = _vlc(r, t["dc_chrom"], 12, "dct_dc_size")
                diff = 0
                if size:
                    diff = r.read(size)
                    if not diff >> (size - 1):
                        diff -= (1 << size) - 1
                    if size > 8:
                        r.marker("DC")
                a, bb, c = g[y, x - 1], g[y - 1, x - 1], g[y - 1, x]
                pred = c if abs(a - bb) < abs(bb - c) else a
                g[y, x] = levels[mb, b, 0] = pred + diff
                if cbp >> (5 - b) & 1:
                    _block(r, levels[mb, b], 1, INTRA, t["intra"])
        return reconstruct_intra(levels, quant, v.mbh, v.mbw, self.transform)

    def _inter(self, r: _Reader, quant: int, rounding: int) -> Planes:
        t = _LUTS
        v = self.vol
        n = v.mbh * v.mbw
        levels = np.zeros((n, 6, 64), np.int64)
        mv = np.zeros((v.mbh + 1, v.mbw + 2, 2), np.int64)     # a border of zeros
        for mb in range(n):
            my, mx = divmod(mb, v.mbw)
            if r.read(1):
                continue
            i = _vlc(r, t["mcbpc_p"], 9, "MCBPC")
            if i >= 4:
                raise ValueError(f"MPEG-4: {_MCBPC_P_NAMES[i - 4]} macroblocks in a P-VOP are "
                                 "not read")
            cbpy = 15 - _vlc(r, t["cbpy"], 6, "CBPY")
            cbp = (cbpy << 2) | i
            a = mv[my + 1, mx]
            if my == 0:
                pred = a
            else:
                b, c = mv[my, mx + 1], mv[my, mx + 2]
                pred = np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))
            for k in range(2):
                j = _vlc(r, t["mvd"], 12, "motion vector")
                d = -j if j and r.read(1) else j
                mv[my + 1, mx + 1, k] = wrap_mvd(pred[k] + d)
            for b in range(6):
                if cbp >> (5 - b) & 1:
                    _block(r, levels[mb, b], 0, INTER, t["inter"])
        vec = mv[1:, 1:-1].reshape(-1, 2)
        pred = motion_compensate(self.reference, vec, v.mbh, v.mbw, v.width, v.height, rounding)
        return reconstruct_inter(levels, pred, quant, v.mbh, v.mbw, self.transform)


def decode_stream(headers: bytes, packets, idct: str = "simple"):
    """Decode an elementary stream: ``headers`` (VOS/VO/VOL; empty when
    they lead the first packet) and the VOP packets, with the inverse
    transform ``idct``.  Returns (VOL, list of (Y, Cb, Cr) uint8 planes of
    the displayed size, list of I-VOP flags)."""
    packets = list(packets)
    if not packets:
        raise ValueError("MPEG-4: no frames")
    head = headers if headers else packets[0]
    vol = parse_vol(head)
    dec = Decoder(vol, idct)
    planes, keys = [], []
    for p in packets:
        frame, key = dec.decode(p)
        planes.append(frame.crop(vol.width, vol.height))
        keys.append(key)
    return vol, planes, keys
