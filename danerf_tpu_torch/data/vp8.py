"""Lossy WebP in Python and numpy: the VP8 key frame of a ``VP8 `` chunk
(RFC 6386), decoded to the RGB that PIL 12.1 opens through libwebp 1.6
(``WebPAnimDecoder``: fancy upsampling on, no dithering).  Where RFC 6386
could be read two ways, libwebp's decoder decides; every output equals
PIL's bit for bit.  ``data/webp.py`` reads the container and the ALPH
alpha plane around it.

The parts, in decoding order:

- the frame tag (key frames only; the 14-bit sizes, the scale bits
  ignored) and the first partition's frame header: segmentation, the loop
  filter's type, level, sharpness and deltas, the token partitions, the
  quantiser indices (section 14.1: Y2 DC x2, Y2 AC x155/100 floored at 8,
  UV DC capped at 132), the coefficient-probability updates over the
  defaults of section 13.5, and the skip probability;
- each macroblock's segment, skip flag, luma mode (16x16, or B_PRED's 16
  sub-block modes with their contextual key-frame probabilities) and
  chroma mode;
- the residual tokens (section 13) of every block with their contexts,
  the zigzag and the DCT_CAT extra bits, the Y2 block through the inverse
  WHT;
- reconstruction: the inverse DCT of every block at once (a residual does
  not depend on the prediction), then the intra prediction (section 12)
  along the macroblock wavefronts x + 2y (a macroblock's top-right
  neighbour lies on the wavefront before it) and, inside each B_PRED
  macroblock, along its sub-block wavefronts i + 2j.  Prediction reads
  unfiltered pixels, as libwebp does (it keeps the top rows aside before
  it filters), so the whole frame is reconstructed before the filter;
- the loop filter (section 15, simple or normal) in libwebp's order: per
  macroblock the left edge, the inner vertical edges, the top edge, the
  inner horizontal edges; along the same wavefronts (a macroblock's top
  edge reads pixels that the left edge of the one above and to the right
  has filtered);
- libwebp's fancy 4:2:0 upsampling (``UpsampleRgbaLinePair``) and its
  fixed-point YUV to RGB (``VP8YUVToR/G/B``) over the whole frame, cropped
  to the frame's size.

The boolean decoder is serial by nature: one Python step a decision, the
token loop's frequent decisions inlined.  What libwebp refuses (not a key
frame, a bad frame tag, a truncated partition) raises ValueError naming
it.
"""

from __future__ import annotations

import numpy as np

# RFC 6386 section 13.4 (coeff_update_probs), section 11.5 (kf_bmode_probs,
# in libwebp's order of the ten sub-block modes) and section 13.5
# (default_coeff_probs), as bytes [type][band][context][node] and
# [above mode][left mode][node].
_COEF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
)
_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418"
)
_COEF_DEFAULT = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
)
_COEF_UPDATE = np.frombuffer(_COEF_UPDATE, np.uint8).reshape(4, 8, 3, 11)
_BMODE_PROBS = np.frombuffer(_BMODE_PROBS, np.uint8).reshape(10, 10, 9).tolist()
_COEF_DEFAULT = np.frombuffer(_COEF_DEFAULT, np.uint8).reshape(4, 8, 3, 11)

_DC_TABLE = (                       # section 14.1 dc_qlookup
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (                       # section 14.1 ac_qlookup
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)   # the 17th: past the last
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_NORM = [8 - r.bit_length() for r in range(256)]   # shift that brings a range to 128..255

# Sub-block modes in libwebp's order; 16x16 and chroma modes use the first four.
DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)

# The blocks of a macroblock in token order: (block, coefficient type, first
# coefficient, top context slot, left context slot, dequantiser pair).  Blocks
# 0-15 are Y in raster order, 16-19 U, 20-23 V, 24 Y2; context slots 0-3 are
# Y columns or rows, 4-5 U, 6-7 V, 8 Y2.
_UV_BLOCKS = tuple((16 + k, 2, 0, 4 + (k & 1), 4 + (k >> 1), 4) for k in range(4)) + \
    tuple((20 + k, 2, 0, 6 + (k & 1), 6 + (k >> 1), 4) for k in range(4))
_I16_BLOCKS = ((24, 1, 0, 8, 8, 2),) + \
    tuple((k, 0, 1, k & 3, k >> 2, 0) for k in range(16)) + _UV_BLOCKS
_I4_BLOCKS = tuple((k, 3, 0, k & 3, k >> 2, 0) for k in range(16)) + _UV_BLOCKS


def _load(data: bytes, pos: int, value: int, bits: int, eof: bool):
    """The boolean decoder's next bytes, as libwebp's ``VP8LoadNewBytes``:
    up to 7 at once; past the end one zero byte and ``eof`` (then no
    more).  Returns (pos, value, bits, eof)."""
    k = min(7, len(data) - pos)
    if k > 0:
        return pos + k, (value << (8 * k)) | int.from_bytes(data[pos:pos + k], "big"), \
            bits + 8 * k, eof
    if not eof:
        return pos, value << 8, bits + 8, True
    return pos, value, 0, eof


class _BoolDecoder:
    """Section 7's boolean decoder as libwebp's ``VP8GetBit``: ``eof`` is
    set when a decision needs a byte past the end (libwebp's ``eof_``; the
    bytes read then are zeros)."""

    __slots__ = ("data", "pos", "value", "bits", "range", "eof")

    def __init__(self, data: bytes):
        self.data, self.pos, self.value = data, 0, 0
        self.bits, self.range, self.eof = -8, 255, False

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.pos, self.value, self.bits, self.eof = _load(self.data, self.pos, self.value,
                                                              self.bits, self.eof)
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.bits
        if self.value >= big:
            r = self.range - split
            self.value -= big
            b = 1
        else:
            r = split
            b = 0
        s = _NORM[r]
        self.range = r << s
        self.bits -= s
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def _index(q: int, top: int = 127) -> int:
    return min(max(q, 0), top)


class FrameHeader:
    """The fields of section 9's frame header, as read (section 19.2)."""

    def __init__(self, bd: _BoolDecoder):
        self.colour_space = bd.bit(128)
        self.clamping = bd.bit(128)
        self.use_segment = bd.bit(128)
        self.update_map = self.update_data = 0
        self.absolute_delta = 1
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_probs = [255] * 3
        if self.use_segment:
            self.update_map = bd.bit(128)
            self.update_data = bd.bit(128)
            if self.update_data:
                self.absolute_delta = bd.bit(128)
                self.seg_quant = [bd.signed(7) if bd.bit(128) else 0 for _ in range(4)]
                self.seg_filter = [bd.signed(6) if bd.bit(128) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [bd.literal(8) if bd.bit(128) else 255 for _ in range(3)]
        if bd.eof:
            raise ValueError("corrupt lossy WebP: cannot parse the segment header")
        self.simple = bd.bit(128)
        self.level = bd.literal(6)
        self.sharpness = bd.literal(3)
        self.use_lf_delta = bd.bit(128)
        self.update_lf_delta = 0
        self.ref_lf_delta = [0] * 4
        self.mode_lf_delta = [0] * 4
        if self.use_lf_delta:
            self.update_lf_delta = bd.bit(128)
            if self.update_lf_delta:
                for deltas in (self.ref_lf_delta, self.mode_lf_delta):
                    for i in range(4):
                        if bd.bit(128):
                            deltas[i] = bd.signed(6)
        if bd.eof:
            raise ValueError("corrupt lossy WebP: cannot parse the filter header")
        self.log2_parts = bd.literal(2)
        self.base_q = bd.literal(7)
        self.q_deltas = [bd.signed(4) if bd.bit(128) else 0 for _ in range(5)]
        self.refresh_probs = bd.bit(128)              # read and ignored, as libwebp does
        probs = _COEF_DEFAULT.copy()
        for t, b, c, p in np.ndindex(probs.shape):
            if bd.bit(int(_COEF_UPDATE[t, b, c, p])):
                probs[t, b, c, p] = bd.literal(8)
        self.coef_probs = probs
        self.use_skip = bd.bit(128)
        self.skip_prob = bd.literal(8) if self.use_skip else 0

    def dequant(self):
        """Per segment (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac), as
        libwebp's ``VP8ParseQuant``."""
        d1, d2dc, d2ac, duvdc, duvac = self.q_deltas
        out = []
        for s in range(4):
            q = self.base_q
            if self.use_segment:
                q = self.seg_quant[s] + (0 if self.absolute_delta else self.base_q)
            out.append((_DC_TABLE[_index(q + d1)], _AC_TABLE[_index(q)],
                        _DC_TABLE[_index(q + d2dc)] * 2,
                        max((_AC_TABLE[_index(q + d2ac)] * 101581) >> 16, 8),  # x 155 / 100
                        _DC_TABLE[_index(q + duvdc, 117)], _AC_TABLE[_index(q + duvac)]))
        return out

    def filter_strengths(self):
        """Per segment and per B_PRED or not: (limit, interior limit, hev
        threshold), limit 0 for no filtering (libwebp's
        ``PrecomputeFilterStrengths``; no filtering at all at level 0)."""
        out = np.zeros((4, 2, 3), np.int32)
        if self.level == 0:
            return out
        for s in range(4):
            base = self.level
            if self.use_segment:
                base = self.seg_filter[s] + (0 if self.absolute_delta else self.level)
            for i4 in (0, 1):
                level = base
                if self.use_lf_delta:
                    level += self.ref_lf_delta[0] + (self.mode_lf_delta[0] if i4 else 0)
                level = min(max(level, 0), 63)
                if level == 0:
                    continue
                ilevel = level
                if self.sharpness:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                out[s, i4] = (2 * level + ilevel, ilevel, hev)
        return out


def vp8_frame_size(chunk: bytes):
    """(width, height) of a VP8 key frame's tag, checked as libwebp's
    ``VP8GetInfo``."""
    if len(chunk) < 10:
        raise ValueError("truncated lossy WebP: no frame header")
    bits = chunk[0] | (chunk[1] << 8) | (chunk[2] << 16)
    if bits & 1:
        raise ValueError("corrupt lossy WebP: not a key frame")
    if chunk[3:6] != b"\x9d\x01\x2a":
        raise ValueError("corrupt lossy WebP: bad start code")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"corrupt lossy WebP: profile {(bits >> 1) & 7}")
    if not (bits >> 4) & 1:
        raise ValueError("unsupported lossy WebP: a frame not for display")
    if (bits >> 5) >= len(chunk):
        raise ValueError("truncated lossy WebP: bad partition length")
    w = (chunk[6] | (chunk[7] << 8)) & 0x3FFF
    h = (chunk[8] | (chunk[9] << 8)) & 0x3FFF
    if not w or not h:
        raise ValueError("corrupt lossy WebP: zero size")
    return w, h


def _partitions(chunk: bytes, log2_parts: int, start: int):
    """The token partitions' bytes (libwebp's ``ParsePartitions``: a size
    past the end is cut to what is left, the last takes the rest)."""
    last = (1 << log2_parts) - 1
    size = len(chunk) - start
    if size < 3 * last:
        raise ValueError("truncated lossy WebP: cannot read the partition sizes")
    sizes, pos, left = chunk[start:start + 3 * last], start + 3 * last, size - 3 * last
    parts = []
    for p in range(last):
        n = min(int.from_bytes(sizes[3 * p:3 * p + 3], "little"), left)
        parts.append(chunk[pos:pos + n])
        pos += n
        left -= n
    if pos >= len(chunk):
        raise ValueError("truncated lossy WebP: an empty token partition")
    parts.append(chunk[pos:])
    return parts


def _modes(bd: _BoolDecoder, hdr: FrameHeader, mbw: int, mbh: int):
    """Per macroblock (section 19.3): segment, skip flag, B_PRED or not,
    the 16x16 luma mode, the 16 sub-block modes (the 16x16 mode's
    counterpart repeated, for the contexts), the chroma mode."""
    n = mbw * mbh
    seg, skip, is4, ymode, uvmode = [0] * n, [0] * n, [0] * n, [0] * n, [0] * n
    bmodes = [None] * n
    bit = bd.bit
    sp0, sp1, sp2 = hdr.seg_probs
    top = [DC] * (4 * mbw)
    for y in range(mbh):
        left = [DC] * 4
        for x in range(mbw):
            mb = y * mbw + x
            if hdr.update_map:
                seg[mb] = bit(sp1) if not bit(sp0) else 2 + bit(sp2)
            if hdr.use_skip:
                skip[mb] = bit(hdr.skip_prob)
            if bit(145):
                m = (TM if bit(128) else HE) if bit(156) else (VE if bit(163) else DC)
                ymode[mb] = m
                top[4 * x:4 * x + 4] = left = [m] * 4
                bmodes[mb] = (m,) * 16
            else:
                is4[mb] = 1
                modes = []
                for j in range(4):
                    m = left[j]
                    for i in range(4):
                        p = _BMODE_PROBS[top[4 * x + i]][m]
                        if not bit(p[0]):
                            m = DC
                        elif not bit(p[1]):
                            m = TM
                        elif not bit(p[2]):
                            m = VE
                        elif not bit(p[3]):
                            m = HE if not bit(p[4]) else (RD if not bit(p[5]) else VR)
                        elif not bit(p[6]):
                            m = LD
                        elif not bit(p[7]):
                            m = VL
                        else:
                            m = HD if not bit(p[8]) else HU
                        top[4 * x + i] = m
                        modes.append(m)
                    left[j] = m
                bmodes[mb] = tuple(modes)
            uvmode[mb] = DC if not bit(142) else VE if not bit(114) else TM if bit(183) else HE
    if bd.eof:
        raise ValueError("truncated lossy WebP: premature end of the first partition")
    return (np.array(seg), np.array(skip, bool), np.array(is4, bool), np.array(ymode),
            np.array(bmodes, np.int64), np.array(uvmode))


def _residuals(parts, mbw, mbh, skip, is4, seg, hdr: FrameHeader):
    """Every macroblock's dequantized coefficients (section 13), as int16
    (n_mb, 25, 16), each block in raster order (blocks as ``_I16_BLOCKS``),
    and libwebp's per-block count ``nz`` (the position after the last token,
    n_mb x 25): ``VP8DecodeMB`` and ``GetCoeffs``, the row's partition the
    row's index modulo their number."""
    n_mb = mbw * mbh
    probs = [[hdr.coef_probs[t, _BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    dq = hdr.dequant()
    at, vals, nzs = [], [], [0] * (25 * n_mb)
    top = [0] * (9 * mbw)
    state = [[0, -8, 255, 0, False] for _ in parts]   # value, bits, range, pos, eof
    norm, zigzag = _NORM, _ZIGZAG
    v = nb = r = pos = 0
    eof = False
    data = b""

    def bit(prob):                                   # the decisions not inlined below
        nonlocal v, nb, r, pos, eof
        if nb < 0:
            pos, v, nb, eof = _load(data, pos, v, nb, eof)
        s = 1 + (((r - 1) * prob) >> 8)
        bs = s << nb
        if v >= bs:
            r -= s
            v -= bs
            b = 1
        else:
            r = s
            b = 0
        sh = norm[r]
        r <<= sh
        nb -= sh
        return b

    def large(p):                                    # a token past DCT_1
        if not bit(p[3]):
            return 2 if not bit(p[4]) else 3 + bit(p[5])
        if not bit(p[6]):
            if not bit(p[7]):
                return 5 + bit(159)
            return 7 + 2 * bit(165) + bit(145)
        cat = 2 * bit(p[8])
        cat += bit(p[9 + cat // 2])
        e = 0
        for prob in _CAT_PROBS[cat]:
            e = 2 * e + bit(prob)
        return e + 3 + (8 << cat)

    for y in range(mbh):
        part = y % len(parts)
        data = parts[part]
        v, nb, r, pos, eof = state[part]
        left = [0] * 9
        for x in range(mbw):
            mb = y * mbw + x
            tb = 9 * x
            if skip[mb]:
                top[tb:tb + 8] = left[:8] = [0] * 8
                if not is4[mb]:
                    top[tb + 8] = left[8] = 0
                continue
            q = dq[seg[mb]]
            for blk, t, first, ti, li, qi in (_I4_BLOCKS if is4[mb] else _I16_BLOCKS):
                bands = probs[t]
                qdc, qac = q[qi], q[qi + 1]
                base = 16 * (25 * mb + blk)
                n = first
                p = bands[n][top[tb + ti] + left[li]]
                while n < 16:
                    if nb < 0:
                        pos, v, nb, eof = _load(data, pos, v, nb, eof)
                    s = 1 + (((r - 1) * p[0]) >> 8)
                    bs = s << nb
                    if v < bs:                       # end of block
                        r = s
                        sh = norm[r]
                        r <<= sh
                        nb -= sh
                        break
                    r -= s
                    v -= bs
                    sh = norm[r]
                    r <<= sh
                    nb -= sh
                    while True:                      # zeros
                        if nb < 0:
                            pos, v, nb, eof = _load(data, pos, v, nb, eof)
                        s = 1 + (((r - 1) * p[1]) >> 8)
                        bs = s << nb
                        if v >= bs:
                            r -= s
                            v -= bs
                            sh = norm[r]
                            r <<= sh
                            nb -= sh
                            break
                        r = s
                        sh = norm[r]
                        r <<= sh
                        nb -= sh
                        n += 1
                        if n == 16:
                            break
                        p = bands[n][0]
                    if n == 16:
                        break
                    if nb < 0:
                        pos, v, nb, eof = _load(data, pos, v, nb, eof)
                    s = 1 + (((r - 1) * p[2]) >> 8)
                    bs = s << nb
                    if v < bs:
                        r = s
                        sh = norm[r]
                        r <<= sh
                        nb -= sh
                        val, ctx = 1, 1
                    else:
                        r -= s
                        v -= bs
                        sh = norm[r]
                        r <<= sh
                        nb -= sh
                        val, ctx = large(p), 2
                    if nb < 0:                       # the sign, at 1/2
                        pos, v, nb, eof = _load(data, pos, v, nb, eof)
                    s = 1 + ((r - 1) >> 1)
                    bs = s << nb
                    if v >= bs:
                        r -= s
                        v -= bs
                        val = -val
                    else:
                        r = s
                    sh = norm[r]
                    r <<= sh
                    nb -= sh
                    at.append(base + zigzag[n])
                    vals.append(val * (qac if n else qdc))
                    n += 1
                    p = bands[n][ctx]
                nzs[25 * mb + blk] = n
                top[tb + ti] = left[li] = int(n > first)
        state[part] = [v, nb, r, pos, eof]
        if eof:
            raise ValueError("truncated lossy WebP: premature end of a token partition")
    coef = np.zeros(n_mb * 400, np.int16)
    coef[np.array(at, np.int64)] = np.array(vals, np.int64).astype(np.int16)   # int16, as libwebp
    return coef.reshape(n_mb, 25, 16), np.array(nzs).reshape(n_mb, 25)


def _iwht(c):
    """Section 14.3's inverse WHT of Y2 blocks (m, 16) to the 16 DCs (m, 16),
    as libwebp's ``TransformWHT``."""
    x = c.astype(np.int32).reshape(-1, 4, 4)
    a0, a1 = x[:, 0] + x[:, 3], x[:, 1] + x[:, 2]
    a2, a3 = x[:, 1] - x[:, 2], x[:, 0] - x[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)     # [row][column]
    dc = t[..., 0] + 3
    a0, a1 = dc + t[..., 3], t[..., 1] + t[..., 2]
    a2, a3 = t[..., 1] - t[..., 2], dc - t[..., 3]
    return (np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=-1) >> 3).reshape(-1, 16)


def _idct(c):
    """Section 14.4's inverse DCT of blocks (..., 16) to the residuals
    (..., 16) libwebp adds to the prediction (``TransformOne``: 20091 and
    35468, the rounding in the second pass, ``>> 3``)."""
    shape = c.shape
    x = c.astype(np.int32).reshape(-1, 4, 4)
    mul1 = lambda a: ((a * 20091) >> 16) + a         # noqa: E731
    mul2 = lambda a: (a * 35468) >> 16               # noqa: E731
    r0, r1, r2, r3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    a, b = r0 + r2, r0 - r2
    c_, d = mul2(r1) - mul1(r3), mul1(r1) + mul2(r3)
    t = np.stack([a + d, b + c_, b - c_, a - d], axis=1)    # pass 1, [output k][column]
    dc = t[..., 0] + 4                               # pass 2, on each row k
    a, b = dc + t[..., 2], dc - t[..., 2]
    c_, d = mul2(t[..., 1]) - mul1(t[..., 3]), mul1(t[..., 1]) + mul2(t[..., 3])
    return (np.stack([a + d, b + c_, b - c_, a - d], axis=-1) >> 3).reshape(shape)


# ------------------------------------------------------------ reconstruction

_K4, _K8, _K16 = np.arange(4), np.arange(8), np.arange(16)
_SUBSTEPS = [np.array([k for k in range(16) if (k & 3) + 2 * (k >> 2) == s]) for s in range(10)]


def _bpred_weights() -> np.ndarray:
    """(10, 16, 13) weights: a sub-block mode predicts pixel (row, column)
    as ``(weights . edge + 4) >> 3``, clipped, over the edge I J K L (left,
    top to bottom), X (top-left), A B C D (top), E F G H (top-right):
    libwebp's AVG3 as 2 4 2, AVG2 as 4 4, DC as 1 a pixel, TrueMotion as
    8 8 -8 (``VE4``, ``HE4``, ``DC4``, ``TM4``, ``RD4``, ``VR4``, ``LD4``,
    ``VL4``, ``HD4``, ``HU4``)."""
    I, J, K, L, X, A, B, C, D, E, F, G, H = range(13)
    w = np.zeros((10, 4, 4, 13), np.int32)

    def put(mode, cells, *terms):                   # cells as libwebp's DST(column, row)
        for x, y in cells:
            for e, k in terms:
                w[mode, y, x, e] += k

    def avg3(a, b, c):
        return (a, 2), (b, 4), (c, 2)

    def avg2(a, b):
        return (a, 4), (b, 4)

    every = [(x, y) for y in range(4) for x in range(4)]
    top, left = (X, A, B, C, D, E), (X, I, J, K, L, L)
    for i in range(4):
        put(VE, [(i, y) for y in range(4)], *avg3(*top[i:i + 3]))
        put(HE, [(x, i) for x in range(4)], *avg3(*left[i:i + 3]))
    put(DC, every, *((e, 1) for e in (A, B, C, D, I, J, K, L)))
    for x, y in every:
        put(TM, [(x, y)], (A + x, 8), (I + y, 8), (X, -8))
        s = (L, K, J, I, X, A, B, C, D)[x - y + 3:x - y + 6]
        put(RD, [(x, y)], *avg3(*s))
        t = (A, B, C, D, E, F, G, H, H)[x + y:x + y + 3]
        put(LD, [(x, y)], *avg3(*t))
    for cells, terms in (
            (((0, 0), (1, 2)), avg2(X, A)), (((1, 0), (2, 2)), avg2(A, B)),
            (((2, 0), (3, 2)), avg2(B, C)), (((3, 0),), avg2(C, D)),
            (((0, 3),), avg3(K, J, I)), (((0, 2),), avg3(J, I, X)),
            (((0, 1), (1, 3)), avg3(I, X, A)), (((1, 1), (2, 3)), avg3(X, A, B)),
            (((2, 1), (3, 3)), avg3(A, B, C)), (((3, 1),), avg3(B, C, D))):
        put(VR, cells, *terms)
    for cells, terms in (
            (((0, 0),), avg2(A, B)), (((1, 0), (0, 2)), avg2(B, C)),
            (((2, 0), (1, 2)), avg2(C, D)), (((3, 0), (2, 2)), avg2(D, E)),
            (((0, 1),), avg3(A, B, C)), (((1, 1), (0, 3)), avg3(B, C, D)),
            (((2, 1), (1, 3)), avg3(C, D, E)), (((3, 1), (2, 3)), avg3(D, E, F)),
            (((3, 2),), avg3(E, F, G)), (((3, 3),), avg3(F, G, H))):
        put(VL, cells, *terms)
    for cells, terms in (
            (((0, 0), (2, 1)), avg2(I, X)), (((0, 1), (2, 2)), avg2(J, I)),
            (((0, 2), (2, 3)), avg2(K, J)), (((0, 3),), avg2(L, K)),
            (((3, 0),), avg3(A, B, C)), (((2, 0),), avg3(X, A, B)),
            (((1, 0), (3, 1)), avg3(I, X, A)), (((1, 1), (3, 2)), avg3(J, I, X)),
            (((1, 2), (3, 3)), avg3(K, J, I)), (((1, 3),), avg3(L, K, J))):
        put(HD, cells, *terms)
    for cells, terms in (
            (((0, 0),), avg2(I, J)), (((2, 0), (0, 1)), avg2(J, K)),
            (((2, 1), (0, 2)), avg2(K, L)), (((1, 0),), avg3(I, J, K)),
            (((3, 0), (1, 1)), avg3(J, K, L)), (((3, 1), (1, 2)), avg3(K, L, L)),
            (((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)), ((L, 8),))):
        put(HU, cells, *terms)
    return w.reshape(10, 16, 13)


_BPRED_W = _bpred_weights()


def _predict(mode, top, left, tl, has_left, has_top, s: int):
    """(..., s*s) predictions of 16x16 luma (s = 16) or 8x8 chroma (s = 8)
    blocks from their top row, left column and top-left pixel: libwebp's
    ``VP8PredLuma16``/``VP8PredChroma8``, DC by ``CheckMode`` (no top, no
    left, neither: 128)."""
    st, sl = top.sum(-1), left.sum(-1)
    k = s.bit_length()                              # log2(2 s)
    dc = np.where(has_top & has_left, (st + sl + s) >> k,
                  np.where(has_top, (st + s // 2) >> (k - 1),
                           np.where(has_left, (sl + s // 2) >> (k - 1), 128)))
    m = mode[:, None, None]
    t, lf = top[..., None, :], left[..., :, None]
    pred = np.where(m == VE, t, np.where(m == HE, lf, np.where(
        m == TM, np.clip(t + lf - tl[..., None, None], 0, 255), dc[..., None, None])))
    return pred.reshape(*pred.shape[:-2], s * s)


def _wavefronts(mbw: int, mbh: int):
    """The macroblocks (x, y) of each wavefront x + 2y, in order."""
    out = []
    for t in range(mbw + 2 * mbh - 2):
        ys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        if ys.size:
            out.append((t - 2 * ys, ys))
    return out


def _reconstruct(mbw, mbh, is4, ymode, bmodes, uvmode, res, fronts):
    """The unfiltered planes Y (16 mbh, 16 mbw) and U, V (8 mbh, 8 mbw),
    int32: prediction plus residual, clipped (libwebp's ``ReconstructRow``:
    left of the frame 129, above it 127, the top-left corner 127 on the
    first row and 129 below; a B_PRED macroblock's right column of
    sub-blocks takes its top-right pixels from the row above the
    macroblock, the last column's replicated from its last pixel)."""
    hm, wm = 16 * mbh, 16 * mbw
    wp, cw = wm + 5, wm // 2 + 1                    # a left border column, 4 past the right
    yp = np.empty((hm + 1, wp), np.int32)
    yp[0], yp[1:, 0] = 127, 129
    cp = np.empty((2, hm // 2 + 1, cw), np.int32)
    cp[:, 0], cp[:, 1:, 0] = 127, 129
    yf, cf = yp.reshape(-1), cp.reshape(2, -1)
    n = len(is4)
    res16 = res[:, :16].reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 256)
    res8 = res[:, 16:].reshape(n, 2, 2, 2, 4, 4).transpose(1, 0, 2, 4, 3, 5).reshape(2, n, 64)
    res4 = res[:, :16]
    top16, left16 = 1 + _K16, (1 + _K16) * wp
    pix16 = ((1 + _K16)[:, None] * wp + 1 + _K16).ravel()
    top8, left8 = 1 + _K8, (1 + _K8) * cw
    pix8 = ((1 + _K8)[:, None] * cw + 1 + _K8).ravel()
    pix4 = ((1 + _K4)[:, None] * wp + 1 + _K4).ravel()
    sub_base = 4 * (_K16 >> 2) * wp + 4 * (_K16 & 3)
    edge = np.empty((16, 13), np.int64)             # offsets of I..L, X, A..D, E..H
    edge[:, :4] = (1 + _K4) * wp
    edge[:, 4:9] = np.arange(5)
    edge[:, 9:] = 5 + _K4
    edge[3::4, 9:] -= (4 * _K4 * wp)[:, None]       # right column: the row above the macroblock
    for xs, ys in fronts:
        mbs = ys * mbw + xs
        b16 = 16 * ys * wp + 16 * xs                # the top-left neighbour of each macroblock
        big = ~is4[mbs]
        if big.any():
            m, b = mbs[big], b16[big]
            pred = _predict(ymode[m], yf[b[:, None] + top16], yf[b[:, None] + left16], yf[b],
                            xs[big] > 0, ys[big] > 0, 16)
            yf[b[:, None] + pix16] = np.clip(pred + res16[m], 0, 255)
        if not big.all():
            m, b = mbs[~big], b16[~big]
            for ks in _SUBSTEPS:
                mm, kk = np.repeat(m, len(ks)), np.tile(ks, len(m))
                bb = np.repeat(b, len(ks)) + sub_base[kk]
                e = yf[bb[:, None] + edge[kk]]
                pred = np.einsum("npe,ne->np", _BPRED_W[bmodes[mm, kk]], e)
                pred = np.clip((pred + 4) >> 3, 0, 255)
                yf[bb[:, None] + pix4] = np.clip(pred + res4[mm, kk], 0, 255)
        if xs[0] == mbw - 1 and ys[0] < mbh - 1:    # the top-right pixels past the frame
            r = 16 * ys[0] + 16
            yp[r, wm + 1:] = yp[r, wm]
        b8 = 8 * ys * cw + 8 * xs
        pred = _predict(uvmode[mbs], cf[:, b8[:, None] + top8], cf[:, b8[:, None] + left8],
                        cf[:, b8], xs > 0, ys > 0, 8)
        cf[:, b8[:, None] + pix8] = np.clip(pred + res8[:, mbs], 0, 255)
    return yp[1:, 1:wm + 1], cp[0, 1:, 1:], cp[1, 1:, 1:]


# ---------------------------------------------------------------- loop filter

_TAPS = np.arange(-4, 4)
_INTERIOR = [0, 1, 2, 4, 5, 6]          # |p3-p2| |p2-p1| |p1-p0| |q0-q1| |q1-q2| |q2-q3|


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def _filter_lines(buf, k, t2, it, hev, mb_edge: bool, simple: bool):
    """Filter lines across an edge in place: ``k`` (n, 8) the indices of
    each line's p3 p2 p1 p0 q0 q1 q2 q3, ``t2`` 2 * limit + 1, ``it`` the
    interior limit, ``hev`` the high-edge-variance threshold (libwebp's
    ``SimpleHFilter16``/``SimpleVFilter16`` with ``DoFilter2``, else
    ``FilterLoop26`` on macroblock edges, ``FilterLoop24`` inside)."""
    px = buf[k]
    d = np.abs(np.diff(px, axis=1))
    live = 4 * d[:, 3] + np.abs(px[:, 2] - px[:, 5]) <= t2
    if not simple:
        live &= d[:, _INTERIOR].max(1) <= it
    if not live.any():
        return
    k, px, d = k[live], px[live], d[live]
    p2, p1, p0, q0, q1, q2 = px[:, 1], px[:, 2], px[:, 3], px[:, 4], px[:, 5], px[:, 6]
    a = _clip(3 * (q0 - p0) + _clip(p1 - q1, -128, 127), -128, 127)
    f1, f2 = _clip((a + 4) >> 3, -16, 15), _clip((a + 3) >> 3, -16, 15)
    if simple:
        buf[k[:, 3]] = _clip(p0 + f2, 0, 255)
        buf[k[:, 4]] = _clip(q0 - f1, 0, 255)
        return
    hv = (np.maximum(d[:, 2], d[:, 4]) > hev[live])[:, None]
    outer = np.stack([p2, p1, p0 + f2, q0 - f1, q1, q2], axis=1)     # DoFilter2
    if mb_edge:                                                      # DoFilter6
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        wide = np.stack([p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3], axis=1)
    else:                                                            # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = _clip((a + 4) >> 3, -16, 15), _clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        wide = np.stack([p2, p1 + a3, p0 + a2, q0 - a1, q1 - a3, q2], axis=1)
    buf[k[:, 1:7]] = _clip(np.where(hv, outer, wide), 0, 255)


def _loop_filter(y, u, v, hdr: FrameHeader, seg, is4, inner, fronts):
    """Section 15's loop filter in place, as libwebp's ``DoFilter``: per
    macroblock the left edge (not in the first column), the inner vertical
    edges (B_PRED, or with coefficients), the top edge (not in the first
    row), the inner horizontal edges; chroma beside luma unless the filter
    is simple.  Wavefront by wavefront, each of the eight steps over all
    the wavefront's macroblocks at once."""
    strengths = hdr.filter_strengths()[seg, is4.astype(np.int64)]
    limit, ilevel, hev = strengths[:, 0], strengths[:, 1], strengths[:, 2]
    if not limit.any():
        return
    mbw = y.shape[1] // 16
    wm, wc = y.shape[1], u.shape[1]
    buf = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).astype(np.int16)
    mbx, mby = np.arange(len(seg)) % mbw, np.arange(len(seg)) // mbw
    bases = (16 * mby * wm + 16 * mbx, y.size + 8 * mby * wc + 8 * mbx,
             y.size + u.size + 8 * mby * wc + 8 * mbx)
    simple = bool(hdr.simple)

    def offsets(vertical, c):
        """Per plane (bases, (lines, 8) offsets across the edge at offset c
        of a macroblock): 16 luma lines, and 8 + 8 chroma ones at c = 0 and
        4 unless the filter is simple."""
        def across(width, n):
            if vertical:
                return (np.arange(n) * width)[:, None] + c + _TAPS
            return (c + _TAPS) * width + np.arange(n)[:, None]
        planes = [(bases[0], across(wm, 16))]
        if not simple and c in (0, 4):
            planes += [(bases[p], across(wc, 8)) for p in (1, 2)]
        return planes

    plans = [[(c, offsets(vertical, c)) for c in (0, 4, 8, 12)] for vertical in (True, False)]
    for xs, ys in fronts:
        mbs = ys * mbw + xs
        mbs = mbs[limit[mbs] > 0]
        if not mbs.size:
            continue
        for vertical, plan in zip((True, False), plans):
            first = mbs[mbs % mbw > 0] if vertical else mbs[mbs >= mbw]
            inside = mbs[inner[mbs]]
            for c, planes in plan:
                m = first if c == 0 else inside
                if not m.size:
                    continue
                k = np.concatenate([(b[m][:, None, None] + o).reshape(-1, 8) for b, o in planes])
                t2, it, hv = (np.concatenate([np.repeat(x, len(o)) for _, o in planes])
                              for x in (2 * (limit[m] + (4 if c == 0 else 0)) + 1, ilevel[m],
                                        hev[m]))
                _filter_lines(buf, k, t2, it, hv, c == 0, simple)
    y[...] = buf[:y.size].reshape(y.shape)
    u[...] = buf[y.size:y.size + u.size].reshape(u.shape)
    v[...] = buf[y.size + u.size:].reshape(v.shape)


# --------------------------------------------------------------------- output

def _upsample(plane, near, far, w):
    """libwebp's fancy upsampling of one chroma plane to (len(near), w):
    each output row from its nearer and its farther chroma row (``near``,
    ``far``), as ``UpsampleRgbaLinePair`` computes a lane."""
    n, f = plane[near], plane[far]
    out = np.empty((len(near), w), np.int32)
    out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
    last = (w - 1) >> 1
    if last:
        tl, t, lf, c = n[:, :last], n[:, 1:last + 1], f[:, :last], f[:, 1:last + 1]
        d12 = (tl + 3 * t + 3 * lf + c + 8) >> 3
        d03 = (3 * tl + t + lf + 3 * c + 8) >> 3
        out[:, 1:2 * last:2] = (d12 + tl) >> 1
        out[:, 2:2 * last + 1:2] = (d03 + t) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * n[:, last] + f[:, last] + 2) >> 2
    return out


def _to_rgb(y, u, v, w, h):
    """(h, w, 3) uint8 RGB of the planes cropped to the frame: the fancy
    upsampler's rows (the first with its own chroma row twice, then pairs
    between two chroma rows, the last of an even height alone), then
    ``VP8YUVToR/G/B`` (14-bit fixed point, ``>> 6`` clipped)."""
    hc = (h + 1) // 2
    r = np.arange(h)
    upper = (r & 1) | (r == 0)                      # nearer to the chroma row above
    k = (r + 1) // 2
    near = np.where(upper, np.maximum(k - 1, 0), r // 2)
    far = np.where(upper, np.minimum(k, hc - 1), r // 2 - 1)
    uu = _upsample(u[:hc, :(w + 1) // 2], near, far, w)
    vv = _upsample(v[:hc, :(w + 1) // 2], near, far, w)
    yy = (y[:h, :w] * 19077) >> 8
    rgb = np.stack([yy + ((vv * 26149) >> 8) - 14234,
                    yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708,
                    yy + ((uu * 33050) >> 8) - 17685], axis=-1)
    return (np.clip(rgb, 0, 16383) >> 6).astype(np.uint8)


def decode_vp8(chunk: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a VP8 key frame: the ``VP8 `` chunk's payload
    (with the RIFF padding byte after it, which libwebp's last partition
    takes in)."""
    w, h = vp8_frame_size(chunk)
    size0 = (chunk[0] | (chunk[1] << 8) | (chunk[2] << 16)) >> 5
    if size0 > len(chunk) - 10:
        raise ValueError("truncated lossy WebP: bad partition length")
    bd = _BoolDecoder(chunk[10:10 + size0])
    hdr = FrameHeader(bd)
    parts = _partitions(chunk, hdr.log2_parts, 10 + size0)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    seg, skip, is4, ymode, bmodes, uvmode = _modes(bd, hdr, mbw, mbh)
    coef, nz = _residuals(parts, mbw, mbh, skip, is4, seg, hdr)
    i16 = np.flatnonzero(~is4)
    coef[i16, :16, 0] = _iwht(coef[i16, 24]).astype(np.int16)
    # libwebp's f_inner: B_PRED, or any block with a coefficient (a Y DC from the WHT too)
    inner = is4 | ((nz[:, :24] > 1) | (coef[:, :24, 0] != 0)).any(1)
    fronts = _wavefronts(mbw, mbh)
    y, u, v = _reconstruct(mbw, mbh, is4, ymode, bmodes, uvmode, _idct(coef[:, :24]), fronts)
    _loop_filter(y, u, v, hdr, seg, is4, inner, fronts)
    return _to_rgb(y, u, v, w, h)
