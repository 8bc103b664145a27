"""WebP decoder in Python and numpy, giving what PIL 12 opens:
``np.asarray(Image.open(path))``, mode "RGBA" where libwebp reports alpha,
else "RGB" (PIL asks libwebp for its features and drops the alpha channel
of an image without it).

The container is RIFF/WEBP with a bare ``VP8L`` or ``VP8 `` chunk, or a
``VP8X`` header before it (extended format: ICC, EXIF and XMP chunks are
skipped), read as libwebp's demuxer reads a still image: an ``ALPH`` chunk
only in a VP8X file and right before its ``VP8 `` chunk, its plane used
only where the VP8X alpha flag is set (the image is RGBA, alpha 255, where
either is there without the other), the frame's size equal to the canvas.

Lossless: the bitstream of RFC 9649: the four transforms (predictor with
its 14 modes, cross-colour, subtract-green, colour indexing with pixel
bundling), each a sub-image of its own; prefix codes, simple and normal,
with the code-length code; meta prefix codes (an entropy image choosing a
group of five codes per block); the colour cache; LZ77 backward
references with the 120-entry distance map.  Lossy: the VP8 key frame
(``data/vp8.py``) and the ALPH plane: its header byte (compression 0 raw
or 1, a VP8L image stream without its header whose green channel is the
alpha; the filter; the preprocessing bits, read and ignored), then
libwebp's unfilter (none, horizontal, vertical, gradient).  Animated WebP,
and what libwebp refuses (a bad ALPH header, a VP8 frame that is not a key
frame, a truncated partition), raise ValueError naming it.

Speed.  The entropy-coded pixels are sequential by nature (each code's
length, a backward reference's target and the colour cache depend on all
before them): one Python step per symbol, over a list of 64-bit windows
that gives the next bits at any bit position in one lookup, and two-level
code tables (8 bits at the root).  A backward reference copies its run as
one list slice; the colour cache takes the pixels since its last use only
when a cache code asks for one.  The transforms are numpy: the predictor
runs along anti-diagonals x + 2y (each pixel's left, top, top-left and
top-right neighbours lie on earlier ones), the others at once; so do the
alpha planes' gradient unfilter (along x + y) and the other unfilters
(running sums).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np

from danerf_tpu_torch.data.vp8 import decode_vp8, vp8_frame_size

_CODE_TO_PLANE = (                  # (dy << 4) | (8 - dx) of the 120 short distances
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ROOT = 8
_NUM_LENGTH_CODES = 24
_BLACK = np.array([[255, 0, 0, 0]], np.int32)   # (a, r, g, b) of predictor 0


class _Bits:
    """LSB-first bit reader: ``win[i]`` holds the 64 bits from byte i."""

    def __init__(self, data: bytes):
        buf = np.frombuffer(bytes(data) + bytes(8), np.uint8).astype(np.uint64)
        n = len(data)
        w = np.zeros(n + 1, np.uint64)
        for k in range(8):
            w |= buf[k:k + n + 1] << np.uint64(8 * k)
        self.win = w.tolist()
        self.pos = 0
        self.end = 8 * n

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError("truncated WebP lossless data")
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)


def _table(lengths) -> tuple:
    """A two-level decode table of a canonical prefix code given its code
    lengths: (root list of 2**8 entries, sub-tables).  An entry is
    ``symbol << 4 | length``; a root entry below 0 is ``~index`` of a
    sub-table (list, bits).  A code with one used symbol takes 0 bits."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if used.size == 0:
        raise ValueError("corrupt WebP lossless data: an empty prefix code")
    if used.size == 1:
        return [int(used[0]) << 4] * (1 << _ROOT), []
    ln = lengths[used]
    order = np.lexsort((used, ln))
    syms, ln = used[order], ln[order]
    # canonical codes, then bit-reversed (the first bit read is the top bit)
    codes = np.zeros(len(ln), np.int64)
    code, prev = 0, int(ln[0])
    for i, l in enumerate(ln.tolist()):
        code <<= l - prev
        prev = l
        codes[i] = code
        code += 1
    if code != 1 << prev:
        raise ValueError("corrupt WebP lossless data: an incomplete prefix code")
    rev = np.zeros_like(codes)
    for b in range(int(ln.max())):
        live = b < ln
        rev[live] |= ((codes[live] >> (ln[live] - 1 - b)) & 1) << b
    root = np.full(1 << _ROOT, -1, np.int64)
    short = ln <= _ROOT
    for s, r, l in zip(syms[short], rev[short], ln[short]):
        root[r::1 << int(l)] = (int(s) << 4) | int(l)
    subs = []
    if (~short).any():
        lsyms, lrev, lln = syms[~short], rev[~short], ln[~short]
        low = lrev & ((1 << _ROOT) - 1)
        for key in np.unique(low):
            pick = low == key
            bits = int(lln[pick].max()) - _ROOT
            sub = np.zeros(1 << bits, np.int64)
            for s, r, l in zip(lsyms[pick], lrev[pick] >> _ROOT, lln[pick]):
                sub[r::1 << (int(l) - _ROOT)] = (int(s) << 4) | int(l)
            root[key] = ~len(subs)
            subs.append((sub.tolist(), (1 << bits) - 1))
    return root.tolist(), subs


def _read_code(br: _Bits, alphabet: int):
    """One prefix code of the bitstream (simple or normal) as a table."""
    lengths = [0] * alphabet
    if br.read(1):                                   # simple code
        n = br.read(1) + 1
        s0 = br.read(1 + 7 * br.read(1))
        if s0 >= alphabet:
            raise ValueError("corrupt WebP lossless data: a symbol past the alphabet")
        lengths[s0] = 1
        if n == 2:
            s1 = br.read(8)
            if s1 >= alphabet:
                raise ValueError("corrupt WebP lossless data: a symbol past the alphabet")
            lengths[s1] = 1
        return _table(lengths)
    n_codes = br.read(4) + 4
    cl = [0] * 19
    for i in range(n_codes):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_table = _table(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("corrupt WebP lossless data: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = _symbol(br, cl_table)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, base = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + base
            if sym + rep > alphabet:
                raise ValueError("corrupt WebP lossless data: code lengths past the alphabet")
            v = prev if c == 16 else 0
            lengths[sym:sym + rep] = [v] * rep
            sym += rep
    return _table(lengths)


def _symbol(br: _Bits, table) -> int:
    root, subs = table
    p = br.pos
    w = br.win[p >> 3] >> (p & 7)
    e = root[w & 0xFF]
    if e < 0:
        sub, mask = subs[~e]
        e = sub[(w >> _ROOT) & mask]
    br.pos = p + (e & 15)
    return e >> 4


def _copy_length(br: _Bits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = _CODE_TO_PLANE[code - 1]
    return max(1, (d >> 4) * xsize + 8 - (d & 15))


def _decode_pixels(br: _Bits, xsize: int, ysize: int, level0: bool) -> np.ndarray:
    """An entropy-coded image (the ARGB image, or a transform's or the
    entropy image's sub-image) as uint32 (ysize * xsize,)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"corrupt WebP lossless data: colour cache of {cache_bits} bits")
    meta, meta_bits, meta_w = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = -(-xsize // (1 << meta_bits))
        img = _decode_pixels(br, meta_w, -(-ysize // (1 << meta_bits)), False)
        meta = ((img >> 8) & 0xFFFF).astype(np.int64).tolist()
    n_groups = max(meta) + 1 if meta else 1
    green_size = 256 + _NUM_LENGTH_CODES + ((1 << cache_bits) if cache_bits else 0)
    groups = []
    for _ in range(n_groups):
        groups.append(tuple(_read_code(br, a) for a in (green_size, 256, 256, 256, 40)))
    return _entropy_loop(br, xsize, ysize, groups, meta, meta_bits, meta_w, cache_bits)


def _entropy_loop(br, xsize, ysize, groups, meta, meta_bits, meta_w, cache_bits):
    """The symbol loop: a literal (green, then red, blue, alpha), a backward
    reference (length, distance) or a colour cache index a step.  Each
    lookup is ``root[low 8 bits]``, or a sub-table for longer codes; the
    window read at a literal's green code holds at least 57 bits, enough
    for the green, red and blue codes."""
    total = xsize * ysize
    out = []
    append = out.append
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0                                       # pixels already in the cache
    win = br.win
    p, end = br.pos, br.end
    x = y = src = 0
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    (gr, gs), (rr, rs), (br_, bs), (ar, as_), dist = groups[meta[0] if meta else 0]
    while src < total:
        if meta is not None and not (x & mask):
            (gr, gs), (rr, rs), (br_, bs), (ar, as_), dist = \
                groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        w = win[p >> 3] >> (p & 7)
        e = gr[w & 0xFF]
        if e < 0:
            sub, m = gs[~e]
            e = sub[(w >> _ROOT) & m]
        n = e & 15
        p += n
        code = e >> 4
        if code < 256:
            w >>= n
            e = rr[w & 0xFF]
            if e < 0:
                sub, m = rs[~e]
                e = sub[(w >> _ROOT) & m]
            n = e & 15
            p += n
            r = e >> 4
            w >>= n
            e = br_[w & 0xFF]
            if e < 0:
                sub, m = bs[~e]
                e = sub[(w >> _ROOT) & m]
            p += e & 15
            b = e >> 4
            w = win[p >> 3] >> (p & 7)
            e = ar[w & 0xFF]
            if e < 0:
                sub, m = as_[~e]
                e = sub[(w >> _ROOT) & m]
            p += e & 15
            append((e >> 4 << 24) | (r << 16) | (code << 8) | b)
            src += 1
            x += 1
            if x == xsize:
                x = 0
                y += 1
        elif code < 256 + _NUM_LENGTH_CODES:
            br.pos = p
            length = _copy_length(br, code - 256)
            d = _distance(xsize, _copy_length(br, _symbol(br, dist)))
            p = br.pos
            if d > src or src + length > total:
                raise ValueError("corrupt WebP lossless data: a backward reference out of "
                                 "the image")
            start = src - d
            if d >= length:
                out.extend(out[start:start + length])
            else:
                run = out[start:src]
                out.extend((run * (length // d + 1))[:length])
            src += length
            x += length
            if x >= xsize:
                y += x // xsize
                x %= xsize
            if meta is not None and x & mask and src < total:
                (gr, gs), (rr, rs), (br_, bs), (ar, as_), dist = \
                    groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        else:
            if cache is None:
                raise ValueError("corrupt WebP lossless data: a cache code without a cache")
            for v in out[cached:src]:
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
            cached = src
            append(cache[code - 256 - _NUM_LENGTH_CODES])
            src += 1
            x += 1
            if x == xsize:
                x = 0
                y += 1
        if p > end:
            raise ValueError("truncated WebP lossless data")
    br.pos = p
    return np.array(out, np.uint32)


def _channels(px: np.ndarray) -> np.ndarray:
    """uint32 ARGB (..., ) to int32 (..., 4) as (a, r, g, b)."""
    return np.stack([(px >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.uint32) & 0xFF
    return (ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]


def _avg(a, b):
    return (a + b) >> 1


def _predict(mode: np.ndarray, L, T, TL, TR) -> np.ndarray:
    """The 14 predictors of RFC 9649 on (n, 4) channel arrays, each pixel
    by its mode (14 and 15 act as 0); only the modes present are computed."""
    there = np.bincount(mode, minlength=16)
    there[0] += there[14] + there[15]
    c = [_BLACK, L, T, TR, TL] + [L] * 9
    if there[5]:
        c[5] = _avg(_avg(L, TR), T)
    if there[6] or there[10]:
        c[6] = _avg(L, TL)
    if there[7] or there[13]:
        c[7] = _avg(L, T)
    if there[8]:
        c[8] = _avg(TL, T)
    if there[9] or there[10]:
        c[9] = _avg(T, TR)
    if there[10]:
        c[10] = _avg(c[6], c[9])
    if there[11]:
        left = np.abs(T - TL).sum(1) < np.abs(L - TL).sum(1)
        c[11] = np.where(left[:, None], L, T)
    if there[12]:
        c[12] = np.clip(L + T - TL, 0, 255)
    if there[13]:
        d = c[7] - TL
        c[13] = np.clip(c[7] + ((d + (d < 0)) >> 1), 0, 255)   # (d / 2) truncated
    mode = np.where(mode < 14, mode, 0)
    present = np.flatnonzero(there[:14])
    if len(present) == 1:
        return np.broadcast_to(c[present[0]], L.shape)
    if there[0]:
        c[0] = np.broadcast_to(_BLACK, L.shape)
    slot = np.zeros(14, np.int64)
    slot[present] = np.arange(len(present))
    return np.stack([c[k] for k in present])[slot[mode], np.arange(len(mode))]


def _inverse_predictor(px: np.ndarray, w: int, h: int, bits: int, sub: np.ndarray):
    """Add each pixel's prediction to its residual, along the anti-diagonals
    t = x + 2y: a pixel's left, top, top-left and top-right neighbours (the
    rightmost pixel's top-right is its own row's first) have smaller t."""
    n = h * w
    y, x = np.divmod(np.arange(n), w)
    bw = -(-w // (1 << bits))
    mode = ((sub >> 8) & 0xF).astype(np.int64)[(y >> bits) * bw + (x >> bits)]
    mode = np.where(y == 0, np.where(x == 0, 0, 1), np.where(x == 0, 2, mode))
    t = x + 2 * y
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(int(t[-1]) + 2)).tolist()
    res, mode = _channels(px)[order], mode[order]
    near = [np.maximum(order - d, 0) for d in (1, w, w + 1, w - 1)]   # L, T, TL, TR
    out = np.zeros((n, 4), np.int32)
    for a, b in zip(bounds[:-1], bounds[1:]):
        L, T, TL, TR = (out[k[a:b]] for k in near)
        out[order[a:b]] = (res[a:b] + _predict(mode[a:b], L, T, TL, TR)) & 0xFF
    return _pack(out)


def _inverse_cross_color(px: np.ndarray, w: int, h: int, bits: int, sub: np.ndarray):
    ch = _channels(px).reshape(h, w, 4)
    bw = -(-w // (1 << bits))
    ys, xs = np.mgrid[0:h, 0:w]
    e = sub[(ys >> bits) * bw + (xs >> bits)]
    s8 = lambda v: ((v.astype(np.int32) & 0xFF) ^ 0x80) - 0x80   # noqa: E731
    g2r, g2b, r2b = s8(e), s8(e >> 8), s8(e >> 16)
    g = s8(ch[..., 2])
    r = (ch[..., 1] + ((g2r * g) >> 5)) & 0xFF
    b = ch[..., 3] + ((g2b * g) >> 5)
    b = (b + ((r2b * s8(r)) >> 5)) & 0xFF
    ch[..., 1], ch[..., 3] = r, b
    return _pack(ch).ravel()


def _inverse_subtract_green(px: np.ndarray):
    g = (px >> 8) & 0xFF
    r = (((px >> 16) & 0xFF) + g) & 0xFF
    b = ((px & 0xFF) + g) & 0xFF
    return (px & 0xFF00FF00) | (r << 16) | b


def _inverse_color_indexing(px: np.ndarray, w: int, h: int, bits: int, table: np.ndarray):
    full = np.zeros(256, np.uint32)
    full[:len(table)] = table[:256]
    packed = ((px >> 8) & 0xFF).reshape(h, -1)
    if bits:
        per = 1 << bits
        depth = 8 >> bits
        x = np.arange(w)
        idx = (packed[:, x >> bits] >> ((x & (per - 1)) * depth).astype(np.uint32)) \
            & ((1 << depth) - 1)
    else:
        idx = packed
    return full[idx.astype(np.int64)].ravel()


def webp_size(data: bytes):
    """(width, height) as PIL gives it: the VP8X canvas, else the VP8L or
    VP8 header's."""
    img = _chunks(data)
    if img.canvas is not None:
        return img.canvas
    if img.tag == b"VP8L":
        return _vp8l_header(img.body)[:2]
    return vp8_frame_size(img.body)


class _Image(NamedTuple):
    """The chunks of a still WebP that libwebp's demuxer hands its decoder."""

    tag: bytes                      # b"VP8L" or b"VP8 "
    body: bytes
    flags: Optional[int]            # of the VP8X header
    canvas: Optional[tuple]         # (width, height) of the VP8X header
    alph: Optional[bytes]


def _chunks(data: bytes) -> _Image:
    """The image chunk (``VP8L``, or ``VP8 `` with the padding byte after
    it), the VP8X flags and canvas (None without VP8X) and the ALPH payload
    (None without one).  As libwebp's demuxer: ALPH only in a VP8X file and
    right before its ``VP8 `` chunk; animation refused."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    pos, flags, canvas, alph = 12, None, None, None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + n]
        if alph is not None and tag != b"VP8 ":
            raise ValueError("corrupt WebP file: an ALPH chunk not followed by its VP8 chunk")
        if tag == b"VP8X":
            if len(body) < 10:
                raise ValueError("truncated WebP file: a short VP8X chunk")
            flags = body[0]
            canvas = (1 + int.from_bytes(body[4:7], "little"),
                      1 + int.from_bytes(body[7:10], "little"))
            if flags & 0x02:
                raise ValueError("unsupported WebP: animated WebP")
        elif tag in (b"ANIM", b"ANMF"):
            raise ValueError("unsupported WebP: animated WebP")
        elif tag == b"ALPH":
            if flags is None:
                raise ValueError("corrupt WebP file: an ALPH chunk without a VP8X header")
            alph = body
        elif tag == b"VP8L":
            return _Image(tag, body, flags, canvas, None)
        elif tag == b"VP8 ":
            if len(body) < n:
                raise ValueError("truncated WebP file: the VP8 chunk is cut short")
            return _Image(tag, data[pos + 8:pos + 8 + n + (n & 1)], flags, canvas, alph)
        pos += 8 + n + (n & 1)
    raise ValueError("corrupt WebP file: no image chunk")


def _vp8l_header(chunk: bytes):
    if len(chunk) < 5 or chunk[0] != 0x2F:
        raise ValueError("corrupt WebP lossless data: bad signature")
    v = struct.unpack("<I", chunk[1:5])[0]
    if v >> 29:
        raise ValueError(f"corrupt WebP lossless data: version {v >> 29}")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def _image_stream(br: _Bits, w: int, h: int) -> np.ndarray:
    """A VP8L image stream (transforms, then the entropy-coded pixels) as
    uint32 ARGB (h * w,)."""
    xsize = w
    transforms, seen = [], set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("corrupt WebP lossless data: a transform given twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_pixels(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, xsize, bits, sub))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:
            n = br.read(8) + 1
            table = _decode_pixels(br, n, 1, False)
            table = _pack(np.cumsum(_channels(table), axis=0) & 0xFF)
            bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            transforms.append((kind, xsize, bits, table))
            xsize = -(-xsize // (1 << bits))
    px = _decode_pixels(br, xsize, h, True)
    for kind, tw, bits, extra in reversed(transforms):
        if kind == 0:
            px = _inverse_predictor(px, tw, h, bits, extra)
        elif kind == 1:
            px = _inverse_cross_color(px, tw, h, bits, extra)
        elif kind == 2:
            px = _inverse_subtract_green(px)
        else:
            px = _inverse_color_indexing(px, tw, h, bits, extra)
    return px


def _unfilter(d: np.ndarray, method: int) -> np.ndarray:
    """libwebp's ``WebPUnfilters`` over an (h, w) plane of filtered alpha:
    0 none; 1 horizontal, 2 vertical, 3 gradient, each predicting the
    first row from the left (0 before the first pixel) and, below it, the
    first column from above.  The gradient (left + top - top-left,
    clipped) runs along the anti-diagonals x + y."""
    d = d.astype(np.int64)
    if method == 0:
        return d.astype(np.uint8)
    out = np.empty_like(d)
    out[0] = np.cumsum(d[0])
    out[1:, 0] = out[0, 0] + np.cumsum(d[1:, 0])
    if method == 1:
        out[1:, 1:] = out[:-1, :1] + np.cumsum(d[1:], axis=1)[:, 1:]
    elif method == 2:
        out[1:, 1:] = out[0, 1:] + np.cumsum(d[1:, 1:], axis=0)
    else:
        h, w = d.shape
        out &= 0xFF
        for s in range(2, w + h - 1):
            ys = np.arange(max(1, s - w + 1), min(h - 1, s - 1) + 1)
            xs = s - ys
            pred = np.clip(out[ys, xs - 1] + out[ys - 1, xs] - out[ys - 1, xs - 1], 0, 255)
            out[ys, xs] = (pred + d[ys, xs]) & 0xFF
    return (out & 0xFF).astype(np.uint8)


def _alpha_plane(alph: bytes, w: int, h: int) -> np.ndarray:
    """(h, w) uint8 alpha of an ALPH payload, as libwebp's ``ALPHInit`` and
    ``ALPHDecode``: the header byte (compression 0 raw or 1 VP8L, filter,
    preprocessing 0 or 1 (ignored), reserved bits 0), then the data."""
    if len(alph) <= 1:
        raise ValueError("corrupt lossy WebP: an empty ALPH chunk")
    head = alph[0]
    method, filt, pre = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or pre > 1 or head >> 6:
        raise ValueError(f"corrupt lossy WebP: ALPH header {head:#04x} (compression {method}, "
                         f"preprocessing {pre}, reserved {head >> 6})")
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("truncated lossy WebP: raw ALPH data shorter than the image")
        plane = np.frombuffer(alph, np.uint8, w * h, 1).reshape(h, w)
    else:
        plane = ((_image_stream(_Bits(alph[1:]), w, h) >> 8) & 0xFF).reshape(h, w)
    return _unfilter(plane, filt)


def decode_webp(data: bytes):
    """``(array, None)``: (H, W, 4) RGBA uint8 where PIL opens the file as
    RGBA, else (H, W, 3) RGB.  Lossless: RGBA where the VP8L header says
    the image uses alpha.  Lossy: RGBA where the VP8X header says alpha or
    an ALPH chunk is there; the ALPH plane is used only with both (else
    alpha 255, as libwebp's demuxer drops it)."""
    img = _chunks(data)
    if img.tag == b"VP8L":
        w, h, has_alpha = _vp8l_header(img.body)
        br = _Bits(img.body)
        br.pos = 40
        ch = _channels(_image_stream(br, w, h)).reshape(h, w, 4)[..., [1, 2, 3, 0]]
        ch = ch.astype(np.uint8)
        return np.ascontiguousarray(ch if has_alpha else ch[..., :3]), None
    w, h = vp8_frame_size(img.body)
    if img.canvas is not None and img.canvas != (w, h):
        raise ValueError(f"corrupt WebP file: a {w}x{h} frame on a {img.canvas[0]}x"
                         f"{img.canvas[1]} canvas")
    flagged = img.flags is not None and bool(img.flags & 0x10)
    rgb = decode_vp8(img.body)
    if not flagged and img.alph is None:
        return rgb, None
    if flagged and img.alph is not None:
        alpha = _alpha_plane(img.alph, w, h)
    else:
        alpha = np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1), None
