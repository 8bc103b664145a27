"""Baseline JPEG decoder in numpy, for the custom loader (``data/custom.py``),
which the JAX package reads with PIL.

Decodes what a baseline libjpeg build decodes for it: SOF0/SOF1 frames of
8-bit samples, Huffman-coded, one component (gray, expanded to RGB as
``Image.convert("RGB")`` does) or three (YCbCr, or RGB under an Adobe
transform of 0 or component ids R, G, B), chroma sampled 4:4:4, 4:2:2 or
4:2:0, interleaved or one scan a component, restart intervals
(DRI/RSTn), stuffed 0xFF00 bytes, and any size (the partial MCUs at the
right and bottom edges are cropped).  Progressive (SOF2), lossless and
hierarchical frames, arithmetic coding, 12-bit samples and four
components (CMYK, YCCK) raise ``ValueError`` naming the feature, as do
other chroma samplings (4:4:0, 4:1:1).

To give PIL's pixels (libjpeg-turbo with its defaults) the decoder copies
libjpeg's integer arithmetic: the slow integer IDCT (``jidctint.c``,
13-bit constants, 2 extra bits in the first pass, the post-IDCT range
table), "fancy" triangle upsampling of the chroma (``jdsample.c``, with
the first and last rows and columns replicated, box upsampling for
planes at most 2 samples wide), and the fixed-point YCbCr to RGB tables
of ``jdcolor.c`` (16 fractional bits).

The Huffman decode is serial: one 16-bit peek and one table lookup a
symbol over the de-stuffed bytes of each restart interval.  Dequantizing,
the IDCT, upsampling and colour conversion are vectorised over all blocks.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
              0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
              0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic coding (SOF9)",
              0xCA: "arithmetic coding (SOF10)", 0xCB: "arithmetic coding (SOF11)",
              0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)",
              0xCF: "arithmetic coding (SOF15)", 0xCC: "arithmetic coding (DAC)"}


def _huffman_lut(counts, symbols):
    """A 65,536-entry table: each 16-bit window -> (code length << 8) | symbol,
    0 where no code starts the window."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(seg: bytes):
    """The 32-bit big-endian window at every byte of ``seg`` (zero-filled
    past its end, as libjpeg fills a buffer that meets a marker)."""
    b = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
    n = len(seg) + 4
    return ((b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]).tolist()


def _decode_segment(seg: bytes, units, pos, val):
    """Huffman-decode one restart interval.  ``units``: per block, (the flat
    index of its coefficient 0, DC table, AC table, the component's DC
    predictor slot); ``pos``/``val`` collect the non-zero coefficients
    (flat index in the zigzag order, value)."""
    w = _windows(seg)
    limit = len(seg) * 8 + 16
    p = 0
    pred = {}
    for base, dc, ac, slot in units:
        look = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not look:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        p += look >> 8
        s = look & 0xFF
        diff = 0
        if s:
            v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            diff = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
        dcv = pred.get(slot, 0) + diff
        pred[slot] = dcv
        if dcv:
            pos.append(base)
            val.append(dcv)
        k = 1
        while k < 64:
            look = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not look:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            p += look >> 8
            rs = look & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("corrupt JPEG data: coefficient index past 63")
                v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                pos.append(base + k)
                val.append(v - (1 << s) + 1 if v < (1 << (s - 1)) else v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        if p > limit:
            raise ValueError("corrupt JPEG data: the scan ends early")


def _split_scan(data: bytes, start: int):
    """The entropy-coded segments of a scan starting at ``start``, split at
    its RSTn markers and de-stuffed, and the offset of the marker that ends
    the scan."""
    segs, seg_start, i = [], start, start
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("corrupt JPEG data: no marker ends the scan")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1 if m == 0xFF else 2
            continue
        segs.append(data[seg_start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            i += 2
            seg_start = i
            continue
        return segs, i


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow over (N, 64) natural-order coefficients
    with the (64,) quantization table: (N, 8, 8) uint8 samples."""
    c = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)

    def butterfly(x, descale):
        # x[..., k] the k-th input of the 1-D pass over the last axis
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * 4433
        tmp2 = z1 + z3 * -15137
        tmp3 = z1 + z2 * 6270
        tmp0 = (x[..., 0] + x[..., 4]) << 13
        tmp1 = (x[..., 0] - x[..., 4]) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633
        o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        rnd = 1 << (descale - 1)
        out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
        return np.stack([(v + rnd) >> descale for v in out], axis=-1)

    # pass 1 over the columns (the first axis of each block), 2 extra bits
    ws = butterfly(np.swapaxes(c, 1, 2), 13 - 2)          # (N, col, row)
    # pass 2 over the rows
    out = butterfly(np.swapaxes(ws, 1, 2), 13 + 2 + 3)     # (N, row, col)
    return _RANGE_LIMIT[out & 1023]


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range table indexed by (value & 1023): value +
    128 clamped to [0, 255] for values in [-512, 511]."""
    v = np.arange(1024)
    v = np.where(v >= 512, v - 1024, v)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a chroma plane (its true downsampled
    size) by (fx, fy) in (1, 1), (2, 1), (2, 2): fancy (triangle), or box
    where the plane is at most 2 samples wide."""
    x = plane.astype(np.int32)
    if (fx, fy) == (1, 1):
        return plane
    if fx == 2 and x.shape[1] <= 2:          # no fancy upsampling that narrow
        return np.repeat(np.repeat(plane, 2, axis=1), fy, axis=0)
    if fy == 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        sums = [3 * x + up, 3 * x + down]                   # the upper and lower row
        out = []
        for cs in sums:
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out.append(np.stack([(3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4],
                                axis=2).reshape(x.shape[0], -1))
        return np.stack(out, axis=1).reshape(2 * x.shape[0], -1).astype(np.uint8)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    return np.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2],
                    axis=2).reshape(x.shape[0], -1).astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _ycc_tables():
    c = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * c + half) >> 16
    cb_b = (_fix(1.77200) * c + half) >> 16
    cr_g = -_fix(0.71414) * c
    cb_g = -_fix(0.34414) * c + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of a baseline JPEG file's bytes."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    frame = None
    restart = 0
    adobe = None
    jfif = False
    coefs = None
    i = 2
    while True:
        while i < len(data) and data[i] == 0xFF and i + 1 < len(data) and data[i + 1] == 0xFF:
            i += 1                                           # fill bytes
        if i + 2 > len(data) or data[i] != 0xFF:
            raise ValueError("corrupt JPEG data: marker expected")
        m = data[i + 1]
        if m == 0xD9:                                        # EOI
            break
        if i + 4 > len(data):
            raise ValueError("corrupt JPEG data: truncated marker")
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        body = data[i + 4:i + 2 + length]
        i += 2 + length
        if m in _SOF_NAMES:
            raise ValueError(f"unsupported JPEG: {_SOF_NAMES[m]}")
        if m in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"unsupported JPEG: {prec}-bit samples (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"unsupported JPEG: {nc} components"
                                 + (" (CMYK/YCCK)" if nc == 4 else "") + " (1 or 3 only)")
            if h == 0:
                raise ValueError("unsupported JPEG: height defined by a DNL marker")
            comps = []
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = {"h": h, "w": w, "comps": comps}
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            frame.update(hmax=hmax, vmax=vmax, mx=-(-w // (8 * hmax)), my=-(-h // (8 * vmax)))
            sizes = [frame["my"] * c["v"] * frame["mx"] * c["h"] * 64 for c in comps]
            frame["offsets"] = np.cumsum([0] + sizes).tolist()
            coefs = np.zeros(sum(sizes), np.int32)
        elif m == 0xDB:                                      # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                if pq:
                    q = np.frombuffer(body[k + 1:k + 129], ">u2").astype(np.int32)
                    k += 129
                else:
                    q = np.frombuffer(body[k + 1:k + 65], np.uint8).astype(np.int32)
                    k += 65
                nat = np.zeros(64, np.int32)
                nat[_ZIGZAG] = q
                qts[tq] = nat
        elif m == 0xC4:                                      # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = list(body[k + 1:k + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, list(body[k + 17:k + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = lut
                k += 17 + n
        elif m == 0xDD:                                      # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xDA:                                      # SOS
            if frame is None:
                raise ValueError("corrupt JPEG data: SOS before SOF")
            ns = body[0]
            sel = []
            for c in range(ns):
                cs, t = body[1 + 2 * c:3 + 2 * c]
                ci = next((j for j, cc in enumerate(frame["comps"]) if cc["id"] == cs), None)
                if ci is None:
                    raise ValueError(f"corrupt JPEG data: scan of unknown component {cs}")
                sel.append((ci, t >> 4, t & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError("unsupported JPEG: progressive scan parameters")
            segs, i = _split_scan(data, i)
            _decode_scan(frame, sel, segs, restart, dc_tabs, ac_tabs, coefs)
        elif m == 0xDC:
            raise ValueError("unsupported JPEG: DNL marker")
        # other APPn, COM: skipped
    if frame is None:
        raise ValueError("corrupt JPEG data: no frame")
    return _reconstruct(frame, coefs, qts, adobe, jfif)


def _decode_scan(frame, sel, segs, restart, dc_tabs, ac_tabs, coefs):
    """Huffman-decode one scan into ``coefs``: the zigzag coefficients of
    every component's MCU-padded block grid, one flat array, component c's
    from ``frame["offsets"][c]`` on."""
    comps, mx, my, off = frame["comps"], frame["mx"], frame["my"], frame["offsets"]
    units = []
    if len(sel) == 1:           # non-interleaved: the component's own blocks, in raster order
        ci, td, ta = sel[0]
        c = comps[ci]
        cw = -(-frame["w"] * c["h"] // frame["hmax"])
        chh = -(-frame["h"] * c["v"] // frame["vmax"])
        bw, bh = -(-cw // 8), -(-chh // 8)
        stride = mx * c["h"]
        for by in range(bh):
            for bx in range(bw):
                units.append([(off[ci] + (by * stride + bx) * 64, dc_tabs[td], ac_tabs[ta],
                               ci)])
    else:
        for y in range(my):
            for x in range(mx):
                mcu = []
                for ci, td, ta in sel:
                    c = comps[ci]
                    stride = mx * c["h"]
                    for v in range(c["v"]):
                        for u in range(c["h"]):
                            b = (y * c["v"] + v) * stride + x * c["h"] + u
                            mcu.append((off[ci] + b * 64, dc_tabs[td], ac_tabs[ta], ci))
                units.append(mcu)
    per = restart or len(units)
    n_seg = -(-len(units) // per)
    if len(segs) < n_seg:
        raise ValueError(f"corrupt JPEG data: {len(segs)} restart intervals, "
                         f"{n_seg} expected")
    for j in range(n_seg):
        pos, val = [], []
        _decode_segment(segs[j], [u for mcu in units[j * per:(j + 1) * per] for u in mcu],
                        pos, val)
        if pos:
            coefs[np.asarray(pos, np.int64)] = np.asarray(val, np.int32)


def _reconstruct(frame, coefs, qts, adobe, jfif):
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    planes = []
    for ci, c in enumerate(comps):
        cf = coefs[frame["offsets"][ci]:frame["offsets"][ci + 1]]
        bh, bw = frame["my"] * c["v"], frame["mx"] * c["h"]
        nat = np.zeros((bh * bw, 64), np.int32)
        nat[:, _ZIGZAG] = cf.reshape(-1, 64)
        blocks = _idct_islow(nat, qts[c["tq"]])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        ch = -(-h * c["v"] // frame["vmax"])
        cw = -(-w * c["h"] // frame["hmax"])
        fx, fy = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if (fx, fy) not in ((1, 1), (2, 1), (2, 2)) or (
                fx * c["h"] != frame["hmax"] or fy * c["v"] != frame["vmax"]):
            raise ValueError(f"unsupported JPEG: sampling factors "
                             f"{[(cc['h'], cc['v']) for cc in comps]}")
        planes.append(_upsample(plane[:ch, :cw], fx, fy)[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    ids = [c["id"] for c in comps]
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == [82, 71, 66])
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def jpeg_size(data: bytes):
    """(height, width) from a JPEG's frame header, without decoding."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError("corrupt JPEG data: marker expected")
        m = data[i + 1]
        if m == 0xFF:
            i += 1
            continue
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return struct.unpack(">HH", data[i + 5:i + 9])
        i += 2 + length
    raise ValueError("corrupt JPEG data: no frame header")


def read_jpeg(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of a baseline JPEG file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
