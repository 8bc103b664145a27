"""Netpbm decoder (PBM, PGM, PPM: P1-P6, plain and raw; PFM gray, Pf) in
numpy, giving what PIL 12 opens: ``np.asarray(Image.open(path))``.

The header is read as PIL's ``PpmImagePlugin`` reads it: the magic number,
then width, height and (but for bitmaps) maxval or scale, as tokens of at
most 10 characters separated by whitespace, a ``#`` starting a comment up
to the next CR or LF; the data starts one byte after the last token.  The
modes are PIL's:

- P1, P4: "1" (bool; a 1 bit is black, False);
- P2, P5: "L", or "I" (int32) where maxval > 255; P3, P6: "RGB";
- a maxval other than 255 (65535 for "I") scales each sample to 255 (or
  65535) as PIL does, ``round(v / maxval * out_max)`` in float64, half to
  even, raw samples above maxval clipped, plain ones refused;
- Pf: "F" (float32), rows bottom-up, little-endian when the scale is
  negative.

PIL's CMYK extension (P0CMYK), its test-only "Py" modes and colour PFM (PF)
raise ValueError naming them.
"""

from __future__ import annotations

import math

import numpy as np

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"Pf": "F"}


def is_netpbm(head: bytes) -> bool:
    return len(head) >= 2 and head[:1] == b"P" and head[1:2] in b"0123456fFy"


def _header(data: bytes):
    """(magic, width, height, maxval or scale, data start)."""
    pos, magic = 0, b""
    while pos < min(6, len(data)):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        what = {b"P0CMYK": "CMYK (PIL's P0CMYK extension)", b"PF": "colour PFM (PF)",
                b"PyP": "PIL's test-only PyP mode", b"PyRGBA": "PIL's test-only PyRGBA mode",
                b"PyCMYK": "PIL's test-only PyCMYK mode"}.get(magic)
        raise ValueError(f"unsupported Netpbm: {what}" if what else "not a Netpbm file")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            if pos >= len(data):
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok:
            raise ValueError("corrupt Netpbm header: reached the end while reading it")
        if len(tok) > 10:
            raise ValueError("corrupt Netpbm header: a token too long")
        return tok

    w, h = int(token()), int(token())
    if magic in (b"P1", b"P4"):
        return magic, w, h, 1, pos
    if magic == b"Pf":
        scale = float(token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PFM header: the scale must be finite and non-zero")
        return magic, w, h, scale, pos
    maxval = int(token())
    if not 0 < maxval < 65536:
        raise ValueError("corrupt Netpbm header: maxval must be greater than 0 and less "
                         "than 65536")
    return magic, w, h, maxval, pos


def netpbm_size(data: bytes):
    _, w, h, _, _ = _header(data)
    return w, h


def _plain_tokens(body: bytes) -> list:
    """The data tokens of a plain file, comments (``#`` to CR or LF) removed."""
    out, i = [], 0
    while True:
        j = body.find(b"#", i)
        if j < 0:
            out.append(body[i:])
            break
        out.append(body[i:j])
        k = min([p for p in (body.find(b"\n", j), body.find(b"\r", j)) if p >= 0],
                default=len(body))
        i = k + 1
    return b"".join(out).split()


def decode_netpbm(data: bytes):
    """``(array, None)``: PIL's array of the file (dtype and shape of its
    mode)."""
    magic, w, h, maxval, pos = _header(data)
    mode = _MODES[magic]
    body = data[pos:]
    if magic == b"Pf":
        n = w * h * 4
        if len(body) < n:
            raise ValueError("truncated PFM data")
        a = np.frombuffer(body[:n], "<f4" if maxval < 0 else ">f4").reshape(h, w)
        return np.ascontiguousarray(a[::-1]).astype(np.float32), None
    if magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError("truncated PBM data")
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride),
                             axis=1)[:, :w]
        return ((bits == 0).view(np.uint8) * np.uint8(255)).view(bool), None   # True: 255
    if magic == b"P1":
        digits = b"".join(_plain_tokens(body))
        bad = digits.translate(None, b"01")
        if bad:
            raise ValueError(f"corrupt PBM data: a token {bad[:1]!r}")
        if len(digits) < w * h:
            raise ValueError("truncated PBM data")
        white = np.frombuffer(digits[:w * h], np.uint8).reshape(h, w) == ord("0")
        return (white.view(np.uint8) * np.uint8(255)).view(bool), None
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    out_i = mode == "L" and maxval > 255
    out_max = 65535 if out_i else 255
    if magic in (b"P2", b"P3"):
        toks = _plain_tokens(body)
        if any(len(t) > 10 for t in toks[:n]):
            raise ValueError("corrupt Netpbm data: a token too long")
        v = np.array([int(t) for t in toks[:n]], np.int64)
        if v.size < n:
            raise ValueError("truncated Netpbm data")
        if np.any(v < 0) or np.any(v > maxval):
            raise ValueError("corrupt Netpbm data: a sample outside 0..maxval")
        v = np.rint(v / maxval * out_max)
    else:
        wide = maxval > 255
        need = n * (2 if wide else 1)
        if len(body) < need:
            raise ValueError("truncated Netpbm data")
        v = np.frombuffer(body[:need], ">u2" if wide else np.uint8).astype(np.int64)
        if maxval != out_max:
            v = np.minimum(out_max, np.rint(v / maxval * out_max))
    arr = v.reshape((h, w, 3) if bands == 3 else (h, w))
    return arr.astype(np.int32 if out_i else np.uint8), None
