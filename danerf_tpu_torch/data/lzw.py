"""LZW decoder in numpy for the two variants image files use: GIF's
(codes packed from the least significant bit; the code width grows when
the next free code reaches a power of two) and TIFF's (packed from the
most significant bit, "early change": the width grows one code sooner).
Both have a clear code, an end code and codes of at most 12 bits; the
table stops growing at 4096 entries (GIF's "deferred clear").

The decode takes a few numpy steps per clear code, not one per symbol:

1. Between two clear codes the width of every code follows from its index
   since the clear, so the codes of a whole segment are cut out of the bit
   stream at once; the first clear or end code among them ends it.
2. Each code k >= 1 of a segment defines one table entry: the string of
   code k - 1 plus the first byte of code k's string.  Every entry is a
   node with a parent (its prefix) and a last byte; each node's first byte
   and length come from pointer doubling over the parents (13 rounds for
   chains of up to 4096).
3. A binary-lifting table over the parents (13 levels, one gather each)
   gives every output byte at once: byte o of code k's string is the last
   byte of the node (length - 1 - o) parents above code k's node.
"""

from __future__ import annotations

import numpy as np

_MAX_BITS = 12
_TABLE = 1 << _MAX_BITS
_ROUNDS = _MAX_BITS + 1            # 2**13 > the longest parent chain


def _bit_length(x: np.ndarray) -> np.ndarray:
    return np.frexp(x.astype(np.float64))[1].astype(np.int64)


def _codes_at(buf: np.ndarray, pos: np.ndarray, width: np.ndarray, msb: bool) -> np.ndarray:
    """The codes of ``width`` bits at bit offsets ``pos``; ``buf`` is the
    data padded with 3 zero bytes."""
    i = pos >> 3
    b0, b1, b2 = (buf[i].astype(np.int64), buf[i + 1].astype(np.int64),
                  buf[i + 2].astype(np.int64))
    if msb:
        win = (b0 << 16) | (b1 << 8) | b2
        return (win >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
    win = b0 | (b1 << 8) | (b2 << 16)
    return (win >> (pos & 7)) & ((1 << width) - 1)


def _segments(data: bytes, min_bits: int, msb: bool, early: int) -> list:
    """The codes between clear codes, one array a segment (clear and end
    codes dropped); each segment starts from a fresh table."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    first = clear + 2
    nbits = len(data) * 8
    buf = np.frombuffer(bytes(data) + b"\0\0\0", np.uint8)
    segs, pos = [], 0
    while True:
        parts, k0 = [], 0
        while True:
            k = np.arange(k0, k0 + _TABLE, dtype=np.int64)
            free = np.minimum(first + np.maximum(k - 1, 0), _TABLE)
            width = np.clip(_bit_length(free + early), min_bits + 1, _MAX_BITS)
            starts = pos + np.concatenate([[0], np.cumsum(width[:-1])])
            n_fit = int(np.count_nonzero(starts + width <= nbits))
            codes = _codes_at(buf, starts[:n_fit], width[:n_fit], msb)
            stop = np.flatnonzero((codes == clear) | (codes == end))
            if stop.size:
                s = int(stop[0])
                parts.append(codes[:s])
                pos = int(starts[s] + width[s])
                more = bool(codes[s] == clear)
                break
            parts.append(codes)
            if n_fit < len(k):              # the data ends without an end code
                more = False
                break
            pos = int(starts[-1] + width[-1])
            k0 += _TABLE
        seg = np.concatenate(parts)
        if seg.size:
            segs.append(seg)
        if not more:
            return segs


def lzw_decode(data: bytes, min_bits: int, msb: bool, early: int, limit: int) -> np.ndarray:
    """The first ``limit`` bytes (or fewer, where the stream ends) that an
    LZW stream decodes to.

    GIF: ``min_bits`` its LZW minimum code size, ``msb=False``, ``early=0``;
    TIFF: ``min_bits=8``, ``msb=True``, ``early=1``.  A code past the
    table raises ValueError."""
    clear = 1 << min_bits
    first = clear + 2
    ids = np.arange(clear, dtype=np.int64)
    parent, suffix_of, nodes, base = [ids], [ids], [], clear
    for seg in _segments(data, min_bits, msb, early):
        k = np.arange(len(seg))
        top = np.where(k == 0, clear - 1, np.minimum(first + k - 1, _TABLE - 1))
        if np.any(((seg >= clear) & (seg < first)) | (seg > top)):
            raise ValueError("corrupt LZW data: a code past the table")
        node = np.where(seg < clear, seg, base + seg - first)
        n_new = min(len(seg) - 1, _TABLE - first)
        nodes.append(node)
        parent.append(node[:n_new])                   # entry k's prefix: code k - 1's string
        suffix_of.append(node[1:n_new + 1])           # its last byte: code k's first byte
        base += n_new
    if not nodes:
        return np.zeros(0, np.uint8)
    parent, suffix_of, node = (np.concatenate(parent), np.concatenate(suffix_of),
                               np.concatenate(nodes))
    n = np.arange(len(parent))
    # pointer doubling: each node's root literal and its depth below it
    root, depth = parent.copy(), (n >= clear).astype(np.int64)
    for _ in range(_ROUNDS):
        depth = depth + depth[root]
        root = root[root]
    byte = np.where(n < clear, n, root[suffix_of])    # each node's last byte
    lens = depth[node] + 1
    ends = np.cumsum(lens)
    total = int(min(ends[-1], limit))
    out = np.arange(total)
    which = np.searchsorted(ends, out, side="right")
    climb = ends[which] - 1 - out                     # parents above code's node
    cur = node[which]
    up = parent
    for lvl in range(_ROUNDS):
        cur = np.where((climb >> lvl) & 1, up[cur], cur)
        up = up[up]
    return byte[cur].astype(np.uint8)
