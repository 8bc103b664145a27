"""Zstandard decompression (RFC 8878) in Python and numpy.

The port reads the JAX package's Orbax checkpoints on a host that has no
zstd library: every zarr chunk and every OCDBT node there is a zstd frame.
``decompress(data)`` decodes one buffer (one frame or several, skippable
frames skipped); ``decompress_many(buffers)`` decodes a list of them
together, which is how a checkpoint is read.

What it takes: frames with or without the content size and the
single-segment flag, skippable frames, raw, RLE and compressed blocks;
literals raw, RLE, Huffman-coded in one or four streams, and treeless (the
previous table); sequences with predefined, RLE, FSE-compressed and repeat
tables, and the three repeat offsets; the XXH64 content checksum where a
frame has one.  A frame that names a dictionary is refused, as is any
stream that does not add up (``ValueError``, naming what is wrong).

Speed.  A checkpoint is mostly Huffman-coded float bytes: one symbol a
byte, each symbol's position known only after the one before it is read.
The Huffman streams of every block of every buffer are therefore decoded
in one walk, a numpy step per symbol index across all streams at once (a
checkpoint's ~300 streams of up to 32 K symbols each are ~32 K steps, not
~6 M).  Sequences and their execution run in Python, a few microseconds a
sequence.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024

# literal and match length codes: (baseline, extra bits)  (RFC 8878 3.1.1.3.2.1.1)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
                -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1], 5)
# (largest symbol, largest accuracy log) of each table kind
_KINDS = {"literal lengths": (35, 9), "offsets": (31, 8), "match lengths": (52, 9)}


def _fail(msg: str):
    raise ValueError(f"zstd: {msg}")


# ---------------------------------------------------------------- FSE tables

def _read_distribution(data: bytes, pos: int, end: int, max_symbol: int, max_log: int,
                       what: str):
    """An FSE table description at ``data[pos:end]`` (RFC 8878 4.1.1):
    (normalized counts, accuracy log, bytes read)."""
    bit = pos * 8

    def peek(n):
        word = int.from_bytes(data[bit >> 3:(bit >> 3) + 8], "little")
        return (word >> (bit & 7)) & ((1 << n) - 1)

    log = peek(4) + 5
    bit += 4
    if log > max_log:
        _fail(f"{what} table's accuracy log {log} exceeds {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    zero = False
    while remaining > 1:
        if zero:
            run = 0
            while True:
                r = peek(2)
                bit += 2
                run += r
                if r != 3:
                    break
            counts.extend([0] * run)
            if len(counts) > max_symbol + 1:
                _fail(f"{what} table describes more than {max_symbol + 1} symbols")
        lim = (2 * threshold - 1) - remaining
        v = peek(nbits)
        if (v & (threshold - 1)) < lim:
            v &= threshold - 1
            bit += nbits - 1
        else:
            v &= 2 * threshold - 1
            if v >= threshold:
                v -= lim
            bit += nbits
        count = v - 1
        remaining -= abs(count)
        counts.append(count)
        if len(counts) > max_symbol + 1:
            _fail(f"{what} table describes more than {max_symbol + 1} symbols")
        zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    used = (bit - pos * 8 + 7) >> 3
    if remaining != 1 or pos + used > end:
        _fail(f"{what} table description is corrupt or truncated")
    return counts, log, used


def _fse_table(counts: Sequence[int], log: int, what: str):
    """The decoding table of a distribution: per state (symbol, bits, base)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        _fail(f"{what} table's distribution does not fill the table")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        x = nxt[symbol[u]]
        nxt[symbol[u]] = x + 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbol, nbits, base, log


_PREDEFINED = {"literal lengths": _fse_table(*_LL_DEFAULT, "literal lengths"),
               "offsets": _fse_table(*_OF_DEFAULT, "offsets"),
               "match lengths": _fse_table(*_ML_DEFAULT, "match lengths")}


class _Backward:
    """A backward bit stream (RFC 8878 4.1): read from its last bit down,
    after the end marker in its last byte.  ``left`` counts the bits not yet
    read; reads past the start give zeros and drive it below 0."""

    def __init__(self, buf: bytes, what: str):
        if not buf or buf[-1] == 0:
            _fail(f"{what} bit stream lacks its end marker")
        self.buf = bytes(8) + buf
        self.left = 8 * len(buf) - (8 - buf[-1].bit_length() + 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.left -= n
        b = self.left + 64
        if b < 0:
            _fail("bit stream read far past its start")
        return (int.from_bytes(self.buf[b >> 3:(b >> 3) + 8], "little") >> (b & 7)) & ((1 << n) - 1)


# ---------------------------------------------------------------- Huffman

def _huffman_weights(data: bytes, pos: int, end: int):
    """The Huffman tree description at ``pos`` (RFC 8878 4.2.1):
    (table as a uint16 array of (bits << 8) | symbol, max bits, bytes read)."""
    if pos >= end:
        _fail("literals section truncated in its Huffman tree description")
    head = data[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            _fail("Huffman tree description truncated")
        w = []
        for b in data[pos + 1:pos + 1 + size]:
            w += [b >> 4, b & 15]
        weights = w[:n]
        used = 1 + size
    else:
        if pos + 1 + head > end:
            _fail("Huffman tree description truncated")
        counts, log, k = _read_distribution(data, pos + 1, pos + 1 + head, 255, 6,
                                            "Huffman weights")
        sym, nb, base, _ = _fse_table(counts, log, "Huffman weights")
        bits = _Backward(data[pos + 1 + k:pos + 1 + head], "Huffman weights")
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            weights.append(sym[s1])
            s1 = base[s1] + bits.read(nb[s1])
            if bits.left < 0:
                weights.append(sym[s2])
                break
            weights.append(sym[s2])
            s2 = base[s2] + bits.read(nb[s2])
            if bits.left < 0:
                weights.append(sym[s1])
                break
            if len(weights) > 255:
                _fail("Huffman tree describes more than 255 weights")
        used = 1 + head
    if len(weights) > 255 or max(weights, default=0) > 11:
        _fail("Huffman tree description is corrupt")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("Huffman tree has no symbol")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        _fail("Huffman weights do not describe a prefix code")
    weights.append(rest.bit_length())
    table = np.empty(1 << max_bits, np.uint16)
    p = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                table[p:p + n] = ((max_bits + 1 - w) << 8) | s
                p += n
    return table, max_bits, used


def _walk_streams(streams: list, tables: list) -> List[np.ndarray]:
    """Decode Huffman streams, all at once: ``streams`` holds (bytes,
    symbols, table index); returns each one's symbols.

    The streams' bytes are laid out reversed, one after another, so that a
    backward stream reads forwards, most significant bit first; a 32-bit
    window at every byte gives any position's next code in two shifts.
    Each step decodes one symbol of every stream (streams that are done
    step on through zeros and other streams' bits, which is harmless)."""
    if not streams:
        return []
    n = len(streams)
    counts = np.array([s[1] for s in streams], np.int64)
    steps = int(counts.max())
    parts, start, total = [], np.empty(n, np.int64), np.empty(n, np.int64)
    off = 0
    for j, (raw, _, _) in enumerate(streams):
        if not raw or raw[-1] == 0:
            _fail("Huffman stream lacks its end marker")
        skip = 8 - (raw[-1].bit_length() - 1)
        start[j] = off * 8 + skip
        total[j] = len(raw) * 8 - skip
        parts += [np.frombuffer(raw, np.uint8)[::-1], np.zeros(4, np.uint8)]
        off += len(raw) + 4
    parts.append(np.zeros(steps * 11 // 8 + 8, np.uint8))
    r = np.concatenate(parts).astype(np.int64)
    window = (r[:-3] << 24) | (r[1:-2] << 16) | (r[2:-1] << 8) | r[3:]
    offsets = np.cumsum([0] + [len(t) for t, _ in tables])
    table = np.concatenate([t for t, _ in tables]).astype(np.int64)
    tid = np.array([s[2] for s in streams], np.int64)
    bits = np.array([tables[t][1] for t in tid], np.int64)
    shift = 32 - bits
    mask = (1 << bits) - 1
    base = offsets[tid]
    out = np.empty((steps, n), np.uint16)
    p = start.copy()
    for k in range(steps):
        v = window[p >> 3]
        v >>= shift - (p & 7)
        v &= mask
        v += base
        e = table[v]
        out[k] = e
        p += e >> 8
    result = []
    for j in range(n):
        col = out[:counts[j], j]
        if int((col >> 8).sum(dtype=np.int64)) != total[j]:
            _fail("Huffman stream does not end where its symbols do")
        result.append((col & 0xFF).astype(np.uint8))
    return result


# ---------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the zstd content checksum is its low 32 bits)."""
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        v1, v2, v3, v4 = v
        for j in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        i = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- frames

class _Frame:
    """One frame's parse: its stated size (or None), its checksum (or None)
    and its blocks, each ("raw", a, b), ("rle", byte, n) or ("cmp",
    literals, sequences), before any Huffman stream is read."""

    def __init__(self, size):
        self.size, self.checksum, self.blocks = size, None, []


def _parse_frame(data: bytes, pos: int, streams: list, tables: list):
    """Parse the frame at ``pos``: (frame, position after it).  Huffman
    streams go to ``streams`` and their tables to ``tables``."""
    end = len(data)
    if pos + 6 > end:
        _fail("frame header truncated")
    fhd = data[pos + 4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _fail("frame header's reserved bit is set")
    q = pos + 5
    window = None
    if not single:
        wd = data[q]
        q += 1
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    did = (0, 1, 2, 4)[dict_flag]
    if did:
        ident = int.from_bytes(data[q:q + did], "little")
        if ident:
            _fail(f"frame names dictionary {ident}; decoding with a dictionary is not supported")
        q += did
    nfcs = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if nfcs:
        if q + nfcs > end:
            _fail("frame header truncated")
        size = int.from_bytes(data[q:q + nfcs], "little") + (256 if nfcs == 2 else 0)
        q += nfcs
    if window is None:
        window = size
    frame = _Frame(size)
    huf = None                       # the last Huffman table, for treeless literals
    fse = {}                         # the last table of each kind, for repeat mode
    while True:
        if q + 3 > end:
            _fail("block header truncated")
        head = int.from_bytes(data[q:q + 3], "little")
        q += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if kind == 3:
            _fail("reserved block type")
        limit = min(_BLOCK_MAX, window) if window else _BLOCK_MAX
        if bsize > limit:
            _fail(f"block of {bsize} bytes exceeds the maximum of {limit}")
        if kind == 0:
            if q + bsize > end:
                _fail("raw block truncated")
            frame.blocks.append(("raw", q, q + bsize))
            q += bsize
        elif kind == 1:
            if q + 1 > end:
                _fail("RLE block truncated")
            frame.blocks.append(("rle", data[q], bsize))
            q += 1
        else:
            if q + bsize > end:
                _fail("compressed block truncated")
            lit, seq, huf = _parse_block(data, q, q + bsize, huf, fse, streams, tables)
            frame.blocks.append(("cmp", lit, seq))
            q += bsize
        if last:
            break
    if checksum:
        if q + 4 > end:
            _fail("content checksum truncated")
        frame.checksum = int.from_bytes(data[q:q + 4], "little")
        q += 4
    return frame, q


def _parse_block(data, q, end, huf, fse, streams, tables):
    """A compressed block's literals and sequences sections (their headers
    and tables; the Huffman streams are only located)."""
    b0 = data[q]
    ltype, sf = b0 & 3, (b0 >> 2) & 3
    if ltype < 2:
        hsize = (1, 2, 1, 3)[sf]
        if q + hsize > end:
            _fail("literals section header truncated")
        h = int.from_bytes(data[q:q + hsize], "little")
        n = h >> (3 if sf in (0, 2) else 4)
        q += hsize
        if ltype == 0:
            if q + n > end:
                _fail("raw literals truncated")
            lit = ("raw", q, n)
            q += n
        else:
            if q + 1 > end:
                _fail("RLE literals truncated")
            lit = ("rle", data[q], n)
            q += 1
    else:
        hsize, width = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
        if q + hsize > end:
            _fail("literals section header truncated")
        h = int.from_bytes(data[q:q + hsize], "little")
        mask = (1 << width) - 1
        n, csize = (h >> 4) & mask, (h >> (4 + width)) & mask
        q += hsize
        cend = q + csize
        if cend > end:
            _fail("compressed literals truncated")
        if ltype == 2:
            table, bits, used = _huffman_weights(data, q, cend)
            tables.append((table, bits))
            huf = len(tables) - 1
            q += used
        elif huf is None:
            _fail("treeless literals without an earlier Huffman table")
        ids = []
        if sf == 0:
            ids.append(len(streams))
            streams.append((data[q:cend], n, huf))
        else:
            if q + 6 > cend:
                _fail("Huffman jump table truncated")
            s1, s2, s3 = struct.unpack_from("<3H", data, q)
            seg = (n + 3) // 4
            if n - 3 * seg < 0:
                _fail("four Huffman streams for fewer than 4 literals")
            a = q + 6
            s4 = cend - a - s1 - s2 - s3
            for ln, cnt in ((s1, seg), (s2, seg), (s3, seg), (s4, n - 3 * seg)):
                if ln <= 0 or a + ln > cend:
                    _fail("Huffman jump table points outside the literals")
                ids.append(len(streams))
                streams.append((data[a:a + ln], cnt, huf))
                a += ln
        lit = ("huf", ids, n)
        q = cend
    if n > _BLOCK_MAX:
        _fail("literals exceed the block maximum")
    # sequences section
    if q >= end:
        _fail("sequences section truncated")
    b0 = data[q]
    if b0 < 128:
        nseq, q = b0, q + 1
    elif b0 < 255:
        if q + 2 > end:
            _fail("sequences section truncated")
        nseq, q = ((b0 - 128) << 8) + data[q + 1], q + 2
    else:
        if q + 3 > end:
            _fail("sequences section truncated")
        nseq, q = data[q + 1] + (data[q + 2] << 8) + 0x7F00, q + 3
    if nseq == 0:
        if q != end:
            _fail("block holds bytes after its sequences section")
        return lit, None, huf
    if q >= end:
        _fail("sequences section truncated")
    modes = data[q]
    q += 1
    if modes & 3:
        _fail("reserved bits of the symbol compression modes are set")
    tabs = []
    for what, mode in (("literal lengths", modes >> 6), ("offsets", (modes >> 4) & 3),
                       ("match lengths", (modes >> 2) & 3)):
        max_symbol, max_log = _KINDS[what]
        if mode == 0:
            t = _PREDEFINED[what]
        elif mode == 1:
            if q >= end:
                _fail(f"{what} RLE symbol truncated")
            if data[q] > max_symbol:
                _fail(f"{what} RLE symbol {data[q]} out of range")
            t = ([data[q]], [0], [0], 0)
            q += 1
        elif mode == 2:
            counts, log, used = _read_distribution(data, q, end, max_symbol, max_log, what)
            t = _fse_table(counts, log, what)
            q += used
        else:
            if what not in fse:
                _fail(f"{what} table repeated with no earlier table")
            t = fse[what]
        fse[what] = t
        tabs.append(t)
    return lit, (nseq, tabs, q, end), huf


def _sequences(data, seq):
    """Decode a block's sequences: three lists (literal lengths, match
    lengths, offset values)."""
    nseq, (llt, oft, mlt), a, b = seq
    bits = _Backward(data[a:b], "sequences")
    rd = bits.read
    ll_sym, ll_nb, ll_base, ll_log = llt
    of_sym, of_nb, of_base, of_log = oft
    ml_sym, ml_nb, ml_base, ml_log = mlt
    ls, os_, ms = rd(ll_log), rd(of_log), rd(ml_log)
    lls, mls, ofs = [0] * nseq, [0] * nseq, [0] * nseq
    for i in range(nseq):
        oc, mc, lc = of_sym[os_], ml_sym[ms], ll_sym[ls]
        ofs[i] = (1 << oc) + rd(oc)
        mls[i] = _ML_BASE[mc] + rd(_ML_BITS[mc])
        lls[i] = _LL_BASE[lc] + rd(_LL_BITS[lc])
        if i + 1 < nseq:
            ls = ll_base[ls] + rd(ll_nb[ls])
            ms = ml_base[ms] + rd(ml_nb[ms])
            os_ = of_base[os_] + rd(of_nb[os_])
    if bits.left != 0:
        _fail("sequences bit stream does not end where its sequences do")
    return lls, mls, ofs


def _execute(out: np.ndarray, op: int, lit: np.ndarray, seqs, reps: list) -> int:
    """Write a block's literals and matches into ``out`` from ``op``;
    ``reps`` (the three repeat offsets) is updated in place."""
    lp = 0
    r1, r2, r3 = reps
    for ll, ml, ov in zip(*seqs):
        if ll:
            if lp + ll > len(lit):
                _fail("sequence takes more literals than the block has")
            out[op:op + ll] = lit[lp:lp + ll]
            op += ll
            lp += ll
        if ov > 3:
            off = ov - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = ov if ll else ov + 1
            if idx == 1:
                off = r1
            elif idx == 2:
                off = r2
                r1, r2 = r2, r1
            elif idx == 3:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    _fail("repeat offset of 0")
                r1, r2, r3 = off, r1, r2
        if off > op:
            _fail("match reaches before the start of the frame")
        src = op - off
        if off >= ml:
            out[op:op + ml] = out[src:src + ml]
        else:
            out[op:op + ml] = np.resize(out[src:op], ml)
        op += ml
    rest = len(lit) - lp
    out[op:op + rest] = lit[lp:]
    reps[:] = [r1, r2, r3]
    return op + rest


def _frame_bytes(data: bytes, frame: _Frame, literals: list) -> bytes:
    """Run a parsed frame's blocks, given every Huffman stream's symbols."""
    plans = []
    need = 0
    for block in frame.blocks:
        if block[0] == "raw":
            need += block[2] - block[1]
            plans.append(block)
            continue
        if block[0] == "rle":
            need += block[2]
            plans.append(block)
            continue
        lit, seq = block[1], block[2]
        if lit[0] == "raw":
            lbytes = np.frombuffer(data, np.uint8, lit[2], lit[1])
        elif lit[0] == "rle":
            lbytes = np.full(lit[2], lit[1], np.uint8)
        else:
            lbytes = (np.concatenate([literals[i] for i in lit[1]]) if len(lit[1]) > 1
                      else literals[lit[1][0]])
        seqs = _sequences(data, seq) if seq is not None else ([], [], [])
        size = len(lbytes) + sum(seqs[1])
        if size > _BLOCK_MAX:
            _fail(f"block decodes to {size} bytes, more than the maximum of {_BLOCK_MAX}")
        need += size
        plans.append(("cmp", lbytes, seqs))
    if frame.size is not None and need != frame.size:
        _fail(f"frame states {frame.size} bytes, its blocks hold {need}")
    out = np.empty(need, np.uint8)
    op = 0
    reps = [1, 4, 8]
    for block in plans:
        if block[0] == "raw":
            n = block[2] - block[1]
            out[op:op + n] = np.frombuffer(data, np.uint8, n, block[1])
            op += n
        elif block[0] == "rle":
            out[op:op + block[2]] = block[1]
            op += block[2]
        else:
            op = _execute(out, op, block[1], block[2], reps)
    result = out.tobytes()
    if frame.checksum is not None and (xxh64(result) & 0xFFFFFFFF) != frame.checksum:
        _fail("content checksum does not match")
    return result


def decompress_many(buffers: Sequence[bytes]) -> List[bytes]:
    """Decompress each buffer (its frames in order, skippable frames
    skipped) and return the results in the same order.  All Huffman
    streams of all buffers are decoded in one walk."""
    streams: list = []
    tables: list = []
    parsed = []
    for data in buffers:
        data = bytes(data)
        frames = []
        pos = 0
        if not data:
            _fail("empty input")
        while pos < len(data):
            if pos + 4 > len(data):
                _fail("truncated frame magic")
            magic = int.from_bytes(data[pos:pos + 4], "little")
            if magic == MAGIC:
                frame, pos = _parse_frame(data, pos, streams, tables)
                frames.append(frame)
            elif magic & 0xFFFFFFF0 == 0x184D2A50:
                if pos + 8 > len(data):
                    _fail("skippable frame header truncated")
                size = int.from_bytes(data[pos + 4:pos + 8], "little")
                if pos + 8 + size > len(data):
                    _fail("skippable frame truncated")
                pos += 8 + size
            else:
                _fail(f"unknown frame magic 0x{magic:08x}")
        parsed.append((data, frames))
    literals = _walk_streams(streams, tables)
    return [b"".join(_frame_bytes(data, f, literals) for f in frames) for data, frames in parsed]


def decompress(data: bytes) -> bytes:
    """Decompress one buffer of zstd frames."""
    return decompress_many([data])[0]
