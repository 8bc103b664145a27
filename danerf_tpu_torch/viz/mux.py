"""The four containers of the JAX package's videos, written and read without
an imaging or media library:

- ``.mp4`` and ``.mov``: ISO base media files (``ftyp isom`` or ``ftyp qt
  ``), the ``mdat`` first and the ``moov`` after it; an ``mp4v`` sample
  entry whose ``esds`` carries the stream's headers as its
  DecoderSpecificInfo, and ``stts``, ``stss`` (the I-VOPs), ``stsz``,
  ``stsc`` and ``stco`` (``co64`` past 4 GiB);
- ``.mkv``: Matroska, codec ``V_MPEG4/ISO/SP`` with the headers as
  ``CodecPrivate``, one cluster for each group of pictures, SimpleBlocks
  flagged as key frames on the I-VOPs;
- ``.avi``: RIFF with the ``XVID`` fourcc, one ``00dc`` chunk a frame (the
  headers lead the first one) and an ``idx1`` whose key-frame flag marks
  the I-VOPs.  RIFF's sizes are 32-bit: a file past 4 GiB is refused.

``open_writer(path, ...)`` picks the container by the extension; each
writer takes packets one at a time (``add``) and writes its index on
``close``.  ``demux(path)`` reads any of the four back as (headers,
packets, key flags, frames per second, codec tag).
"""

from __future__ import annotations

import os
import struct
from fractions import Fraction

RIFF_MAX = 0xFFFFFFFF
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _box(tag: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + tag + body


def _full(tag: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes((tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F)) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class _Writer:
    def __init__(self, path: str, headers: bytes, width: int, height: int, fps):
        self.path, self.headers = path, headers
        self.width, self.height = width, height
        self.rate = Fraction(fps).limit_denominator(65535)
        self.sizes, self.keys, self.offsets = [], [], []
        self.f = open(path, "wb")

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.close()
        else:
            self.f.close()
            os.remove(self.path)

    def close(self):
        self.finish()
        self.f.close()


class IsoWriter(_Writer):
    """MP4 (``brand`` b"isom") or QuickTime (b"qt  ")."""

    def __init__(self, path, headers, width, height, fps, brand=b"isom"):
        super().__init__(path, headers, width, height, fps)
        if brand == b"qt  ":
            ftyp = _box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  ")
        else:
            ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
        self.f.write(ftyp)
        self.mdat = len(ftyp)
        self.f.write(struct.pack(">I4sQ", 1, b"mdat", 0))     # 64-bit size, set on close
        self.pos = self.mdat + 16

    def add(self, packet: bytes, key: bool):
        self.f.write(packet)
        self.offsets.append(self.pos)
        self.sizes.append(len(packet))
        self.keys.append(key)
        self.pos += len(packet)

    def finish(self):
        n = len(self.sizes)
        timescale, delta = self.rate.numerator, self.rate.denominator
        duration = n * delta
        movie_ms = duration * 1000 // timescale
        esds = _full(b"esds", 0, 0, _descriptor(3, struct.pack(">HB", 1, 0) + _descriptor(
            4, struct.pack(">BB", 0x20, 0x11) + bytes(3)
            + struct.pack(">II", 0, 0) + _descriptor(5, self.headers))
            + _descriptor(6, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 24, -1), esds)
        wide = self.pos > RIFF_MAX
        chunk_offsets = (_full(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self.offsets)) if wide
                         else _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self.offsets)))
        key_numbers = [i + 1 for i, k in enumerate(self.keys) if k]
        stbl = _box(b"stbl",
                    _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                    _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
                    _full(b"stss", 0, 0, struct.pack(f">I{len(key_numbers)}I", len(key_numbers),
                                                     *key_numbers)),
                    _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
                    _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes)),
                    chunk_offsets)
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                    _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full(b"url ", 0, 1))), stbl)
        mdia = _box(b"mdia",
                    _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                                     0x55C4, 0)),
                    _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0"),
                    minf)
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", self.width << 16, self.height << 16))
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, movie_ms, 0x10000, 0x100),
                     bytes(10), _MATRIX, bytes(24), struct.pack(">I", 2))
        self.f.write(_box(b"moov", mvhd, _box(b"trak", tkhd, mdia)))
        self.f.seek(self.mdat + 8)
        self.f.write(struct.pack(">Q", self.pos - self.mdat))


# ---------------------------------------------------------------- Matroska

def _ebml_id(i: int) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big")


def _vint(n: int, width: int = 0) -> bytes:
    width = width or next(w for w in range(1, 9) if n < (1 << (7 * w)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def _el(i: int, body) -> bytes:
    if isinstance(body, int):
        body = body.to_bytes(max(1, (body.bit_length() + 7) // 8), "big")
    elif isinstance(body, float):
        body = struct.pack(">d", body)
    elif isinstance(body, str):
        body = body.encode()
    return _ebml_id(i) + _vint(len(body)) + body


class MkvWriter(_Writer):
    """Matroska, one cluster a group of pictures."""

    def __init__(self, path, headers, width, height, fps):
        super().__init__(path, headers, width, height, fps)
        ebml = _el(0x1A45DFA3, _el(0x4286, 1) + _el(0x42F7, 1) + _el(0x42F2, 4)
                   + _el(0x42F3, 8) + _el(0x4282, "matroska") + _el(0x4287, 4)
                   + _el(0x4285, 2))
        self.f.write(ebml)
        self.segment = len(ebml)
        self.f.write(_ebml_id(0x18538067) + _vint(0, 8))      # size set on close
        frame_ns = round(1e9 / self.rate)
        video = _el(0xE0, _el(0xB0, width) + _el(0xBA, height))
        track = _el(0xAE, _el(0xD7, 1) + _el(0x73C5, 1) + _el(0x9C, 0) + _el(0x83, 1)
                    + _el(0x86, "V_MPEG4/ISO/SP") + _el(0x63A2, headers)
                    + _el(0x23E383, frame_ns) + video)
        self.info_at = self.f.tell()
        self.f.write(self._info(0.0))
        self.f.write(_el(0x1654AE6B, track))
        self.cluster = []
        self.count = 0

    def _info(self, duration_ms: float) -> bytes:
        return _el(0x1549A966, _el(0x2AD7B1, 1000000) + _el(0x4D80, "danerf")
                   + _el(0x5741, "danerf") + _el(0x4489, float(duration_ms)))

    def _ms(self, i: int) -> int:
        return round(i * 1000 / self.rate)

    def add(self, packet: bytes, key: bool):
        if key or (self.cluster and self._ms(self.count) - self._ms(self.cluster[0][0]) > 30000):
            self._flush()
        self.cluster.append((self.count, packet, key))
        self.count += 1

    def _flush(self):
        if not self.cluster:
            return
        start = self._ms(self.cluster[0][0])
        blocks = b"".join(
            _el(0xA3, b"\x81" + struct.pack(">hB", self._ms(i) - start, 0x80 if key else 0)
                + packet) for i, packet, key in self.cluster)
        self.f.write(_el(0x1F43B675, _el(0xE7, start) + blocks))
        self.cluster = []

    def finish(self):
        self._flush()
        end = self.f.tell()
        self.f.seek(self.info_at)
        self.f.write(self._info(float(self._ms(self.count))))
        self.f.seek(self.segment + 4)
        self.f.write(_vint(end - self.segment - 12, 8))


# ---------------------------------------------------------------- AVI

class AviWriter(_Writer):
    """RIFF AVI with the XVID fourcc; the stream headers lead the first
    chunk."""

    HEADER = 12 + 8 + 4 + (8 + 56) + 8 + 4 + (8 + 56) + (8 + 40) + 12

    def __init__(self, path, headers, width, height, fps):
        super().__init__(path, headers, width, height, fps)
        self.f.write(bytes(self.HEADER))
        self.pos = 4                                  # chunk offsets from the "movi" tag

    def add(self, packet: bytes, key: bool):
        if not self.sizes:
            packet = self.headers + packet
        size = len(packet)
        riff = self.HEADER - 8 + self.pos - 4 + 8 + size + (size & 1) + 8 \
            + 16 * (len(self.sizes) + 1)
        if riff > RIFF_MAX:
            raise ValueError(f"frame {len(self.sizes)} would take the AVI past 4 GiB, the most "
                             "a RIFF AVI holds: write fewer frames or pass a smaller resolution, "
                             "or use an .mp4 name")
        self.f.write(b"00dc" + struct.pack("<I", size) + packet + bytes(size & 1))
        self.offsets.append(self.pos)
        self.sizes.append(size)
        self.keys.append(key)
        self.pos += 8 + size + (size & 1)

    def finish(self):
        n = len(self.sizes)
        idx = b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME if k else 0, o, s)
                       for o, s, k in zip(self.offsets, self.sizes, self.keys))
        self.f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        end = self.f.tell()
        rate, scale = self.rate.numerator, self.rate.denominator
        biggest = max(self.sizes, default=0)
        usec = round(1e6 * scale / rate)
        avih = struct.pack("<14I", usec, min(RIFF_MAX, biggest * rate // scale), 0,
                           _AVIF_HASINDEX, n, 0, 1, biggest, self.width, self.height, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"XVID", 0, 0, 0, 0, scale, rate, 0,
                           n, biggest, 0xFFFFFFFF, 0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"XVID",
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = b"strl" + b"strh" + struct.pack("<I", 56) + strh + b"strf" \
            + struct.pack("<I", 40) + strf
        hdrl = b"hdrl" + b"avih" + struct.pack("<I", 56) + avih + b"LIST" \
            + struct.pack("<I", len(strl)) + strl
        head = (b"RIFF" + struct.pack("<I", end - 8) + b"AVI " + b"LIST"
                + struct.pack("<I", len(hdrl)) + hdrl + b"LIST"
                + struct.pack("<I", self.pos) + b"movi")
        assert len(head) == self.HEADER
        self.f.seek(0)
        self.f.write(head)


CONTAINERS = {".mp4": (IsoWriter, {"brand": b"isom"}), ".mov": (IsoWriter, {"brand": b"qt  "}),
              ".mkv": (MkvWriter, {}), ".avi": (AviWriter, {})}


def open_writer(path: str, headers: bytes, width: int, height: int, fps):
    """The writer for ``path``'s extension (one of ``CONTAINERS``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in CONTAINERS:
        raise ValueError(f"{path}: no container for {ext!r}; one of {sorted(CONTAINERS)}")
    cls, kw = CONTAINERS[ext]
    return cls(path, headers, width, height, fps, **kw)


# ---------------------------------------------------------------- readers

def _iso_boxes(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise ValueError("ISO media file: a box smaller than its header")
        yield tag, pos + head, pos + size
        pos += size


def _iso_find(data, pos, end, path):
    for tag, body, stop in _iso_boxes(data, pos, end):
        if tag == path[0]:
            return (body, stop) if len(path) == 1 else _iso_find(data, body, stop, path[1:])
    raise ValueError(f"ISO media file: no {b'/'.join(path).decode()} box")


def _descriptors(data: bytes, pos: int, end: int):
    while pos < end:
        tag = data[pos]
        n, pos = 0, pos + 1
        while True:
            b = data[pos]
            pos += 1
            n = (n << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        yield tag, pos, pos + n
        pos += n


def _read_iso(data: bytes):
    moov = _iso_find(data, 0, len(data), [b"moov"])
    trak = None
    for tag, body, stop in _iso_boxes(data, *moov):
        if tag == b"trak":
            hdlr = _iso_find(data, body, stop, [b"mdia", b"hdlr"])
            if data[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                trak = (body, stop)
                break
    if trak is None:
        raise ValueError("ISO media file: no video track")
    mdhd = _iso_find(data, *trak, [b"mdia", b"mdhd"])[0]
    if data[mdhd] != 0:
        raise ValueError("ISO media file: a version-1 mdhd is not read")
    timescale = struct.unpack(">I", data[mdhd + 12:mdhd + 16])[0]
    stbl = _iso_find(data, *trak, [b"mdia", b"minf", b"stbl"])
    boxes = {tag: (body, stop) for tag, body, stop in _iso_boxes(data, *stbl)}
    stsd = boxes[b"stsd"][0]
    entry_tag = data[stsd + 12:stsd + 16]
    if entry_tag != b"mp4v":
        raise ValueError(f"ISO media file: sample entry {entry_tag!r}, only mp4v is read")
    entry = stsd + 16
    esds = _iso_find(data, entry + 78, stsd + 8 + struct.unpack(">I", data[stsd + 8:stsd + 12])[0],
                     [b"esds"])
    headers = b""
    for tag, body, stop in _descriptors(data, esds[0] + 4, esds[1]):
        if tag == 3:
            flags = data[body + 2]
            sub = body + 3 + (2 if flags & 0x80 else 0) + (1 + data[body + 3] if flags & 0x40
                                                             else 0) + (2 if flags & 0x20 else 0)
            for t4, b4, s4 in _descriptors(data, sub, stop):
                if t4 == 4:
                    if data[b4] != 0x20:
                        raise ValueError(f"ISO media file: object type 0x{data[b4]:02x}, "
                                         "only MPEG-4 Visual (0x20) is read")
                    for t5, b5, s5 in _descriptors(data, b4 + 13, s4):
                        if t5 == 5:
                            headers = data[b5:s5]

    def table(tag, fmt):
        """The entries of a full box whose count follows its flags; ``fmt``
        one entry's fields, all of one type."""
        body = boxes[tag][0]
        n = struct.unpack(">I", data[body + 4:body + 8])[0]
        end = body + 8 + n * struct.calcsize(">" + fmt)
        return struct.unpack(f">{n * len(fmt)}{fmt[0]}", data[body + 8:end])

    stsz = boxes[b"stsz"][0]
    fixed, n = struct.unpack(">II", data[stsz + 4:stsz + 12])
    sizes = ([fixed] * n if fixed
             else list(struct.unpack(f">{n}I", data[stsz + 12:stsz + 12 + 4 * n])))
    offsets = list(table(b"co64", "Q")) if b"co64" in boxes else list(table(b"stco", "I"))
    stsc = table(b"stsc", "III")
    runs = [stsc[i:i + 3] for i in range(0, len(stsc), 3)]
    starts = []
    for c in range(len(offsets)):
        per = next(r[1] for r in reversed(runs) if r[0] <= c + 1)
        pos = offsets[c]
        for _ in range(per):
            starts.append(pos)
            pos += sizes[len(starts) - 1]
    packets = [data[p:p + s] for p, s in zip(starts, sizes)]
    keys = [True] * n
    if b"stss" in boxes:
        marked = set(table(b"stss", "I"))
        keys = [i + 1 in marked for i in range(n)]
    stts = table(b"stts", "II")
    count = sum(stts[0::2])
    ticks = sum(c * d for c, d in zip(stts[0::2], stts[1::2]))
    fps = Fraction(count * timescale, ticks) if ticks else Fraction(0)
    return headers, packets, keys, fps, b"mp4v"


def _vint_at(data: bytes, pos: int, keep_marker: bool = False):
    first = data[pos]
    width = 9 - first.bit_length()
    if width > 8:
        raise ValueError("Matroska: an invalid length")
    v = int.from_bytes(data[pos:pos + width], "big")
    if not keep_marker:
        v &= (1 << (7 * width)) - 1
        if v == (1 << (7 * width)) - 1:
            v = -1                                            # unknown size
    return v, pos + width


def _ebml(data: bytes, pos: int, end: int):
    while pos < end:
        i, p = _vint_at(data, pos, keep_marker=True)
        n, p = _vint_at(data, p)
        stop = end if n < 0 else p + n
        yield i, p, stop
        pos = stop


def _read_mkv(data: bytes):
    headers, packets, keys, fps, track = b"", [], [], Fraction(0), None
    segment = next((b, s) for i, b, s in _ebml(data, 0, len(data)) if i == 0x18538067)
    for i, b, s in _ebml(data, *segment):
        if i == 0x1654AE6B:
            for ti, tb, ts in _ebml(data, b, s):
                if ti != 0xAE:
                    continue
                f = {ei: data[eb:es] for ei, eb, es in _ebml(data, tb, ts)}
                if int.from_bytes(f.get(0x83, b"\0"), "big") != 1:
                    continue
                codec = f.get(0x86, b"").decode()
                if not codec.startswith("V_MPEG4/ISO/"):
                    raise ValueError(f"Matroska: codec {codec!r}, only MPEG-4 Part 2 is read")
                track = int.from_bytes(f[0xD7], "big")
                headers = f.get(0x63A2, b"")
                if 0x23E383 in f:
                    fps = Fraction(10 ** 9, int.from_bytes(f[0x23E383], "big")) \
                        .limit_denominator(1001)                # nanoseconds round the rate
        elif i == 0x1F43B675:
            for ci, cb, cs in _ebml(data, b, s):
                if ci != 0xA3:
                    continue
                number, p = _vint_at(data, cb)
                if number != track:
                    continue
                flags = data[p + 2]
                if flags & 0x06:
                    raise ValueError("Matroska: laced blocks are not read")
                packets.append(data[p + 3:cs])
                keys.append(bool(flags & 0x80))
    if track is None:
        raise ValueError("Matroska: no video track")
    return headers, packets, keys, fps, codec.encode()


def _read_avi(data: bytes):
    info, packets, keys = {}, [], []
    movi = []

    def walk(pos, end):
        while pos + 8 <= end:
            tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if tag == b"LIST":
                if data[body:body + 4] == b"movi":
                    movi.append(body)
                walk(body + 4, body + size)
            elif tag == b"strh" and data[body:body + 4] == b"vids":
                info["scale"], info["rate"] = struct.unpack("<II", data[body + 20:body + 28])
            elif tag == b"strf" and "comp" not in info:
                info["comp"] = data[body + 16:body + 20]
            elif tag == b"00dc":
                packets.append(data[body:body + size])
            elif tag == b"idx1":
                for p in range(body, body + size, 16):
                    ck, flags = struct.unpack("<4sI", data[p:p + 8])
                    if ck == b"00dc":
                        keys.append(bool(flags & _AVIIF_KEYFRAME))
            pos = body + size + (size & 1)

    walk(12, len(data))
    if info.get("comp", b"").upper() not in (b"XVID", b"FMP4", b"DIVX", b"DX50", b"MP4V"):
        raise ValueError(f"AVI: compression {info.get('comp')!r}, only MPEG-4 Part 2 is read")
    if len(keys) != len(packets):
        keys = [p.find(b"\x00\x00\x01\xb6") >= 0
                and (p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6) == 0 for p in packets]
    return b"", packets, keys, Fraction(info["rate"], info["scale"]), info["comp"]


def demux(path: str):
    """(headers, packets, key flags, frames per second as a Fraction, codec
    tag: b"mp4v", the Matroska codec ID or the AVI fourcc) of an MP4, MOV,
    Matroska or AVI file of MPEG-4 Part 2 video; the container is told by
    the file's first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[4:8] == b"ftyp":
            return _read_iso(data)
        if data[:4] == b"\x1a\x45\xdf\xa3":
            return _read_mkv(data)
        if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
            return _read_avi(data)
    except (struct.error, IndexError, KeyError, StopIteration) as e:
        raise ValueError(f"{path}: corrupt or truncated video ({e!r})") from None
    raise ValueError(f"{path}: not an MP4, MOV, Matroska or AVI file")
