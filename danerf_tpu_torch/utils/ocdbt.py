"""A read-only reader of OCDBT key-value stores, tensorstore's
"Optionally-Cooperative Distributed B+Tree" format, in Python and numpy.

Orbax writes a checkpoint's arrays into one such store
(``checkpoint_NNNNNN/state/``): ``manifest.ocdbt`` at its root names the
latest version of a B+tree whose nodes and out-of-line values live in data
files (``d/<hex>`` and, for a store merged from per-process stores,
``ocdbt.process_<i>/d/<hex>``).  ``OcdbtStore(root).list()`` gives every
key of the latest version, ``read(key)`` one value.

Format (tensorstore's published OCDBT format): every manifest and node is
a header (a magic number, its length as uint64le, a format version varint,
a compression varint: 0 none, 1 zstd), a body compressed so, and a CRC-32C
of everything before it.  Bodies are column-wise: varints, then the byte
strings.  A data file table (paths prefix-coded against the previous path,
each a base path and a relative path, resolved against the store's root)
begins the version tree and every B+tree node; an interior node's entries
give each child's first key, the prefix its keys share (stored without
it), its location (data file, offset, length) and statistics; a leaf's
give each key's value, inline or by location.  A manifest it cannot
follow raises ``ValueError`` naming the field.
"""

from __future__ import annotations

import os
from typing import Dict, List

from danerf_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_VERSION = 0

_CRC32C = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC32C.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC32C
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Body:
    """A cursor over a decoded body; running out of bytes names the field."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int, field: str) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: truncated in {field}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self, field: str) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError(f"OCDBT {self.what}: truncated in {field}")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: {field} varint is too long")

    def varints(self, n: int, field: str) -> List[int]:
        return [self.varint(field) for _ in range(n)]


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or node file ``raw``."""
    if len(raw) < 18:
        raise ValueError(f"OCDBT {what}: truncated header ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"OCDBT {what}: magic 0x{got:08x}, expected 0x{magic:08x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"OCDBT {what}: header length {length}, the file holds {len(raw)} "
                         "bytes (truncated or corrupt)")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT {what}: CRC-32C checksum does not match")
    head = _Body(raw[12:-4], what)
    version = head.varint("format version")
    if version != _VERSION:
        raise ValueError(f"OCDBT {what}: format version {version} is not supported")
    compression = head.varint("compression format")
    rest = raw[12 + head.pos:-4]
    if compression == 0:
        return rest
    if compression == 1:
        return zstd.decompress(rest)
    raise ValueError(f"OCDBT {what}: compression format {compression} is not supported")


def _data_file_table(body: _Body) -> List[str]:
    """The data file table: each file's path (base path + relative path)."""
    n = body.varint("data file count")
    prefix = [0] + body.varints(max(n - 1, 0), "data file path prefix length")
    suffix = body.varints(n, "data file path suffix length")
    base = body.varints(n, "data file base path length")
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {body.what}: data file path prefix length {prefix[i]} "
                             "exceeds the previous path")
        path = prev[:prefix[i]] + body.take(suffix[i], "data file path")
        if base[i] > len(path):
            raise ValueError(f"OCDBT {body.what}: data file base path length {base[i]} "
                             "exceeds its path")
        paths.append(path.decode())
        prev = path
    return paths


class OcdbtStore:
    """The latest version of the OCDBT store whose ``manifest.ocdbt`` is in
    directory ``root``."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        self._values: Dict[bytes, tuple] = {}
        self.config, loc = self._manifest()
        if loc is not None:
            self._walk(loc, b"", "root")

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            if not os.path.exists(path):
                raise ValueError(f"OCDBT store {self.root}: data file {rel} is missing")
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int, what: str) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise ValueError(f"OCDBT {what}: {rel}[{offset}:{offset + length}] lies past the "
                             f"end of the file ({len(data)} bytes; truncated)")
        return data[offset:offset + length]

    def _manifest(self):
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise ValueError(f"OCDBT store {self.root}: no manifest.ocdbt")
        with open(path, "rb") as f:
            body = _Body(_unframe(f.read(), MANIFEST_MAGIC, "manifest"), "manifest")
        config = {"uuid": body.take(16, "uuid").hex()}
        kind = body.varint("manifest_kind")
        if kind != 0:
            raise ValueError(f"OCDBT manifest: manifest_kind {kind} (numbered manifests) is "
                             "not supported; only a single manifest file is")
        config["max_inline_value_bytes"] = body.varint("max_inline_value_bytes")
        config["max_decoded_node_bytes"] = body.varint("max_decoded_node_bytes")
        config["version_tree_arity_log2"] = body.take(1, "version_tree_arity_log2")[0]
        method = body.varint("compression method")
        if method == 1:
            config["zstd_level"] = int.from_bytes(body.take(4, "zstd level"), "little",
                                                  signed=True)
        elif method != 0:
            raise ValueError(f"OCDBT manifest: compression method {method} is not supported")
        files = _data_file_table(body)
        n = body.varint("version count")
        if n == 0:
            return config, None
        gen = body.varints(n, "generation_number")
        height = list(body.take(n, "root_height"))
        fid = body.varints(n, "root data file id")
        off = body.varints(n, "root offset")
        length = body.varints(n, "root length")
        keys = body.varints(n, "root num_keys")
        last = max(range(n), key=gen.__getitem__)
        config["generation_number"] = gen[last]
        config["root_height"] = height[last]
        config["num_keys"] = keys[last]
        if keys[last] == 0:
            return config, None
        if fid[last] >= len(files):
            raise ValueError(f"OCDBT manifest: root data file id {fid[last]} is outside its "
                             f"table of {len(files)}")
        return config, (files[fid[last]], off[last], length[last], height[last])

    def _walk(self, loc, prefix: bytes, what: str):
        rel, offset, length, want = loc
        where = f"B+tree node {rel}:{offset}:{length} ({what})"
        raw = self._slice(rel, offset, length, where)
        body = _Body(_unframe(raw, BTREE_MAGIC, where), where)
        height = body.take(1, "height")[0]
        if want is not None and height != want:
            raise ValueError(f"OCDBT {where}: height {height}, its parent says {want}")
        files = _data_file_table(body)
        n = body.varint("entry count")
        kpre = [0] + body.varints(max(n - 1, 0), "key prefix length")
        ksuf = body.varints(n, "key suffix length")
        common = body.varints(n, "subtree common prefix length") if height else None
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            if kpre[i] > len(prev):
                raise ValueError(f"OCDBT {where}: key prefix length {kpre[i]} exceeds the "
                                 "previous key")
            prev = prev[:kpre[i]] + body.take(ksuf[i], "key")
            keys.append(prev)

        def located(count, field):
            fid = body.varints(count, f"{field} data file id")
            for f in fid:
                if f >= len(files):
                    raise ValueError(f"OCDBT {where}: {field} data file id {f} is outside its "
                                     f"table of {len(files)}")
            return fid

        if height:
            fid = located(n, "child")
            off = body.varints(n, "child offset")
            ln = body.varints(n, "child length")
            for field in ("num_keys", "num_tree_bytes", "num_indirect_value_bytes"):
                body.varints(n, field)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"OCDBT {where}: subtree common prefix length "
                                     f"{common[i]} exceeds its key")
                self._walk((files[fid[i]], off[i], ln[i], height - 1),
                           prefix + keys[i][:common[i]], what)
            return
        vlen = body.varints(n, "value length")
        kind = list(body.take(n, "value kind"))
        if any(k > 1 for k in kind):
            raise ValueError(f"OCDBT {where}: value kind {max(kind)} is not supported")
        indirect = [i for i in range(n) if kind[i] == 1]
        fid = located(len(indirect), "value")
        off = body.varints(len(indirect), "value offset")
        for j, i in enumerate(indirect):
            self._values[prefix + keys[i]] = ("file", files[fid[j]], off[j], vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[prefix + keys[i]] = ("inline", body.take(vlen[i], "inline value"))
        if body.pos != len(body.data):
            raise ValueError(f"OCDBT {where}: {len(body.data) - body.pos} bytes after its "
                             "last inline value")

    def list(self) -> List[str]:
        """Every key of the latest version, sorted."""
        return [k.decode() for k in sorted(self._values)]

    def has(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        """The value of ``key`` (``KeyError`` when the store has none)."""
        v = self._values.get(key.encode())
        if v is None:
            raise KeyError(key)
        if v[0] == "inline":
            return v[1]
        return self._slice(v[1], v[2], v[3], f"value of {key}")
