"""zarr v2 arrays over a key-value store, read-only, in Python and numpy.

Orbax keeps each leaf of a checkpoint as a zarr v2 array: ``NAME/.zarray``
(JSON: shape, chunks, dtype, compressor, order, fill value, separator) and
one value per chunk, ``NAME/i.j`` (``NAME/i/j`` with the ``"/"``
separator; ``NAME/0`` for a 0-d array).  The store is an OCDBT store
(``ocdbt.OcdbtStore``, what orbax writes by default) or a plain directory
(``DirectoryStore``, orbax with ``use_ocdbt=False``).

Taken: little-endian numeric dtypes (``<f4``, ``<i4``, ``<u4``, ...), C
order, both separators, chunks smaller than the array (edge chunks are
stored whole and cut), a missing chunk filled with ``fill_value``, and the
compressors ``zstd`` and none.  Refused by name: ``filters``, any other
compressor, ``"order": "F"``, big-endian or structured dtypes, and zarr v3
(``zarr.json``).  ``read_arrays`` decompresses every chunk of the arrays
it is given in one ``zstd.decompress_many`` call.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Dict, Sequence

import numpy as np

from danerf_tpu_torch.utils import zstd

_KINDS = "fiub"          # float, signed, unsigned, bool


class DirectoryStore:
    """A directory as a key-value store: key ``a/b`` is file ``root/a/b``."""

    def __init__(self, root: str):
        if not os.path.isdir(root):
            raise ValueError(f"zarr store {root} is not a directory")
        self.root = root

    def has(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def read(self, key: str) -> bytes:
        path = os.path.join(self.root, key)
        if not os.path.isfile(path):
            raise KeyError(key)
        with open(path, "rb") as f:
            return f.read()


def _meta(store, name: str) -> dict:
    """The ``.zarray`` of array ``name``, checked."""
    if store.has(f"{name}/zarr.json"):
        raise ValueError(f"zarr array {name}: zarr v3 (zarr.json) is not supported; only "
                         "zarr v2 (.zarray) is")
    if not store.has(f"{name}/.zarray"):
        raise ValueError(f"zarr array {name}: no {name}/.zarray in the store")
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr array {name}: zarr_format {meta.get('zarr_format')} is not "
                         "supported; only 2 is")
    if meta.get("filters"):
        raise ValueError(f"zarr array {name}: filters {meta['filters']} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr array {name}: compressor {comp.get('id')!r} is not supported; "
                         "only zstd and none are")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr array {name}: order {meta.get('order')!r} (Fortran) is not "
                         "supported; only C order is")
    dtype = meta.get("dtype")
    if not isinstance(dtype, str) or len(dtype) < 3 or dtype[0] not in "<|" \
            or dtype[1] not in _KINDS:
        raise ValueError(f"zarr array {name}: dtype {dtype!r} is not supported; only "
                         "little-endian numeric dtypes are")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"zarr array {name}: dimension_separator {sep!r} is not supported")
    if len(meta["chunks"]) != len(meta["shape"]) or any(c <= 0 for c in meta["chunks"]):
        raise ValueError(f"zarr array {name}: chunks {meta['chunks']} do not fit shape "
                         f"{meta['shape']}")
    return meta


def _fill(meta: dict, dtype: np.dtype):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[v]
    return np.array(v).astype(dtype)


def read_arrays(store, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Arrays ``names`` of ``store`` as numpy arrays (each ``.zarray``'s
    shape and dtype)."""
    metas = {n: _meta(store, n) for n in names}
    jobs = []          # (array, chunk index, compressed?, bytes)
    for name, meta in metas.items():
        shape, chunks = meta["shape"], meta["chunks"]
        sep = meta.get("dimension_separator", ".")
        grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
        for idx in itertools.product(*grid):
            key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
            if store.has(key):
                jobs.append((name, idx, meta.get("compressor") is not None, store.read(key)))
    packed = [j[3] for j in jobs if j[2]]
    unpacked = iter(zstd.decompress_many(packed) if packed else [])
    out = {}
    for name, meta in metas.items():
        dtype = np.dtype(meta["dtype"])
        out[name] = np.full(meta["shape"], _fill(meta, dtype), dtype)
    for name, idx, compressed, raw in jobs:
        meta = metas[name]
        dtype = np.dtype(meta["dtype"])
        chunks = meta["chunks"]
        data = next(unpacked) if compressed else raw
        want = math.prod(chunks) * dtype.itemsize
        if len(data) != want:
            raise ValueError(f"zarr array {name}: chunk {idx or (0,)} holds {len(data)} bytes, "
                             f"a chunk of {chunks} {meta['dtype']} holds {want} (truncated or "
                             "corrupt)")
        block = np.frombuffer(data, dtype).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, meta["shape"]))
        out[name][region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out
