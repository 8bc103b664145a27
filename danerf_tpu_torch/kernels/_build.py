"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into its own shared library with a
plain C interface under ``build/danerf_tpu_torch/`` at the repository root,
and is bound with ``ctypes``.  A build happens at first use from a CUDA call
(never at import, so the package imports on hosts without ``nvcc``) and is
redone when a source is newer than the library.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "danerf_tpu_torch"
SOURCES = ("march", "merged", "march_bwd", "merged_train", "march_train", "merged_bwd",
           "mlp_fwd", "mlp_bwd", "hier_onepass", "march_f32", "merged_f32", "mlp_fwd_f32",
           "march_bwd_f32", "merged_train_f32", "march_train_f32", "merged_bwd_f32",
           "mlp_bwd_f32", "hier_onepass_f32")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_longlong
# C signatures (csrc/*.cu); every pointer, the stream included, is a
# c_void_p so ctypes does not cut it to 32 bits; the time input t (null
# without use_time) follows the other data inputs.  The tail of the backward
# entry points: transposed weights, their layout record, scratch, n_vecs.
# K1 (mlp_fwd) takes its scratch and its size before the stream.  The f32
# variants of K2 and K5 take their bf16 kernels' arguments with three weight
# pointers in place of the packed bf16 ones (the packed f32 weights and their
# TF32 hi and lo halves), K1's the weights transposed in f32 and none of its
# scratch; those of K6, K7, K8 and K9 take their bf16 kernels' arguments,
# those of K3 and K4 theirs with four forward and two chain weight
# pointers (fused_mlp.fwd_weights, bwd_weights: the weights each reads).
_BWD_TAIL = [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _P]
_SIGNATURES = {
    "march": ("danerf_march", [_P] * 5 + [_I] * 3 + [_P] * 5 + [_P, _P, _P, _I, _P]),
    "merged": ("danerf_merged", [_P] * 7 + [_I] * 4 + [_P] * 5 + [_P, _P, _P, _I, _P]),
    "march_bwd": ("danerf_march_bwd", [_P] * 5 + [_I] * 3 + [_P] * 5 + [_P] * 3 + _BWD_TAIL),
    "merged_train": ("danerf_merged_train", [_P] * 8 + [_I] * 4 + [_P] * 5 + _BWD_TAIL),
    "march_train": ("danerf_march_train", [_P] * 6 + [_I] * 3 + [_P] * 4 + _BWD_TAIL),
    "merged_bwd": ("danerf_merged_bwd", [_P] * 7 + [_I] * 4 + [_P] * 4 + [_P] * 4 + _BWD_TAIL),
    "mlp_fwd": ("danerf_mlp_fwd", [_P] * 4 + [_I] * 2 + [_P] * 2 + [_P, _P, _P, _I, _P, _I, _P]),
    "mlp_bwd": ("danerf_mlp_bwd", [_P] * 4 + [_I] * 2 + [_P] * 2 + [_P] * 3 + _BWD_TAIL),
    "hier_onepass": ("danerf_hier_onepass",
                     [_P] * 7 + [_I] * 4 + [ctypes.c_double] + [_P] * 4 + _BWD_TAIL),
    "march_f32": ("danerf_march_f32",
                  [_P] * 5 + [_I] * 3 + [_P] * 5 + [_P, _P, _P, _P, _P, _I, _P]),
    "merged_f32": ("danerf_merged_f32",
                   [_P] * 7 + [_I] * 4 + [_P] * 5 + [_P, _P, _P, _P, _P, _I, _P]),
    "mlp_fwd_f32": ("danerf_mlp_fwd_f32", [_P] * 4 + [_I] * 2 + [_P] * 2 + [_P, _P, _P, _I, _P]),
}
for _name in ("march_train", "merged_bwd", "mlp_bwd", "hier_onepass"):
    _SIGNATURES[f"{_name}_f32"] = (f"danerf_{_name}_f32", _SIGNATURES[_name][1])
# the f32 K3 and K4 (csrc/field_bwd_f32_sm90.cuh): three more weight
# pointers after the packed f32 weights (their TF32 hi and lo, the weights
# transposed) and one more after the chain's (its hi, then lo)
_TF32_TAIL = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P]
for _name in ("march_bwd", "merged_train"):
    _SIGNATURES[f"{_name}_f32"] = (f"danerf_{_name}_f32",
                                   _SIGNATURES[_name][1][:-len(_BWD_TAIL)] + _TF32_TAIL)
# The scratch size of a backward library, (meta, n_meta, R, s, n_vecs) ->
# bytes: danerf_bwd_scratch_bytes for one row set a tile (K3/K4/K6/K7/K8,
# field_bwd_sm90.cuh's layout), K9's own for its two; the f32 variants'
# their f32 stash: K3's and K4's field_bwd_f32_sm90.cuh's, the others'
# field_bwd_f32.cuh's, K9's again its own.
SCRATCH_FN = {"hier_onepass": "danerf_hier_onepass_scratch_bytes",
              "hier_onepass_f32": "danerf_hier_onepass_f32_scratch_bytes",
              **{f"{n}_f32": "danerf_bwd_f32_scratch_bytes"
                 for n in ("march_train", "merged_bwd", "mlp_bwd")},
              **{f"{n}_f32": "danerf_bwd_tf32_scratch_bytes"
                 for n in ("march_bwd", "merged_train")}}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
                           "the CUDA kernels cannot be built on this host")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, str]:
    """Compile the named sources, all ``nvcc`` processes at once.

    Returns {name: compiler output} for the sources built (``-Xptxas -v``
    prints each kernel's registers, shared memory and spills).  Raises
    RuntimeError naming the source when a build fails.
    """
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        for size_fn in ("danerf_bwd_scratch_bytes", SCRATCH_FN.get(name)):
            if size_fn is not None and hasattr(lib, size_fn):
                getattr(lib, size_fn).argtypes = [_P, _I, _I, _I, _I]
                getattr(lib, size_fn).restype = ctypes.c_longlong
        lib.danerf_error_string.argtypes = [ctypes.c_int]
        lib.danerf_error_string.restype = ctypes.c_char_p
        if hasattr(lib, "danerf_tile_smem_bytes"):  # K1, K2, K5 and their f32 variants
            lib.danerf_tile_smem_bytes.argtypes = []
            lib.danerf_tile_smem_bytes.restype = ctypes.c_longlong
        if hasattr(lib, "danerf_mlp_fwd_scratch_bytes"):  # K1: (N, E) -> bytes
            lib.danerf_mlp_fwd_scratch_bytes.argtypes = [_I, _I]
            lib.danerf_mlp_fwd_scratch_bytes.restype = ctypes.c_longlong
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch function returned non-zero."""
    if code != 0:
        msg = lib.danerf_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed ({code}): {msg}")
