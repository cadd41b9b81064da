"""ctypes loaders for the repo's native input-pipeline sources.

The port's own counterpart of ``distkeras_tpu/native/__init__.py``:
``native/tokenizer.cc`` (byte-level BPE train / encode / decode, for
``data.tokenizer``) and ``native/dataloader.cc`` (the threaded row
gathers :func:`gather_rows` and :func:`gather_normalize_u8`).  Each
source builds with ``g++`` at first use into the gitignored
``distkeras_tpu_torch/_build/``, under a name keyed by the source and
the flags, so an edited source rebuilds.  As in the reference a failed
build (no compiler) gives ``None`` and the callers take their numpy /
pure-Python path, which returns the same values; the compiler's output
is kept in :data:`build_errors`, and the callers record which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from distkeras_tpu_torch.ops._build import BUILD_DIR
from distkeras_tpu_torch.utils.locks import TracedLock

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_DEF_THREADS = min(8, os.cpu_count() or 1)

# Build-cache lock (leaf): held across the one-time g++ build of a
# source, never on a hot path; traced, so the lock-order sanitizer sees it.
_lock = TracedLock("native.build")
_libs: dict[str, ctypes.CDLL | None] = {}
build_errors: dict[str, str] = {}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "tokenizer": {
        "dkt_bpe_train": (_I32, [_P, _I64, _I32, _P]),
        "dkt_bpe_encode": (_I64, [_P, _I32, _P, _I64, _P]),
        "dkt_bpe_decode": (_I64, [_P, _I32, _P, _I64, _P, _I64]),
    },
    "dataloader": {
        "dkt_gather_f32": (None, [_P, _P, _P, _I64, _I64, ctypes.c_int]),
        "dkt_gather_bytes": (None, [_P, _P, _P, _I64, _I64, ctypes.c_int]),
        "dkt_gather_u8_normalize": (None, [_P, _P, _P, _I64, _I64,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_int]),
    },
}


def library_path(name: str) -> Path:
    """Where ``native/<name>.cc`` builds to: keyed by source and flags."""
    key = hashlib.sha256((NATIVE_DIR / f"{name}.cc").read_bytes())
    key.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libdkt_{name}_{key.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        ["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cc"), "-o", str(tmp)],
        capture_output=True, text=True, timeout=120)
    if res.returncode:
        raise OSError(f"g++ failed for {name}.cc:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str) -> ctypes.CDLL | None:
    """The library of ``native/<name>.cc``, built and loaded once per
    process; None (and the reason in :data:`build_errors`) if it cannot
    be."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        try:
            handle = ctypes.CDLL(str(_build(name)))
        except (OSError, subprocess.SubprocessError) as e:
            build_errors[name] = str(e)
            return None
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(handle, fn).restype = restype
            getattr(handle, fn).argtypes = argtypes
        _libs[name] = handle
        return handle


def bpe_lib() -> ctypes.CDLL | None:
    """The BPE library (``native/tokenizer.cc``), or None."""
    return _load("tokenizer")


def lib() -> ctypes.CDLL | None:
    """The gather library (``native/dataloader.cc``), or None."""
    return _load("dataloader")


def available() -> bool:
    """Does the threaded row-gather library build and load here?"""
    return lib() is not None


def _check_idx(idx, n_rows: int) -> np.ndarray:
    """Bounds-check on both paths (no negative-index wrapping, so numpy
    matches native) and coerce to contiguous int64."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(f"gather index out of range for {n_rows} rows")
    return idx


def _check_out(out: np.ndarray, shape: tuple, dtype) -> np.ndarray:
    if out.shape != shape or out.dtype != np.dtype(dtype):
        raise ValueError(
            f"out buffer mismatch: need {shape} {np.dtype(dtype)}, got "
            f"{out.shape} {out.dtype}")
    if not out.flags.c_contiguous:
        raise ValueError("out buffer must be C-contiguous (reshape of a "
                         "non-contiguous buffer would write into a copy)")
    return out


def gather_rows(src, idx, out: np.ndarray | None = None,
                n_threads: int = _DEF_THREADS) -> np.ndarray:
    """``src[idx]`` on axis 0 of a row-major array, the row copies
    spread over ``n_threads`` when the library is built."""
    handle = lib()
    src = np.ascontiguousarray(src)
    idx = _check_idx(idx, len(src))
    out_shape = (len(idx), *src.shape[1:])
    if out is not None:
        out = _check_out(out, out_shape, src.dtype)
    if handle is None:
        if out is None:
            return src[idx]
        out[...] = src[idx]
        return out
    if out is None:
        out = np.empty(out_shape, src.dtype)
    if idx.size == 0:  # reshape(0, -1) below would raise
        return out
    rows = src.reshape(len(src), -1)
    flat_out = out.reshape(len(idx), -1)
    if src.dtype == np.float32:
        handle.dkt_gather_f32(rows.ctypes.data, idx.ctypes.data,
                              flat_out.ctypes.data, len(idx), rows.shape[1],
                              n_threads)
    else:
        handle.dkt_gather_bytes(
            rows.view(np.uint8).ctypes.data, idx.ctypes.data,
            flat_out.view(np.uint8).ctypes.data, len(idx),
            rows.shape[1] * src.dtype.itemsize, n_threads)
    return out


def gather_normalize_u8(src, idx, scale: float, bias: float = 0.0,
                        out: np.ndarray | None = None,
                        n_threads: int = _DEF_THREADS) -> np.ndarray:
    """``src[idx].astype(f32) * scale + bias`` fused (uint8 images)."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8:
        raise TypeError(f"gather_normalize_u8 needs uint8, got {src.dtype}")
    handle = lib()
    idx = _check_idx(idx, len(src))
    out_shape = (len(idx), *src.shape[1:])
    if out is not None:
        out = _check_out(out, out_shape, np.float32)
    if handle is None:
        result = src[idx].astype(np.float32) * scale + bias
        if out is None:
            return result
        out[...] = result
        return out
    if out is None:
        out = np.empty(out_shape, np.float32)
    if idx.size == 0:
        return out
    handle.dkt_gather_u8_normalize(
        src.reshape(len(src), -1).ctypes.data, idx.ctypes.data,
        out.reshape(len(idx), -1).ctypes.data, len(idx),
        int(np.prod(src.shape[1:])), scale, bias, n_threads)
    return out
