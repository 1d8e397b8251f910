"""Host-side batch hashing of raw entity keys, in C++ with a numpy fallback.

The port's counterpart of the JAX package's ``native`` module, with the same
functions and the same slots: ``hash_ids`` (uint64 keys) and
``hash_strings`` (str or bytes keys) map raw keys to int32 slots in
[0, table_size) with an xxHash64-style avalanche mix, stable across
processes and platforms, which checkpointed embedding tables require
(Python's ``hash`` is salted per process).

``hashing.cpp`` beside this file is compiled with the host's C++ compiler
(``c++``, ``g++`` or ``clang++``; ``CXX_FLAGS``) on the first call, never at
import, into ``_build/hashing-<hash of source and flags>/`` of this package,
and loaded with ``ctypes``.  Where no compiler builds it, the numpy twin
runs instead; the compiler's error stays readable (``build_error``) and
``calls`` counts every call by the path it took (``"cpp"`` or
``"numpy"``), as ``ops._lib.launches`` counts kernels, so a run can show
that the C++ path served it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "hashing.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
COMPILERS = ("c++", "g++", "clang++")

calls: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_error: Optional[str] = None  # set once a build failed: the compilers' output

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)


def reset_calls() -> None:
    calls.clear()


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"hashing-{h.hexdigest()[:16]}" / "_hashing.so"


def _compile(out: Path) -> Optional[str]:
    """Build ``out`` with the first compiler that succeeds: None, or every
    compiler's error.  The library is written to a temporary file and moved
    into place, so processes that build at once never load a partial one."""
    out.parent.mkdir(parents=True, exist_ok=True)
    errors = []
    for cxx in COMPILERS:
        exe = shutil.which(cxx)
        if exe is None:
            errors.append(f"{cxx}: not found")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            res = subprocess.run([exe, *CXX_FLAGS, "-o", tmp, str(_SRC)],
                                 capture_output=True, text=True)
            if res.returncode == 0:
                os.replace(tmp, out)
                return None
            errors.append(f"{cxx} (exit {res.returncode}):\n{res.stderr}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return "\n".join(errors)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_path, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        out = _target()
        if not out.exists():
            try:
                _error = _compile(out)
            except OSError as e:  # e.g. a read-only package directory
                _error = f"building {out}: {e}"
            if _error is not None:
                return None
        lib = ctypes.CDLL(str(out))
        lib.hash_ids_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.hash_ids_bytes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.hash_ids_u64.restype = None
        lib.hash_ids_bytes.restype = None
        _lib, _lib_path = lib, out
        return lib


def native_available() -> bool:
    """Whether the C++ path is built and loaded (building it if need be)."""
    return _load() is not None


def library_path() -> Optional[Path]:
    """The loaded library's path, under ``BUILD_DIR``; None without one."""
    _load()
    return _lib_path


def build_error() -> Optional[str]:
    """The compilers' output from a build that failed in this process, or None."""
    _load()
    return _error


def _check_table_size(table_size: int) -> None:
    # slots must fit int32, and a size of 0 would divide by zero in C++
    if not 1 <= table_size <= 1 << 31:
        raise ValueError(f"table_size must be in [1, 2^31], got {table_size}")


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(33))
    x = x * _P2
    x = x ^ (x >> np.uint64(29))
    x = x * _P3
    return x ^ (x >> np.uint64(32))


def _hash_u64_np(keys: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized numpy twin of the C++ uint64 hash (bit-identical).  The
    products wrap modulo 2^64 on purpose: call under
    ``np.errstate(over="ignore")``."""
    h = np.uint64(seed) + _P1
    h = h ^ _mix64(keys * _P2)
    return _mix64(_rotl(h, 27) * _P1 + _P2)


def _hash_bytes_np(raw: Sequence[bytes], table_size: int, seed: int) -> np.ndarray:
    """Python twin of the C++ byte hash (bit-identical), one key at a time."""
    out = np.empty(len(raw), np.int32)
    with np.errstate(over="ignore"):
        for i, r in enumerate(raw):
            h = np.uint64(seed) + _P1 + np.uint64(len(r))
            j = 0
            while j + 8 <= len(r):
                w = np.uint64(int.from_bytes(r[j : j + 8], "little"))
                h = _rotl(h ^ _mix64(w * _P2), 27) * _P1 + _P2
                j += 8
            tail = np.uint64(int.from_bytes(r[j:], "little")) if j < len(r) else np.uint64(0)
            h = _rotl(h ^ _mix64(tail * _P2), 27) * _P1 + _P2
            out[i] = int(_mix64(h) % np.uint64(table_size))
    return out


def hash_ids(ids, table_size: int, seed: int = 0, force_fallback: bool = False) -> np.ndarray:
    """Raw uint64 entity ids -> int32 table slots in [0, table_size), in the
    input's shape."""
    _check_table_size(table_size)
    keys = np.ascontiguousarray(np.asarray(ids, dtype=np.uint64).reshape(-1))
    lib = None if force_fallback else _load()
    if lib is not None:
        calls["cpp"] += 1
        out = np.empty(keys.shape, np.uint32)
        lib.hash_ids_u64(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            keys.size, seed, table_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
    else:
        calls["numpy"] += 1
        with np.errstate(over="ignore"):
            out = (_hash_u64_np(keys, seed) % np.uint64(table_size)).astype(np.uint32)
    return out.astype(np.int32).reshape(np.asarray(ids).shape)


def hash_strings(
    keys: Sequence[str | bytes], table_size: int, seed: int = 0, force_fallback: bool = False,
) -> np.ndarray:
    """String or bytes entity keys -> int32 table slots in [0, table_size),
    flat; a ``str`` key hashes as its UTF-8 bytes."""
    _check_table_size(table_size)
    for k in keys:
        if not isinstance(k, (str, bytes)):
            # bytes(int) would allocate that many ZERO bytes: an int key
            # here is a routing bug (use hash_ids), never a valid encoding
            raise TypeError(f"hash_strings takes str/bytes keys, got {type(k)}")
    raw = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
    lib = None if force_fallback else _load()
    if lib is None:
        calls["numpy"] += 1
        return _hash_bytes_np(raw, table_size, seed)
    calls["cpp"] += 1
    # an empty key list still hands the C++ side a valid pointer
    blob = np.frombuffer(b"".join(raw), np.uint8) if raw else np.empty(0, np.uint8)
    blob = np.ascontiguousarray(blob)
    offsets = np.zeros(len(raw) + 1, np.int64)
    np.cumsum([len(r) for r in raw], out=offsets[1:])
    out = np.empty(len(raw), np.uint32)
    lib.hash_ids_bytes(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(raw), seed, table_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out.astype(np.int32)
