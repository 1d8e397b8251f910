"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
file (all sources at once, in parallel), and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens on first use, never at import, so the package imports on a
machine without ``nvcc`` or a GPU.  The library is cached under
``_build/<hash of the sources and flags>/``, so an edited source rebuilds.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, so a refused launch (too much shared
memory, a bad grid) never passes silently.

``launches`` counts kernel launches by wrapper name.  A wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

launches: collections.Counter = collections.Counter()

_lib = None
build_seconds: float | None = None  # wall time of the build this process ran

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry takes its pointers, floats, ints and the stream last.
_SIGNATURES = {
    "tt_fused_history_encoder": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tt_tile_max_scores": [_P, _P, _P] + [_I] * 6 + [_P],
    "tt_select_topk_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tt_select_topk_radix": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tt_gather_rescore_invert": [_P, _P, _I, _I, _I, _P],
    "tt_gather_rescore": [_P] * 4 + [_I] * 6 + [_P],
    "tt_fused_history_encoder_res": [_P] * 10 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_bwd": [_P] * 10 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_bwd_reduce": [_P, _P, _I, _I, _P],
    "tt_fused_attn_stack": [_P] * 7 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_tc": [_P] * 7 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_res_tc": [_P] * 10 + [_I] * 7 + [_P],
    "tt_fused_attn_stack_tc": [_P] * 7 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_bwd_recompute": [_P] * 11 + [_I] * 7 + [_P],
    "tt_fused_attn_stack_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_bwd_tc": [_P] * 10 + [_I] * 7 + [_P],
    "tt_fused_history_encoder_bwd_recompute_tc": [_P] * 11 + [_I] * 7 + [_P],
    "tt_fused_attn_stack_bwd_tc": [_P] * 11 + [_I] * 7 + [_P],
    "tt_in_batch_ce_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "tt_in_batch_ce_bwd": [_P] * 6 + [_I] * 5 + [_P],
    "tt_in_batch_ce_bwd_reduce": [_P] * 7 + [_I] * 6 + [_P],
    "tt_rows_scatter_add": [_P] * 5 + [_I] * 3 + [_P],
    "tt_rows_write": [_P] * 8 + [_I] * 6 + [_P],
    "tt_fused_mha_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "tt_fused_mha_fwd_tc": [_P] * 7 + [_I] * 6 + [_P],
    "tt_fused_mha_bwd": [_P] * 8 + [_I] * 7 + [_P],
    "tt_fused_mha_bwd_tc": [_P] * 8 + [_I] * 6 + [_P],
    "tt_fused_mha_bwd_reduce": [_P, _P, _I, _I, _P],
    "tt_blockwise_attn_fwd": [_P] * 6 + [_I] * 3 + [_P],
    "tt_blockwise_attn_fwd_tc": [_P] * 6 + [_I] * 4 + [_P],
    "tt_blockwise_attn_dq": [_P] * 8 + [_I] * 3 + [_P],
    "tt_blockwise_attn_dkv": [_P] * 9 + [_I] * 3 + [_P],
    "tt_blockwise_attn_dq_tc": [_P] * 8 + [_I] * 4 + [_P],
    "tt_blockwise_attn_dkv_tc": [_P] * 9 + [_I] * 4 + [_P],
    "tt_fused_adam": [_P] * 5 + [_F] * 6 + [_I] * 3 + [ctypes.c_longlong, _P],
    "tt_approx_scan": [_P] * 5 + [_I] * 6 + [_P],
    "tt_approx_scan_tc": [_P] * 5 + [_I] * 9 + [_P],
}


def reset_launch_counts() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build(out: Path) -> None:
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for cu in cus:  # one nvcc per source, all started together
        obj = tmp / (cu.stem + ".o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
        procs.append((cu, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for cu, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{cu.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib_tmp = tmp / "libtt_kernels.so"
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(lib_tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout)
    os.replace(lib_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [*cus, *headers]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / "libtt_kernels.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _build(out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels' float4
    and cp.async reads): ``t`` itself where it is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once: the
    launch plans read it on every launch."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
