"""Approximate top-k of inner products: the port's ``lax.approx_max_k``.

The JAX package's approximate MIPS scores the whole [B, C] matrix and calls
``lax.approx_max_k(scores, k, recall_target)`` (``aggregate_to_topk=True``),
which the TPU reduces in hardware (XLA's PartialReduce).  The port does the
same reduction without the score matrix, in three parts:

  1. ``approx_bins(n, k, recall_target)``: the number of bins M, equal to
     XLA's ``ApproxTopKReductionOutputSize`` for a rank-2 operand.
  2. ``approx_scan`` (N1, csrc/approx_scan.cu, launch counter
     ``approx_scan``): for each query and bin j < M the largest score over
     the rows c = j (mod M), in the select's total order (``f32_keys``), a
     tie to the lowest row, and that row.  The corpus is f32 or bf16 rows,
     or int8 rows with a per-row scale (the score is the int8 dot times the
     row's scale, as ``retrieval/quant.py:quantized_scores`` has it).
     ``scan_route`` picks the kernel: ``approx_scan_tc_kernel`` on the
     tensor cores (``wgmma``; counter ``approx_scan_tc`` beside
     ``approx_scan``) for D % 8 == 0 (int8: D % 16 == 0), D <= 128, whose
     f32 scores are 3xTF32 sums within 1e-5 of each query's scale of the
     plain version's; else ``approx_scan_kernel`` on the CUDA cores (f32
     rows with D % 4 == 0, a bf16 corpus widened first), whose f32 scores
     are the fmaf chain in d order.  On integer grids both are bit-equal
     to the plain version.
  3. ``approx_max_k``: the exact top-k of the M bin maxima through
     ``select_rows`` (B3), ties to the lowest bin, then each chosen bin's row.

Where M = C every bin is one row and the result is the exact top-k, equal to
the dense scan including its tie order.  Otherwise a bin keeps only its best
row, so two of the true top k in one bin lose one: the recall the formula
aims at.  JAX's ``approx_max_k`` sorts exactly on the CPU; this one is
approximate on every device.

Beside the wrapper is its plain PyTorch version: a CPU tensor takes it, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
import struct

import torch

from two_tower_models_tpu_torch.ops import _lib
from two_tower_models_tpu_torch.ops.mips_topk import (
    _check_cuda,
    f32_keys,
    keys_f32,
    select_rows,
)

_TILING = 128  # XLA's TPU tiling of a rank-2 operand's last axis
_INT_MIN = -(1 << 31)
_PLAIN_CHUNK_ELEMS = 1 << 26  # (query, row) scores the plain version holds at once
MAX_D = 128  # both kernels' widest row (csrc/approx_scan.cu MAX_D)
_TQ, _NB = 64, 64  # queries and bins a block (csrc/approx_scan.cu TQ, NB; tc::QW, tc::NB)
ROW_KINDS = ("f32", "int8", "bf16")  # approx_scan_tc_kernel's ROWS, in order
_ELSIZE = {"f32": 4, "int8": 1, "bf16": 2}
_TC_MAX_STAGES, _TC_MAX_TILES = 4, 3  # tc::MAX_STAGES, tc::MAX_TILES
SMEM_LIMIT = 232448  # a block's dynamic shared memory on the H100 (tc::SMEM_LIMIT)


def _tc_smem(d: int, rows: str, nwg: int, tiles: int, stages: int) -> int:
    """csrc/approx_scan.cu tc::smem_bytes: the query tiles (hi, lo) of nwg
    warpgroups, ``tiles`` depths' row tiles (two parts but for int8), the
    raw stages, the int8 scales of four depths, the mbarriers."""
    parts = 1 if rows == "int8" else 2
    return (4 * (nwg * 2 * _TQ * d + tiles * parts * _NB * d) + stages * _NB * d * _ELSIZE[rows]
            + (4 * _NB * 4 if rows == "int8" else 0) + 8 * (stages + 2 * _TC_MAX_TILES))


def tc_plan(b: int, d: int, rows: str) -> tuple[int, int, int, int]:
    """(consumer warpgroups, row tiles, raw stages, shared memory bytes) of
    ``approx_scan_tc_kernel``: two consumer warpgroups of 64 queries from
    B = 65 on where two row tiles and two stages fit, so two query tiles
    share each row tile, else one; three row tiles where two stages still
    fit (the converters run two depths ahead), else two; then as many
    stages as fit, up to four."""
    for nwg in (2, 1) if b > _TQ else (1,):
        for tiles, least in ((_TC_MAX_TILES, 2), (2, 2 if nwg == 2 else 1)):
            stages = next((s for s in range(_TC_MAX_STAGES, least - 1, -1)
                           if _tc_smem(d, rows, nwg, tiles, s) <= SMEM_LIMIT), 0)
            if stages:
                return nwg, tiles, stages, _tc_smem(d, rows, nwg, tiles, stages)
    raise ValueError(f"approx_scan_tc_kernel: D={d} {rows} rows do not fit in shared memory")


def scan_smem_bytes(d: int, rows: str, route: str, b: int = 1024) -> int:
    """Dynamic shared memory of N1 at width d: ``approx_scan_kernel``
    (route "fma", csrc/approx_scan.cu smem_bytes: the block's queries,
    d-major, and the rows' ring (f32), or one stage of widened rows and a
    two-stage ring of int8 rows), or ``approx_scan_tc_kernel`` (route "tc":
    ``tc_plan``'s at a batch of b queries)."""
    if route == "tc":
        return tc_plan(b, d, rows)[3]
    int8 = rows == "int8"
    padded = d if (d // 4) % 2 else d + 4
    return 4 * (d * _TQ + (1 if int8 else 2) * _NB * padded) + (2 * _NB * d if int8 else 0)


def scan_route(d: int, rows: str) -> str:
    """The kernel ``approx_scan`` launches for rows of width d: "tc"
    (``approx_scan_tc_kernel``) where D % 8 == 0 (int8: D % 16 == 0) and D <=
    MAX_D, else "fma" (``approx_scan_kernel``, which takes f32 rows with D %
    4 == 0 and int8 rows with D % 16 == 0; bf16 rows are widened for it)."""
    tc = 0 < d <= MAX_D and d % (16 if rows == "int8" else 8) == 0
    return "tc" if tc else "fma"


def approx_bins(n: int, k: int, recall_target: float) -> int:
    """The bins ``lax.approx_max_k`` reduces n scores to for top k at
    ``recall_target`` (XLA's ``ApproxTopKReductionOutputSize``, rank 2):
    M = (1 - k) / ln(recall_target) floored and clipped to [128, n], then
    r = floor(log2(n / M)), and ceil(n / 2^r) rounded up to 128, or n where
    r = 0.  k = 1 reduces as far as the tiling allows (r = ceil(log2(
    ceil(n / 128)))), and recall_target 1 not at all.  The target is
    rounded to f32 first, as XLA takes it."""
    if n <= _TILING:
        return n
    if k == 1:
        r = math.ceil(math.log2(-(-n // _TILING)))
    else:
        target = struct.unpack("f", struct.pack("f", recall_target))[0]
        if target >= 1.0:
            return n
        m = min(max(math.floor((1 - k) / math.log(target)), _TILING), n)
        r = int(math.floor(math.log2(n / m)))
    if r <= 0:
        return n
    return -(-(-(-n // (1 << r))) // _TILING) * _TILING


def _valid(valid_count, c: int) -> int:
    return c if valid_count is None else max(0, min(int(valid_count), c))


def approx_scan_plain(query, corpus, m: int, valid_count=None, scale=None):
    """(values [B, M] f32, rows [B, M] int32): for each query and bin
    j < M the largest score over rows j, j + M, ... < C, rows at or past
    ``valid_count`` scoring -inf, in the total order of ``f32_keys``, a tie
    to the lowest row.  The rows are padded to W * M and viewed as
    [B, W, M]; the max over W is taken of the int64 (key << 32 | 2^32 - 1 -
    w), every value distinct, so no tie order is left to the library.
    Padding takes the lowest key, below every row's, so it never wins."""
    b, c = query.shape[0], corpus.shape[0]
    w = -(-c // m)
    lim = _valid(valid_count, c)
    dev = query.device
    q = query.float()
    cf = corpus.float()
    depth = torch.arange(w * m, device=dev) // m
    low = (1 << 32) - 1 - depth  # [W * M]
    rows_per = max(1, _PLAIN_CHUNK_ELEMS // max(w * m, 1))
    vals, rows = [], []
    for b0 in range(0, b, rows_per):
        s = q[b0 : b0 + rows_per] @ cf.T  # [qb, C]
        if scale is not None:
            s.mul_(scale.float()[None, :])
        if lim < c:
            s[:, lim:] = float("-inf")
        comp = f32_keys(s).long()
        if w * m > c:
            comp = torch.nn.functional.pad(comp, (0, w * m - c), value=_INT_MIN)
        comp = comp.mul_(1 << 32).add_(low).view(s.shape[0], w, m).amax(dim=1)
        vals.append(keys_f32((comp >> 32).int()))
        best = (1 << 32) - 1 - (comp & 0xFFFFFFFF)
        rows.append((best * m + torch.arange(m, device=dev)).int())
    if not vals:
        return (torch.empty((0, m), dtype=torch.float32, device=dev),
                torch.empty((0, m), dtype=torch.int32, device=dev))
    return torch.cat(vals), torch.cat(rows)


def approx_scan(query: torch.Tensor, corpus: torch.Tensor, m: int, valid_count=None,
                scale: torch.Tensor | None = None, force: str | None = None):
    """N1: (values [B, M] f32, rows [B, M] int32) as ``approx_scan_plain``;
    ``corpus`` f32 or bf16 [C, D], or int8 [C, D] with ``scale`` [C] f32.
    On the card ``scan_route``'s kernel runs, or ``force``'s ("tc" or
    "fma")."""
    if query.device.type == "cpu":
        return approx_scan_plain(query, corpus, m, valid_count, scale)
    int8 = scale is not None
    _check_cuda("approx_scan", query, corpus, *([scale] if int8 else []))
    b, d = query.shape
    c = corpus.shape[0]
    rows_ok = (torch.int8,) if int8 else (torch.float32, torch.bfloat16)
    if query.dtype != torch.float32 or corpus.dtype not in rows_ok:
        raise TypeError("approx_scan takes an f32 query and f32 or bf16 rows, or int8 rows with "
                        "a scale")
    if int8 and (scale.dtype != torch.float32 or scale.shape != (c,)):
        raise TypeError("approx_scan takes an f32 scale [C] beside int8 rows")
    rows_kind = "int8" if int8 else "bf16" if corpus.dtype == torch.bfloat16 else "f32"
    route = force or scan_route(d, rows_kind)
    if route not in ("tc", "fma"):
        raise ValueError(f"approx_scan: force must be 'tc' or 'fma', got {force!r}")
    if route == "fma" and rows_kind == "bf16":  # the FMA kernel reads f32 rows
        corpus, rows_kind = corpus.float(), "f32"
    step = 16 if int8 else 8 if route == "tc" else 4
    if corpus.shape[1] != d or not 0 < d <= MAX_D or d % step:
        raise ValueError(f"approx_scan's {route} kernel takes D <= {MAX_D}, D % {step} == 0 for "
                         f"{rows_kind} rows, got D={d}, rows of {corpus.shape[1]}")
    if not 1 <= m <= c:
        raise ValueError(f"approx_scan needs 1 <= M <= C, got M={m}, C={c}")
    q, cc = _lib.aligned(query), _lib.aligned(corpus)
    sc = scale.contiguous() if int8 else None
    vals = torch.empty((b, m), dtype=torch.float32, device=q.device)
    rows = torch.empty((b, m), dtype=torch.int32, device=q.device)
    if b:
        args = (q.data_ptr(), cc.data_ptr(), sc.data_ptr() if int8 else None, vals.data_ptr(),
                rows.data_ptr(), b, c, d, m, _valid(valid_count, c))
        if route == "tc":
            nwg, tiles, stages, _ = tc_plan(b, d, rows_kind)
            err = _lib.library().tt_approx_scan_tc(*args, ROW_KINDS.index(rows_kind), nwg, tiles,
                                                   stages, _lib.stream_ptr(q))
        else:
            err = _lib.library().tt_approx_scan(*args, int(int8), _lib.stream_ptr(q))
        _lib.check(err, "approx_scan")
        _lib.launches["approx_scan"] += 1
        if route == "tc":
            _lib.launches["approx_scan_tc"] += 1
    return vals, rows


def approx_max_k(query: torch.Tensor, corpus: torch.Tensor, k: int, recall_target: float,
                 valid_count=None, scale: torch.Tensor | None = None, force: str | None = None):
    """(scores [B, k] f32, indices [B, k] int64): the approximate top k of
    each query's scores against ``corpus`` (f32 or bf16 rows, or int8 rows
    with ``scale``), descending in the total order, through M =
    ``approx_bins(C, k, recall_target)`` bins; ``force`` as ``approx_scan``'s."""
    c = corpus.shape[0]
    m = approx_bins(c, k, recall_target)
    if k > m:
        raise ValueError(f"approx_max_k: k={k} exceeds the {m} bins of recall_target "
                         f"{recall_target} over {c} rows")
    vals, rows = approx_scan(query.float(), corpus, m, valid_count, scale, force)
    keys, pos = select_rows(vals, k)  # B3: ties to the lowest bin
    return keys_f32(keys), torch.gather(rows, 1, pos.long()).long()
