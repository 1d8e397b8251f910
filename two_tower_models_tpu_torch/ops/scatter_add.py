"""Row scatter-add that scales with the update count: the embedding-table
backward.

Port of ``two_tower_models_tpu/ops/pallas/scatter_add.py``.
``rows_scatter_add`` launches kernel B18 (``csrc/scatter_add.cu``, whose
note says what bounds it and how it keeps a skewed id stream parallel) on
CUDA tensors and runs ``rows_scatter_add_reference`` on CPU tensors.  As the
JAX wrapper does outside its ``pallas_call``, the wrapper prepares the
stream: a stable sort of the ids (out-of-range ids replaced by the row
count, so they sort last and are dropped) and its permutation; the kernel
finds each table tile's range of the sorted ids itself.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.ops import _lib


def rows_scatter_add_reference(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """out[v] = sum over {n : ids[n] == v} of rows[n], f32 [num_rows, D];
    ids outside [0, num_rows) are dropped."""
    ids = ids.reshape(-1)
    rows = rows.reshape(-1, rows.shape[-1]).float()
    keep = (ids >= 0) & (ids < num_rows)
    out = torch.zeros(num_rows, rows.shape[-1], dtype=torch.float32, device=rows.device)
    return out.index_add_(0, ids[keep].long(), rows[keep])


def rows_scatter_add(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``rows_scatter_add_reference``'s function; a CUDA tensor launches
    kernel B18, which writes every row of the output (no zero fill)."""
    if rows.device.type == "cpu":
        return rows_scatter_add_reference(ids, rows, num_rows)
    ids = ids.reshape(-1)
    if rows.device.type != "cuda" or ids.device != rows.device:
        raise ValueError(f"rows_scatter_add takes CUDA tensors on one device, got {ids.device}, {rows.device}")
    if rows.dim() != 2 or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"rows must be [N, D] for N ids, got {tuple(rows.shape)} for {ids.shape[0]}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if num_rows >= 1 << 31 or ids.shape[0] >= 1 << 31:
        raise ValueError("rows_scatter_add takes fewer than 2^31 rows and ids")
    rows = rows.float().contiguous()
    if num_rows == 0 or rows.shape[1] == 0:
        return torch.empty(num_rows, rows.shape[1], dtype=torch.float32, device=rows.device)
    return scatter_sorted(*sort_stream(ids, num_rows), rows, num_rows)


def sort_stream(ids: torch.Tensor, num_rows: int):
    """The prep outside the kernel, as the JAX wrapper's: (sorted int32
    keys, the stable sort's permutation), out-of-range ids keyed
    ``num_rows`` so they sort last and are dropped."""
    key = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows).to(torch.int32)
    return torch.sort(key, stable=True)


def scatter_sorted(s_ids: torch.Tensor, order: torch.Tensor, rows: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Kernel B18 on a stream ``sort_stream`` prepared, f32 contiguous
    ``rows`` [N, D] with D > 0: the chunk and fill launches alone."""
    n, d = rows.shape
    out = torch.empty(num_rows, d, dtype=torch.float32, device=rows.device)
    partial = torch.empty_like(rows)
    err = _lib.library().tt_rows_scatter_add(
        s_ids.data_ptr(), order.data_ptr(), rows.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n, num_rows, d, _lib.stream_ptr(rows),
    )
    _lib.check(err, "rows_scatter_add")
    _lib.launches["rows_scatter_add"] += 1
    return out
