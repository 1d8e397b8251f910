"""128-lane-packed embedding-table storage for large tables.

Port of ``two_tower_models_tpu/nn/packed_table.py``.  A [V, D] table with
D | 128 packs P = 128 / D logical rows into each physical 128-lane row,
stored as [ceil(V / P), 128]; id v lives in physical row v // P, lane block
(v % P) * D.  The layout exists for the TPU (it keeps Mosaic's tiling free
of padding); the port keeps it so that weights, optimizer states and
checkpoints cross between the packages unchanged, and because the packed
tensor is, in memory, the logical [V', D] table: a contiguous [Vp, P*D]
tensor viewed as [Vp*P, D] holds logical row v at row v.  So the gather and
its gradient work on that view: the gradient is the plain row scatter-add
into the logical view, which computes the JAX package's one-hot-widened
physical-row sums (zeros add exactly) without widening anything.

Packing is numerics-neutral: padded tail rows get zero gradient and never
change, and ``unpack_table`` restores the logical table bit for bit.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.nn.layers import embedding_lookup, scatter_add_rows

LANES = 128


def pack_factor(dim: int) -> int:
    """How many logical rows share one 128-lane physical row (1: no pack)."""
    if dim < LANES and LANES % dim == 0:
        return LANES // dim
    return 1


def packed_shape(vocab: int, dim: int):
    p = pack_factor(dim)
    return (-(-vocab // p), dim * p)


def is_packed(table: torch.Tensor, dim: int) -> bool:
    """A table is packed iff its lane width is not the logical dim."""
    return table.shape[-1] != dim


def pack_table(table: torch.Tensor) -> torch.Tensor:
    """[V, D] -> [ceil(V/P), P*D], the tail padded with zero rows (a view
    when P divides V)."""
    v, d = table.shape
    p = pack_factor(d)
    if p == 1:
        return table
    vp = -(-v // p) * p
    if vp != v:
        table = torch.cat([table, table.new_zeros(vp - v, d)])
    return table.reshape(vp // p, p * d)


def unpack_table(packed: torch.Tensor, vocab: int, dim: int) -> torch.Tensor:
    """Inverse of ``pack_table``: [Vp/P, P*D] -> [vocab, dim]."""
    if not is_packed(packed, dim):
        return packed
    return packed.reshape(-1, dim)[:vocab]


def _packed_gather(packed: torch.Tensor, ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Logical rows [*ids.shape, dim] of a packed table."""
    return torch.nn.functional.embedding(ids.long(), packed.reshape(-1, dim))


def packed_rows_scatter_add(ids: torch.Tensor, rows: torch.Tensor, rows_p: int,
                            width: int) -> torch.Tensor:
    """f32 [rows_p, width]: rows[n] added into logical row ids[n]'s lane
    block; logical ids outside [0, rows_p * P) are dropped.  The scatter-add
    into the logical view, under ``nn.layers``' kernel gate from its lower
    edge up (the JAX package's gate, with CUDA in place of the TPU)."""
    dim = rows.shape[-1]
    return scatter_add_rows(ids, rows, rows_p * (width // dim), capped=False).view(rows_p, width)


def table_lookup(table: torch.Tensor, ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Dispatch on the storage layout: a packed table is looked up as its
    logical view, whose gradient autograd carries back into the packed
    shape (``packed_rows_scatter_add``'s function: B18 on the card from
    2^18 logical rows up, ``F.embedding``'s below); a plain one through
    ``nn.layers.embedding_lookup``."""
    if is_packed(table, dim):
        return embedding_lookup(table.reshape(-1, dim), ids, capped=False)
    return embedding_lookup(table, ids)
