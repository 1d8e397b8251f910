"""In-place writes of touched table rows: the lazy-Adam write-back of
128-lane-packed tables.

Port of ``two_tower_models_tpu/ops/pallas/rows_write.py``.  ``rows_write``
launches kernel B19 (``csrc/rows_write.cu``, whose note says what bounds it
and why it may skip the no-op slots) on CUDA tensors and runs
``rows_write_reference`` on CPU tensors; both write into ``dst`` in place,
where the JAX function returns a new array.  ``rows_write_many`` writes up
to three arrays that share the ids and bits (a table and its Adam moments)
in one launch, and on CPU tensors runs the plain version once per array.
``lane_block_plan``, ``merge_rows`` and ``merge_lane_blocks`` turn sorted
logical-row updates into the physical-row stream the write takes; they are
plain torch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.ops import _lib


@torch.no_grad()
def rows_write_reference(dst: torch.Tensor, ids: torch.Tensor, bits: torch.Tensor,
                         vals: torch.Tensor, block_dim: int) -> torch.Tensor:
    """In place: dst[ids[n], lanes of the blocks set in bits[n]] = vals[n],
    as ``old * (1 - m) + new * m``; slots with ``bits == 0`` or an id outside
    [0, V) are dropped.  Returns ``dst``."""
    v, w = dst.shape
    live = (bits != 0) & (ids >= 0) & (ids < v)
    lid = ids[live].long()
    lanes = torch.arange(w, device=dst.device) // block_dim
    m = ((bits[live][:, None] >> lanes[None, :]) & 1).to(dst.dtype)
    dst[lid] = dst[lid] * (1 - m) + vals[live] * m
    return dst


def rows_write_many_reference(dsts, ids: torch.Tensor, bits: torch.Tensor, vals,
                              block_dim: int):
    """``rows_write_reference`` once per (dst, vals) pair, in order.
    Returns ``dsts``."""
    for dst, v in zip(dsts, vals, strict=True):
        rows_write_reference(dst, ids, bits, v, block_dim)
    return dsts


_MAX_ARRAYS = 3  # csrc/rows_write.cu's MAX_ARRAYS


def rows_write_many(dsts, ids: torch.Tensor, bits: torch.Tensor, vals, block_dim: int):
    """``rows_write`` into up to three distinct arrays that share the slots
    (the table and its two Adam moments under one lane-block plan): dsts
    and vals are sequences of [V, W] and [N, W] f32 tensors, ids [N]
    physical rows, unique among the live slots (bits != 0), bits [N] the
    live lane blocks (each ``block_dim`` wide).  A CUDA tensor launches
    kernel B19 once for all the arrays; CPU tensors run
    ``rows_write_many_reference``.  Returns ``dsts``."""
    dsts, vals = list(dsts), list(vals)
    if not 1 <= len(dsts) == len(vals) <= _MAX_ARRAYS:
        raise ValueError(f"rows_write_many takes 1 to {_MAX_ARRAYS} (dst, vals) pairs, "
                         f"got {len(dsts)} and {len(vals)}")
    if dsts[0].device.type == "cpu":
        return rows_write_many_reference(dsts, ids, bits, vals, block_dim)
    dev = dsts[0].device
    if not (dev.type == "cuda" and ids.device == bits.device == dev
            and all(t.device == dev for t in (*dsts, *vals))):
        raise ValueError("rows_write takes CUDA tensors on one device")
    v, w = dsts[0].shape
    n = ids.shape[0]
    if any(t.dtype != torch.float32 for t in (*dsts, *vals)):
        raise TypeError(f"rows_write takes f32 rows, got {[t.dtype for t in (*dsts, *vals)]}")
    if not all(t.is_contiguous() for t in dsts):
        raise ValueError("rows_write writes in place: dst must be contiguous")
    if (any(tuple(t.shape) != (v, w) for t in dsts) or any(tuple(t.shape) != (n, w) for t in vals)
            or bits.shape != ids.shape or w % block_dim):
        raise ValueError(f"shapes dst {[tuple(t.shape) for t in dsts]}, ids {tuple(ids.shape)}, "
                         f"bits {tuple(bits.shape)}, vals {[tuple(t.shape) for t in vals]}, "
                         f"D {block_dim}")
    if len({t.data_ptr() for t in dsts}) != len(dsts):
        raise ValueError("rows_write_many writes distinct arrays")
    # the plan's own types (int64 ids, int32 bits) pass through uncopied
    ids64 = ids.to(torch.int64).contiguous()
    bits32 = bits.to(torch.int32).contiguous()
    vals = [t.contiguous() for t in vals]
    ptrs = lambda ts: [t.data_ptr() for t in ts] + [None] * (_MAX_ARRAYS - len(ts))
    err = _lib.library().tt_rows_write(
        *ptrs(dsts), *ptrs(vals), ids64.data_ptr(), bits32.data_ptr(), len(dsts),
        n, v, w, block_dim, _lib.sm_count(dev.index), _lib.stream_ptr(dsts[0]),
    )
    _lib.check(err, "rows_write")
    _lib.launches["rows_write"] += 1
    return dsts


def rows_write(dst: torch.Tensor, ids: torch.Tensor, bits: torch.Tensor,
               vals: torch.Tensor, block_dim: int) -> torch.Tensor:
    """``rows_write_reference``'s function, in place on ``dst`` [V, W]; ids
    [N] physical rows, unique among the live slots (bits != 0), bits [N] the
    live lane blocks (each ``block_dim`` wide), vals [N, W].  A CUDA tensor
    launches kernel B19 (``rows_write_many``'s one-array case)."""
    return rows_write_many([dst], ids, bits, [vals], block_dim)[0]


def lane_block_plan(sorted_ids: torch.Tensor, dup_mask: torch.Tensor, pack: int):
    """Id-dependent half of ``merge_lane_blocks``: (phys_ids [N], bits [N],
    pos [P, N], found [P, N], keep [N]); one plan serves every row array
    written back for the same id set (table, mu and nu).  The P lane
    partners of a physical row are the consecutive first slots of logical
    runs inside that row's run of equal ``ids // pack``, so each is reached
    by hopping the next-first-slot chain from the physical run's start."""
    n = sorted_ids.shape[0]
    dev = sorted_ids.device
    ids = sorted_ids.long()
    phys = ids // pack
    iota = torch.arange(n, device=dev)
    phys_dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), phys[1:] == phys[:-1]])
    # first slot of this slot's physical run
    phys_first = torch.cummax(torch.where(phys_dup, -1, iota), 0).values
    # next first slot of a logical run strictly after each slot (n: none)
    rn = torch.where(~dup_mask, iota, n).flip(0).cummin(0).values.flip(0)
    next_first = torch.cat([rn[1:], torch.full((1,), n, device=dev)])

    pos = torch.zeros(pack, n, dtype=torch.long, device=dev)
    found = torch.zeros(pack, n, dtype=torch.bool, device=dev)
    bits = torch.zeros(n, dtype=torch.int32, device=dev)
    j = phys_first  # hop 0: the physical run's first slot
    for _ in range(pack):
        jc = torch.clamp_max(j, n - 1)
        valid = (j < n) & (phys[jc] == phys)
        c_j = ids[jc] - phys * pack  # lane block of this partner
        for c in range(pack):
            hit = valid & (c_j == c)
            pos[c] = torch.where(hit, jc, pos[c])
            found[c] |= hit
            bits |= hit.int() << c
        j = next_first[jc]
    bits = torch.where(phys_dup, 0, bits)  # later slots of a run: no-ops
    return phys, bits, pos, found, ~dup_mask


def merge_rows(plan, sorted_ids: torch.Tensor, new_rows: torch.Tensor) -> torch.Tensor:
    """Value half: the [N, D] logical rows merged into [N, P*D] physical
    rows per a ``lane_block_plan``, in the JAX package's arithmetic (a
    one-hot widening, then the partners' rows added)."""
    _, _, pos, found, keep = plan
    n, d = new_rows.shape
    pack = pos.shape[0]
    blk = sorted_ids.long() % pack
    oh = torch.nn.functional.one_hot(blk, pack).to(new_rows.dtype) * keep[:, None]
    contrib = (oh[:, :, None] * new_rows[:, None, :]).reshape(n, pack * d)
    vals = torch.zeros_like(contrib)
    for c in range(pack):
        vals = vals + torch.where(found[c][:, None], contrib[pos[c]], 0)
    return vals


def merge_lane_blocks(sorted_ids: torch.Tensor, dup_mask: torch.Tensor,
                      new_rows: torch.Tensor, pack: int):
    """(phys_ids [N], bits [N], vals [N, P*D]) sorted by physical row: the
    first slot of each physical run carries the merged row and the live
    lane blocks, later slots of the run the same id and bits 0."""
    plan = lane_block_plan(sorted_ids, dup_mask, pack)
    return plan[0], plan[1], merge_rows(plan, sorted_ids, new_rows)
