"""In-place writes of touched table rows: the lazy-Adam write-back of
128-lane-packed tables.

Port of ``two_tower_models_tpu/ops/pallas/rows_write.py``.  ``rows_write``
launches kernel B19 (``csrc/rows_write.cu``, whose note says what bounds it
and why it may skip the no-op slots) on CUDA tensors and runs
``rows_write_reference`` on CPU tensors; both write into ``dst`` in place,
where the JAX function returns a new array.  ``lane_block_plan``,
``merge_rows`` and ``merge_lane_blocks`` turn sorted logical-row updates
into the physical-row stream the write takes; they are plain torch, as the
JAX package leaves them to XLA.
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


def rows_write(dst: torch.Tensor, ids: torch.Tensor, bits: torch.Tensor,
               vals: torch.Tensor, block_dim: int) -> torch.Tensor:
    """``rows_write_reference``'s function, in place on ``dst`` [V, W]; ids
    [N] physical rows, unique among the live slots (bits != 0), bits [N] the
    live lane blocks (each ``block_dim`` wide), vals [N, W].  A CUDA tensor
    launches kernel B19."""
    if dst.device.type == "cpu":
        return rows_write_reference(dst, ids, bits, vals, block_dim)
    if not (dst.device.type == "cuda" and ids.device == bits.device == vals.device == dst.device):
        raise ValueError("rows_write takes CUDA tensors on one device")
    v, w = dst.shape
    n = ids.shape[0]
    if dst.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"rows_write takes f32 rows, got {dst.dtype}, {vals.dtype}")
    if not dst.is_contiguous():
        raise ValueError("rows_write writes in place: dst must be contiguous")
    if tuple(vals.shape) != (n, w) or bits.shape != ids.shape or w % block_dim:
        raise ValueError(f"shapes dst {tuple(dst.shape)}, ids {tuple(ids.shape)}, "
                         f"bits {tuple(bits.shape)}, vals {tuple(vals.shape)}, D {block_dim}")
    ids32 = ids.to(torch.int32).contiguous()
    bits32 = bits.to(torch.int32).contiguous()
    vals = vals.contiguous()
    err = _lib.library().tt_rows_write(
        dst.data_ptr(), ids32.data_ptr(), bits32.data_ptr(), vals.data_ptr(),
        n, v, w, block_dim, _lib.stream_ptr(dst),
    )
    _lib.check(err, "rows_write")
    _lib.launches["rows_write"] += 1
    return dst


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
