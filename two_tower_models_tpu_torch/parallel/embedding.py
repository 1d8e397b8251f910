"""Row-sharded embedding lookup with explicit collectives (forward only).

Port of ``two_tower_models_tpu/parallel/embedding.py:39-131``.  Every rank
of the ``model`` process group holds a contiguous block of V/n rows and
passes the same ids; each returns the [B, dim] rows.  Two strategies:

``psum_lookup`` (default): every rank gathers the rows it owns (others
contribute zeros) and one ``all_reduce(SUM)`` combines.  A row plus zeros
is exact, so the rows are bit-equal to a single-device gather, except that
a -0.0 entry comes back +0.0 (as in JAX).

``all_to_all_lookup``: bucket ids by owner with a stable sort, exchange
the id buckets (``all_to_all_single``), gather locally, exchange the rows
back and unsort.  Comms: two small all-to-alls instead of a [B, D]
all-reduce.

Both accept 128-lane-packed shards ([V/(n*P), P*D]; pass the logical
``dim``): id v lives in physical row v // P, so a contiguous logical range
shards as a contiguous physical range and the owner arithmetic works in
logical rows.  Local gathers go through ``nn.packed_table.table_lookup``.
The gradients of both wait for A13b.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.nn.packed_table import table_lookup


def _logical_rows(table_shard: torch.Tensor, dim: int) -> int:
    """Logical rows this shard holds (== physical rows unless packed)."""
    return table_shard.shape[0] * (table_shard.shape[-1] // dim)


def psum_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group, dim: int | None = None):
    """Masked local gather + all_reduce over ``group``: [B, dim] on every rank."""
    dim = dim or table_shard.shape[-1]
    shard = dist.get_rank(group)
    v_local = _logical_rows(table_shard, dim)
    local = ids.long() - shard * v_local
    valid = (local >= 0) & (local < v_local)
    safe = torch.where(valid, local, 0)
    rows = table_lookup(table_shard, safe, dim)  # [B, dim]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    dist.all_reduce(rows, group=group)
    return rows


def all_to_all_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group, dim: int | None = None):
    """Owner-bucketed all-to-all exchange: [B, dim] on every rank.

      1. owner[b] = ids[b] // (V/n)
      2. stable-sort ids by owner -> contiguous buckets, each slotted into
         its owner's B-wide request row (buckets cannot overflow: B ids);
      3. all_to_all the [n, B] requests, their mask beside them: rank s
         receives the ids each peer wants from s;
      4. gather locally: [n, B, D];
      5. all_to_all back, unsort.
    """
    dim = dim or table_shard.shape[-1]
    n = dist.get_world_size(group)
    shard = dist.get_rank(group)
    ids = ids.long()
    b = ids.shape[0]
    v_local = _logical_rows(table_shard, dim)

    owner = torch.clamp(ids // v_local, 0, n - 1)  # [B]
    order = torch.argsort(owner, stable=True)  # positions sorted by owner
    sorted_ids = ids[order]
    sorted_owner = owner[order]
    # rank within bucket = sorted position - first position of that owner
    first_pos = torch.searchsorted(sorted_owner, sorted_owner, side="left")
    rank = torch.arange(b, device=ids.device) - first_pos
    req = torch.zeros((n, 2, b), dtype=torch.int64, device=ids.device)  # [ids; mask]
    req[sorted_owner, 0, rank] = sorted_ids
    req[sorted_owner, 1, rank] = 1

    # 3. exchange requests: recv[p] = ids (and mask) peer p wants from me
    recv = torch.empty_like(req)
    dist.all_to_all_single(recv, req, group=group)

    # 4. answer with local rows
    local_idx = torch.clamp(recv[:, 0] - shard * v_local, 0, v_local - 1)
    answers = table_lookup(table_shard, local_idx.reshape(-1), dim).reshape(n, b, -1)
    answers = torch.where(recv[:, 1, :, None] > 0, answers, torch.zeros_like(answers))

    # 5. send back: my row p of answers returns to peer p
    returned = torch.empty_like(answers)
    dist.all_to_all_single(returned, answers.contiguous(), group=group)
    gathered_sorted = returned[sorted_owner, rank]  # [B, D]
    out = torch.zeros_like(gathered_sorted)
    out[order] = gathered_sorted  # unsort to the batch order
    return out


def sharded_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group,
                             strategy: str = "psum", dim: int | None = None):
    if strategy == "psum":
        return psum_lookup(table_shard, ids, group, dim)
    if strategy == "all_to_all":
        return all_to_all_lookup(table_shard, ids, group, dim)
    raise ValueError(f"unknown lookup strategy {strategy!r}")
