"""Row-sharded embedding lookup with explicit collectives, and its gradient.

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

The gradient (both strategies): every rank of the ``model`` group computes
the same loss from the same [B, dim] rows, so it holds the same cotangent,
and the rows it owns take exactly that cotangent.  The backward is local:
the rank's cotangent, masked to the ids it owns, scatter-added into its
shard by the single-device lookup's own gradient (``nn.layers.lookup_grad``:
``F.embedding``'s, or B18 inside the scatter window, packed shards from
2^18 logical rows up).  No collective runs.  JAX differentiates the psum
lookup inside ``shard_map(check_vma=False)``, where the adjoint of the
``psum`` is a second ``psum``: every shard's cotangent comes back n_model
times over, and its table gradients with it (ROADMAP.md C).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.nn.layers import lookup_grad
from two_tower_models_tpu_torch.nn.packed_table import table_lookup


def _logical_rows(table_shard: torch.Tensor, dim: int) -> int:
    """Logical rows this shard holds (== physical rows unless packed)."""
    return table_shard.shape[0] * (table_shard.shape[-1] // dim)


def _owned(table_shard: torch.Tensor, ids: torch.Tensor, group, dim: int):
    """(shard-local ids, 0 where not owned; the mask of owned ids)."""
    v_local = _logical_rows(table_shard, dim)
    local = ids - dist.get_rank(group) * v_local
    valid = (local >= 0) & (local < v_local)
    return torch.where(valid, local, 0), valid


def _psum_rows(table_shard, safe, valid, group, dim):
    """Masked local gather + all_reduce over ``group``."""
    rows = table_lookup(table_shard, safe, dim)  # [B, dim]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    dist.all_reduce(rows, group=group)
    return rows


def _all_to_all_rows(table_shard, ids, group, dim):
    """Owner-bucketed all-to-all exchange.

      1. owner[b] = ids[b] // (V/n)
      2. stable-sort ids by owner -> contiguous buckets, each slotted into
         its owner's B-wide request row (buckets cannot overflow: B ids);
      3. all_to_all the [n, B] requests, their mask beside them: rank s
         receives the ids each peer wants from s;
      4. gather locally: [n, B, D];
      5. all_to_all back, unsort.
    """
    n = dist.get_world_size(group)
    shard = dist.get_rank(group)
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


class _ShardLookup(torch.autograd.Function):
    """[B, dim] rows of the sharded table by ``strategy``; the gradient of
    the rank's shard is its own cotangent scatter-added into the rows it
    owns (the module's docstring says why no collective runs)."""

    @staticmethod
    def forward(ctx, table_shard, ids, group, dim, strategy):
        safe, valid = _owned(table_shard, ids, group, dim)
        ctx.save_for_backward(safe, valid)
        ctx.shape, ctx.dim = table_shard.shape, dim
        if strategy == "psum":
            return _psum_rows(table_shard, safe, valid, group, dim)
        return _all_to_all_rows(table_shard, ids, group, dim)

    @staticmethod
    def backward(ctx, g):
        safe, valid = ctx.saved_tensors
        rows_p, width = ctx.shape
        g = torch.where(valid[:, None], g, torch.zeros_like(g))
        # a packed shard's gradient is its logical view's, uncapped
        # (nn.packed_table.table_lookup)
        grad = lookup_grad(safe, g, rows_p * (width // ctx.dim), capped=width == ctx.dim)
        return grad.view(rows_p, width), None, None, None, None


def _lookup(table_shard, ids, group, dim, strategy):
    return _ShardLookup.apply(table_shard, ids.long(), group, dim or table_shard.shape[-1],
                              strategy)


def psum_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group, dim: int | None = None):
    """Masked local gather + all_reduce over ``group``: [B, dim] on every rank."""
    return _lookup(table_shard, ids, group, dim, "psum")


def all_to_all_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group, dim: int | None = None):
    """Owner-bucketed all-to-all exchange (``_all_to_all_rows``): [B, dim]
    on every rank."""
    return _lookup(table_shard, ids, group, dim, "all_to_all")


def sharded_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor, group,
                             strategy: str = "psum", dim: int | None = None):
    if strategy == "psum":
        return psum_lookup(table_shard, ids, group, dim)
    if strategy == "all_to_all":
        return all_to_all_lookup(table_shard, ids, group, dim)
    raise ValueError(f"unknown lookup strategy {strategy!r}")
