"""The mesh step's collectives, each with the adjoint its use needs.

A rank differentiates only its own share of the global loss, so a
collective's backward is the sum over ranks of what each share sends back:

  * ``all_gather_rows`` (an all-gather over ``data``: the negatives, the
    logQ corrections, the nuv max's vector) takes a reduce-scatter over
    the same group: each rank gets the sum of every share's cotangent for
    its own rows;
  * ``all_reduce_replicated`` (an all-reduce over ``model`` whose result
    every rank of the group uses alike: the ``tower_tp`` MLP's output)
    takes none: every rank of the group holds the same cotangent, and it is
    each rank's own contribution's cotangent.

JAX's explicit step differentiates inside ``shard_map(check_vma=False)``,
where the adjoint of ``psum`` is another ``psum``; ROADMAP.md C records
what that does to its gradients.  A group of one is the identity here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13's names; earlier releases have only the older ones
all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        all_gather_into(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        reduce_scatter_into(out, g.contiguous(), group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * B, ...]: every rank's ``x`` [B, ...] of ``group`` in rank order;
    the gradient reduce-scatters."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, used alike by every rank of it: the
    gradient passes through unchanged.  Without autograd, in place."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        dist.all_reduce(x, group=group)
        return x
    return _AllReduceReplicated.apply(x, group)
