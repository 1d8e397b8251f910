"""Dense layers, MLPs and embedding lookups.

Weights are stored ``[in, out]`` (``y = x @ w + b``), the JAX package's
layout, so the weight bridge is a plain copy.  Parameter names follow the
JAX params pytree (``w``, ``b``; MLP layers by index).

bf16 numerics: JAX multiplies bf16 operands with
``preferred_element_type=float32`` and never rounds the product, while
``torch.matmul`` on bf16 tensors returns a bf16-rounded result.  So a
compute dtype here means: round the operands to it, then multiply them as
f32.  Products of two bf16 values are exact in f32, so only the summation
order differs from JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch import nn


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and returned as f32 (identity for None or
    f32)."""
    if dtype is None or dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()


class Linear(nn.Module):
    """Dense layer, weight ``w`` [in, out] and bias ``b`` [out]."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.empty(out_dim, dtype=dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-1/sqrt(in), 1/sqrt(in)) for weight and bias (torch's Linear
        default, as the JAX package draws it)."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        with torch.no_grad():
            self.w.uniform_(-bound, bound, generator=generator)
            self.b.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        return linear_apply(self, x, compute_dtype)


def linear_apply(layer: Linear, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """f32 ``x @ w + b`` with the operands first rounded to ``compute_dtype``."""
    y = round_to(x, compute_dtype) @ round_to(layer.w, compute_dtype)
    return y + layer.b.float()


class MLP(nn.ModuleList):
    """Linear layers with ReLU between them; layer i is named ``i``."""

    def __init__(self, dims: Sequence[int], dtype=torch.float32, device=None):
        super().__init__(
            Linear(din, dout, dtype, device) for din, dout in zip(dims[:-1], dims[1:])
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        return mlp_apply(self, x, compute_dtype)


def mlp_apply(mlp: MLP, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    for i, layer in enumerate(mlp):
        x = linear_apply(layer, x, compute_dtype)
        if i < len(mlp) - 1:
            x = torch.relu(x)
    return x


def embedding_init(table: torch.Tensor, generator: torch.Generator) -> None:
    """ID-embedding table ~ N(0, 1) (torch nn.Embedding default)."""
    with torch.no_grad():
        table.normal_(generator=generator)


# The table sizes whose lookup gradient goes through the update-count
# scatter kernel (B18, ops.scatter_add) instead of F.embedding's gradient:
# the JAX package's window, chosen on its TPU (the H100's own answer is in
# PERF.md).  Packed tables take the kernel from the lower edge up, with no
# upper edge (``capped=False``, nn.packed_table).
_SCATTER_KERNEL_MIN_ROWS = 1 << 18
_SCATTER_KERNEL_MAX_ROWS = 1 << 22

_scatter_kernel_enabled = True


def _in_scatter_window(vocab: int, capped: bool = True) -> bool:
    """Whether a table of ``vocab`` rows takes the scatter kernel: at least
    ``_SCATTER_KERNEL_MIN_ROWS``, and below ``_SCATTER_KERNEL_MAX_ROWS``
    when ``capped``."""
    return _SCATTER_KERNEL_MIN_ROWS <= vocab and (not capped or vocab < _SCATTER_KERNEL_MAX_ROWS)


@contextlib.contextmanager
def disable_scatter_kernel():
    """Inside, every lookup gradient takes the plain scatter-add
    (``rows_scatter_add_reference``), on the card too."""
    global _scatter_kernel_enabled
    prev = _scatter_kernel_enabled
    _scatter_kernel_enabled = False
    try:
        yield
    finally:
        _scatter_kernel_enabled = prev


def scatter_add_rows(ids: torch.Tensor, rows: torch.Tensor, vocab: int,
                     capped: bool = True, fixed_order: bool = False) -> torch.Tensor:
    """out[v] = sum of rows[n] over ids[n] == v, f32 [vocab, D]; ids outside
    [0, vocab) dropped.  With the kernel enabled, inside the window
    (``_in_scatter_window``) or with ``fixed_order``, ``rows_scatter_add``
    (B18 on the card, which sums each id's rows in a fixed order), else the
    plain scatter-add."""
    from two_tower_models_tpu_torch.ops.scatter_add import (
        rows_scatter_add,
        rows_scatter_add_reference,
    )

    ids, rows = ids.reshape(-1), rows.reshape(-1, rows.shape[-1])
    if _scatter_kernel_enabled and (fixed_order or _in_scatter_window(vocab, capped)):
        return rows_scatter_add(ids, rows, vocab)
    return rows_scatter_add_reference(ids, rows, vocab)


class _Lookup(torch.autograd.Function):
    """``table[ids]`` whose gradient is ``scatter_add_rows``; it keeps only
    the ids for the backward, not the table."""

    @staticmethod
    def forward(ctx, table, ids, capped, fixed_order):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.capped, ctx.fixed_order = table.shape[0], capped, fixed_order
        return torch.nn.functional.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = scatter_add_rows(ids, g, ctx.vocab, ctx.capped, ctx.fixed_order)
        return grad.to(g.dtype), None, None, None


def lookup_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int, capped: bool = True) -> torch.Tensor:
    """The table gradient [vocab, D] of ``embedding_lookup(table, ids,
    capped)`` for the cotangent ``g`` [*ids.shape, D], computed by the
    function its autograd takes: ``scatter_add_rows`` inside the window,
    ``F.embedding``'s gradient below it.  For a lookup whose forward runs
    elsewhere (``parallel.embedding``)."""
    ids, g = ids.reshape(-1).long(), g.reshape(-1, g.shape[-1])
    if _in_scatter_window(vocab, capped):
        return scatter_add_rows(ids, g, vocab, capped).to(g.dtype)
    return torch.ops.aten.embedding_dense_backward(g, ids, vocab, -1, False)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, capped: bool = True,
                     fixed_order: bool = False) -> torch.Tensor:
    """Rows ``table[ids]``; ``ids`` of any shape, values in [0, V).

    Inside the scatter window (``_in_scatter_window(V, capped)``), or with
    ``fixed_order``, the gradient is ``scatter_add_rows`` (B18 on the card).
    ``fixed_order`` is for a table whose ``F.embedding`` gradient gives new
    bits on every call on CUDA: the position-bias table, [100, 1] under
    4096 ids (five distinct results in five calls on an H100, where the
    D = 64 id tables, even under a Zipf batch's 341 repeats of one id, gave
    one; ``scripts/torch_lookup_repeats.py``).  Below the window, through
    ``F.embedding`` rather than indexing: the two gather alike, but the
    gradient of an index is an accumulating ``index_put_``, which on CUDA
    sums each id's repeats one after another.  A batch of variable-length
    histories repeats the padding id 0 about B*H/2 times, and that serial
    sum took 44 ms of a 69 ms training step on an H100; the embedding
    gradient splits a long run of one id into segments."""
    kernel = fixed_order or _in_scatter_window(table.shape[0], capped)
    if kernel and torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids.long(), capped, fixed_order)
    return torch.nn.functional.embedding(ids.long(), table)
