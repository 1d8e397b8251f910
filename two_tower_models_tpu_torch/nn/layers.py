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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]``; ``ids`` of any shape, values in [0, V)."""
    return table[ids.long()]


def table_lookup(table: torch.Tensor, ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain [V, dim] tables only: the JAX package's 128-lane packed storage
    is not ported yet (ROADMAP.md, queue A, "Large tables")."""
    if table.shape[-1] != dim:
        raise NotImplementedError(
            "packed embedding tables are not ported yet "
            "(ROADMAP.md, queue A, 'Large tables')"
        )
    return embedding_lookup(table, ids)
