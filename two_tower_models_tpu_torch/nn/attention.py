"""Multi-head self-attention (the JAX package's ``mha_apply``): fused QKV
projection, per-head softmax attention, output projection, batch-major
[B, H, D].  The dense branch is the plain reference for the encoder; the
``fused`` branch runs the whole layer in one kernel
(``ops.fused_mha.fused_mha_layer``, B13 and B14), which rounds at other
points and is held against its own plain version.  The ``blockwise``
branch folds the heads into the leading axis and runs
``ops.history_attention.blockwise_self_attention`` (B15 forward; B16, B17
backward) between the same projections as the dense branch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from two_tower_models_tpu_torch.nn.layers import Linear, linear_apply
from two_tower_models_tpu_torch.ops.fused_mha import fused_mha_layer
from two_tower_models_tpu_torch.ops.history_attention import blockwise_self_attention


class MultiheadAttention(nn.Module):
    """Parameters ``in_proj`` (D -> 3D) and ``out_proj`` (D -> D)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.in_proj = Linear(dim, 3 * dim, dtype, device)
        self.out_proj = Linear(dim, dim, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights and zero biases (torch's
        MultiheadAttention init, as the JAX package draws it)."""
        dim = self.out_proj.w.shape[0]
        with torch.no_grad():
            lim_in = math.sqrt(6.0 / (dim + 3 * dim))
            self.in_proj.w.uniform_(-lim_in, lim_in, generator=generator)
            lim_out = math.sqrt(6.0 / (dim + dim))
            self.out_proj.w.uniform_(-lim_out, lim_out, generator=generator)
            self.in_proj.b.zero_()
            self.out_proj.b.zero_()


def mha_apply(
    layer: MultiheadAttention,
    x: torch.Tensor,  # [B, H, D]
    num_heads: int,
    compute_dtype=None,
    blockwise: bool = False,
    fused: bool = False,
    lengths: torch.Tensor | None = None,  # [B] valid lengths; keys past it masked
) -> torch.Tensor:
    """Self-attention (q = k = v = x), [B, H, D] -> [B, H, D]: f32 on the
    dense and blockwise branches; in x's dtype with ``fused``, which casts x
    to the compute dtype, runs ``fused_mha_layer`` and casts its output
    back (``fused`` is read first, as in the JAX package).  Query rows past
    an example's length are computed with their keys masked."""
    if fused:
        y = fused_mha_layer(
            x if compute_dtype is None else x.to(compute_dtype),
            layer.in_proj.w, layer.in_proj.b, layer.out_proj.w, layer.out_proj.b,
            num_heads, lengths=lengths,
        )
        return y.to(x.dtype)
    b, h, d = x.shape
    hd = d // num_heads
    qkv = linear_apply(layer.in_proj, x, compute_dtype)  # [B, H, 3D] f32
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):  # [B, H, D] -> [B, nh, H, hd]
        return t.reshape(b, h, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if blockwise:
        # heads fold into the leading axis as n = b * nh + head, the lengths
        # repeated per head in that order (jnp.repeat)
        fold = lambda t: t.reshape(b * num_heads, h, hd)
        lens = None if lengths is None else lengths.repeat_interleave(num_heads)
        out = blockwise_self_attention(fold(q), fold(k), fold(v), lengths=lens)
        out = out.reshape(b, num_heads, h, hd)
    else:
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))  # [B, nh, H, H]
        if lengths is not None:
            key_valid = torch.arange(h, device=x.device)[None, :] < lengths[:, None]
            scores = scores.masked_fill(~key_valid[:, None, None, :], float("-inf"))
        out = torch.softmax(scores, dim=-1) @ v  # [B, nh, H, hd]
    out = out.transpose(1, 2).reshape(b, h, d).to(x.dtype)
    return linear_apply(layer.out_proj, out, compute_dtype)
