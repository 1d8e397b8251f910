"""Multi-head self-attention, dense (the JAX package's ``mha_apply`` dense
branch): fused QKV projection, per-head softmax attention, output
projection, batch-major [B, H, D].  It is the plain reference for the
encoder: the whole-encoder kernel (ops.fused_encoder) rounds at other points
and is held against its own plain version.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from two_tower_models_tpu_torch.nn.layers import Linear, linear_apply


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
    lengths: torch.Tensor | None = None,  # [B] valid lengths; keys past it masked
) -> torch.Tensor:
    """Self-attention (q = k = v = x), [B, H, D] -> [B, H, D] f32."""
    b, h, d = x.shape
    hd = d // num_heads
    qkv = linear_apply(layer.in_proj, x, compute_dtype)  # [B, H, 3D] f32
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):  # [B, H, D] -> [B, nh, H, hd]
        return t.reshape(b, h, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))  # [B, nh, H, H]
    if lengths is not None:
        key_valid = torch.arange(h, device=x.device)[None, :] < lengths[:, None]
        scores = scores.masked_fill(~key_valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(b, h, d).to(x.dtype)
    return linear_apply(layer.out_proj, out, compute_dtype)
