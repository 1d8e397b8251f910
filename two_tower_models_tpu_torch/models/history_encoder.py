"""User-history encoder: self-attention summary + mean-pool, [B, 2, DI].

Port of ``two_tower_models_tpu/models/history_encoder.py``.  Given an
embedded history [B, H, DI], newest item at row 0, the output is
(row 0 after the attention stack, mean-pool of the input).  The tiers, in
the JAX package's order: with ``fused_encoder`` the whole stack runs in one
kernel (``ops.fused_encoder``): ``fused_history_encoder`` for full
histories, ``fused_attn_stack`` under per-example ``lengths``; otherwise
``mha_apply`` runs layer by layer, each layer in one kernel with
``fused_kernel`` (``ops.fused_mha``, B13 and B14), blockwise with
``blockwise_kernel`` (``ops.history_attention``, B15-B17), else dense.  The
PE, the zeroing past each length and the f32 mean-pool stay outside the
kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from two_tower_models_tpu_torch.config import HistoryEncoderConfig
from two_tower_models_tpu_torch.nn.attention import MultiheadAttention, mha_apply
from two_tower_models_tpu_torch.ops.fused_encoder import (
    fused_attn_stack,
    fused_history_encoder,
)


@functools.lru_cache(maxsize=32)
def _cached_pe_raw(seq_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    col = np.arange(d_model, dtype=np.float64)[None, :]
    # column j: angular frequency exponent 2j/d; even columns sin, odd cos
    ang = pos / np.power(10000.0, 2.0 * col / d_model)
    pe = np.where(col % 2 == 0, np.sin(ang), np.cos(ang))
    return np.ascontiguousarray(pe).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _cached_pe(seq_len: int, d_model: int) -> np.ndarray:
    # flipped along positions: the newest item sits at index 0 (a copy: for
    # one position the flipped view counts as contiguous, with a negative
    # stride torch.tensor refuses)
    return _cached_pe_raw(seq_len, d_model)[::-1].copy()


def sinusoidal_positional_encoding(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Flipped sinusoidal PE, [H, D] f32.  Copied to the device without
    blocking: a blocking copy from host memory synchronises the stream,
    which would stall every step that calls it."""
    return torch.tensor(_cached_pe(seq_len, d_model)).to(device, non_blocking=True)


def per_example_positional_encoding(
    lengths: torch.Tensor, seq_len: int, d_model: int
) -> torch.Tensor:
    """[B] lengths -> [B, H, D]: position p of an example of length L gets
    the raw PE at L-1-p (the flip at the example's own length); positions
    past L get zeros."""
    raw = torch.tensor(_cached_pe_raw(seq_len, d_model)).to(lengths.device, non_blocking=True)
    pos = torch.arange(seq_len, device=lengths.device)
    idx = (lengths[:, None] - 1 - pos[None, :]).clamp(0, seq_len - 1)
    pe = raw[idx]
    return torch.where((pos[None, :] < lengths[:, None])[..., None], pe, 0.0)


class HistoryEncoder(nn.Module):
    """``attn_layers``: the stack of self-attention layers.  Construction
    plus ``reset_parameters`` is the JAX package's ``history_encoder_init``."""

    def __init__(self, dim: int, cfg: HistoryEncoderConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiheadAttention(dim, cfg.num_heads, dtype, device)
            for _ in range(cfg.num_layers)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.attn_layers:
            layer.reset_parameters(generator)


def history_encoder_apply(
    encoder: HistoryEncoder,
    history_emb: torch.Tensor,  # [B, H, DI], newest first
    cfg: HistoryEncoderConfig,
    compute_dtype=None,
    lengths: torch.Tensor | None = None,  # optional [B] valid-history lengths
) -> torch.Tensor:
    """Returns [B, 2, DI]: (post-attention newest item, mean-pool).  An
    unresolved ``fused_encoder`` (None) reads as False, as in the JAX
    package; entry points resolve it first (config.resolve_kernel_flags)."""
    b, h, d = history_emb.shape
    layers = encoder.attn_layers
    stacked = lambda: [
        torch.stack([getattr(getattr(l, proj), leaf) for l in layers])
        for proj, leaf in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))
    ]

    if lengths is not None:
        lengths = lengths.to(device=history_emb.device, dtype=torch.int64).clamp(1, h)
        valid = torch.arange(h, device=history_emb.device)[None, :] < lengths[:, None]
        x0 = torch.where(valid[..., None], history_emb, 0)
        mean_pooled = (
            x0.float().sum(dim=1) / lengths[:, None].float()
        ).to(history_emb.dtype)
        x = x0
        if cfg.use_positional_encoding:
            x = x0 + per_example_positional_encoding(lengths, h, d).to(x0.dtype)
        if cfg.fused_encoder:
            # the stack alone in the kernel: PE, zeroing and the f32 mean
            # stay outside it, and y0 comes back in the compute dtype
            y0 = fused_attn_stack(
                x if compute_dtype is None else x.to(compute_dtype),
                lengths, *stacked(), cfg.num_heads,
            ).to(history_emb.dtype)
            return torch.stack([y0, mean_pooled], dim=1)
        for layer in layers:
            x = mha_apply(layer, x, cfg.num_heads, compute_dtype,
                          blockwise=cfg.blockwise_kernel, fused=cfg.fused_kernel,
                          lengths=lengths)
        return torch.stack([x[:, 0, :], mean_pooled], dim=1)

    if cfg.fused_encoder:
        dev = history_emb.device
        pe = (
            sinusoidal_positional_encoding(h, d, dev)
            if cfg.use_positional_encoding
            else torch.zeros((h, d), device=dev)
        )
        he = history_emb if compute_dtype is None else history_emb.to(compute_dtype)
        out = fused_history_encoder(he, pe, *stacked(), cfg.num_heads)
        return out.to(history_emb.dtype)

    mean_pooled = history_emb.mean(dim=1)
    x = history_emb
    if cfg.use_positional_encoding:
        x = x + sinusoidal_positional_encoding(h, d, x.device).to(x.dtype)[None]
    for layer in layers:
        x = mha_apply(layer, x, cfg.num_heads, compute_dtype,
                      blockwise=cfg.blockwise_kernel, fused=cfg.fused_kernel)
    return torch.stack([x[:, 0, :], mean_pooled], dim=1)
