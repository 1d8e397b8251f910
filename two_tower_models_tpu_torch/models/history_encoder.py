"""User-history encoder: self-attention summary + mean-pool, [B, 2, DI].

Port of ``two_tower_models_tpu/models/history_encoder.py``.  Given an
embedded history [B, H, DI], newest item at row 0, the output is
(row 0 after the attention stack, mean-pool of the input).  With
``fused_encoder`` the whole stack runs in one kernel
(``ops.fused_encoder``); otherwise the dense ``mha_apply`` layers run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from two_tower_models_tpu_torch.config import HistoryEncoderConfig
from two_tower_models_tpu_torch.nn.attention import MultiheadAttention, mha_apply
from two_tower_models_tpu_torch.ops.fused_encoder import fused_history_encoder


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
    # flipped along positions: the newest item sits at index 0
    return np.ascontiguousarray(_cached_pe_raw(seq_len, d_model)[::-1])


def sinusoidal_positional_encoding(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Flipped sinusoidal PE, [H, D] f32."""
    return torch.tensor(_cached_pe(seq_len, d_model), device=device)


def per_example_positional_encoding(
    lengths: torch.Tensor, seq_len: int, d_model: int
) -> torch.Tensor:
    """[B] lengths -> [B, H, D]: position p of an example of length L gets
    the raw PE at L-1-p (the flip at the example's own length); positions
    past L get zeros."""
    raw = torch.tensor(_cached_pe_raw(seq_len, d_model), device=lengths.device)
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
    if cfg.fused_kernel or cfg.blockwise_kernel:
        raise NotImplementedError(
            "the per-layer and blockwise attention kernels are not ported yet "
            "(ROADMAP.md, queue B)"
        )
    b, h, d = history_emb.shape
    layers = encoder.attn_layers

    if lengths is not None:
        if cfg.fused_encoder:
            raise NotImplementedError(
                "variable-length histories through the fused encoder "
                "(fused_attn_stack) are not ported yet (ROADMAP.md, queue A, "
                "'Variable-length histories')"
            )
        lengths = lengths.to(device=history_emb.device, dtype=torch.int64).clamp(1, h)
        valid = torch.arange(h, device=history_emb.device)[None, :] < lengths[:, None]
        x0 = torch.where(valid[..., None], history_emb, 0)
        mean_pooled = (
            x0.float().sum(dim=1) / lengths[:, None].float()
        ).to(history_emb.dtype)
        x = x0
        if cfg.use_positional_encoding:
            x = x0 + per_example_positional_encoding(lengths, h, d).to(x0.dtype)
        for layer in layers:
            x = mha_apply(layer, x, cfg.num_heads, compute_dtype, lengths=lengths)
        return torch.stack([x[:, 0, :], mean_pooled], dim=1)

    if cfg.fused_encoder:
        dev = history_emb.device
        pe = (
            sinusoidal_positional_encoding(h, d, dev)
            if cfg.use_positional_encoding
            else torch.zeros((h, d), device=dev)
        )
        he = history_emb if compute_dtype is None else history_emb.to(compute_dtype)
        out = fused_history_encoder(
            he,
            pe,
            torch.stack([l.in_proj.w for l in layers]),
            torch.stack([l.in_proj.b for l in layers]),
            torch.stack([l.out_proj.w for l in layers]),
            torch.stack([l.out_proj.b for l in layers]),
            cfg.num_heads,
        )
        return out.to(history_emb.dtype)

    mean_pooled = history_emb.mean(dim=1)
    x = history_emb
    if cfg.use_positional_encoding:
        x = x + sinusoidal_positional_encoding(h, d, x.device).to(x.dtype)[None]
    for layer in layers:
        x = mha_apply(layer, x, cfg.num_heads, compute_dtype)
    return torch.stack([x[:, 0, :], mean_pooled], dim=1)
