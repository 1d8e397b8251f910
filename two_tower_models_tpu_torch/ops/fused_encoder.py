"""Whole history encoder in one kernel (forward only).

Port of ``two_tower_models_tpu/ops/pallas/fused_encoder.py:
fused_history_encoder`` (its primal, ``_enc_fwd_kernel``).  The CUDA kernel
is ``csrc/fused_encoder.cu``; its note says what bounds it on the H100 and
what its design does about that.  ``fused_history_encoder_plain`` is the
same function in plain PyTorch, with the kernel's rounding points: the CPU
path and the reference the kernel is held against on the card.
"""

from __future__ import annotations

import math

import torch

from two_tower_models_tpu_torch.nn.layers import round_to
from two_tower_models_tpu_torch.ops import _lib

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MAX_EXAMPLES_PER_BLOCK = 8


def fused_history_encoder_plain(
    hist_emb: torch.Tensor,  # [B, H, D] bf16 or f32, newest item at row 0
    pe: torch.Tensor,  # [H, D] positional encoding (zeros to disable)
    w_in: torch.Tensor,  # [L, D, 3D]
    b_in: torch.Tensor,  # [L, 3D]
    w_out: torch.Tensor,  # [L, D, D]
    b_out: torch.Tensor,  # [L, D]
    num_heads: int,
) -> torch.Tensor:
    """[B, H, D] -> [B, 2, D] in the input dtype: (last layer's row 0,
    mean-pool of the input).  Under bf16 input every matmul operand is
    rounded to bf16 (weights too) and accumulated in f32, exactly where the
    Pallas kernel rounds."""
    mm = torch.bfloat16 if hist_emb.dtype == torch.bfloat16 else None
    b, h, d = hist_emb.shape
    nh, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    xin = hist_emb.float()
    mean = xin.sum(dim=1) / h
    x = xin + pe.float()
    num_layers = w_in.shape[0]
    for l in range(num_layers):
        last = l == num_layers - 1
        qkv = round_to(x, mm) @ round_to(w_in[l], mm) + b_in[l].float()
        q, k, v = (round_to(t, mm) for t in qkv.split(d, dim=-1))
        if last:  # only query row 0 is consumed downstream
            q = q[:, :1]
        nq = q.shape[1]
        qh = q.reshape(b, nq, nh, hd).transpose(1, 2)  # [B, NH, nq, hd]
        kh = k.reshape(b, h, nh, hd).transpose(1, 2)
        vh = v.reshape(b, h, nh, hd).transpose(1, 2)
        s = (qh @ kh.transpose(-1, -2)) * scale  # [B, NH, nq, H]
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))  # per-head max
        denom = round_to(e, mm).sum(dim=-1, keepdim=True)
        p = e / denom.clamp_min(1e-30)
        out = (round_to(p, mm) @ vh).transpose(1, 2).reshape(b, nq, d)
        x = round_to(out, mm) @ round_to(w_out[l], mm) + b_out[l].float()
    return torch.stack([x[:, 0], mean], dim=1).to(hist_emb.dtype)


def _examples_per_block(h: int, d: int, nh: int) -> int:
    fixed = 4 * (3 * d * d + 3 * d + d * d + d + 3 * h * d + nh * h * h + h * d)
    epb = min(_MAX_EXAMPLES_PER_BLOCK, (_SMEM_LIMIT - fixed) // (4 * h * d))
    if epb < 1:
        raise ValueError(
            f"history encoder of H={h}, D={d}, NH={nh} does not fit the "
            "kernel's shared memory"
        )
    return epb


def fused_history_encoder(
    hist_emb: torch.Tensor,
    pe: torch.Tensor,
    w_in: torch.Tensor,
    b_in: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """[B, H, D] -> [B, 2, D]; see ``fused_history_encoder_plain``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_plain(
            hist_emb, pe, w_in, b_in, w_out, b_out, num_heads
        )
    if hist_emb.device.type != "cuda":
        raise ValueError(f"unsupported device {hist_emb.device}")
    if hist_emb.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"history must be bf16 or f32, got {hist_emb.dtype}")
    b, h, d = hist_emb.shape
    num_layers = w_in.shape[0]
    if d % num_heads or pe.shape != (h, d) or w_in.shape != (num_layers, d, 3 * d):
        raise ValueError("encoder shapes do not agree")
    if b_in.shape != (num_layers, 3 * d) or w_out.shape != (num_layers, d, d) \
            or b_out.shape != (num_layers, d):
        raise ValueError("encoder weight shapes do not agree")
    epb = _examples_per_block(h, d, num_heads)
    dev = hist_emb.device
    x = hist_emb.contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    pe_, wi, bi, wo, bo = f32(pe), f32(w_in), f32(b_in), f32(w_out), f32(b_out)
    y = torch.empty((b, 2, d), dtype=hist_emb.dtype, device=dev)
    if b == 0:
        return y
    lib = _lib.library()
    err = lib.tt_fused_history_encoder(
        x.data_ptr(), pe_.data_ptr(), wi.data_ptr(), bi.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), y.data_ptr(),
        b, h, d, num_heads, num_layers, int(hist_emb.dtype == torch.bfloat16), epb,
        _lib.stream_ptr(x),
    )
    _lib.check(err, "fused_history_encoder")
    _lib.launches["fused_history_encoder"] += 1
    return y
