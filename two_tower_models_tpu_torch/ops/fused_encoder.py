"""Whole history encoder in one kernel, and the length-masked attention
stack: forward, residual forward, backward.

Port of ``two_tower_models_tpu/ops/pallas/fused_encoder.py``:

- B1, ``_enc_fwd_kernel``: ``fused_history_encoder``'s forward alone
  (``csrc/fused_encoder.cu``), taken when no gradient is wanted (serving);
- B5, ``_enc_fwd_res_kernel``: the same forward that also stores each
  layer's input and attention probabilities (``csrc/fused_encoder.cu`` with
  its residual flag), taken when a gradient is wanted;
- B6, ``_enc_bwd_res_kernel``: the backward from those residuals
  (``csrc/fused_encoder_bwd.cu``), plus a second launch that sums the
  per-block weight grads in a fixed order;
- B7, ``_enc_bwd_kernel``: the backward that recomputes the forward in the
  kernel instead (same file, same reduce), taken with B1 as the forward
  when ``_RESIDUAL_BWD`` is False;
- B8, ``_stack_fwd_kernel``: ``fused_attn_stack``, the attention stack
  under per-example history lengths, row 0 of the last layer out
  (``csrc/fused_encoder.cu`` with its stack flag);
- B9, ``_stack_bwd_kernel``: its backward, recomputing the forward
  (``csrc/fused_encoder_bwd.cu``, same reduce).

``fused_history_encoder`` picks B1 or the ``autograd.Function`` (B5 then
B6, or B1 then B7), and ``fused_attn_stack`` picks B8 or its
``autograd.Function`` (B8 then B9), as the JAX primal / ``_vjp_fwd`` split
does.  Each kernel has a plain PyTorch version with its rounding points:
the CPU path, and the reference the kernel is held against on the card.
The plain backwards are written out with the Pallas kernels' rounding
points; they are not torch autograd of the plain forward.

B1, B5 and B8 run on one of two kernels, chosen by ``_enc_route`` before
the launch from the dtype and shape alone: bf16 encoders of head width 16,
32, ..., D a multiple of 32, H up to 64 and every layer's weights in shared
memory beside a tile go to the tensor cores (``encoder_tc_kernel``, tiles
of several examples kept on chip across the layers); every other encoder
(f32, head width 8, longer histories, deeper or wider layers) to the CUDA
cores (``encoder_kernel``).  The tensor cores sum in f32 in another order
than the plain version, so ``fused_history_encoder_f64_sums``,
``fused_history_encoder_res_f64_sums`` and ``fused_attn_stack_f64_sums``
(the same functions with every sum in f64) are the yardstick both are
measured against on the card.

B6 and B9 run on one of two kernels too, chosen by ``_enc_bwd_route``:
bf16 encoders of D 32 or 64, head width 16k and H up to 64 go to
``encoder_bwd_tc_kernel`` (the tensor cores, one layer's weights staged at
a time, the layers walked last to first over each block's own tiles), the
rest to ``encoder_bwd_kernel`` (the CUDA cores); B7 stays on the CUDA cores.
``fused_history_encoder_bwd_f64_sums`` and ``fused_attn_stack_bwd_f64_sums``
are the backwards' yardsticks.

Residual layouts (any layout will do, as long as kernel and plain agree):
xs [L, B, H, D], ps [L-1, B, NH, H, H] (None when L == 1) and p0
[B, NH, H], all in the input dtype: per head, the values of the Pallas
kernel's merged [H, NH*H] layout without its padding.
"""

from __future__ import annotations

import functools
import math

import torch

from two_tower_models_tpu_torch.nn.layers import round_to
from two_tower_models_tpu_torch.ops import _lib

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MAX_EXAMPLES_PER_BLOCK = 8
_TC_ROWS = 128  # rows a tensor-core tile aims at: E examples of Hp rows
_TC_MAX_HP = 64  # the longest padded history whose S band fits the kernels' registers
_TC_STATIC_SMEM = 32  # bytes of static shared memory of encoder_tc_kernel (a tile's lengths)
_NEG_INF = -1e30  # an invalid key's score (the Pallas kernels' mask value)

# Backward strategy of fused_history_encoder, the JAX module's constant of
# the same name: True = B5 stores each layer's input and probabilities and
# B6 reads them; False = B1 stores nothing and B7 recomputes the forward.
_RESIDUAL_BWD = True


def _mm(dtype):
    """The matmul operand dtype of the kernels: bf16 for bf16 input, else f32."""
    return torch.bfloat16 if dtype == torch.bfloat16 else None


def _key_invalid(lengths, h: int, device):
    """[B, 1, 1, H] mask of the keys past each example's length (a key kj
    of example b is valid iff kj < lengths[b])."""
    pos = torch.arange(h, device=device)
    return (pos[None, :] >= lengths.to(device)[:, None])[:, None, None, :]


def _attn_layer_plain(x, w_in, b_in, w_out, b_out, num_heads, mm, invalid=None, nq=None):
    """One attention layer on an f32 input x [B, H, D], query rows [:nq]
    (all by default).  ``invalid`` (``_key_invalid``) masks keys: an
    invalid score is -1e30 after the scale, before the per-head max.
    Returns (the layer's output [B, nq, D] f32, its probabilities
    [B, NH, nq, H] f32 and unrounded).  Operands round to ``mm`` where the
    Pallas kernels round them."""
    b, h, d = x.shape
    nh, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    qkv = round_to(x, mm) @ round_to(w_in, mm) + b_in.float()
    q, k, v = (round_to(t, mm) for t in qkv.split(d, dim=-1))
    q = q[:, :nq]
    nq = q.shape[1]
    qh = q.reshape(b, nq, nh, hd).transpose(1, 2)  # [B, NH, nq, hd]
    kh = k.reshape(b, h, nh, hd).transpose(1, 2)
    vh = v.reshape(b, h, nh, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * scale  # [B, NH, nq, H]
    if invalid is not None:
        s = s.masked_fill(invalid, _NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))  # per-head max
    denom = round_to(e, mm).sum(dim=-1, keepdim=True)
    p = e / denom.clamp_min(1e-30)
    out = (round_to(p, mm) @ vh).transpose(1, 2).reshape(b, nq, d)
    return round_to(out, mm) @ round_to(w_out, mm) + b_out.float(), p


def _layers_plain(x, w_in, b_in, w_out, b_out, num_heads, mm, lengths=None):
    """The attention layers on an f32 input x [B, H, D], the last one thin
    (query row 0 only), each an ``_attn_layer_plain``; with ``lengths``
    [B], keys past each length are masked.  Returns (the last layer's row 0
    [B, D] f32, each layer's input [B, H, D] f32, each layer's
    probabilities [B, NH, nq, H] f32 and unrounded, nq = 1 in the last
    layer)."""
    num_layers = w_in.shape[0]
    invalid = None if lengths is None else _key_invalid(lengths, x.shape[1], x.device)
    xs, ps = [], []
    for l in range(num_layers):
        xs.append(x)
        nq = 1 if l == num_layers - 1 else None  # only row 0 is consumed downstream
        x, p = _attn_layer_plain(x, w_in[l], b_in[l], w_out[l], b_out[l], num_heads, mm,
                                 invalid, nq)
        ps.append(p)
    return x[:, 0], xs, ps


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
    xin = hist_emb.float()
    y0, _, _ = _layers_plain(
        xin + pe.float(), w_in, b_in, w_out, b_out, num_heads, _mm(hist_emb.dtype)
    )
    return torch.stack([y0, xin.sum(dim=1) / xin.shape[1]], dim=1).to(hist_emb.dtype)


def fused_history_encoder_res_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """B5's function: (y, xs, ps, p0), the forward of
    ``fused_history_encoder_plain`` and its residuals (module docstring)."""
    dt = hist_emb.dtype
    xin = hist_emb.float()
    y0, xs, ps = _layers_plain(
        xin + pe.float(), w_in, b_in, w_out, b_out, num_heads, _mm(dt)
    )
    y = torch.stack([y0, xin.sum(dim=1) / xin.shape[1]], dim=1).to(dt)
    full = torch.stack([p.to(dt) for p in ps[:-1]]) if len(ps) > 1 else None
    return y, torch.stack([x.to(dt) for x in xs]), full, ps[-1][:, :, 0].to(dt)


def _backward_plain(dy, xs, ps, w_in, b_in, w_out, num_heads, mm):
    """The layers' backward, last to first, with the rounding points of
    ``_layer_bwd`` / ``_thin_bwd``: from ``dy`` [B, nq, D], the f32
    cotangent of the last layer's nq output rows (row 0 of a thin layer),
    each layer's input ``xs[l]`` and probabilities ``ps[l]`` [B, NH, nq, H].  g2, do, dp * p, ds and dqkv are
    rounded before their products; p is rounded where it is a P.V operand
    and used as given in dp * p and ds; db_out sums the unrounded dy and
    db_in the rounded dqkv; the thin last layer has dq at row 0 only.
    Returns (the f32 cotangent of layer 0's input [B, H, D], [dw_in, db_in,
    dw_out, db_out] f32 summed over the batch)."""
    num_layers = w_in.shape[0]
    b, h, d = xs[0].shape
    nh, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    heads = lambda t: t.reshape(b, t.shape[1], nh, hd).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(b, t.shape[2], d)
    grads = [[None] * num_layers for _ in range(4)]  # dwi, dbi, dwo, dbo
    for l in range(num_layers - 1, -1, -1):
        x2 = round_to(xs[l], mm)
        wi = round_to(w_in[l], mm)
        qkv = x2 @ wi + b_in[l].float()
        q, k, v = (round_to(t, mm) for t in qkv.split(d, dim=-1))
        p = ps[l]
        q = q[:, : p.shape[2]]  # row 0 only in the thin last layer
        pv = round_to(p, mm)
        qh, kh, vh = heads(q), heads(k), heads(v)
        ao = round_to(merge(pv @ vh), mm)  # [B, nq, D]
        g2 = round_to(dy, mm)
        grads[2][l] = torch.einsum("bqc,bqj->cj", ao, g2)
        grads[3][l] = dy.sum(dim=(0, 1))
        do = heads(round_to(g2 @ round_to(w_out[l], mm).T, mm))  # [B, NH, nq, hd]
        dp = do @ vh.transpose(-1, -2)  # [B, NH, nq, H]
        dv = merge(pv.transpose(-1, -2) @ do)  # [B, H, D]
        pdp = round_to(dp * p, mm).sum(dim=-1, keepdim=True)
        ds = round_to(p * (dp - pdp) * scale, mm)
        dq = merge(ds @ kh)  # [B, nq, D]
        dk = merge(ds.transpose(-1, -2) @ qh)  # [B, H, D]
        if dq.shape[1] < h:
            dq = torch.cat([dq, dq.new_zeros(b, h - dq.shape[1], d)], dim=1)
        dqkv = round_to(torch.cat([dq, dk, dv], dim=-1), mm)  # [B, H, 3D]
        grads[0][l] = torch.einsum("brd,brj->dj", x2, dqkv)
        grads[1][l] = dqkv.sum(dim=(0, 1))
        dy = dqkv @ wi.T  # [B, H, D]: the layer input's cotangent
    return dy, [torch.stack(t) for t in grads]


def _encoder_grads(g, xs, ps, w_in, b_in, w_out, num_heads, dtype):
    """(dx, dpe, dw_in, db_in, dw_out, db_out) of the whole encoder from its
    cotangent g [B, 2, D]: dx = dy0 + gmean / H in ``dtype``, dpe sums dy0."""
    g = g.to(dtype).float()
    dy, grads = _backward_plain(g[:, :1], xs, ps, w_in, b_in, w_out, num_heads, _mm(dtype))
    return ((dy + g[:, 1:] / dy.shape[1]).to(dtype), dy.sum(dim=0), *grads)


def fused_history_encoder_bwd_plain(g, xs, ps, p0, w_in, b_in, w_out, num_heads):
    """B6's function: from the cotangent ``g`` [B, 2, D] and the residuals,
    (dx [B, H, D] in the residuals' dtype, dpe [H, D], dw_in, db_in, dw_out,
    db_out), the grads f32 and summed over the batch (``_backward_plain``;
    the stored p is already rounded)."""
    num_layers = xs.shape[0]
    probs = [ps[l].float() for l in range(num_layers - 1)] + [p0.float()[:, :, None, :]]
    return _encoder_grads(g, list(xs.float()), probs, w_in, b_in, w_out, num_heads, xs.dtype)


def fused_history_encoder_bwd_recompute_plain(g, hist_emb, pe, w_in, b_in, w_out, b_out,
                                              num_heads):
    """B7's function: the outputs of ``fused_history_encoder_bwd_plain``
    from the encoder's inputs, the forward recomputed.  Its p is the f32
    probability, unrounded in dp * p and ds (B6's is the stored, rounded
    one), as in ``_enc_bwd_kernel``."""
    dt = hist_emb.dtype
    _, xs, ps = _layers_plain(
        hist_emb.float() + pe.float(), w_in, b_in, w_out, b_out, num_heads, _mm(dt)
    )
    return _encoder_grads(g, xs, ps, w_in, b_in, w_out, num_heads, dt)


def fused_attn_stack_fwd_plain(
    x: torch.Tensor,  # [B, H, D] bf16 or f32: PE added, rows past the length zeroed
    lengths: torch.Tensor,  # [B] int valid-history counts
    w_in: torch.Tensor,
    b_in: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """B8's function: [B, H, D] -> [B, D] in x's dtype, row 0 of the last
    layer of the length-masked stack.  No PE add and no mean-pool; query
    rows at or past the length are computed, but their keys are masked."""
    y0, _, _ = _layers_plain(
        x.float(), w_in, b_in, w_out, b_out, num_heads, _mm(x.dtype), lengths
    )
    return y0.to(x.dtype)


def fused_attn_stack_bwd_plain(g, x, lengths, w_in, b_in, w_out, b_out, num_heads):
    """B9's function: from the cotangent g [B, D] of the stack's output,
    (dx [B, H, D] in x's dtype, dw_in, db_in, dw_out, db_out), the forward
    recomputed with its f32 probabilities (``_stack_bwd_kernel``); g is
    rounded to x's dtype first.  ``lengths`` gets no gradient."""
    mm = _mm(x.dtype)
    _, xs, ps = _layers_plain(x.float(), w_in, b_in, w_out, b_out, num_heads, mm, lengths)
    g0 = g.to(x.dtype).float()[:, None]
    dy, grads = _backward_plain(g0, xs, ps, w_in, b_in, w_out, num_heads, mm)
    return (dy.to(x.dtype), *grads)


def _layers_f64_sums(x, w_in, b_in, w_out, b_out, num_heads, rb, lengths=None):
    """``_layers_plain`` with every sum in f64 on an f64 input x [B, H, D],
    the operands rounded by ``rb`` (to bf16 and back, or not at all): (the
    last layer's row 0 [B, D], each layer's input, each layer's
    probabilities [B, NH, nq, H], all f64 and unrounded)."""
    num_layers = w_in.shape[0]
    b, h, d = x.shape
    hd = d // num_heads
    heads = lambda t: t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
    invalid = None if lengths is None else _key_invalid(lengths, h, x.device)
    xs, ps = [], []
    for l in range(num_layers):
        xs.append(x)
        nq = 1 if l == num_layers - 1 else h
        q, k, v = (heads(rb(t)) for t in (rb(x) @ rb(w_in[l]) + b_in[l].double()).split(d, -1))
        s = (q[:, :, :nq] @ k.transpose(-1, -2)) / math.sqrt(hd)
        if invalid is not None:
            s = s.masked_fill(invalid, _NEG_INF)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / rb(e).sum(-1, keepdim=True)
        ps.append(p)
        out = (rb(p) @ v).transpose(1, 2).reshape(b, nq, d)
        x = rb(out) @ rb(w_out[l]) + b_out[l].double()
    return x[:, 0], xs, ps


def _rounder(dtype):
    """The f64 yardsticks' rounding: to bf16 and back for bf16 input, none for f32."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).double()
    return lambda t: t.double()


def fused_history_encoder_res_f64_sums(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """B5's function (``fused_history_encoder_res_plain``) at the same
    rounding points with every sum in f64: (y, xs, ps, p0) in the input
    dtype.  The yardstick against which two f32 versions whose sums run in
    different orders (the plain version and the tensor-core kernel) are both
    measured."""
    dt, rb = hist_emb.dtype, _rounder(hist_emb.dtype)
    xin = hist_emb.double()
    y0, xs, ps = _layers_f64_sums(rb(xin + pe.double()), w_in, b_in, w_out, b_out, num_heads, rb)
    y = torch.stack([y0, xin.mean(dim=1)], dim=1).to(dt)
    full = torch.stack([p.to(dt) for p in ps[:-1]]) if len(ps) > 1 else None
    return y, torch.stack([x.to(dt) for x in xs]), full, ps[-1][:, :, 0].to(dt)


def fused_history_encoder_f64_sums(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """B1's function (``fused_history_encoder_plain``) with every sum in
    f64: [B, 2, D] in the input dtype (``fused_history_encoder_res_f64_sums``)."""
    return fused_history_encoder_res_f64_sums(hist_emb, pe, w_in, b_in, w_out, b_out,
                                              num_heads)[0]


def fused_attn_stack_f64_sums(x, lengths, w_in, b_in, w_out, b_out, num_heads):
    """B8's function (``fused_attn_stack_fwd_plain``) with every sum in f64:
    [B, D] in x's dtype."""
    rb = _rounder(x.dtype)
    y0, _, _ = _layers_f64_sums(rb(x.double()), w_in, b_in, w_out, b_out, num_heads, rb,
                                lengths)
    return y0.to(x.dtype)


def _backward_f64_sums(dy, xs, ps, w_in, b_in, w_out, num_heads, rb):
    """``_backward_plain`` with every sum in f64: dy [B, nq, D], the layers'
    inputs xs and probabilities ps f64 (each rounded by ``rb`` where the
    plain version rounds it).  Returns (the cotangent of layer 0's input,
    [dw_in, db_in, dw_out, db_out]), f64."""
    num_layers = w_in.shape[0]
    b, h, d = xs[0].shape
    hd = d // num_heads
    heads = lambda t: t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(b, t.shape[2], d)
    grads = [[None] * num_layers for _ in range(4)]
    for l in range(num_layers - 1, -1, -1):
        x2, wi, p = rb(xs[l]), rb(w_in[l]), ps[l]
        q, k, v = (rb(t) for t in (x2 @ wi + b_in[l].double()).split(d, -1))
        qh, kh, vh = heads(q[:, : p.shape[2]]), heads(k), heads(v)
        pv = rb(p)
        g2 = rb(dy)
        grads[2][l] = torch.einsum("bqc,bqj->cj", rb(merge(pv @ vh)), g2)
        grads[3][l] = dy.sum(dim=(0, 1))
        do = heads(rb(g2 @ rb(w_out[l]).T))
        dp = do @ vh.transpose(-1, -2)
        ds = rb(p * (dp - rb(dp * p).sum(-1, keepdim=True)) / math.sqrt(hd))
        dq = merge(ds @ kh)
        dq = torch.cat([dq, dq.new_zeros(b, h - dq.shape[1], d)], dim=1)
        dqkv = rb(torch.cat([dq, merge(ds.transpose(-1, -2) @ qh),
                             merge(pv.transpose(-1, -2) @ do)], -1))
        grads[0][l] = torch.einsum("brd,brj->dj", x2, dqkv)
        grads[1][l] = dqkv.sum(dim=(0, 1))
        dy = dqkv @ wi.T
    return dy, [torch.stack(t) for t in grads]


def fused_history_encoder_bwd_f64_sums(g, xs, ps, p0, w_in, b_in, w_out, num_heads):
    """B6's function (``fused_history_encoder_bwd_plain``) at the same
    rounding points with every sum in f64: (dx in the residuals' dtype, dpe,
    dw_in, db_in, dw_out, db_out f64), the yardstick of the backward as
    ``fused_history_encoder_res_f64_sums`` is the forward's."""
    dt, rb = xs.dtype, _rounder(xs.dtype)
    num_layers = xs.shape[0]
    probs = [ps[l].double() for l in range(num_layers - 1)] + [p0.double()[:, :, None, :]]
    g = g.to(dt).double()
    dy, grads = _backward_f64_sums(g[:, :1], list(xs.double()), probs, w_in, b_in, w_out,
                                   num_heads, rb)
    return ((dy + g[:, 1:] / dy.shape[1]).to(dt), dy.sum(dim=0), *grads)


def fused_attn_stack_bwd_f64_sums(g, x, lengths, w_in, b_in, w_out, b_out, num_heads):
    """B9's function (``fused_attn_stack_bwd_plain``) with every sum in f64,
    the forward recomputed in f64 (``_layers_f64_sums``): (dx in x's dtype,
    dw_in, db_in, dw_out, db_out f64)."""
    rb = _rounder(x.dtype)
    _, xs, ps = _layers_f64_sums(rb(x.double()), w_in, b_in, w_out, b_out, num_heads, rb, lengths)
    dy, grads = _backward_f64_sums(g.to(x.dtype).double()[:, None], xs, ps, w_in, b_in, w_out,
                                   num_heads, rb)
    return (dy.to(x.dtype), *grads)


def _examples_per_block(h: int, d: int, nh: int) -> int:
    fixed = 4 * (3 * d * d + 3 * d + d * d + d + 3 * h * d + nh * h * h + h * d)
    epb = min(_MAX_EXAMPLES_PER_BLOCK, (_SMEM_LIMIT - fixed) // (4 * h * d))
    if epb < 1:
        raise ValueError(
            f"history encoder of H={h}, D={d}, NH={nh} does not fit the "
            "kernel's shared memory"
        )
    return epb


def _check(x, w_in, b_in, w_out, b_out, num_heads) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"history must be bf16 or f32, got {x.dtype}")
    _, _, d = x.shape
    num_layers = w_in.shape[0]
    if d % num_heads or w_in.shape != (num_layers, d, 3 * d):
        raise ValueError("encoder shapes do not agree")
    if b_in.shape != (num_layers, 3 * d) or w_out.shape != (num_layers, d, d) \
            or b_out.shape != (num_layers, d):
        raise ValueError("encoder weight shapes do not agree")


def _f32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.detach().to(device=dev, dtype=torch.float32).contiguous()


def _lens(lengths: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The lengths as the kernels take them: int32 [B] on x's device."""
    b = x.shape[0]
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    return lengths.detach().to(device=x.device, dtype=torch.int32).contiguous()


def _pe(pe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The PE as the kernels take it: f32 [H, D] on x's device."""
    if pe.shape != x.shape[1:]:
        raise ValueError("encoder shapes do not agree")
    return _f32(pe, x.device)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tc_tile(h: int, smem) -> int | None:
    """Examples a tensor-core tile holds: as many as make about 128 rows,
    the rows a multiple of 32 (the projections' warp tiles), fewer where
    ``smem(ept)`` bytes exceed a block's shared memory; None if one does
    not fit."""
    hp = _round_up(h, 16)
    step = 1 if hp % 32 == 0 else 2
    ept = _TC_ROWS // hp // step * step
    while ept >= step and smem(ept) > _SMEM_LIMIT:
        ept -= step
    return ept if ept >= step else None


def _enc_tc_smem_bytes(h: int, d: int, num_layers: int, ept: int) -> int:
    """Dynamic shared memory of ``encoder_tc_kernel`` (csrc/fused_encoder.cu,
    tc::smem_bytes) with ``ept`` examples a tile: bf16 round(W_in) [D, 3D]
    and round(W_out) [D, D] of every layer, two x buffers [rows, D] and
    q | k | v [rows, 3D], each row padded by 8 bf16, then f32 b_in and
    b_out of every layer; rows = ept * round_up(H, 16)."""
    rows = ept * _round_up(h, 16)
    return (2 * (num_layers * d * (3 * d + 8) + num_layers * d * (d + 8) + 2 * rows * (d + 8)
                 + rows * (3 * d + 8)) + 16 * num_layers * d)


def _enc_tc_tile(h: int, d: int, num_layers: int) -> int | None:
    """The whole-encoder tensor-core tile (``_tc_tile``): fewer examples
    where the layers' weights leave less room; None where they leave none."""
    return _tc_tile(h, lambda ept: _enc_tc_smem_bytes(h, d, num_layers, ept) + _TC_STATIC_SMEM)


@functools.lru_cache(maxsize=64)
def _enc_route(dtype, h: int, d: int, nh: int, num_layers: int) -> str:
    """B1's, B5's and B8's kernel, a function of the dtype and shape alone:
    "tc" (the tensor cores: bf16, D a multiple of 32 (the QKV projection's
    warp tiles), the head width a multiple of 16, round_up(H, 16) <= 64,
    every layer's weights and a tile in shared memory) or "fma" (the CUDA
    cores: f32, which the Pallas kernel computes in f32 and TF32 would not
    match; a head width of 8; other widths; longer histories; encoders too
    deep or too wide for shared memory).  Cached, as the plan and the SM
    count are: the wrapper asks on every launch."""
    tc = (dtype == torch.bfloat16 and d % nh == 0 and d % 32 == 0 and (d // nh) % 16 == 0
          and _round_up(h, 16) <= _TC_MAX_HP and _enc_tc_tile(h, d, num_layers) is not None)
    return "tc" if tc else "fma"


@functools.lru_cache(maxsize=64)
def _enc_tc_plan(b: int, h: int, d: int, num_layers: int, sms: int) -> tuple[int, int, int, int]:
    """(examples a tile, rows a tile, dynamic shared memory bytes, grid) of
    a tensor-core launch: one block an SM (the weights of every layer
    staged once a block), at most one a tile; each block walks its tiles in
    a persistent loop."""
    ept = _enc_tc_tile(h, d, num_layers)
    return (ept, ept * _round_up(h, 16), _enc_tc_smem_bytes(h, d, num_layers, ept),
            min(-(-b // ept), sms))


def _enc_bwd_tc_smem_bytes(h: int, d: int, ept: int) -> int:
    """Dynamic shared memory of ``encoder_bwd_tc_kernel``
    (csrc/fused_encoder_bwd.cu, tc::smem_bytes) with ``ept`` examples a
    tile: bf16 round(W_in) [D, 3D] and round(W_out) [D, D] of one layer, x,
    g2, do and the attention output [rows, D] each, q | k | v [rows, 3D],
    each row padded by 8 bf16; min(8, ept * D / 16) warp slabs of round(p)
    and ds [Hp, Hp + 8] each; f32 b_in [3D], b_out [D] and dW_out [D, D]."""
    hp = _round_up(h, 16)
    rows, slabs = ept * hp, min(8, ept * d // 16)
    return (2 * (d * (3 * d + 8) + d * (d + 8) + 4 * rows * (d + 8) + rows * (3 * d + 8)
                 + slabs * 2 * hp * (hp + 8)) + 16 * d + 4 * d * d)


def _enc_bwd_tc_tile(h: int, d: int) -> int | None:
    """The tensor-core backward's tile (``_tc_tile``): fewer examples at
    Hp = 48 and 64."""
    return _tc_tile(h, lambda ept: _enc_bwd_tc_smem_bytes(h, d, ept) + _TC_STATIC_SMEM)


@functools.lru_cache(maxsize=64)
def _enc_bwd_route(dtype, h: int, d: int, nh: int, num_layers: int) -> str:
    """B6's and B9's kernel, a function of the dtype and shape alone: "tc"
    (the tensor cores: bf16, D 32 or 64, the head width a multiple of 16,
    round_up(H, 16) <= 64, a tile in shared memory) or "fma" (the CUDA
    cores: f32, which the Pallas kernel computes in f32 and TF32 would not
    match; a head width of 8; D = 128, whose weight-grad slices (256 floats
    a lane) do not fit the registers; longer histories).  The kernel stages
    one layer's weights at a time, so no depth is refused.  Cached, as
    ``_enc_route``."""
    tc = (dtype == torch.bfloat16 and d in (32, 64) and d % nh == 0 and (d // nh) % 16 == 0
          and num_layers >= 1 and _round_up(h, 16) <= _TC_MAX_HP
          and _enc_bwd_tc_tile(h, d) is not None)
    return "tc" if tc else "fma"


@functools.lru_cache(maxsize=64)
def _enc_bwd_tc_plan(b: int, h: int, d: int, num_layers: int,
                     sms: int) -> tuple[int, int, int, int]:
    """(examples a tile, rows a tile, dynamic shared memory bytes, grid) of
    a tensor-core backward: one block an SM (its weight-grad slices take up
    to 255 registers a thread), at most one a tile.  Block k owns tiles k,
    k + grid, ... and walks them for every layer, so which tiles it sums,
    and in what order, is fixed by (B, H, D) and the SM count; the depth
    changes neither."""
    ept = _enc_bwd_tc_tile(h, d)
    return (ept, ept * _round_up(h, 16), _enc_bwd_tc_smem_bytes(h, d, ept),
            min(-(-b // ept), sms))


def _forward_outputs(name, x, num_layers, num_heads):
    """Empty outputs of forward kernel ``name``: (y, xs, ps, p0) for B5
    (ps None when L == 1), y alone for B1 ([B, 2, D]) and B8 ([B, D])."""
    b, h, d = x.shape
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    y = new(b, d) if name == "fused_attn_stack" else new(b, 2, d)
    if not name.endswith("_res"):
        return y
    ps = new(num_layers - 1, b, num_heads, h, h) if num_layers > 1 else None
    return y, new(num_layers, b, h, d), ps, new(b, num_heads, h)


def _pointers(out) -> list:
    """The pointers of a tensor, or of a tuple or list of tensors (0 for
    None): a forward's outputs (y, or y, xs, ps, p0), a backward's inputs."""
    return [0 if t is None else t.data_ptr()
            for t in (out if isinstance(out, (tuple, list)) else (out,))]


def _launch_fwd_fma(name, x, side, wi, bi, wo, bo, num_heads):
    """Forward kernel ``name`` (B1, B5 or B8) on the CUDA cores
    (``encoder_kernel``) on the wrapper's prepared inputs (``side``: the PE
    or the lengths).  Counts nothing: ``_launch_forward`` does."""
    b, h, d = x.shape
    num_layers = wi.shape[0]
    epb = _examples_per_block(h, d, num_heads)
    out = _forward_outputs(name, x, num_layers, num_heads)
    if b:
        err = getattr(_lib.library(), "tt_" + name)(
            x.data_ptr(), side.data_ptr(), wi.data_ptr(), bi.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), *_pointers(out), b, h, d, num_heads, num_layers,
            int(x.dtype == torch.bfloat16), epb, _lib.stream_ptr(x),
        )
        _lib.check(err, name)
    return out


def _launch_fwd_tc(name, x, side, wi, bi, wo, bo, num_heads):
    """Forward kernel ``name`` on the tensor cores (``encoder_tc_kernel``,
    bf16 x) on the wrapper's prepared inputs.  Counts nothing."""
    b, h, d = x.shape
    num_layers = wi.shape[0]
    # the kernel reads x, W_in and W_out in 16-byte chunks
    x, wi, wo = (t.clone() if t.data_ptr() % 16 else t for t in (x, wi, wo))
    out = _forward_outputs(name, x, num_layers, num_heads)
    if b:
        ept, _, _, grid = _enc_tc_plan(b, h, d, num_layers, _lib.sm_count(x.device.index))
        err = getattr(_lib.library(), f"tt_{name}_tc")(
            x.data_ptr(), side.data_ptr(), wi.data_ptr(), bi.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), *_pointers(out), b, h, d, num_heads, num_layers, ept, grid,
            _lib.stream_ptr(x),
        )
        _lib.check(err, name + "_tc")
    return out


def _launch_forward(name, x, side, w_in, b_in, w_out, b_out, num_heads):
    """Launch forward kernel ``name``: B1 (``fused_history_encoder``), B5
    (``fused_history_encoder_res``: with the residuals) or B8
    (``fused_attn_stack``: a [B, D] output), on the route ``_enc_route``
    gives the dtype and shape.  ``side`` is the prepared PE (``_pe``) or,
    for B8, the lengths (``_lens``).  Every launch counts as ``name``, one
    on the tensor cores also as ``name_tc``."""
    _check(x, w_in, b_in, w_out, b_out, num_heads)
    b, h, d = x.shape
    num_layers = w_in.shape[0]
    tc = _enc_route(x.dtype, h, d, num_heads, num_layers) == "tc"
    out = (_launch_fwd_tc if tc else _launch_fwd_fma)(
        name, x.detach().contiguous(), side,
        *(_f32(t, x.device) for t in (w_in, b_in, w_out, b_out)), num_heads)
    if b:
        _lib.launches[name] += 1
        if tc:
            _lib.launches[name + "_tc"] += 1
    return out


def fused_history_encoder_res(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """(y, xs, ps, p0); see ``fused_history_encoder_res_plain``.  A CPU
    tensor takes the plain version; a CUDA tensor launches kernel B5."""
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_res_plain(
            hist_emb, pe, w_in, b_in, w_out, b_out, num_heads
        )
    return _launch_forward("fused_history_encoder_res", hist_emb, _pe(pe, hist_emb),
                           w_in, b_in, w_out, b_out, num_heads)


def _encoder_forward(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """B1, or its plain version for a CPU tensor."""
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads)
    return _launch_forward("fused_history_encoder", hist_emb, _pe(pe, hist_emb),
                           w_in, b_in, w_out, b_out, num_heads)


def fused_attn_stack_fwd(x, lengths, w_in, b_in, w_out, b_out, num_heads):
    """[B, H, D] -> [B, D]; see ``fused_attn_stack_fwd_plain``.  A CPU
    tensor takes the plain version; a CUDA tensor launches kernel B8."""
    if x.device.type == "cpu":
        return fused_attn_stack_fwd_plain(x, lengths, w_in, b_in, w_out, b_out, num_heads)
    return _launch_forward("fused_attn_stack", x, _lens(lengths, x), w_in, b_in, w_out,
                           b_out, num_heads)


def _bwd_smem_bytes(h: int, d: int, nh: int) -> int:
    """Shared memory of csrc/fused_encoder_bwd.cu (its bwd_smem_bytes)."""
    d3 = 3 * d
    return 4 * (d * (d3 + 1) + d3 + d * (d + 1) + d * d3 + d3 + d * d + d
                + 4 * h * d + h * (d3 + 1) + 2 * nh * h * h)


def _check_bwd_smem(h: int, d: int, nh: int) -> None:
    if _bwd_smem_bytes(h, d, nh) > _SMEM_LIMIT:
        raise ValueError(
            f"history encoder backward of H={h}, D={d}, NH={nh} does not "
            "fit the kernel's shared memory"
        )


def _bwd_grid(b: int, device) -> tuple[int, int]:
    """(blocks, examples per block) of a backward launch: at most one block
    per SM, each owning a contiguous run of examples."""
    sms = _lib.sm_count(device.index)
    epb = -(-b // min(b, sms))
    return -(-b // epb), epb


def _launch_bwd_fma(name, inputs, dx, shapes, num_heads, num_layers, res_floats: int = 0):
    """Backward ``name`` (B6, B7 or B9) on the CUDA cores
    (``encoder_bwd_kernel``) over at most one block per SM, each owning a
    contiguous run of examples, then the reduce: writes dx [B, H, D] and
    returns the grads of ``shapes`` (``_grad_shapes``).  ``inputs`` are the
    kernel's leading tensor arguments (None for a null pointer);
    ``res_floats`` > 0 gives the recomputing kernels their f32 scratch [B,
    res_floats].  Counts nothing: ``_launch_backward`` does."""
    b, h, d = dx.shape
    blocks, epb = _bwd_grid(b, dx.device)
    ws = torch.empty((blocks, sum(math.prod(s) for s in shapes)), dtype=torch.float32,
                     device=dx.device)
    dy = torch.empty((b, h, d), dtype=torch.float32, device=dx.device)
    res = ([torch.empty((b, res_floats), dtype=torch.float32, device=dx.device)]
           if res_floats else [])
    err = getattr(_lib.library(), "tt_" + name)(
        *_pointers(inputs), dx.data_ptr(), *_pointers(res), dy.data_ptr(), ws.data_ptr(), b, h,
        d, num_heads, num_layers, int(dx.dtype == torch.bfloat16), epb, _lib.stream_ptr(dx),
    )
    _lib.check(err, name)
    return _split_grads(_reduce_partials(ws, name), shapes)


def _launch_bwd_tc(name, inputs, dx, shapes, num_heads, num_layers):
    """Backward ``name`` (B6 or B9) on the tensor cores
    (``encoder_bwd_tc_kernel``, bf16) over the plan's grid, then the
    reduce: writes dx and returns the grads, as ``_launch_bwd_fma``.  B9
    gets a bf16 scratch [L-1, B, H, D] for the layers' rebuilt inputs.
    Counts nothing."""
    b, h, d = dx.shape
    # the kernel reads x, g, the probabilities and the weights in 16-byte chunks
    inputs = [t.clone() if t is not None and t.data_ptr() % 16 else t for t in inputs]
    ept, _, _, grid = _enc_bwd_tc_plan(b, h, d, num_layers, _lib.sm_count(dx.device.index))
    ws = torch.empty((grid, sum(math.prod(s) for s in shapes)), dtype=torch.float32,
                     device=dx.device)
    dy = torch.empty((b, h, d), dtype=torch.float32, device=dx.device)
    scratch = []
    if name == "fused_attn_stack_bwd":
        scratch = [torch.empty((num_layers - 1, b, h, d), dtype=dx.dtype, device=dx.device)
                   if num_layers > 1 else None]
    err = getattr(_lib.library(), f"tt_{name}_tc")(
        *_pointers(inputs), dx.data_ptr(), *_pointers(scratch), dy.data_ptr(), ws.data_ptr(),
        b, h, d, num_heads, num_layers, ept, grid, _lib.stream_ptr(dx),
    )
    _lib.check(err, name + "_tc")
    return _split_grads(_reduce_partials(ws, name), shapes)


def _grad_shapes(h: int, d: int, num_layers: int, with_pe: bool) -> list:
    """The grads a backward launch writes, flat and in this order: dW_in,
    db_in, dW_out, db_out and, with the PE, dPE."""
    shapes = [(num_layers, d, 3 * d), (num_layers, 3 * d), (num_layers, d, d), (num_layers, d)]
    return shapes + ([(h, d)] if with_pe else [])


def _split_grads(grads, shapes) -> list:
    """The flat grads as the tensors of ``shapes`` (``_grad_shapes``)."""
    parts = torch.split(grads, [math.prod(s) for s in shapes])
    return [t.view(s) for t, s in zip(parts, shapes)]


def _reduce_partials(ws, name: str) -> torch.Tensor:
    """The per-block partial grads ws [blocks, n] of backward ``name``
    summed in block order (``reduce_kernel``)."""
    grads = torch.empty(ws.shape[1], dtype=torch.float32, device=ws.device)
    err = _lib.library().tt_fused_history_encoder_bwd_reduce(
        ws.data_ptr(), grads.data_ptr(), ws.shape[0], ws.shape[1], _lib.stream_ptr(ws))
    _lib.check(err, name + "_reduce")
    return grads


def _launch_backward(name, inputs, b, h, d, num_heads, num_layers, dtype, dev,
                     with_pe: bool, res_floats: int = 0):
    """Launch backward ``name`` (B6, B7 or B9), B6 and B9 on the route
    ``_enc_bwd_route`` gives the dtype and shape (B7 on the CUDA cores),
    then the reduce that sums the per-block partial grads in block order.
    Every launch counts as ``name`` and ``name_reduce``, one on the tensor
    cores also as ``name_tc``.  ``inputs`` are the kernel's leading tensor
    arguments (None for a null pointer).  Returns (dx, dw_in, db_in,
    dw_out, db_out[, dpe])."""
    shapes = _grad_shapes(h, d, num_layers, with_pe)
    tc = (name != "fused_history_encoder_bwd_recompute"
          and _enc_bwd_route(dtype, h, d, num_heads, num_layers) == "tc")
    if not tc:
        _check_bwd_smem(h, d, num_heads)
    dx = torch.empty((b, h, d), dtype=dtype, device=dev)
    if b == 0:
        return (dx, *(torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes))
    if tc:
        grads = _launch_bwd_tc(name, inputs, dx, shapes, num_heads, num_layers)
    else:
        grads = _launch_bwd_fma(name, inputs, dx, shapes, num_heads, num_layers, res_floats)
    _lib.launches[name] += 1
    _lib.launches[name + "_reduce"] += 1
    if tc:
        _lib.launches[name + "_tc"] += 1
    return (dx, *grads)


def fused_history_encoder_bwd(g, xs, ps, p0, w_in, b_in, w_out, num_heads):
    """(dx, dpe, dw_in, db_in, dw_out, db_out); see
    ``fused_history_encoder_bwd_plain``.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B6, on the route
    ``_enc_bwd_route`` gives, and its reduce."""
    if xs.device.type == "cpu":
        return fused_history_encoder_bwd_plain(g, xs, ps, p0, w_in, b_in, w_out, num_heads)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    num_layers, b, h, d = xs.shape
    dx, dwi, dbi, dwo, dbo, dpe = _launch_backward(
        "fused_history_encoder_bwd", _res_bwd_inputs(g, xs, ps, p0, w_in, b_in, w_out, num_heads),
        b, h, d, num_heads, num_layers, xs.dtype, xs.device, True,
    )
    return dx, dpe, dwi, dbi, dwo, dbo


def _res_bwd_inputs(g, xs, ps, p0, w_in, b_in, w_out, num_heads) -> list:
    """B6's checks and its kernels' leading tensor arguments: g in the
    residuals' dtype, xs, ps (None when L == 1), p0, the f32 weights."""
    if xs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"residuals must be bf16 or f32, got {xs.dtype}")
    num_layers, b, h, d = xs.shape
    if d % num_heads or g.shape != (b, 2, d) or p0.shape != (b, num_heads, h) \
            or (num_layers > 1) != (ps is not None) \
            or (ps is not None and ps.shape != (num_layers - 1, b, num_heads, h, h)):
        raise ValueError("encoder residual shapes do not agree")
    if w_in.shape != (num_layers, d, 3 * d) or b_in.shape != (num_layers, 3 * d) \
            or w_out.shape != (num_layers, d, d):
        raise ValueError("encoder weight shapes do not agree")
    return [g.detach().to(xs.dtype).contiguous(), xs.detach().contiguous(),
            None if ps is None else ps.detach().contiguous(), p0.detach().contiguous(),
            *(_f32(t, xs.device) for t in (w_in, b_in, w_out))]


def _recompute_bwd_inputs(g, x, side, w_in, b_in, w_out, b_out, num_heads, *,
                          enc: bool) -> list:
    """B7's (``enc``: ``side`` the prepared PE, g [B, 2, D]) or B9's
    (``side`` the prepared lengths, g [B, D]) checks and its kernels'
    leading tensor arguments: g in x's dtype, x, side, the f32 weights."""
    _check(x, w_in, b_in, w_out, b_out, num_heads)
    b, _, d = x.shape
    if g.shape != ((b, 2, d) if enc else (b, d)):
        raise ValueError(f"cotangent of shape {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    return [g.detach().to(x.dtype).contiguous(), x.detach().contiguous(), side,
            *(_f32(t, x.device) for t in (w_in, b_in, w_out, b_out))]


def _res_floats(h: int, d: int, num_heads: int, num_layers: int) -> int:
    """The FMA kernels' rebuilt residuals of an example, in floats: its
    layers' inputs and the full and thin layers' probabilities."""
    return num_layers * h * d + (num_layers - 1) * num_heads * h * h + num_heads * h


def _launch_recompute_bwd(name, g, x, side, w_in, b_in, w_out, b_out, num_heads, *,
                          enc: bool):
    """Launch recomputing backward ``name``: B7 or B9 (``_recompute_bwd_inputs``).
    Returns (dx, dw_in, db_in, dw_out, db_out[, dpe])."""
    inputs = _recompute_bwd_inputs(g, x, side, w_in, b_in, w_out, b_out, num_heads, enc=enc)
    b, h, d = x.shape
    num_layers = w_in.shape[0]
    return _launch_backward(name, inputs, b, h, d, num_heads, num_layers, x.dtype, x.device,
                            enc, _res_floats(h, d, num_heads, num_layers))


def fused_history_encoder_bwd_recompute(g, hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """(dx, dpe, dw_in, db_in, dw_out, db_out); see
    ``fused_history_encoder_bwd_recompute_plain``.  A CPU tensor takes the
    plain version; a CUDA tensor launches kernel B7 and its reduce."""
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_bwd_recompute_plain(
            g, hist_emb, pe, w_in, b_in, w_out, b_out, num_heads
        )
    dx, dwi, dbi, dwo, dbo, dpe = _launch_recompute_bwd(
        "fused_history_encoder_bwd_recompute", g, hist_emb, _pe(pe, hist_emb), w_in, b_in,
        w_out, b_out, num_heads, enc=True,
    )
    return dx, dpe, dwi, dbi, dwo, dbo


def fused_attn_stack_bwd(g, x, lengths, w_in, b_in, w_out, b_out, num_heads):
    """(dx, dw_in, db_in, dw_out, db_out); see ``fused_attn_stack_bwd_plain``.
    A CPU tensor takes the plain version; a CUDA tensor launches kernel B9,
    on the route ``_enc_bwd_route`` gives, and its reduce."""
    if x.device.type == "cpu":
        return fused_attn_stack_bwd_plain(g, x, lengths, w_in, b_in, w_out, b_out, num_heads)
    return _launch_recompute_bwd(
        "fused_attn_stack_bwd", g, x, _lens(lengths, x), w_in, b_in, w_out, b_out,
        num_heads, enc=False,
    )


def _input_grads(grads, ctx) -> list:
    """Each input's grad in its dtype (``ctx.dtypes``), None where autograd
    wants none."""
    return [g.to(dt) if need and g is not None else None
            for g, dt, need in zip(grads, ctx.dtypes, ctx.needs_input_grad)]


class _FusedHistoryEncoder(torch.autograd.Function):
    """The JAX custom VJP of ``fused_history_encoder``: B5 forward and B6
    backward, or, with ``_RESIDUAL_BWD`` False when the forward ran, B1
    forward and B7 backward."""

    @staticmethod
    def forward(ctx, hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
        args = (hist_emb, pe, w_in, b_in, w_out, b_out)
        ctx.num_heads = num_heads
        ctx.residual = _RESIDUAL_BWD
        ctx.dtypes = [t.dtype for t in args]
        if not ctx.residual:
            ctx.save_for_backward(*args)
            return _encoder_forward(*args, num_heads)
        y, xs, ps, p0 = fused_history_encoder_res(*args, num_heads)
        ctx.save_for_backward(xs, ps, p0, w_in, b_in, w_out)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.residual:
            grads = fused_history_encoder_bwd(g, *ctx.saved_tensors, ctx.num_heads)
        else:
            grads = fused_history_encoder_bwd_recompute(g, *ctx.saved_tensors, ctx.num_heads)
        return (*_input_grads(grads, ctx), None)


def fused_history_encoder(
    hist_emb: torch.Tensor,
    pe: torch.Tensor,
    w_in: torch.Tensor,
    b_in: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """[B, H, D] -> [B, 2, D]; see ``fused_history_encoder_plain``.  When a
    gradient is wanted (grad mode on and an input requires grad) it runs the
    ``autograd.Function`` (B5 and B6, or B1 and B7); otherwise B1.  A CPU
    tensor takes the plain versions; a CUDA tensor launches the kernels."""
    args = (hist_emb, pe, w_in, b_in, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedHistoryEncoder.apply(*args, num_heads)
    return _encoder_forward(*args, num_heads)


class _FusedAttnStack(torch.autograd.Function):
    """The JAX custom VJP of ``fused_attn_stack``: B8 forward, B9 backward
    (``_stack_vjp_fwd`` / ``_stack_vjp_bwd``); ``lengths`` gets no grad."""

    @staticmethod
    def forward(ctx, x, lengths, w_in, b_in, w_out, b_out, num_heads):
        ctx.num_heads = num_heads
        ctx.dtypes = [t.dtype for t in (x, lengths, w_in, b_in, w_out, b_out)]
        ctx.save_for_backward(x, lengths, w_in, b_in, w_out, b_out)
        return fused_attn_stack_fwd(x, lengths, w_in, b_in, w_out, b_out, num_heads)

    @staticmethod
    def backward(ctx, g):
        dx, *dw = fused_attn_stack_bwd(g, *ctx.saved_tensors, ctx.num_heads)
        return (*_input_grads([dx, None, *dw], ctx), None)


def fused_attn_stack(
    x: torch.Tensor,  # [B, H, D]: PE already added, rows past the length zeroed
    lengths: torch.Tensor,  # [B] int valid-history counts (>= 1)
    w_in: torch.Tensor,  # [L, D, 3D]
    b_in: torch.Tensor,  # [L, 3D]
    w_out: torch.Tensor,  # [L, D, D]
    b_out: torch.Tensor,  # [L, D]
    num_heads: int,
) -> torch.Tensor:
    """[B, H, D] -> [B, D]: row 0 of the length-masked attention stack (see
    ``fused_attn_stack_fwd_plain``).  When a gradient is wanted it runs the
    ``autograd.Function`` (B8 then B9); otherwise B8."""
    args = (x, w_in, b_in, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedAttnStack.apply(x, lengths, w_in, b_in, w_out, b_out, num_heads)
    return fused_attn_stack_fwd(x, lengths, w_in, b_in, w_out, b_out, num_heads)
