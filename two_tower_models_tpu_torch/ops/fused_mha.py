"""One multi-head self-attention layer in one kernel: forward and its
recompute backward (the per-layer attention tier).

Port of ``two_tower_models_tpu/ops/pallas/fused_mha.py``:

- B13, ``_fwd_kernel`` (``pallas_call`` at :297): ``fused_mha_fwd``, the
  whole layer (QKV projection, per-head softmax attention with a key mask,
  output projection) for every query row (``csrc/fused_mha.cu``), on one
  of two kernels chosen by ``_fwd_route`` before the launch: bf16 layers
  of head width 16, 32, ..., D a multiple of 32 and H up to 64 on the
  tensor cores (``mha_fwd_tc_kernel``, tiles of several examples), every
  other layer on the CUDA cores (``mha_fwd_kernel``, one example at a
  time);
- B14, ``_bwd_kernel`` (:369), the custom VJP's backward: ``fused_mha_bwd``,
  which recomputes the layer's forward and writes dx and per-block
  weight-grad partials, plus a second launch that sums the partials in
  block order (same file), on one of two kernels chosen by ``_bwd_route``:
  bf16 layers of D 32 or 64, head width 16, 32, ... and H up to 64 on the
  tensor cores (``mha_bwd_tc_kernel``), every other layer on the CUDA
  cores (``mha_bwd_kernel``).

``fused_mha_layer`` runs B13 alone when no gradient is wanted and the
``autograd.Function`` (B13 then B14) when one is, as the JAX primal /
``_vjp_fwd`` split does.  Each kernel has a plain PyTorch version with the
Pallas kernel's rounding points (``ops.fused_encoder._attn_layer_plain``
and ``_backward_plain``, which the whole-encoder kernels share): the CPU
path, and the reference the kernel is held against on the card.  The
output rounds to x's dtype at every layer, and every query row is
computed, so it is held against ``fused_mha_layer`` itself, not against
the whole-encoder kernels.

The Pallas ``tile_b`` (and the backward's halving of it) is a VMEM limit of
the TPU and has no counterpart: the CUDA launchers size their grids from B
and the SM count.  Keys past an example's length (``lens``) are masked;
``lens`` None means every key is valid, which is what the JAX default of
H per example computes.
"""

from __future__ import annotations

import functools
import math

import torch

from two_tower_models_tpu_torch.ops import _lib
from two_tower_models_tpu_torch.ops.fused_encoder import (
    _SMEM_LIMIT,
    _TC_MAX_HP,
    _attn_layer_plain,
    _backward_plain,
    _bwd_grid,
    _f32,
    _input_grads,
    _key_invalid,
    _lens,
    _mm,
    _round_up,
    _tc_tile,
)


def fused_mha_layer_plain(
    x: torch.Tensor,  # [B, H, D] bf16 or f32
    lens: torch.Tensor | None,  # [B] valid keys per example in [1, H], or None (all)
    w_in: torch.Tensor,  # [D, 3D]
    b_in: torch.Tensor,  # [3D]
    w_out: torch.Tensor,  # [D, D]
    b_out: torch.Tensor,  # [D]
    num_heads: int,
) -> torch.Tensor:
    """B13's function, ``_fwd_kernel`` with ``_attend``: [B, H, D] -> [B, H, D]
    in x's dtype.  Under bf16 x, x and W_in round to bf16; q, k and v round
    after the f32 bias add; the softmax denominator sums the bf16-rounded
    exponentials in f32; p rounds before P.V, the attention output before
    W_out (rounded too); y adds b_out in f32 and is written in x's dtype."""
    invalid = None if lens is None else _key_invalid(lens, x.shape[1], x.device)
    y, _ = _attn_layer_plain(x.float(), w_in, b_in, w_out, b_out, num_heads, _mm(x.dtype),
                             invalid)
    return y.to(x.dtype)


def fused_mha_layer_f64_sums(x, lens, w_in, b_in, w_out, b_out, num_heads):
    """B13's function on bf16 x at its bf16 rounding points with every sum
    taken in f64, as y [B, H, D] bf16: the yardstick against which two f32
    versions whose sums run in different orders (the plain version and the
    tensor-core kernel) are both measured."""
    rb = lambda t: t.to(torch.bfloat16).double()
    b, h, d = x.shape
    heads = lambda t: t.reshape(b, h, num_heads, d // num_heads).transpose(1, 2)
    q, k, v = (heads(rb(t)) for t in (rb(x) @ rb(w_in) + b_in.double()).split(d, -1))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(d // num_heads)
    if lens is not None:
        s = s.masked_fill(_key_invalid(lens, h, x.device), -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = (rb(e / rb(e).sum(-1, keepdim=True)) @ v).transpose(1, 2).reshape(b, h, d)
    return (rb(out) @ rb(w_out) + b_out.double()).to(torch.bfloat16)


def fused_mha_layer_bwd_plain(g, x, lens, w_in, b_in, w_out, b_out, num_heads):
    """B14's function, ``_bwd_kernel`` and ``_vjp_bwd``: from the cotangent
    g [B, H, D] of the layer's output (rounded to x's dtype first), (dx
    [B, H, D] in x's dtype, dw_in, db_in, dw_out, db_out) with the weight
    grads f32 and summed over the batch.  The forward is recomputed with its
    f32 probabilities, used unrounded in dp * p and ds; db_out sums the
    rounded g and db_in the rounded dqkv (``_backward_plain``)."""
    mm = _mm(x.dtype)
    xf = x.float()
    invalid = None if lens is None else _key_invalid(lens, x.shape[1], x.device)
    _, p = _attn_layer_plain(xf, w_in, b_in, w_out, b_out, num_heads, mm, invalid)
    dx, grads = _backward_plain(g.to(x.dtype).float(), [xf], [p], w_in[None], b_in[None],
                                w_out[None], num_heads, mm)
    return (dx.to(x.dtype), *(t[0] for t in grads))


def fused_mha_layer_bwd_f64_sums(g, x, lens, w_in, b_in, w_out, b_out, num_heads):
    """B14's function on bf16 x at its bf16 rounding points with every sum
    taken in f64: (dx [B, H, D] bf16, dw_in, db_in, dw_out, db_out f64), the
    yardstick of the backward as ``fused_mha_layer_f64_sums`` is the
    forward's."""
    rb = lambda t: t.to(torch.bfloat16).double()
    b, h, d = x.shape
    hd = d // num_heads
    heads = lambda t: t.reshape(b, h, num_heads, hd).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(b, h, d)
    x2, wi = rb(x), rb(w_in)
    q, k, v = (heads(rb(t)) for t in (x2 @ wi + b_in.double()).split(d, -1))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if lens is not None:
        s = s.masked_fill(_key_invalid(lens, h, x.device), -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / rb(e).sum(-1, keepdim=True)
    pv = rb(p)
    g2 = rb(g)
    dwo = torch.einsum("bqc,bqj->cj", rb(merge(pv @ v)), g2)
    do = heads(rb(g2 @ rb(w_out).T))
    dp = do @ v.transpose(-1, -2)
    ds = rb(p * (dp - rb(dp * p).sum(-1, keepdim=True)) / math.sqrt(hd))
    dqkv = rb(torch.cat([merge(ds @ k), merge(ds.transpose(-1, -2) @ q),
                         merge(pv.transpose(-1, -2) @ do)], -1))
    return ((dqkv @ wi.T).to(torch.bfloat16), torch.einsum("brd,brj->dj", x2, dqkv),
            dqkv.sum((0, 1)), dwo, g2.sum((0, 1)))


def _fwd_smem_bytes(h: int, d: int, nh: int, wsm: bool) -> int:
    """Shared memory of B13 (csrc/fused_mha.cu, fwd_smem_floats): with
    ``wsm`` the weights [D, 3D], [3D], [D, D], [D]; always one example's
    qkv [H, 3D+1] and its round(x) / scores [max(H*D, NH*H*H)]."""
    w = d * 3 * d + 3 * d + d * d + d if wsm else 0
    return 4 * (w + h * (3 * d + 1) + max(h * d, nh * h * h))


def _bwd_smem_bytes(h: int, d: int, nh: int, wsm: bool) -> int:
    """Shared memory of B14 (csrc/fused_mha.cu, bwd_smem_floats): with
    ``wsm`` the weights W_in [D, 3D+1], b_in, W_out [D, D+1] and the four
    grad accumulators; always one example's x, do, dy [H, D] each, qkv
    [H, 3D+1], probabilities and scores [NH, H, H] each."""
    w = d * (3 * d + 1) + 3 * d + d * (d + 1) + d * 3 * d + 3 * d + d * d + d if wsm else 0
    return 4 * (w + 3 * h * d + h * (3 * d + 1) + 2 * nh * h * h)


_TC_BLOCKS_PER_SM = 2  # the tensor-core kernel's __launch_bounds__
_SM_SMEM = 233472  # bytes of shared memory a Hopper SM holds for its blocks
_BLOCK_RESERVED = 1024  # of which each resident block takes for itself


def _fwd_tc_smem_bytes(h: int, d: int, ept: int) -> int:
    """Shared memory of B13's tensor-core kernel (csrc/fused_mha.cu,
    tc::smem_bytes) with ``ept`` examples a tile: bf16 round(W_in) [D, 3D],
    round(W_out) [D, D], x [rows, D] and qkv [rows, 3D], each row padded by
    8 bf16, then f32 b_in and b_out; rows = ept * round_up(H, 16)."""
    rows = ept * _round_up(h, 16)
    return 2 * (d * (3 * d + 8) + d * (d + 8) + rows * (d + 8) + rows * (3 * d + 8)) + 16 * d


def _bwd_tc_smem_bytes(h: int, d: int, ept: int) -> int:
    """Shared memory of B14's tensor-core kernel (csrc/fused_mha.cu,
    tc::bwd_smem_bytes) with ``ept`` examples a tile: bf16 round(W_in)
    [D, 3D], round(W_out) [D, D], x, g2, do and the attention output [rows,
    D] each, q | k | v [rows, 3D], each row padded by 8 bf16; min(8, ept * D
    / 16) warp slabs (one a warp with an (example, head) to take) of round(p)
    and ds [Hp, Hp + 8] each; f32 b_in."""
    hp = _round_up(h, 16)
    rows, slabs = ept * hp, min(8, ept * d // 16)
    return 2 * (d * (3 * d + 8) + d * (d + 8) + 4 * rows * (d + 8) + rows * (3 * d + 8)
                + slabs * 2 * hp * (hp + 8)) + 12 * d


def _fwd_tc_tile(h: int, d: int) -> int | None:
    """B13's tile (``_tc_tile``): fewer examples at D = 128."""
    return _tc_tile(h, lambda ept: _fwd_tc_smem_bytes(h, d, ept))


def _bwd_tc_tile(h: int, d: int) -> int | None:
    """B14's tile (``_tc_tile``): one example at H = 64."""
    return _tc_tile(h, lambda ept: _bwd_tc_smem_bytes(h, d, ept))


@functools.lru_cache(maxsize=64)
def _fwd_route(dtype, h: int, d: int, nh: int) -> str:
    """B13's kernel for a layer, a function of its dtype and shape alone:
    "tc" (the tensor cores: bf16, D a multiple of 32 (the QKV projection's
    32-column warp tiles of 3D), the head width a multiple of 16,
    round_up(H, 16) <= 64, a tile that fits) or "fma" (the CUDA cores:
    f32, which the Pallas kernel computes in f32 and TF32 would not match;
    a head width of 8; other widths; longer histories).  Cached, as the
    plan and the SM count are: the wrapper asks on every launch."""
    tc = (dtype == torch.bfloat16 and d % nh == 0 and d % 32 == 0 and (d // nh) % 16 == 0
          and _round_up(h, 16) <= _TC_MAX_HP and _fwd_tc_tile(h, d) is not None)
    return "tc" if tc else "fma"


@functools.lru_cache(maxsize=64)
def _fwd_tc_plan(b: int, h: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """(examples a tile, rows a tile, shared memory bytes, grid) of a
    tensor-core launch: the grid is the blocks resident at once (at most
    two per SM, fewer where shared memory allows fewer), at most one per
    tile; each block walks its tiles in a persistent loop."""
    ept = _fwd_tc_tile(h, d)
    smem = _fwd_tc_smem_bytes(h, d, ept)
    per_sm = max(1, min(_TC_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED)))
    return ept, ept * _round_up(h, 16), smem, min(-(-b // ept), per_sm * sms)


@functools.lru_cache(maxsize=64)
def _bwd_route(dtype, h: int, d: int, nh: int) -> str:
    """B14's kernel for a layer, a function of its dtype and shape alone:
    "tc" (the tensor cores: bf16, D 32 or 64, the head width a multiple of
    16, round_up(H, 16) <= 64, a tile that fits) or "fma" (the CUDA cores:
    every other layer, f32 and D = 128 among them: each warp keeps its
    slice of the 4D^2 weight-grad sums in registers, 64 a lane at D = 64
    and 256 at D = 128, more than a thread has).  Cached, as ``_fwd_route``."""
    tc = (dtype == torch.bfloat16 and d in (32, 64) and d % nh == 0 and (d // nh) % 16 == 0
          and _round_up(h, 16) <= _TC_MAX_HP and _bwd_tc_tile(h, d) is not None)
    return "tc" if tc else "fma"


@functools.lru_cache(maxsize=64)
def _bwd_tc_plan(b: int, h: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """(examples a tile, rows a tile, shared memory bytes, grid) of a
    tensor-core backward: one block an SM (its weight-grad slices take up
    to 255 registers a thread), at most one a tile; each block walks its
    tiles in a persistent loop, so which tiles it sums, and in what order,
    is fixed by (B, H, D) and the SM count."""
    ept = _bwd_tc_tile(h, d)
    return ept, ept * _round_up(h, 16), _bwd_tc_smem_bytes(h, d, ept), min(-(-b // ept), sms)


def _weights_in_smem(smem_bytes, what: str, h: int, d: int, nh: int) -> bool:
    """True if the weights (and a backward's grad accumulators) fit in
    shared memory beside one example's working set; False if only the
    working set does (the kernel then reads the weights from device memory
    and accumulates the grads in its workspace slice); raises if neither."""
    for wsm in (True, False):
        if smem_bytes(h, d, nh, wsm) <= _SMEM_LIMIT:
            return wsm
    raise ValueError(
        f"attention layer {what} of H={h}, D={d}, NH={nh} does not fit the kernel's "
        "shared memory"
    )


def _check(x, w_in, b_in, w_out, b_out, num_heads) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, H, D], got {tuple(x.shape)}")
    d = x.shape[2]
    if d % num_heads or w_in.shape != (d, 3 * d) or b_in.shape != (3 * d,) \
            or w_out.shape != (d, d) or b_out.shape != (d,):
        raise ValueError("attention layer shapes do not agree")


def _launch_fwd_fma(x, lens, wi, bi, wo, bo, num_heads):
    """B13 on the CUDA cores (``mha_fwd_kernel``) on the wrapper's prepared
    inputs: y [B, H, D] in x's dtype.  Counts nothing: ``fused_mha_fwd``
    does."""
    b, h, d = x.shape
    wsm = _weights_in_smem(_fwd_smem_bytes, "forward", h, d, num_heads)
    y = torch.empty_like(x)
    if b:
        err = _lib.library().tt_fused_mha_fwd(
            x.data_ptr(), 0 if lens is None else lens.data_ptr(), wi.data_ptr(), bi.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), b, h, d, num_heads,
            int(x.dtype == torch.bfloat16), int(wsm), _lib.stream_ptr(x),
        )
        _lib.check(err, "fused_mha_fwd")
    return y


def _launch_fwd_tc(x, lens, wi, bi, wo, bo, num_heads):
    """B13 on the tensor cores (``mha_fwd_tc_kernel``, bf16 x) on the
    wrapper's prepared inputs: y [B, H, D] bf16.  Counts nothing."""
    b, h, d = x.shape
    # the kernel reads x, W_in and W_out in 16-byte chunks
    x, wi, wo = (t.clone() if t.data_ptr() % 16 else t for t in (x, wi, wo))
    y = torch.empty_like(x)
    if b:
        ept, _, _, grid = _fwd_tc_plan(b, h, d, _lib.sm_count(x.device.index))
        err = _lib.library().tt_fused_mha_fwd_tc(
            x.data_ptr(), 0 if lens is None else lens.data_ptr(), wi.data_ptr(), bi.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), b, h, d, num_heads, ept, grid,
            _lib.stream_ptr(x),
        )
        _lib.check(err, "fused_mha_fwd_tc")
    return y


def _fwd_inputs(x, lens, w_in, b_in, w_out, b_out):
    """The kernels' operands: x contiguous, lengths int32, f32 weights, all
    on x's device."""
    dev = x.device
    x = x.detach().contiguous()
    return (x, None if lens is None else _lens(lens, x),
            *(_f32(t, dev) for t in (w_in, b_in, w_out, b_out)))


def fused_mha_fwd(x, lens, w_in, b_in, w_out, b_out, num_heads):
    """[B, H, D] -> [B, H, D]; see ``fused_mha_layer_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor launches kernel B13 on the route
    ``_fwd_route`` gives its dtype and shape.  Every launch counts as
    ``fused_mha_fwd``, one on the tensor cores also as ``fused_mha_fwd_tc``."""
    if x.device.type == "cpu":
        return fused_mha_layer_plain(x, lens, w_in, b_in, w_out, b_out, num_heads)
    _check(x, w_in, b_in, w_out, b_out, num_heads)
    tc = _fwd_route(x.dtype, x.shape[1], x.shape[2], num_heads) == "tc"
    y = (_launch_fwd_tc if tc else _launch_fwd_fma)(
        *_fwd_inputs(x, lens, w_in, b_in, w_out, b_out), num_heads)
    if x.shape[0]:
        _lib.launches["fused_mha_fwd"] += 1
        if tc:
            _lib.launches["fused_mha_fwd_tc"] += 1
    return y


def _bwd_inputs(g, x, lens, w_in, b_in, w_out):
    """The backward kernels' operands: g in x's dtype and x contiguous,
    lengths int32, f32 weights, all on x's device."""
    dev = x.device
    x = x.detach().contiguous()
    return (g.detach().to(x.dtype).contiguous(), x, None if lens is None else _lens(lens, x),
            *(_f32(t, dev) for t in (w_in, b_in, w_out)))


def _reduce_partials(ws):
    """The per-block partial grads ws [blocks, n] summed in block order
    (``reduce_kernel``): flat dW_in, db_in, dW_out, db_out."""
    grads = torch.empty(ws.shape[1], dtype=torch.float32, device=ws.device)
    err = _lib.library().tt_fused_mha_bwd_reduce(ws.data_ptr(), grads.data_ptr(), ws.shape[0],
                                                 ws.shape[1], _lib.stream_ptr(ws))
    _lib.check(err, "fused_mha_bwd_reduce")
    return grads


def _launch_bwd_fma(g, x, lens, wi, bi, wo, num_heads):
    """B14 on the CUDA cores (``mha_bwd_kernel``, over at most one block per
    SM) and its reduce, on the wrapper's prepared inputs (B >= 1): (dx in
    x's dtype, the flat f32 grads).  Counts nothing: ``fused_mha_bwd`` does."""
    b, h, d = x.shape
    wsm = _weights_in_smem(_bwd_smem_bytes, "backward", h, d, num_heads)
    blocks, epb = _bwd_grid(b, x.device)
    ws = torch.empty((blocks, 4 * d * d + 4 * d), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    err = _lib.library().tt_fused_mha_bwd(
        g.data_ptr(), x.data_ptr(), 0 if lens is None else lens.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wo.data_ptr(), dx.data_ptr(), ws.data_ptr(), b, h, d, num_heads,
        int(x.dtype == torch.bfloat16), int(wsm), epb, _lib.stream_ptr(x),
    )
    _lib.check(err, "fused_mha_bwd")
    return dx, _reduce_partials(ws)


def _launch_bwd_tc(g, x, lens, wi, bi, wo, num_heads):
    """B14 on the tensor cores (``mha_bwd_tc_kernel``, bf16) and its reduce,
    on the wrapper's prepared inputs (B >= 1): (dx bf16, the flat f32
    grads).  Counts nothing."""
    b, h, d = x.shape
    # the kernel reads g, x, W_in and W_out in 16-byte chunks
    g, x, wi, wo = (t.clone() if t.data_ptr() % 16 else t for t in (g, x, wi, wo))
    ept, _, _, grid = _bwd_tc_plan(b, h, d, _lib.sm_count(x.device.index))
    ws = torch.empty((grid, 4 * d * d + 4 * d), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    err = _lib.library().tt_fused_mha_bwd_tc(
        g.data_ptr(), x.data_ptr(), 0 if lens is None else lens.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wo.data_ptr(), dx.data_ptr(), ws.data_ptr(), b, h, d, num_heads, ept,
        grid, _lib.stream_ptr(x),
    )
    _lib.check(err, "fused_mha_bwd_tc")
    return dx, _reduce_partials(ws)


def fused_mha_bwd(g, x, lens, w_in, b_in, w_out, b_out, num_heads):
    """(dx, dw_in, db_in, dw_out, db_out); see ``fused_mha_layer_bwd_plain``.
    A CPU tensor takes the plain version; a CUDA tensor launches kernel B14
    on the route ``_bwd_route`` gives its dtype and shape, then the reduce
    that sums the per-block partial grads in block order.  Every launch
    counts as ``fused_mha_bwd`` and ``fused_mha_bwd_reduce``, one on the
    tensor cores also as ``fused_mha_bwd_tc``."""
    if x.device.type == "cpu":
        return fused_mha_layer_bwd_plain(g, x, lens, w_in, b_in, w_out, b_out, num_heads)
    _check(x, w_in, b_in, w_out, b_out, num_heads)
    b, h, d = x.shape
    if g.shape != x.shape:
        raise ValueError(f"cotangent of shape {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    if b == 0:
        dx = torch.empty_like(x)
        grads = torch.zeros(4 * d * d + 4 * d, dtype=torch.float32, device=x.device)
    else:
        tc = _bwd_route(x.dtype, h, d, num_heads) == "tc"
        dx, grads = (_launch_bwd_tc if tc else _launch_bwd_fma)(
            *_bwd_inputs(g, x, lens, w_in, b_in, w_out), num_heads)
        _lib.launches["fused_mha_bwd"] += 1
        _lib.launches["fused_mha_bwd_reduce"] += 1
        if tc:
            _lib.launches["fused_mha_bwd_tc"] += 1
    dwi, dbi, dwo, dbo = torch.split(grads, [d * 3 * d, 3 * d, d * d, d])
    return dx, dwi.view(d, 3 * d), dbi, dwo.view(d, d), dbo


class _FusedMHALayer(torch.autograd.Function):
    """The JAX custom VJP of ``fused_mha_layer``: B13 forward, saving x,
    lens and the weights (``_vjp_fwd``); B14 backward (``_vjp_bwd``).
    ``lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, lens, w_in, b_in, w_out, b_out, num_heads):
        args = (x, lens, w_in, b_in, w_out, b_out)
        ctx.num_heads = num_heads
        ctx.dtypes = [None if t is None else t.dtype for t in args]
        ctx.save_for_backward(*args)
        return fused_mha_fwd(*args, num_heads)

    @staticmethod
    def backward(ctx, g):
        dx, *dw = fused_mha_bwd(g, *ctx.saved_tensors, ctx.num_heads)
        return (*_input_grads([dx, None, *dw], ctx), None)


def fused_mha_layer(
    x: torch.Tensor,  # [B, H, D] bf16 or f32
    w_in: torch.Tensor,  # [D, 3D]
    b_in: torch.Tensor,  # [3D]
    w_out: torch.Tensor,  # [D, D]
    b_out: torch.Tensor,  # [D]
    num_heads: int,
    lengths: torch.Tensor | None = None,  # [B] valid key counts
) -> torch.Tensor:
    """The whole attention layer, [B, H, D] -> [B, H, D] in x's dtype (see
    ``fused_mha_layer_plain``).  ``lengths`` are clipped to [1, H]; keys at
    or past an example's length are masked, and its query rows there are
    computed all the same (rows the encoder never reads).  When a gradient
    is wanted it runs the ``autograd.Function`` (B13 then B14); otherwise
    B13."""
    lens = None if lengths is None else lengths.clamp(1, x.shape[1])
    args = (x, w_in, b_in, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedMHALayer.apply(x, lens, w_in, b_in, w_out, b_out, num_heads)
    return fused_mha_fwd(x, lens, w_in, b_in, w_out, b_out, num_heads)
