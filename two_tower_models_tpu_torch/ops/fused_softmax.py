"""In-batch sampled-softmax cross-entropy without the [B, C] score matrix.

Port of ``two_tower_models_tpu/ops/pallas/fused_softmax.py``:
``fused_in_batch_ce`` (ce, lse with diagonal positives) and ``fused_lse``
(the rectangular row logsumexp), each an ``autograd.Function`` whose
forward is kernel B10 (3xTF32 on the tensor cores, one launch on
``fwd_plan``'s grid) and whose backward is one kernel for both B11 (dU)
and B12 (dI), which computes each tile of scores once, plus the launch
that sums its partial slices, all in ``csrc/fused_softmax.cu``; the
source's note says what bounds them on the H100.  The plain versions below
compute the same functions with the [B, C] matrix materialised: the CPU
path, and the reference the kernels are held against on the card.

As in the JAX package, the backward reads only the cotangent of ``ce``
(``fused_in_batch_ce``) or of ``lse`` (``fused_lse``); a cotangent of the
``lse`` output of ``fused_in_batch_ce`` is dropped.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from two_tower_models_tpu_torch.ops import _lib


def in_batch_ce_fwd_plain(
    u: torch.Tensor, i: torch.Tensor, with_diag: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce [B], lse [B]) f32: lse_b = logsumexp_j u_b . i_j and ce_b =
    lse_b - u_b . i_b (ce = lse without the diagonal)."""
    s = u.float() @ i.float().T
    lse = torch.logsumexp(s, dim=1)
    if not with_diag:
        return lse.clone(), lse
    return lse - torch.diagonal(s), lse


def _gp(u, i, lse, g):
    """g_b * p_bj with p = exp(s - lse), [B, C] f32."""
    return torch.exp(u.float() @ i.float().T - lse[:, None]) * g.float()[:, None]


def in_batch_ce_bwd_du_plain(u, i, lse, g, with_diag: bool = True) -> torch.Tensor:
    """dU_b = sum_j g_b p_bj i_j (- g_b i_b with the diagonal), [B, D] f32."""
    du = _gp(u, i, lse, g) @ i.float()
    if with_diag:
        n = min(u.shape[0], i.shape[0])
        du[:n] -= g.float()[:n, None] * i.float()[:n]
    return du


def in_batch_ce_bwd_di_plain(u, i, lse, g, with_diag: bool = True) -> torch.Tensor:
    """dI_j = sum_b g_b p_bj u_b (- g_j u_j with the diagonal), [C, D] f32."""
    di = _gp(u, i, lse, g).T @ u.float()
    if with_diag:
        n = min(u.shape[0], i.shape[0])
        di[:n] -= g.float()[:n, None] * u.float()[:n]
    return di


def in_batch_ce_bwd_plain(
    u, i, lse, g, with_diag: bool = True, want_du: bool = True, want_di: bool = True
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dU [B, D] or None, dI [C, D] or None) f32: the gradients asked for."""
    du = in_batch_ce_bwd_du_plain(u, i, lse, g, with_diag) if want_du else None
    di = in_batch_ce_bwd_di_plain(u, i, lse, g, with_diag) if want_di else None
    return du, di


# The backward kernel's tiles (csrc/fused_softmax.cu, namespace bwd): 128
# rows of U by 64 rows of I, output slices of 64 d, two blocks per SM (105
# KB of shared memory each).
BWD_ROWS, BWD_COLS, BWD_DSLICE, BWD_BLOCKS_PER_SM = 128, 64, 64, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(b: int, c: int, d: int, sms: int) -> Tuple[int, int, int]:
    """(G_r, G_c, slices): the backward's grid.  The cdiv(B, 128) row tiles
    are split evenly over G_r row groups and the cdiv(C, 64) column tiles
    over G_c column groups (``bwd_tiles``); block (rb, cb) walks every tile
    pair of its two groups, once for each of the cdiv(D, 64) output slices.
    G_r x G_c is at most the blocks that fit on the card at once, as square
    as the tiles allow, so one wave of equal blocks fills the card (16 x 16
    on 132 SMs at B = C = 4096).  The workspace is [G_c, B, D] for dU's
    partial sums and [G_r, C, D] for dI's: with K = slots // isqrt(slots)
    (16 on 132 SMs), at most (K B + slots 128) D and (K C + slots 64) D
    floats, linear in B + C."""
    n_rt, n_ct = _cdiv(b, BWD_ROWS), _cdiv(c, BWD_COLS)
    slots = max(1, sms * BWD_BLOCKS_PER_SM)
    g_r = min(n_rt, math.isqrt(slots))
    g_c = min(n_ct, slots // g_r)
    g_r = min(n_rt, slots // g_c)
    return g_r, g_c, _cdiv(d, BWD_DSLICE)


def bwd_tiles(n_tiles: int, groups: int, k: int) -> range:
    """The tiles of group k when n_tiles are split evenly over groups, as
    ce_bwd_kernel splits them."""
    return range(k * n_tiles // groups, (k + 1) * n_tiles // groups)


# The forward kernel's tiles (csrc/fused_softmax.cu, namespace fwd): 128 rows
# of U (16 a warp, eight warps) by 64 rows of I, d staged 64 at a time in a
# three-stage ring; two blocks an SM for D <= 64, one beyond (the ring then
# also carries U's d chunks).
FWD_ROWS, FWD_COLS, FWD_DCHUNK, FWD_STAGES = 128, 64, 64, 3


def fwd_smem_bytes(multi: bool) -> int:
    """The forward kernel's dynamic shared memory (fwd::smem_bytes): the
    ring's stages, I's TF32 lo, and U's row tile (in each stage if multi,
    D > 64; else once)."""
    sd = FWD_DCHUNK + 4
    stage = (FWD_COLS + (FWD_ROWS if multi else 0)) * sd
    return 4 * (FWD_STAGES * stage + FWD_COLS * sd + (0 if multi else FWD_ROWS * sd))


def fwd_plan(b: int, c: int, d: int, sms: int) -> int:
    """S, the splits of the forward's columns: the cdiv(B, 128) row tiles
    times S fill the blocks the card holds at once (two an SM up to D = 64,
    one beyond), with S at most the cdiv(C, 64) column tiles, which are split
    evenly over S (``bwd_tiles``).  32 x 8 on 132 SMs at B = C = 4096."""
    n_rt, n_ct = _cdiv(b, FWD_ROWS), _cdiv(c, FWD_COLS)
    slots = max(1, sms * (2 if d <= FWD_DCHUNK else 1))
    return max(1, min(n_ct, slots // n_rt))


_tickets: dict = {}


def _zero_tickets(device: torch.device, n: int) -> torch.Tensor:
    """n int32 zeros on ``device`` kept across calls: the forward's row-tile
    counts, which its last block per row tile sets back to zero."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = _tickets[device] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def _check(u: torch.Tensor, i: torch.Tensor, with_diag: bool) -> None:
    if u.device.type != "cuda" or i.device != u.device:
        raise ValueError(f"the CE kernels take CUDA tensors on one device, got {u.device}, {i.device}")
    if u.dtype != torch.float32 or i.dtype != torch.float32:
        raise TypeError(f"the CE kernels take f32 embeddings, got {u.dtype}, {i.dtype}")
    if u.dim() != 2 or i.dim() != 2 or u.shape[1] != i.shape[1]:
        raise ValueError(f"embeddings must be [B, D] and [C, D], got {tuple(u.shape)}, {tuple(i.shape)}")
    if with_diag and u.shape[0] != i.shape[0]:
        raise ValueError("diagonal positives need as many items as users")


def in_batch_ce_fwd(u: torch.Tensor, i: torch.Tensor, with_diag: bool = True):
    """(ce, lse); see ``in_batch_ce_fwd_plain``.  A CPU tensor takes the
    plain version; a CUDA tensor launches kernel B10 once, on ``fwd_plan``'s
    grid (an input not 16-byte aligned copied first)."""
    if u.device.type == "cpu":
        return in_batch_ce_fwd_plain(u, i, with_diag)
    _check(u, i, with_diag)
    u, i = (t.contiguous() for t in (u, i))
    u, i = (t.clone() if t.data_ptr() % 16 else t for t in (u, i))
    (b, d), c = u.shape, i.shape[0]
    s = fwd_plan(b, c, d, _lib.sm_count(u.device.index))
    ce = torch.empty(b, dtype=torch.float32, device=u.device)
    lse = torch.empty_like(ce)
    ws = torch.empty(3, s, b, dtype=torch.float32, device=u.device) if s > 1 else None
    tickets = _zero_tickets(u.device, _cdiv(b, FWD_ROWS)) if s > 1 else None
    err = _lib.library().tt_in_batch_ce_fwd(
        u.data_ptr(), i.data_ptr(), ce.data_ptr(), lse.data_ptr(),
        None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
        b, c, d, int(with_diag), s, _lib.stream_ptr(u),
    )
    _lib.check(err, "fused_in_batch_ce")
    _lib.launches["fused_in_batch_ce"] += 1
    return ce, lse


def in_batch_ce_bwd(
    u, i, lse, g, with_diag: bool = True, want_du: bool = True, want_di: bool = True
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dU or None, dI or None); see ``in_batch_ce_bwd_plain``.  A CPU
    tensor takes the plain version; CUDA tensors launch the backward kernel
    (B11 and B12 in one pass over the score tiles, counted as
    ``in_batch_ce_bwd``) on ``bwd_plan``'s grid, then the reduce that sums
    its partial slices in slice order (``in_batch_ce_bwd_reduce``)."""
    if u.device.type == "cpu":
        return in_batch_ce_bwd_plain(u, i, lse, g, with_diag, want_du, want_di)
    _check(u, i, with_diag)
    if not (want_du or want_di):
        raise ValueError("the CE backward needs dU, dI or both asked for")
    if lse.shape != (u.shape[0],) or g.shape != (u.shape[0],) or lse.device != u.device \
            or g.device != u.device:
        raise ValueError(f"lse and g must be [B] on {u.device}, got {tuple(lse.shape)} on "
                         f"{lse.device}, {tuple(g.shape)} on {g.device}")
    u, i = u.contiguous(), i.contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    (b, d), c = u.shape, i.shape[0]
    g_r, g_c, _ = bwd_plan(b, c, d, _lib.sm_count(u.device.index))
    empty = lambda want, *shape: torch.empty(shape, dtype=torch.float32, device=u.device) if want else None
    ws_du, ws_di = empty(want_du, g_c, b, d), empty(want_di, g_r, c, d)
    du, di = empty(want_du, b, d), empty(want_di, c, d)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib, stream = _lib.library(), _lib.stream_ptr(u)
    err = lib.tt_in_batch_ce_bwd(
        u.data_ptr(), i.data_ptr(), lse.data_ptr(), g.data_ptr(), ptr(ws_du), ptr(ws_di),
        b, c, d, g_r, g_c, stream,
    )
    _lib.check(err, "in_batch_ce_bwd")
    _lib.launches["in_batch_ce_bwd"] += 1
    err = lib.tt_in_batch_ce_bwd_reduce(
        ptr(ws_du), ptr(ws_di), u.data_ptr(), i.data_ptr(), g.data_ptr(), ptr(du), ptr(di),
        b, c, d, g_r, g_c, int(with_diag), stream,
    )
    _lib.check(err, "in_batch_ce_bwd_reduce")
    _lib.launches["in_batch_ce_bwd_reduce"] += 1
    return du, di


class _InBatchCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, i, with_diag):
        ce, lse = in_batch_ce_fwd(u, i, with_diag)
        ctx.save_for_backward(u, i, lse)
        ctx.with_diag = with_diag
        ctx.mark_non_differentiable(lse)
        return ce, lse

    @staticmethod
    def backward(ctx, g_ce, _g_lse):
        u, i, lse = ctx.saved_tensors
        du, di = in_batch_ce_bwd(u, i, lse, g_ce, ctx.with_diag, *ctx.needs_input_grad[:2])
        return (None if du is None else du.to(u.dtype)), (None if di is None else di.to(i.dtype)), None


def fused_in_batch_ce(u: torch.Tensor, i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce [B], lse [B]) with diagonal positives, differentiable in both
    embeddings through ``ce``."""
    return _InBatchCE.apply(u, i, True)


def fused_lse(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row logsumexp of ``u @ i.T`` ([B, C], any C), differentiable in both
    embeddings."""
    ce, _ = _InBatchCE.apply(u, i, False)
    return ce  # without the diagonal, ce is lse
