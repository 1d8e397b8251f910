"""In-batch sampled-softmax cross-entropy without the [B, C] score matrix.

Port of ``two_tower_models_tpu/ops/pallas/fused_softmax.py``:
``fused_in_batch_ce`` (ce, lse with diagonal positives) and ``fused_lse``
(the rectangular row logsumexp), each an ``autograd.Function`` whose
forward is kernel B10 and whose backward is kernels B11 (dU) and B12 (dI),
all in ``csrc/fused_softmax.cu``; the source's note says what bounds them
on the H100.  The plain versions below compute the same functions with the
[B, C] matrix materialised: the CPU path, and the reference the kernels are
held against on the card.

As in the JAX package, the backward reads only the cotangent of ``ce``
(``fused_in_batch_ce``) or of ``lse`` (``fused_lse``); a cotangent of the
``lse`` output of ``fused_in_batch_ce`` is dropped.
"""

from __future__ import annotations

from typing import Tuple

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
    plain version; a CUDA tensor launches kernel B10."""
    if u.device.type == "cpu":
        return in_batch_ce_fwd_plain(u, i, with_diag)
    _check(u, i, with_diag)
    u, i = u.contiguous(), i.contiguous()
    b, d = u.shape
    ce = torch.empty(b, dtype=torch.float32, device=u.device)
    lse = torch.empty_like(ce)
    err = _lib.library().tt_in_batch_ce_fwd(
        u.data_ptr(), i.data_ptr(), ce.data_ptr(), lse.data_ptr(),
        b, i.shape[0], d, int(with_diag), _lib.stream_ptr(u),
    )
    _lib.check(err, "fused_in_batch_ce")
    _lib.launches["fused_in_batch_ce"] += 1
    return ce, lse


def _bwd(u, i, lse, g, with_diag: bool, which: int, name: str) -> torch.Tensor:
    _check(u, i, with_diag)
    u, i = u.contiguous(), i.contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    b, d = u.shape
    out = torch.empty((i.shape[0] if which else b, d), dtype=torch.float32, device=u.device)
    err = _lib.library().tt_in_batch_ce_bwd(
        u.data_ptr(), i.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr(),
        b, i.shape[0], d, int(with_diag), which, _lib.stream_ptr(u),
    )
    _lib.check(err, name)
    _lib.launches[name] += 1
    return out


def in_batch_ce_bwd_du(u, i, lse, g, with_diag: bool = True) -> torch.Tensor:
    """dU; see ``in_batch_ce_bwd_du_plain``.  CUDA tensors launch B11."""
    if u.device.type == "cpu":
        return in_batch_ce_bwd_du_plain(u, i, lse, g, with_diag)
    return _bwd(u, i, lse, g, with_diag, 0, "in_batch_ce_bwd_du")


def in_batch_ce_bwd_di(u, i, lse, g, with_diag: bool = True) -> torch.Tensor:
    """dI; see ``in_batch_ce_bwd_di_plain``.  CUDA tensors launch B12."""
    if u.device.type == "cpu":
        return in_batch_ce_bwd_di_plain(u, i, lse, g, with_diag)
    return _bwd(u, i, lse, g, with_diag, 1, "in_batch_ce_bwd_di")


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
        du = di = None
        if ctx.needs_input_grad[0]:
            du = in_batch_ce_bwd_du(u, i, lse, g_ce, ctx.with_diag).to(u.dtype)
        if ctx.needs_input_grad[1]:
            di = in_batch_ce_bwd_di(u, i, lse, g_ce, ctx.with_diag).to(i.dtype)
        return du, di, None


def fused_in_batch_ce(u: torch.Tensor, i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce [B], lse [B]) with diagonal positives, differentiable in both
    embeddings through ``ce``."""
    return _InBatchCE.apply(u, i, True)


def fused_lse(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row logsumexp of ``u @ i.T`` ([B, C], any C), differentiable in both
    embeddings."""
    ce, _ = _InBatchCE.apply(u, i, False)
    return ce  # without the diagonal, ce is lse
