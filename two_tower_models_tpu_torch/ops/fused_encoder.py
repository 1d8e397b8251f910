"""Whole history encoder in one kernel: forward, residual forward, backward.

Port of ``two_tower_models_tpu/ops/pallas/fused_encoder.py:
fused_history_encoder`` and its custom VJP with ``_RESIDUAL_BWD = True``:

- B1, ``_enc_fwd_kernel``: the forward alone (``csrc/fused_encoder.cu``),
  taken when no gradient is wanted (serving);
- B5, ``_enc_fwd_res_kernel``: the same forward that also stores each
  layer's input and attention probabilities (``csrc/fused_encoder.cu`` with
  its residual flag), taken when a gradient is wanted;
- B6, ``_enc_bwd_res_kernel``: the backward from those residuals
  (``csrc/fused_encoder_bwd.cu``), plus a second launch that sums the
  per-block weight grads in a fixed order.

``fused_history_encoder`` picks B1 or the ``autograd.Function`` (B5 then
B6), as the JAX primal / ``_vjp_fwd`` split does.  Each kernel has a plain
PyTorch version with its rounding points: the CPU path, and the reference
the kernel is held against on the card.  The plain backward is written out
with B6's rounding points; it is not torch autograd of the plain forward.

Residual layouts (any layout will do, as long as kernel and plain agree):
xs [L, B, H, D], ps [L-1, B, NH, H, H] (None when L == 1) and p0
[B, NH, H], all in the input dtype: per head, the values of the Pallas
kernel's merged [H, NH*H] layout without its padding.
"""

from __future__ import annotations

import math

import torch

from two_tower_models_tpu_torch.nn.layers import round_to
from two_tower_models_tpu_torch.ops import _lib

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_MAX_EXAMPLES_PER_BLOCK = 8


def _forward_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads, keep: bool):
    mm = torch.bfloat16 if hist_emb.dtype == torch.bfloat16 else None
    b, h, d = hist_emb.shape
    nh, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    xin = hist_emb.float()
    mean = xin.sum(dim=1) / h
    x = xin + pe.float()
    num_layers = w_in.shape[0]
    xs, ps, p0 = [], [], None
    for l in range(num_layers):
        last = l == num_layers - 1
        if keep:
            xs.append(x.to(hist_emb.dtype))
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
        p = round_to(e / denom.clamp_min(1e-30), mm)
        if keep:
            if last:
                p0 = p[:, :, 0].to(hist_emb.dtype)
            else:
                ps.append(p.to(hist_emb.dtype))
        out = (p @ vh).transpose(1, 2).reshape(b, nq, d)
        x = round_to(out, mm) @ round_to(w_out[l], mm) + b_out[l].float()
    y = torch.stack([x[:, 0], mean], dim=1).to(hist_emb.dtype)
    if not keep:
        return y
    return y, torch.stack(xs), (torch.stack(ps) if ps else None), p0


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
    return _forward_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads, False)


def fused_history_encoder_res_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """B5's function: (y, xs, ps, p0), the forward of
    ``fused_history_encoder_plain`` and its residuals (module docstring)."""
    return _forward_plain(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads, True)


def fused_history_encoder_bwd_plain(g, xs, ps, p0, w_in, b_in, w_out, num_heads):
    """B6's function: from the cotangent ``g`` [B, 2, D] and the residuals,
    (dx [B, H, D] in the residuals' dtype, dpe [H, D], dw_in, db_in, dw_out,
    db_out), the grads f32 and summed over the batch.  The rounding points
    of ``_layer_bwd`` / ``_thin_bwd``: g2, do, p, ds and dqkv are rounded
    before their products; the per-head pdp sum adds rounded dp * p; db_out
    sums the unrounded dy and db_in the rounded dqkv; the thin last layer
    has dq at row 0 only."""
    dtype = xs.dtype
    mm = torch.bfloat16 if dtype == torch.bfloat16 else None
    num_layers, b, h, d = xs.shape
    nh, hd = num_heads, d // num_heads
    scale = 1.0 / math.sqrt(hd)
    g = g.to(dtype).float()
    heads = lambda t: t.reshape(b, t.shape[1], nh, hd).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(b, t.shape[2], d)
    grads = [[None] * num_layers for _ in range(4)]  # dwi, dbi, dwo, dbo
    dy = g[:, :1]  # cotangent of the last layer's row 0
    for l in range(num_layers - 1, -1, -1):
        thin = l == num_layers - 1
        x2 = xs[l].float()
        wi = round_to(w_in[l], mm)
        qkv = x2 @ wi + b_in[l].float()
        q, k, v = (round_to(t, mm) for t in qkv.split(d, dim=-1))
        if thin:
            q, p = q[:, :1], p0.float()[:, :, None, :]  # [B, NH, 1, H]
        else:
            p = ps[l].float()  # [B, NH, H, H]
        qh, kh, vh = heads(q), heads(k), heads(v)
        ao = round_to(merge(p @ vh), mm)  # [B, nq, D]
        g2 = round_to(dy, mm)
        grads[2][l] = torch.einsum("bqc,bqj->cj", ao, g2)
        grads[3][l] = dy.sum(dim=(0, 1))
        do = heads(round_to(g2 @ round_to(w_out[l], mm).T, mm))  # [B, NH, nq, hd]
        dp = do @ vh.transpose(-1, -2)  # [B, NH, nq, H]
        dv = merge(p.transpose(-1, -2) @ do)  # [B, H, D]
        pdp = round_to(dp * p, mm).sum(dim=-1, keepdim=True)
        ds = round_to(p * (dp - pdp) * scale, mm)
        dq = merge(ds @ kh)  # [B, nq, D]
        dk = merge(ds.transpose(-1, -2) @ qh)  # [B, H, D]
        if thin:
            dq = torch.cat([dq, dq.new_zeros(b, h - 1, d)], dim=1)
        dqkv = round_to(torch.cat([dq, dk, dv], dim=-1), mm)  # [B, H, 3D]
        grads[0][l] = torch.einsum("brd,brj->dj", x2, dqkv)
        grads[1][l] = dqkv.sum(dim=(0, 1))
        dy = dqkv @ wi.T  # [B, H, D]: the layer input's cotangent
    dpe = dy.sum(dim=0)
    dx = (dy + g[:, 1:] / h).to(dtype)
    dwi, dbi, dwo, dbo = (torch.stack(t) for t in grads)
    return dx, dpe, dwi, dbi, dwo, dbo


def _examples_per_block(h: int, d: int, nh: int) -> int:
    fixed = 4 * (3 * d * d + 3 * d + d * d + d + 3 * h * d + nh * h * h + h * d)
    epb = min(_MAX_EXAMPLES_PER_BLOCK, (_SMEM_LIMIT - fixed) // (4 * h * d))
    if epb < 1:
        raise ValueError(
            f"history encoder of H={h}, D={d}, NH={nh} does not fit the "
            "kernel's shared memory"
        )
    return epb


def _check(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads) -> None:
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


def _f32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.detach().to(device=dev, dtype=torch.float32).contiguous()


def _launch_forward(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads, res: bool):
    _check(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads)
    b, h, d = hist_emb.shape
    num_layers = w_in.shape[0]
    epb = _examples_per_block(h, d, num_heads)
    dev = hist_emb.device
    x = hist_emb.detach().contiguous()
    pe_, wi, bi, wo, bo = (_f32(t, dev) for t in (pe, w_in, b_in, w_out, b_out))
    y = torch.empty((b, 2, d), dtype=hist_emb.dtype, device=dev)
    new = lambda *shape: torch.empty(shape, dtype=hist_emb.dtype, device=dev)
    xs = new(num_layers, b, h, d) if res else None
    ps = new(num_layers - 1, b, num_heads, h, h) if res and num_layers > 1 else None
    p0 = new(b, num_heads, h) if res else None
    if b == 0:
        return (y, xs, ps, p0) if res else y
    lib = _lib.library()
    args = [x.data_ptr(), pe_.data_ptr(), wi.data_ptr(), bi.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr()]
    if res:
        args += [xs.data_ptr(), 0 if ps is None else ps.data_ptr(), p0.data_ptr()]
    args += [b, h, d, num_heads, num_layers, int(hist_emb.dtype == torch.bfloat16),
             epb, _lib.stream_ptr(x)]
    name = "fused_history_encoder_res" if res else "fused_history_encoder"
    err = getattr(lib, "tt_" + name)(*args)
    _lib.check(err, name)
    _lib.launches[name] += 1
    return (y, xs, ps, p0) if res else y


def fused_history_encoder_res(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
    """(y, xs, ps, p0); see ``fused_history_encoder_res_plain``.  A CPU
    tensor takes the plain version; a CUDA tensor launches kernel B5."""
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_res_plain(
            hist_emb, pe, w_in, b_in, w_out, b_out, num_heads
        )
    return _launch_forward(hist_emb, pe, w_in, b_in, w_out, b_out, num_heads, True)


def _bwd_smem_bytes(h: int, d: int, nh: int) -> int:
    """Shared memory of csrc/fused_encoder_bwd.cu (its bwd_smem_bytes)."""
    d3 = 3 * d
    return 4 * (d * (d3 + 1) + d3 + d * (d + 1) + d * d3 + d3 + d * d + d
                + 4 * h * d + h * (d3 + 1) + 2 * nh * h * h)


def _bwd_grid(b: int, device) -> tuple[int, int]:
    """(blocks, examples per block) of the B6 launch: at most one block per
    SM, each owning a contiguous run of examples."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    epb = -(-b // min(b, sms))
    return -(-b // epb), epb


def fused_history_encoder_bwd(g, xs, ps, p0, w_in, b_in, w_out, num_heads):
    """(dx, dpe, dw_in, db_in, dw_out, db_out); see
    ``fused_history_encoder_bwd_plain``.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B6 and its reduce."""
    if xs.device.type == "cpu":
        return fused_history_encoder_bwd_plain(g, xs, ps, p0, w_in, b_in, w_out, num_heads)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
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
    if _bwd_smem_bytes(h, d, num_heads) > _SMEM_LIMIT:
        raise ValueError(
            f"history encoder backward of H={h}, D={d}, NH={num_heads} does not "
            "fit the kernel's shared memory"
        )
    dev = xs.device
    dtype = xs.dtype
    wi, bi, wo = (_f32(t, dev) for t in (w_in, b_in, w_out))
    g = g.detach().to(dtype).contiguous()
    xs, p0 = xs.contiguous(), p0.contiguous()
    ps = None if ps is None else ps.contiguous()
    sizes = [num_layers * d * 3 * d, num_layers * 3 * d, num_layers * d * d, num_layers * d, h * d]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dx = torch.empty((b, h, d), dtype=dtype, device=dev)
    if b > 0:
        blocks, epb = _bwd_grid(b, dev)
        ws = torch.empty((blocks, grads.numel()), dtype=torch.float32, device=dev)
        dy = torch.empty((b, h, d), dtype=torch.float32, device=dev)
        lib = _lib.library()
        stream = _lib.stream_ptr(xs)
        err = lib.tt_fused_history_encoder_bwd(
            g.data_ptr(), xs.data_ptr(), 0 if ps is None else ps.data_ptr(),
            p0.data_ptr(), wi.data_ptr(), bi.data_ptr(), wo.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), ws.data_ptr(), b, h, d, num_heads, num_layers,
            int(dtype == torch.bfloat16), epb, stream,
        )
        _lib.check(err, "fused_history_encoder_bwd")
        _lib.launches["fused_history_encoder_bwd"] += 1
        err = lib.tt_fused_history_encoder_bwd_reduce(
            ws.data_ptr(), grads.data_ptr(), blocks, grads.numel(), stream
        )
        _lib.check(err, "fused_history_encoder_bwd_reduce")
        _lib.launches["fused_history_encoder_bwd_reduce"] += 1
    else:
        grads.zero_()
    dwi, dbi, dwo, dbo, dpe = torch.split(grads, sizes)
    return (dx, dpe.view(h, d), dwi.view(num_layers, d, 3 * d),
            dbi.view(num_layers, 3 * d), dwo.view(num_layers, d, d),
            dbo.view(num_layers, d))


class _FusedHistoryEncoder(torch.autograd.Function):
    """B5 forward, B6 backward (the JAX custom VJP with _RESIDUAL_BWD)."""

    @staticmethod
    def forward(ctx, hist_emb, pe, w_in, b_in, w_out, b_out, num_heads):
        y, xs, ps, p0 = fused_history_encoder_res(
            hist_emb, pe, w_in, b_in, w_out, b_out, num_heads
        )
        ctx.save_for_backward(xs, ps, p0, w_in, b_in, w_out)
        ctx.num_heads = num_heads
        ctx.dtypes = [t.dtype for t in (hist_emb, pe, w_in, b_in, w_out, b_out)]
        return y

    @staticmethod
    def backward(ctx, g):
        xs, ps, p0, w_in, b_in, w_out = ctx.saved_tensors
        grads = fused_history_encoder_bwd(g, xs, ps, p0, w_in, b_in, w_out, ctx.num_heads)
        out = [gr.to(dt) if need else None
               for gr, dt, need in zip(grads, ctx.dtypes, ctx.needs_input_grad)]
        return (*out, None)


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
    ``autograd.Function`` of B5 and B6; otherwise B1.  A CPU tensor takes
    the plain versions; a CUDA tensor launches the kernels."""
    args = (hist_emb, pe, w_in, b_in, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedHistoryEncoder.apply(*args, num_heads)
    if hist_emb.device.type == "cpu":
        return fused_history_encoder_plain(*args, num_heads)
    return _launch_forward(*args, num_heads, False)
