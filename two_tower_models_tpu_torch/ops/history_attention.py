"""Blockwise (flash) self-attention over the user-history axis: the
forward and its two-kernel backward (the blockwise attention tier).

Port of ``two_tower_models_tpu/ops/pallas/history_attention.py``:

- B15, ``_attn_kernel`` (``pallas_call`` at :144): ``blockwise_attn_fwd``,
  softmax(q kᵀ / √Dh) v with an online softmax over key tiles, keys at or
  past each leading index's length scored −1e30, and the per-row
  lse = m + log l saved for the backward (``csrc/history_attention.cu``:
  ``attn_fwd_tc_kernel``, both products in 3xTF32 on the tensor cores,
  on ``_fwd_tc_plan``'s launch plan, for histories of 64 keys or more;
  the FMA kernel ``attn_fwd_kernel`` for shorter ones, the cells' among
  them: ``_fwd_route``; ``chip_smoke.py`` and the card tests time and hold
  both kernels through the private ``_route``);
- B16, ``_dq_kernel`` (:277): ``blockwise_attn_dq``;
- B17, ``_dkv_kernel`` (:295): ``blockwise_attn_dkv``; both on
  ``_bwd_route``'s kernel: ``attn_bwd_tc_kernel`` (MODE 0 and 1, every
  product in 3xTF32 on the tensor cores, on ``_bwd_tc_plan``'s launch
  plan) for long histories, ``attn_dq_kernel`` and ``attn_dkv_kernel``
  (FMA) for short ones, the cells' among them; a private ``_route``
  forces one.

``_BlockwiseAttention`` is the ``_blockwise_core`` custom VJP: the forward
saves q, k, v, the lengths, the output and the lse, never the [H, H]
probabilities; the backward takes delta = rowsum(do ∘ out) in f32 outside
the kernels, then B16 and B17 recompute the probabilities tile by tile.
Memory is O(H) per row in both directions.  ``blockwise_self_attention``
runs B15 alone when no gradient is wanted.

Layout [N, H, Dh], the heads folded into N (``nn.attention.mha_apply``);
lse and delta are [N, H] f32 (the TPU's [N, 1, H] padding is a layout of
its lanes).  The TPU's ``q_tile``/``kv_tile`` and its padding of Dh to 128
lanes are Mosaic tiling, not semantics: the CUDA kernels pick their own
tiles and take Dh in {16, 32, 64}, and every [N, H, Dh] operand at a
16-byte aligned address: the wrappers copy one that is not.  Each kernel
has a plain PyTorch version beside it (dense, the [N, H, H] scores
materialised): the CPU path, and the reference the kernel is held against
on the card.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.ops import _lib

_NEG_INF = -1e30  # a masked key's score (the Pallas kernels' _NEG_INF)
HEAD_DIMS = (16, 32, 64)  # the head dims the CUDA kernels are built for


def _scale(dh: int) -> float:
    return 1.0 / (dh**0.5)


def _masked_scores(q, k, lens) -> torch.Tensor:
    """s = q kᵀ · scale [N, H, H], keys at or past ``lens`` at −1e30."""
    h = q.shape[1]
    s = (q @ k.transpose(1, 2)) * _scale(q.shape[2])
    invalid = torch.arange(h, device=q.device)[None, :] >= lens[:, None].to(q.device)
    return s.masked_fill(invalid[:, None, :], _NEG_INF)


def blockwise_attn_fwd_plain(q, k, v, lens):
    """B15's function on f32 [N, H, Dh] q, k, v and [N] lengths in [1, H]:
    (out [N, H, Dh], lse [N, H]), both f32, with out = Σ p v / l over the
    valid keys and lse = m + log l."""
    s = _masked_scores(q, k, lens)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / l, (m + torch.log(l))[..., 0]


def blockwise_attn_bwd_plain(q, k, v, do, lse, delta, lens):
    """B16's and B17's function: (dq, dk, dv), f32 [N, H, Dh], from the
    output cotangent ``do``, the forward's ``lse`` and delta = rowsum(do ∘
    out) [N, H].  p = exp(s − lse), ds = p (do·v − delta); dq = scale Σ ds k,
    dk = scale Σ dsᵀ q, dv = Σ pᵀ do.  Masked keys get dk = dv = 0."""
    p = torch.exp(_masked_scores(q, k, lens) - lse[..., None])
    ds = p * (do @ v.transpose(1, 2) - delta[..., None])
    scale = _scale(q.shape[2])
    return (ds @ k) * scale, (ds.transpose(1, 2) @ q) * scale, p.transpose(1, 2) @ do


def attention_reference(q, k, v):
    """Dense reference for parity tests (no lengths): softmax(q kᵀ / √Dh) v
    in f32, cast to q's dtype."""
    s = (q.float() @ k.float().transpose(1, 2)) * _scale(q.shape[-1])
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _check(name: str, lens: torch.Tensor, full, rows=()) -> None:
    """``full``: [N, H, Dh] tensors (q first); ``rows``: [N, H] ones."""
    q = full[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3 or q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{name}: takes [N, H, Dh] with Dh in {HEAD_DIMS}, got {tuple(q.shape)}")
    for want, ts in ((q.shape, full), (q.shape[:2], rows)):
        for t in ts:
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
                raise TypeError(f"{name}: takes contiguous f32 tensors on one device")
            if t.shape != want:
                raise ValueError(f"{name}: shape {tuple(t.shape)} where {tuple(want)} is due")
    if lens.shape != q.shape[:1] or lens.dtype != torch.int32 or lens.device != q.device:
        raise ValueError(f"{name}: lengths must be int32 [{q.shape[0]}] on {q.device}")


# The tensor-core B15's launch plans (csrc/history_attention.cu fwd_tc_plan):
# (warps on the leading index, keys a tile, ring stages).  A warp owns 16
# query rows.
_TC_PLANS = ((4, 64, 3), (8, 64, 3))


def tc_shape(plan: int, dh: int) -> tuple[int, int, int]:
    """Plan ``plan``'s (warps on the leading index, keys a tile, ring
    stages) at head dim ``dh``: key tiles of at most 32 keys at Dh = 64,
    where 64 spill registers."""
    qw, bk, ns = _TC_PLANS[plan]
    return qw, min(bk, 32) if dh == 64 else bk, ns


def _fwd_tc_plan(h: int) -> int:
    """The index in ``_TC_PLANS`` of B15's launch at history length ``h``:
    a query tile of one leading index walking 64-key tiles through a ring
    of three stages, 64 rows up to h = 64 and 128 rows beyond, each the
    faster of the two at those lengths (PERF.md §6)."""
    return 0 if h <= 64 else 1


def fwd_tc_smem_bytes(plan: int, dh: int) -> int:
    """Dynamic shared memory of a tensor-core B15 block on plan ``plan`` at
    head dim ``dh`` (``tc::Shape::SMEM``): a query tile and raw K and V
    tiles for each ring stage, and the split tile (K hi and lo, V^T hi and
    lo, |k|^2); rows of Dh + 4 floats, V^T rows of keys + 4."""
    qw, bk, ns = tc_shape(plan, dh)
    sd, kv = dh + 4, bk * (dh + 4)
    return 4 * (ns * (16 * qw * sd + 2 * kv) + 2 * kv + 2 * dh * (bk + 4) + bk)


def _fwd_route(h: int) -> str:
    """B15's kernel at history length ``h``: "tc" (``attn_fwd_tc_kernel``)
    from 64 keys on, where it was measured faster than the FMA kernel (1.1
    times at H = 64, 1.4 at 128 and 256, 2.2 at 512, 3.0 at 4096; with
    lengths uniform in [1, H] 1.06, 1.2 and 3.0 at 64, 128 and 4096); "fma"
    (``attn_fwd_kernel``) below, where at the cells' H = 32 the two were
    measured within 3% of each other without lengths and the FMA kernel 15%
    faster with them (PERF.md §6)."""
    return "tc" if h >= 64 else "fma"


def _launch_fwd(route: str, q, k, v, lens, plan: int | None = None):
    """B15's kernel on the route ``route`` ("tc": ``attn_fwd_tc_kernel`` on
    ``_fwd_tc_plan``'s plan, or ``plan``; "fma": ``attn_fwd_kernel``) on
    checked, aligned inputs: (out, lse).  Counts nothing."""
    n, h, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, h), dtype=torch.float32, device=q.device)
    if n and h:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                lse.data_ptr(), n, h, dh)
        if route == "tc":
            err = _lib.library().tt_blockwise_attn_fwd_tc(
                *args, _fwd_tc_plan(h) if plan is None else plan, _lib.stream_ptr(q))
        else:
            err = _lib.library().tt_blockwise_attn_fwd(*args, _lib.stream_ptr(q))
        _lib.check(err, "blockwise_attn_fwd")
    return out, lse


def blockwise_attn_fwd(q, k, v, lens, *, _route: str | None = None):
    """(out, lse); see ``blockwise_attn_fwd_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches kernel B15 on the route
    ``_fwd_route`` gives its history length (``_route``, for timing and
    tests only, forces one).  Every launch counts as
    ``blockwise_attn_fwd``, one on the tensor cores also as
    ``blockwise_attn_fwd_tc``."""
    if q.device.type == "cpu":
        return blockwise_attn_fwd_plain(q, k, v, lens)
    _check("blockwise_attn_fwd", lens, (q, k, v))
    route = _fwd_route(q.shape[1]) if _route is None else _route
    if route not in ("tc", "fma"):
        raise ValueError(f"blockwise_attn_fwd: no route {route!r}")
    out, lse = _launch_fwd(route, *map(_lib.aligned, (q, k, v)), lens)
    if q.shape[0] and q.shape[1]:
        _lib.launches["blockwise_attn_fwd"] += 1
        if route == "tc":
            _lib.launches["blockwise_attn_fwd_tc"] += 1
    return out, lse


# The tensor-core B16's and B17's launch plans (csrc/history_attention.cu
# bwd_tc_plan): (warps on the leading index, rows of the other side a tile,
# ring stages).  A warp owns 16 rows: query rows in B16, key rows in B17.
_BWD_PLANS = ((4, 64, 3), (8, 64, 3))


def bwd_tc_shape(plan: int, dh: int) -> tuple[int, int, int]:
    """Backward plan ``plan``'s (warps, rows a tile, ring stages) at head
    dim ``dh``; at Dh = 64 every plan is four warps on tiles of 16 rows
    (B17 spills registers with eight warps or tiles of 32 there)."""
    w, bt, ns = _BWD_PLANS[plan]
    return (4, 16, ns) if dh == 64 else (w, bt, ns)


def _bwd_tc_plan(mode: int, n: int, h: int) -> int:
    """The index in ``_BWD_PLANS`` of B16's (``mode`` 0) or B17's (1)
    launch at n leading indices of history length ``h``: 64 own rows a
    block up to h = 64; beyond, 128 for B16 (two blocks of eight warps an
    SM at its 128 registers), and for B17 (about 165 registers: three
    blocks of four warps an SM, or one of eight) 128 where its blocks do
    not fill the card, 64 where n h reaches 2^17 rows (PERF.md §6)."""
    if h <= 64:
        return 0
    return 1 if mode == 0 or n * h < 1 << 17 else 0


def bwd_tc_smem_bytes(mode: int, plan: int, dh: int) -> int:
    """Dynamic shared memory of a tensor-core B16 (``mode`` 0) or B17 (1)
    block on plan ``plan`` at head dim ``dh`` (``tc::BwdShape::SMEM``): the
    raw tiles of each ring stage (K and V; or Q, dO and their lse and
    delta), the split tile (both by row in hi and lo, K^T, or Q^T and
    dO^T, in hi and lo, and each row's |b1|^2), and past Dh = 16 each
    warp's own rows (q and dO, or k and v); rows of Dh + 4 floats,
    transposed rows of the tile's rows + 4."""
    w, bt, ns = bwd_tc_shape(plan, dh)
    tile = bt * (dh + 4)
    stage = 2 * tile + (2 * bt if mode else 0)
    own = w * 2 * 16 * (dh + 4) if dh > 16 else 0
    return 4 * (ns * stage + 4 * tile + 2 * (2 if mode else 1) * dh * (bt + 4) + bt + own)


def _bwd_route(h: int) -> str:
    """B16's and B17's kernel at history length ``h``: "tc"
    (``attn_bwd_tc_kernel``) from 128 keys on, the least measured length at
    which it beats the FMA kernels with lengths and without; "fma"
    (``attn_dq_kernel``, ``attn_dkv_kernel``) below, the cells' H = 32
    among them (PERF.md §6)."""
    return "tc" if h >= 128 else "fma"


def _launch_dq(route: str, q, k, v, do, lse, delta, lens, plan: int | None = None):
    """B16's kernel on the route ``route`` ("tc": ``attn_bwd_tc_kernel<0,
    ...>`` on ``_bwd_tc_plan``'s plan, or ``plan``; "fma":
    ``attn_dq_kernel``) on checked, aligned inputs: dq.  Counts nothing."""
    n, h, dh = q.shape
    dq = torch.empty_like(q)
    if n and h:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), lens.data_ptr(), dq.data_ptr(), n, h, dh)
        if route == "tc":
            err = _lib.library().tt_blockwise_attn_dq_tc(
                *args, _bwd_tc_plan(0, n, h) if plan is None else plan, _lib.stream_ptr(q))
        else:
            err = _lib.library().tt_blockwise_attn_dq(*args, _lib.stream_ptr(q))
        _lib.check(err, "blockwise_attn_dq")
    return dq


def _launch_dkv(route: str, q, k, v, do, lse, delta, lens, plan: int | None = None):
    """B17's kernel on the route ``route`` ("tc": ``attn_bwd_tc_kernel<1,
    ...>``; "fma": ``attn_dkv_kernel``) on checked, aligned inputs: (dk,
    dv).  Counts nothing."""
    n, h, dh = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if n and h:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, h, dh)
        if route == "tc":
            err = _lib.library().tt_blockwise_attn_dkv_tc(
                *args, _bwd_tc_plan(1, n, h) if plan is None else plan, _lib.stream_ptr(q))
        else:
            err = _lib.library().tt_blockwise_attn_dkv(*args, _lib.stream_ptr(q))
        _lib.check(err, "blockwise_attn_dkv")
    return dk, dv


def _bwd_launch(name: str, launch, q, k, v, do, lse, delta, lens, route):
    """Check the inputs, launch B16 or B17 (``launch``) on ``route`` (None:
    ``_bwd_route``'s) and count it as ``name``, on the tensor cores also as
    ``name``_tc."""
    _check(name, lens, (q, k, v, do), (lse, delta))
    route = _bwd_route(q.shape[1]) if route is None else route
    if route not in ("tc", "fma"):
        raise ValueError(f"{name}: no route {route!r}")
    out = launch(route, *map(_lib.aligned, (q, k, v, do, lse, delta)), lens)
    if q.shape[0] and q.shape[1]:
        _lib.launches[name] += 1
        if route == "tc":
            _lib.launches[name + "_tc"] += 1
    return out


def blockwise_attn_dq(q, k, v, do, lse, delta, lens, *, _route: str | None = None):
    """dq; see ``blockwise_attn_bwd_plain``.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B16 on the route ``_bwd_route``
    gives its history length (``_route``, for timing and tests only, forces
    one).  Every launch counts as ``blockwise_attn_dq``, one on the tensor
    cores also as ``blockwise_attn_dq_tc``."""
    if q.device.type == "cpu":
        return blockwise_attn_bwd_plain(q, k, v, do, lse, delta, lens)[0]
    return _bwd_launch("blockwise_attn_dq", _launch_dq, q, k, v, do, lse, delta, lens, _route)


def blockwise_attn_dkv(q, k, v, do, lse, delta, lens, *, _route: str | None = None):
    """(dk, dv); see ``blockwise_attn_bwd_plain``.  A CPU tensor takes the
    plain version; a CUDA tensor launches kernel B17 on ``_bwd_route``'s
    route (``_route`` forces one).  Every launch counts as
    ``blockwise_attn_dkv``, one on the tensor cores also as
    ``blockwise_attn_dkv_tc``."""
    if q.device.type == "cpu":
        return blockwise_attn_bwd_plain(q, k, v, do, lse, delta, lens)[1:]
    return _bwd_launch("blockwise_attn_dkv", _launch_dkv, q, k, v, do, lse, delta, lens, _route)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


class _BlockwiseAttention(torch.autograd.Function):
    """The JAX ``_blockwise_core`` custom VJP: B15 forward, saving q, k, v
    (as f32), the lengths, the output (in q's dtype) and the lse; B16 and
    B17 backward, their f32 grads cast to each input's dtype.  The lengths
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lens):
        q32, k32, v32 = _f32(q), _f32(k), _f32(v)
        out, lse = blockwise_attn_fwd(q32, k32, v32, lens)
        out = out.to(q.dtype)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.save_for_backward(q32, k32, v32, lens, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lens, out, lse = ctx.saved_tensors
        do = _f32(g)
        delta = (do * out.float()).sum(-1)  # [N, H] f32, outside the kernels
        dq = blockwise_attn_dq(q, k, v, do, lse, delta, lens)
        dk, dv = blockwise_attn_dkv(q, k, v, do, lse, delta, lens)
        return (*(t.to(dt) for t, dt in zip((dq, dk, dv), ctx.dtypes)), None)


def blockwise_self_attention(
    q: torch.Tensor,  # [N, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,  # optional [N] valid key counts
) -> torch.Tensor:
    """softmax(q kᵀ / √Dh) v per leading index, computed in f32 and cast to
    q's dtype; keys at or past ``lengths`` (clipped to [1, H]; H when None)
    are masked, and the query rows there are computed all the same.  When a
    gradient is wanted it runs the ``autograd.Function`` (B15, then B16 and
    B17); otherwise B15."""
    n, h, _ = q.shape
    lens = (
        torch.full((n,), h, dtype=torch.int32, device=q.device)
        if lengths is None
        else lengths.to(device=q.device, dtype=torch.int32).clamp(1, h).contiguous()
    )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockwiseAttention.apply(q, k, v, lens)
    return blockwise_attn_fwd(_f32(q), _f32(k), _f32(v), lens)[0].to(q.dtype)
