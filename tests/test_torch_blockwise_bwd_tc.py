"""PyTorch port: the tensor-core blockwise attention backward's arithmetic
(B16 and B17, ``csrc/history_attention.cu`` ``attn_bwd_tc_kernel``, MODE 0
and 1) emulated in torch on the CPU against ``jax.vjp`` of the JAX
package's ``blockwise_self_attention``, whose Pallas kernels run in
interpret mode as tests/test_torch_blockwise_attention.py runs them.

``_emulate`` repeats the kernel's work in the kernel's order, on its
plans' tiles of the other side's rows (every plan's: its warps change no
sum).  B16 (dq): per 16 query rows and key tile (keys below the length),
the guard (scale² max |q|² max |k|² against SCORE_BOUND², its maxima NaN
where one of theirs is) picks the tile's scores: in 3xTF32 (q split as the
kernel's ``split_fin`` does, k by ``tt::tf32_split_any``, and per k8 step
hi.lo', lo.hi', hi.hi' summed on their own, then added to the running
score in d order) or by the plain version's f32 FMA chain in d order;
then s·scale, keys at or past the length at -1e30, p = exp(s - lse) (each
operation rounded as the plain version's), dP = dO Vᵀ in 3xTF32 (both
split by ``tf32_split_any``), dS = p (dP - delta), and dq += dS K per key
band of eight as one k8 step with the keys in the order 0 2 4 6 1 3 5 7;
at the end dq · scale.  B17 (dk, dv): the same with the roles turned: per
16 key rows and query tile (every query row; rows past H zero, their p and
dS 0), Sᵀ = K Qᵀ under the guard, Pᵀ = exp(Sᵀ·scale - lse[col]) with key
rows at or past the length at -1e30, dv += Pᵀ dO, dPᵀ = V dOᵀ, dSᵀ = Pᵀ
(dPᵀ - delta[col]), dk += dSᵀ Q per query band; dk · scale; masked keys'
dk and dv exact zeros.

Tolerances: rtol 1e-4, atol 1e-5 of each grad's scale (the JAX package's
own for its blockwise kernel against the dense reference, the atol taken
of the scale as chip_smoke.py takes it for B15; the scale as the card
tests take it, ``_scale_of``), and 1e-3 / 1e-4 where q
and k are at 30 sigma (its extreme-score test).  Of the scale: the sums
dq = scale Σ ds k and dk = scale Σ dsᵀ q cancel (Σ_c ds[r, c] = 0), and
two f32 orders of them differ by more than 1e-5 absolute near 0 (at 30
sigma also the plain order of this file's own structure against JAX's),
while the emulated kernels' error from f64 sums stays at the plain
version's (the last test).  One TF32 product (no split) misses 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_blockwise_tc import SCORE_BOUND, _NAN, _close, _fma_scores, _split_fin
from test_torch_ce_forward import _split as _split_any
from two_tower_models_tpu.ops.pallas import history_attention as jha
from two_tower_models_tpu_torch.ops import history_attention as tha

RTOL, ATOL = 1e-4, 1e-5
_NEG_INF = -1e30
_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])

# tests/test_torch_blockwise_attention.py's shapes, and H = 1
SHAPES = [(4, 128, 16), (2, 200, 32), (3, 384, 64), (2, 300, 16), (5, 1, 16)]


def _mm3(a, b, a_fin=False, split=True):
    """a [..., M, 8] . b [..., 8, N] as one k8 step of the kernel's mma:
    hi.lo', lo.hi', hi.hi' summed on their own (hi.hi' alone without
    ``split``); a split by ``split_fin`` (``a_fin``) or
    ``tf32_split_any``, b by ``tf32_split_any``."""
    (ahi, alo), (bhi, blo) = (_split_fin if a_fin else _split_any)(a), _split_any(b)
    return (ahi @ blo + alo @ bhi) + ahi @ bhi if split else ahi @ bhi


def _rows(t, rows):
    """t [N, H, ...] zero-padded to ``rows`` rows."""
    return torch.cat([t, t.new_zeros(t.shape[0], rows - t.shape[1], *t.shape[2:])], 1)


def _pass(a1, a2, b1, b2, own_ok, oth_ok, lse, delta, mode, bt, split, guard, keep_nan, stats):
    """One mode's sums: a1, a2 [N, Ho, Dh] the own rows (q, dO; or k, v),
    b1, b2 [N, Ht, Dh] the other side's tiles (k, v; or q, dO) with rows
    past ``oth_ok`` [N, Ht] zero; lse and delta [N, Ho] (mode 0) or [N,
    Ht] (mode 1).  Returns the accumulators (dq; or dk, dv) before the
    scale."""
    n, ho, dh = a1.shape
    scale = tha._scale(dh)
    drop = (lambda t: t) if keep_nan else (lambda t: torch.where(t.isnan(), 0.0, t))
    an2 = drop((a1 * a1).sum(-1).view(n, ho // 16, 16)).amax(-1)  # a warp's largest |a1|^2
    bn2 = (b1 * b1).sum(-1)
    acc1, acc2 = torch.zeros(n, ho, dh), torch.zeros(n, ho, dh)
    for o0 in range(0, b1.shape[1], bt):
        t1, t2, ok = b1[:, o0:o0 + bt], b2[:, o0:o0 + bt], oth_ok[:, None, o0:o0 + bt]
        s = torch.zeros(n, ho, bt)
        dp = torch.zeros(n, ho, bt)
        for k0 in range(0, dh, 8):
            s = s + _mm3(a1[..., k0:k0 + 8], t1[..., k0:k0 + 8].transpose(1, 2), True, split)
            dp = dp + _mm3(a2[..., k0:k0 + 8], t2[..., k0:k0 + 8].transpose(1, 2), False, split)
        if guard:
            tc = scale * scale * an2 * drop(bn2[:, o0:o0 + bt]).amax(-1, keepdim=True) \
                <= SCORE_BOUND**2
            stats["fma_tiles"] = stats.get("fma_tiles", 0) + int((~tc).sum())
            s = torch.where(tc.repeat_interleave(16, 1)[..., None], s, _fma_scores(a1, t1))
        s = s * scale
        if mode == 0:  # keys at or past the length
            p = torch.exp(torch.where(ok, s, _NEG_INF) - lse[..., None])
            ds = p * (dp - delta[..., None])
        else:  # own key rows at or past the length; query rows past H add 0
            p = torch.exp(torch.where(own_ok[..., None], s, _NEG_INF) - lse[:, None, o0:o0 + bt])
            p = torch.where(ok, p, 0.0)
            ds = torch.where(ok, p * (dp - delta[:, None, o0:o0 + bt]), 0.0)
        for nb in range(bt // 8):
            band = _PERM + 8 * nb
            acc1 = acc1 + _mm3(ds[..., band], t1[:, band], False, split)
            if mode == 1:
                acc2 = acc2 + _mm3(p[..., band], t2[:, band], False, split)
    return acc1, acc2


def _emulate(q, k, v, do, lse, delta, lens, split=True, guard=True, keep_nan=True, stats=None):
    """(dq, dk, dv) in the kernel's order of work; see the module note."""
    n, h, dh = q.shape
    bt = tha.bwd_tc_shape(0, dh)[1]  # every plan's tiles (its warps change no sum)
    stats = {} if stats is None else stats
    ho, ht = -(-h // 16) * 16, -(-h // bt) * bt
    rows = torch.arange(max(ho, ht))
    valid = rows[None, :] < lens[:, None]  # [N, rows]: keys below the length
    inside = (rows < h)[None, :].expand(n, -1)
    # B16: own query rows (past H zero, not stored), key tiles zero past the length
    kk, vv = (torch.where(valid[:, :ht, None], _rows(t, ht), 0.0) for t in (k, v))
    dq, _ = _pass(_rows(q, ho), _rows(do, ho), kk, vv, None, valid[:, :ht], _rows(lse, ho),
                  _rows(delta, ho), 0, bt, split, guard, keep_nan, stats)
    # B17: own key rows, every query row (past H zero, with lse = delta = 0)
    dk, dv = _pass(_rows(k, ho), _rows(v, ho), _rows(q, ht), _rows(do, ht), valid[:, :ho],
                   inside[:, :ht], _rows(lse, ht), _rows(delta, ht), 1, bt, split, guard,
                   keep_nan, stats)
    keep = valid[:, :h, None]
    scale = tha._scale(dh)
    return (dq[:, :h] * scale, torch.where(keep, dk[:, :h] * scale, 0.0),
            torch.where(keep, dv[:, :h], 0.0))


def _inputs(n, h, dh, seed, mag=1.0):
    """q and k at ``mag``, v and the cotangent normal, lengths with the
    extremes 1 and H."""
    r = np.random.default_rng(seed)
    q, k = ((r.normal(size=(n, h, dh)) * mag).astype(np.float32) for _ in range(2))
    v, g = (r.normal(size=(n, h, dh)).astype(np.float32) for _ in range(2))
    lens = r.integers(1, h + 1, size=n).astype(np.int32)
    lens[0], lens[-1] = 1, h
    return q, k, v, g, lens


def _scale_of(grad, ins) -> float:
    """A grad's scale: its largest value, or one term |do| |v| where the
    exact grad is 0 (H = 1: one key takes all the probability, so dq = dk
    = 0), as the card tests take it."""
    return max(float(np.abs(grad).max()), float(ins[3].abs().max() * ins[2].abs().max()))


@functools.lru_cache(maxsize=None)
def _jax_case(n, h, dh, seed, mag, with_lens):
    """The inputs, and from the JAX package: lse (its Pallas forward's,
    cropped to [N, H]), delta = rowsum(g ∘ out) and jax.vjp's (dq, dk, dv)
    of blockwise_self_attention."""
    q, k, v, g, lens = _inputs(n, h, dh, seed, mag)
    if not with_lens:
        lens = np.full(n, h, np.int32)
    ln = jnp.asarray(lens) if with_lens else None
    out, vjp = jax.vjp(lambda *a: jha.blockwise_self_attention(*a, lengths=ln),
                       *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp(jnp.asarray(g))
    _, lse = jha._blockwise_fwd_impl(*(jnp.asarray(t) for t in (q, k, v, lens)))
    lse = np.asarray(lse)[:, 0, :h]
    delta = (g * np.asarray(out)).sum(-1)
    ins = tuple(torch.from_numpy(np.array(t)) for t in (q, k, v, g, lse, delta, lens))
    return ins, tuple(np.asarray(t) for t in grads)


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("n,h,dh", SHAPES)
def test_emulated_kernels_match_jax_vjp(n, h, dh, with_lens):
    """dq, dk and dv on every row (rows past a length too) against jax.vjp:
    several tiles (384), H off a tile (200, 300), one tile (128), a history
    of one key.  Normal q and k stay inside the guard's bound: every tile
    is scored in 3xTF32; masked keys' dk and dv exact zeros."""
    ins, want = _jax_case(n, h, dh, n * h + dh, 1.0, with_lens)
    stats = {}
    got = _emulate(*ins, stats=stats)
    assert stats["fma_tiles"] == 0
    for a, e in zip(got, want):
        _close(a.numpy(), e, RTOL, ATOL * _scale_of(e, ins))
    masked = torch.arange(h)[None, :] >= ins[-1][:, None]
    assert bool((got[1][masked] == 0).all()) and bool((got[2][masked] == 0).all())


def test_extreme_scores_take_the_fma_chain_and_match_jax():
    """q and k at 30 sigma: every tile past the guard's bound takes the FMA
    chain; the grads finite and within 1e-3 / 1e-4 of jax.vjp, with and
    without lengths."""
    for with_lens in (False, True):
        ins, want = _jax_case(2, 256, 16, 5, 30.0, with_lens)
        stats = {}
        got = _emulate(*ins, stats=stats)
        assert stats["fma_tiles"] > 0
        for a, e in zip(got, want):
            assert bool(a.isfinite().all())
            _close(a.numpy(), e, 1e-3, 1e-4 * _scale_of(e, ins))


def test_one_tf32_product_misses_the_tolerance():
    """The split is needed: with hi.hi' alone in every product the grads
    miss rtol 1e-4 / atol 1e-5 against jax.vjp."""
    ins, want = _jax_case(4, 128, 16, 4 * 128 + 16, 1.0, True)
    got = _emulate(*ins, split=False)
    with pytest.raises(AssertionError):
        for a, e in zip(got, want):
            _close(a.numpy(), e, RTOL, ATOL * _scale_of(e, ins))


@pytest.mark.parametrize("n,h,dh", [(64, 32, 16), (4, 512, 16), (3, 384, 64)])
def test_errors_from_f64_sums_as_the_plain_versions(n, h, dh):
    """Against the same function with f64 sums: for each of dq, dk and dv
    the emulated kernels have at most 1.5 times the plain version's count
    of values more than 2^-21 of the grad's scale away (or 1e-3 of the
    values, where both are that rare)."""
    q, k, v, g, lens = (torch.from_numpy(t) for t in _inputs(n, h, dh, seed=n + h))
    out, lse = tha.blockwise_attn_fwd_plain(q.double(), k.double(), v.double(), lens)
    delta = (g.double() * out).sum(-1)
    want = tha.blockwise_attn_bwd_plain(q.double(), k.double(), v.double(), g.double(), lse,
                                        delta, lens)
    args = (q, k, v, g, lse.float(), delta.float(), lens)
    plain = tha.blockwise_attn_bwd_plain(*args)
    for a, p, e in zip(_emulate(*args), plain, want):
        tol = 2.0**-21 * float(e.abs().max())
        count = lambda got: int(((got.double() - e).abs() > tol).sum())  # noqa: E731
        assert count(a) <= max(1.5 * count(p), 1e-3 * a.numel())


@pytest.mark.parametrize("where", ["query", "key"])
def test_nan_in_q_or_k_gives_nan_where_plain_does(where):
    """The card's NaN (0x7fffffff, which ``split_fin`` turns into zeros) in
    one query row, or in one valid key: NaN in the emulated dq, dk and dv
    exactly where the plain version has it (its masked keys' dk and dv
    taken as the kernel's exact zeros), the other values within rtol 1e-4,
    atol 1e-5; the guard's maxima keep the NaN, so the pair takes the FMA
    chain."""
    q, k, v, g, lens = (torch.from_numpy(t) for t in _inputs(3, 128, 16, seed=21))
    if where == "query":
        q[1, 5, 3] = _NAN
    else:
        k[2, 70, 3] = _NAN  # lens[2] = 128: valid
    out, lse = tha.blockwise_attn_fwd_plain(q, k, v, lens)
    args = (q, k, v, g, lse, (g * out).sum(-1), lens)
    want = list(tha.blockwise_attn_bwd_plain(*args))
    masked = torch.arange(128)[None, :] >= lens[:, None]
    for i in (1, 2):
        want[i] = torch.where(masked[..., None], 0.0, want[i])
    stats = {}
    got = _emulate(*args, stats=stats)
    assert stats["fma_tiles"] > 0
    for a, e in zip(got, want):
        assert bool(e.isnan().any())
        assert torch.equal(a.isnan(), e.isnan())
        a, e = torch.nan_to_num(a, 0.0), torch.nan_to_num(e, 0.0)
        _close(a.numpy(), e.numpy(), RTOL, ATOL * float(e.abs().max()))


def test_routes_and_plans_cover_every_history_length():
    """_bwd_route: the tensor cores from H = 128 on (PERF.md §6);
    _bwd_tc_plan: 64 own rows a block up to H = 64; beyond, 128 for B16 and
    for B17 below 2^17 rows, 64 from there; every plan's tiles of the same
    rows (the emulation's order), split into the same number of chunks
    for every thread (the kernel's static_assert), a multiple of 16 rows,
    and its block within the 227 KB of shared memory for every head dim
    and mode."""
    assert [tha._bwd_route(h) for h in (1, 32, 64, 127, 128, 4096)] == ["fma"] * 4 + ["tc"] * 2
    assert [tha._bwd_tc_plan(0, n, h) for n, h in ((4096, 64), (4, 4096), (1024, 4096))] == [0, 1, 1]
    assert [tha._bwd_tc_plan(1, n, h) for n, h in ((4096, 64), (4, 4096), (64, 512), (1024, 128),
                                                   (1024, 4096))] == [0, 1, 1, 0, 0]
    assert len({tha.bwd_tc_shape(i, dh)[1:] for i in range(len(tha._BWD_PLANS))
                for dh in (16, 32)}) == 1
    for plan in range(len(tha._BWD_PLANS)):
        for dh in tha.HEAD_DIMS:
            w, bt, _ = tha.bwd_tc_shape(plan, dh)
            assert bt % 16 == 0 and (bt * dh // 4) % (32 * w) == 0
            for mode in (0, 1):
                assert tha.bwd_tc_smem_bytes(mode, plan, dh) <= 232448
    # B17 at the long history's plan: three stages of Q, dO, lse and delta,
    # Q and dO in hi and lo by row, Q^T and dO^T in hi and lo, |q|^2
    assert tha.bwd_tc_smem_bytes(1, 1, 16) == 4 * (3 * (2 * 64 * 20 + 2 * 64)
                                                  + 4 * 64 * 20 + 4 * 16 * 68 + 64)
    assert tha.bwd_tc_smem_bytes(0, 1, 16) == 4 * (3 * 2 * 64 * 20 + 4 * 64 * 20
                                                  + 2 * 16 * 68 + 64)
