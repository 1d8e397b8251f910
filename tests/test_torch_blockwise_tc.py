"""PyTorch port: the tensor-core blockwise attention forward's arithmetic
(B15, ``csrc/history_attention.cu`` ``attn_fwd_tc_kernel``) emulated in
torch on the CPU against the JAX package's ``blockwise_self_attention``,
whose Pallas kernel runs in interpret mode as
tests/test_torch_blockwise_attention.py runs it.

``_emulate`` repeats the kernel's work in the kernel's order, on the plan
``_fwd_tc_plan`` gives the history length (keys a tile): per 16-row query
group and key tile, the guard (scale² max |q|² max |k|² against the
kernel's SCORE_BOUND², its maxima NaN where one of theirs is) picks the
tile's scores: in 3xTF32 (q and k split into TF32 hi and lo on the bits
as the kernel's ``split_fin`` does, and per k8 step hi.lo', lo.hi', hi.hi'
summed on their own, then added to the running f32 score in d order) or by
the plain version's f32 FMA chain in d order; the scale; keys at or past the length set to -1e30; the
tile's row max, the rescale exp(m - m_new), each lane's partial sum over
its keys 8 nb + 2 t + e (the m16n8 accumulator layout) in (nb, e) order;
P·V per key band of eight as one k8 step in 3xTF32 (P split as q, V as
``tt::tf32_split`` does) with the keys in the order 0 2 4 6 1 3 5 7; at
the end the quad's four partial sums added in butterfly order, out = o (1
/ l), lse = m + log l.

Tolerances: rtol 1e-4, atol 1e-5 (the JAX package's own for its blockwise
kernel against the dense reference), and 1e-3 / 1e-4 where q and k are at
30 sigma (its extreme-score test).  Two cases show why the kernel is built
so: one TF32 product (no split) misses 1e-4, and at 30 sigma even the
correctly rounded score misses the card test's tolerance against the plain
version, which the guard's FMA chain meets.  A NaN in q or k (the card's
0x7fffffff, which ``split_fin`` turns into zeros) gives NaN where the
plain version does only because the guard's maxima keep it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ce_forward import _split
from two_tower_models_tpu.ops.pallas import history_attention as jha
from two_tower_models_tpu_torch.ops import history_attention as tha

RTOL, ATOL = 1e-4, 1e-5
_NEG_INF = -1e30
SCORE_BOUND = 32.0  # csrc/history_attention.cu tc::SCORE_BOUND

# tests/test_torch_blockwise_attention.py's shapes, H = 1 and H = 33
SHAPES = [(4, 128, 16), (2, 200, 32), (3, 384, 64), (2, 300, 16), (5, 1, 16), (3, 33, 16)]


def _split_fin(x):
    """The kernel's ``split_fin``: each of hi and lo rounded to TF32 by
    adding 0x1000 to the bit pattern (a 32-bit add, which wraps) and
    clearing the low 13 bits; ``tt::tf32_split``'s bits for every x but a
    NaN, which may come out as zeros."""
    def rnd(t):
        b = (t.contiguous().view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000
        return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).view(torch.float32)

    hi = rnd(x)
    return hi, rnd(x - hi)


def _mm3(a, b, split=True, b_any=False):
    """a [..., M, 8] . b [..., 8, N] as one k8 step of the kernel's mma:
    hi.lo', lo.hi', hi.hi' summed on their own (hi.hi' alone without
    ``split``); a split by ``split_fin``, b too or (``b_any``) by
    ``tt::tf32_split``."""
    (ahi, alo), (bhi, blo) = _split_fin(a), (_split if b_any else _split_fin)(b)
    return (ahi @ blo + alo @ bhi) + ahi @ bhi if split else ahi @ bhi


def _fma_scores(q, k):
    """q kᵀ by the f32 FMA chain in d order: each step's product and sum
    exact in f64, then rounded to f32."""
    s = torch.zeros(q.shape[0], q.shape[1], k.shape[1], dtype=torch.float32)
    for d in range(q.shape[2]):
        s = (q[..., d, None].double() * k[:, None, :, d].double() + s.double()).float()
    return s


def _emulate(q, k, v, lens, split=True, guard=True, keep_nan=True, stats=None):
    """(out, lse) in the kernel's order of work; see the module note.
    ``split`` False: one TF32 product; ``guard`` False: every tile on the
    tensor cores; ``keep_nan`` False: the guard's maxima drop a NaN beside
    a number (as fmaxf does).  ``stats``, a dict, gets the count of
    (16-row group, key tile) pairs scored by the FMA chain as
    "fma_tiles"."""
    n, h, dh = q.shape
    bk = tha.tc_shape(tha._fwd_tc_plan(h), dh)[1]
    scale = tha._scale(dh)
    hp, kp = -(-h // 16) * 16, -(-h // bk) * bk
    pad = lambda t, rows: torch.cat([t, t.new_zeros(n, rows - h, dh)], 1)
    qp, kk, vv = pad(q, hp), pad(k, kp), pad(v, kp)
    keys = torch.arange(kp)
    valid = keys[None, :] < lens[:, None]  # [N, Kp]: rows at or past the length are zero-filled
    kk, vv = (torch.where(valid[..., None], t, 0.0) for t in (kk, vv))
    drop = (lambda t: t) if keep_nan else (lambda t: torch.where(t.isnan(), 0.0, t))
    qn2 = drop((qp * qp).sum(-1).view(n, hp // 16, 16)).amax(-1)  # a warp's largest |q|^2
    kn2 = (kk * kk).sum(-1)
    fma_tiles = 0
    m = torch.full((n, hp, 4), _NEG_INF)  # per row and lane t of the quad
    l = torch.zeros(n, hp, 4)
    o = torch.zeros(n, hp, dh)
    for c0 in range(0, int(lens.max()), bk):
        kt, vt = kk[:, c0:c0 + bk], vv[:, c0:c0 + bk]
        s = torch.zeros(n, hp, bk)
        for k0 in range(0, dh, 8):
            s = s + _mm3(qp[..., k0:k0 + 8], kt[..., k0:k0 + 8].transpose(1, 2), split)
        s = s * scale
        if guard:
            kmax = drop(kn2[:, c0:c0 + bk]).amax(-1, keepdim=True)
            tc = scale * scale * qn2 * kmax <= SCORE_BOUND**2
            fma_tiles += int((~tc).sum())
            tc = tc.repeat_interleave(16, 1)[..., None]
            s = torch.where(tc, s, _fma_scores(qp, kt) * scale)
        s = torch.where(keys[None, None, c0:c0 + bk] < lens[:, None, None], s, _NEG_INF)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn[..., :1])
        lanes = p.view(n, hp, bk // 8, 4, 2)  # [.., nb, t, e]: lane t holds keys 8 nb + 2 t + e
        tot = torch.zeros(n, hp, 4)
        for nb in range(bk // 8):
            for e in range(2):
                tot = tot + lanes[:, :, nb, :, e]
        l = l * alpha + tot
        m = mn
        o = o * alpha[..., :1]
        perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
        for nb in range(bk // 8):
            band = perm + 8 * nb
            o = o + _mm3(p[..., band], vt[:, band], split, b_any=True)
    if stats is not None:
        stats["fma_tiles"] = fma_tiles
    tot = (l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3])
    return (o * (1 / tot)[..., None])[:, :h], (m[..., 0] + torch.log(tot))[:, :h]


def _inputs(n, h, dh, seed, mag=1.0):
    """test_torch_blockwise_attention.py's inputs: q and k at ``mag``, v
    normal, lengths with the extremes 1 and H."""
    r = np.random.default_rng(seed)
    q, k = ((r.normal(size=(n, h, dh)) * mag).astype(np.float32) for _ in range(2))
    v = r.normal(size=(n, h, dh)).astype(np.float32)
    lens = r.integers(1, h + 1, size=n).astype(np.int32)
    lens[0], lens[-1] = 1, h
    return q, k, v, lens


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _jax(q, k, v, lens):
    """The JAX forward's (out, lse): blockwise_self_attention's output and
    its Pallas kernel's lse (JAX's [N, 1, Hp] cropped to [N, H])."""
    full = np.full(q.shape[0], q.shape[1], np.int32) if lens is None else lens
    out = jha.blockwise_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=None if lens is None else jnp.asarray(lens))
    _, lse = jha._blockwise_fwd_impl(*(jnp.asarray(t) for t in (q, k, v, full)))
    return np.asarray(out), np.asarray(lse)[:, 0, :q.shape[1]]


def _run(q, k, v, lens, **kw):
    full = np.full(q.shape[0], q.shape[1], np.int32) if lens is None else lens
    return _emulate(*(torch.from_numpy(t) for t in (q, k, v, full)), **kw)


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("n,h,dh", SHAPES)
def test_emulated_kernel_matches_jax(n, h, dh, with_lens):
    """out and lse on every row (rows past a length too) against the JAX
    forward: several 64-key tiles (384), H off a tile (200, 300, 33), a
    history of one key, one tile at most (H <= 64).  Normal q and k stay
    inside the guard's bound: every tile is scored in 3xTF32."""
    q, k, v, lens = _inputs(n, h, dh, seed=n * h + dh)
    lens = lens if with_lens else None
    stats = {}
    out, lse = _run(q, k, v, lens, stats=stats)
    assert stats["fma_tiles"] == 0
    want_out, want_lse = _jax(q, k, v, lens)
    _close(out.numpy(), want_out)
    _close(lse.numpy(), want_lse)


def test_extreme_scores_take_the_fma_chain_and_match_jax():
    """q and k at 30 sigma (test_torch_blockwise_attention.py's extreme
    case): every tile is past the guard's bound, the output finite and
    within 1e-3 / 1e-4 of the JAX forward, with and without lengths."""
    q, k, v, lens = _inputs(2, 256, 16, seed=5, mag=30.0)
    scale = tha._scale(16)
    assert scale * np.linalg.norm(q, axis=-1).min() * np.linalg.norm(k, axis=-1).min() > SCORE_BOUND
    for ln in (None, lens):
        stats = {}
        out, lse = _run(q, k, v, ln, stats=stats)
        assert stats["fma_tiles"] > 0
        assert bool(out.isfinite().all()) and bool(lse.isfinite().all())
        want_out, want_lse = _jax(q, k, v, ln)
        _close(out.numpy(), want_out, 1e-3, 1e-4)
        _close(lse.numpy(), want_lse, 1e-3, 1e-4)


def test_extreme_scores_need_the_plain_order():
    """Why the guard: on the card test's extreme input (64 examples, H =
    256, q and k at 30 sigma, mixed lengths), the emulated kernel is
    within 1e-3 / 1e-4 of the plain version, but every tile scored in
    3xTF32, or the correctly rounded score (exact, then rounded to f32),
    misses it: at scores of some thousands a score's last bit moves the
    softmax of a near tie by more than the tolerance."""
    r = np.random.default_rng(11)
    q, k, v = (torch.from_numpy((r.normal(size=(64, 256, 16)) * s).astype(np.float32))
               for s in (30.0, 30.0, 1.0))
    r.normal(size=(64, 256, 16))  # the card test's cotangent
    lens = r.integers(1, 257, size=64)
    lens[:2] = [256, 1]
    lens = torch.from_numpy(lens.astype(np.int32))
    want = tha.blockwise_attn_fwd_plain(q, k, v, lens)[0]
    miss = lambda got: float(((got - want).abs() / (1e-4 + 1e-3 * want.abs())).max())
    assert miss(_emulate(q, k, v, lens)[0]) <= 1.0
    assert miss(_emulate(q, k, v, lens, guard=False)[0]) > 1.0
    s = ((q.double() @ k.double().transpose(1, 2)) * tha._scale(16)).float()
    s = s.masked_fill(torch.arange(256)[None, None, :] >= lens[:, None, None], _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    assert miss((p @ v) / p.sum(-1, keepdim=True)) > 1.0


def test_one_tf32_product_misses_the_tolerance():
    """The split is needed: with hi.hi' alone (one TF32 product in both
    products) the output misses rtol 1e-4 / atol 1e-5 against JAX."""
    q, k, v, lens = _inputs(4, 128, 16, seed=4 * 128 + 16)
    out, _ = _run(q, k, v, lens, split=False)
    want, _ = _jax(q, k, v, lens)
    with pytest.raises(AssertionError):
        _close(out.numpy(), want)


@pytest.mark.parametrize("n,h,dh", [(64, 32, 16), (4, 512, 16), (3, 384, 64)])
def test_errors_from_f64_sums_as_the_plain_versions(n, h, dh):
    """Against the same function with f64 sums: the emulated kernel's out
    has at most 1.5 times the plain version's count of values more than
    2^-21 of the output's scale away (or 1e-3 of the values, where both
    are that rare), and its lse lies within 2e-7 of max |lse|."""
    q, k, v, lens = (torch.from_numpy(t) for t in _inputs(n, h, dh, seed=n + h))
    want_out, want_lse = (t.float() for t in tha.blockwise_attn_fwd_plain(
        q.double(), k.double(), v.double(), lens))
    tol = 2.0**-21 * float(want_out.abs().max())
    count = lambda got: int(((got - want_out).abs() > tol).sum())
    out, lse = _emulate(q, k, v, lens)
    plain_out, _ = tha.blockwise_attn_fwd_plain(q, k, v, lens)
    assert count(out) <= max(1.5 * count(plain_out), 1e-3 * out.numel())
    assert float((lse - want_lse).abs().max()) <= 2e-7 * float(want_lse.abs().max())


_NAN = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)[0]  # the card's NaN


@pytest.mark.parametrize("where", ["query", "key"])
def test_nan_in_q_or_k_gives_nan_where_plain_does(where):
    """The card's NaN (0x7fffffff, what inf - inf gives there) in one query
    row, or in one valid key and in one key past its length: NaN in the
    emulated kernel's out and lse exactly where the plain version has it,
    and the other values within rtol 1e-4, atol 1e-5.  With a guard whose
    maxima drop the NaN (fmaxf), the tile goes to the tensor cores, the
    split reads the NaN as zeros, and a row the plain version makes NaN
    comes out finite."""
    q, k, v, lens = (torch.from_numpy(t) for t in _inputs(3, 128, 16, seed=21))
    if where == "query":
        q[1, 5, 3] = _NAN
    else:
        k[2, 70, 3] = _NAN  # lens[2] = 128: valid
        k[0, 100, 0] = _NAN  # lens[0] = 1: masked, not read
    want = tha.blockwise_attn_fwd_plain(q, k, v, lens)
    got = _emulate(q, k, v, lens)
    for a, e in zip(got, want):
        assert bool(e.isnan().any())
        assert torch.equal(a.isnan(), e.isnan())
        _close(torch.nan_to_num(a, 0.0).numpy(), torch.nan_to_num(e, 0.0).numpy())
    lost = _emulate(q, k, v, lens, keep_nan=False)[0]
    assert bool((want[0].isnan() & lost.isfinite()).any())


def test_plans_cover_every_history_length():
    """_fwd_tc_plan: 64- then 128-row query tiles over 64-key tiles;
    _fwd_route: the tensor cores from H = 64 on; each plan's tiles split
    into the same number of chunks for every thread (the kernel's
    static_assert) and its block fits the 227 KB of shared memory for every
    head dim."""
    assert [tha._fwd_tc_plan(h) for h in (1, 32, 33, 64, 65, 4096)] == [0, 0, 0, 0, 1, 1]
    assert [tha._fwd_route(h) for h in (1, 32, 63, 64, 4096)] == ["fma"] * 3 + ["tc"] * 2
    for i in range(len(tha._TC_PLANS)):
        for dh in tha.HEAD_DIMS:
            qw, bk, _ = tha.tc_shape(i, dh)
            nt = 32 * qw
            assert bk % 16 == 0 and (bk * dh // 4) % nt == 0 and (16 * qw * dh // 4) % nt == 0
            assert tha.fwd_tc_smem_bytes(i, dh) <= 232448
    assert tha.fwd_tc_smem_bytes(0, 16) == 4 * (3 * (64 * 20 + 2 * 64 * 20)
                                                 + 2 * 64 * 20 + 2 * 16 * 68 + 64)
