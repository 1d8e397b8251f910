"""PyTorch port: the in-batch CE forward kernel's arithmetic (B10,
``csrc/fused_softmax.cu`` ``ce_fwd_tc_kernel``) emulated in torch on the CPU
against the JAX package's ``fused_in_batch_ce`` and ``fused_lse``, whose
Pallas kernels run in interpret mode as its own tests run them.

``_emulate`` repeats the kernel's work in the kernel's order: each operand
split into TF32 hi and lo on the bits (round to nearest, ties away from
zero; where hi is infinite, hi = 0 and lo the operand cut to TF32, as
``tt::tf32_split`` does), the three products hi.lo, lo.hi, hi.hi of each
k8 step summed on their own and added to the running f32 score in d order;
then, with ``fwd_plan``'s split of the 64-column tiles, each thread's
running (max, sum) over its 16 columns of each tile (the m16n8 accumulator
layout: columns 8 nt + 2 t + e), the sums taken against the max, or 0
where the max is infinite (the kernel's ``base``), the four lanes of a
quad merged as the butterfly does, and the splits merged in split order.

Tolerance: 1e-5 of each output's largest magnitude (f32 sums in other
orders); NaN in the same places.  One case shows why the kernel splits its
operands: the 3xTF32 emulation lies within 1e-6 of scale of an f64
logsumexp, a single TF32 product does not.  On rows with infinite scores
(an infinite input, a score that overflows, a row of -inf scores) the
emulation has the plain version's infinities and NaNs in the same places,
the plain version those of ``jax.nn.logsumexp`` of the dense scores (the
Pallas kernels give NaN where the max is +inf, a deviation of the
reference), and a split that kept hi infinite with lo = 0 would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_softmax as jfs
from two_tower_models_tpu_torch.ops import fused_softmax as tfs

_NEG_BIG = -1e30
_SMS = 132  # the H100's SMs: fwd_plan's split as the card takes it


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 does it: 10 mantissa bits, to
    nearest, ties away from zero (the magnitude's bits rounded up at bit
    12); NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & 0x7FFFE000
    out = (sign | mag).to(torch.int64)
    out = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32).view(torch.float32)
    return torch.where(x.isnan(), x, out)


def _split(x: torch.Tensor, big_lo: str = "cut"):
    """``tt::tf32_split``: (hi, lo) TF32 with x = hi + lo + a remainder.
    Where hi is infinite (x infinite, or finite with a TF32 rounding that
    overflows) the kernel takes hi = 0 and lo = x with its low 13 bits
    cleared (``big_lo`` "cut"); "zero" is the split that keeps hi and takes
    lo = 0 there instead."""
    hi = _tf32(x)
    lo = _tf32(x - hi)
    big = hi.isinf()
    if big_lo == "zero":
        return hi, torch.where(big, 0.0, lo)
    cut = (x.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return torch.where(big, 0.0, hi), torch.where(big, cut, lo)


def _scores(u: torch.Tensor, i: torch.Tensor, split: bool = True,
            big_lo: str = "cut") -> torch.Tensor:
    """S = U . I^T as the kernel sums it: per k8 step hi.lo, lo.hi, hi.hi (or
    hi.hi alone without ``split``) summed on their own, then added to the
    running score, the steps in d order."""
    (b, d), c = u.shape, i.shape[0]
    s = torch.zeros(b, c)
    for k0 in range(0, d, 8):
        (ahi, alo), (whi, wlo) = (_split(t[:, k0:k0 + 8], big_lo) for t in (u, i))
        step = (ahi @ wlo.T + alo @ whi.T) + ahi @ whi.T if split else ahi @ whi.T
        s = s + step
    return s


def _base(m):
    """The max a part's sum is taken against: m, or 0 where m is infinite."""
    return torch.where(m.isinf(), 0.0, m)


def _merge(m, l, mo, lo):
    """The kernel's merge of two (max, sum) parts: each sum rescaled to the
    larger max's base, the products rounded, then added."""
    mn = torch.fmax(m, mo)
    bn = _base(mn)
    return mn, l * torch.exp(_base(m) - bn) + lo * torch.exp(_base(mo) - bn)


def _emulate(u: torch.Tensor, i: torch.Tensor, with_diag: bool, split: bool = True,
             big_lo: str = "cut"):
    """(ce, lse) in the kernel's order of work; see the module note."""
    (b, d), c = u.shape, i.shape[0]
    bn = tfs.FWD_COLS
    n_ct = -(-c // bn)
    n_split = tfs.fwd_plan(b, c, d, _SMS)
    s = torch.full((b, n_ct * bn), float("nan"))
    s[:, :c] = _scores(u, i, split, big_lo)
    # [B, tile, nt, t, e] -> [B, t, tile, nt, e]: lane t of a quad holds
    # columns 8 nt + 2 t + e of each tile
    s = s.view(b, n_ct, 8, 4, 2).permute(0, 3, 1, 2, 4)
    col = (torch.arange(n_ct)[:, None, None, None] * bn + 8 * torch.arange(8)[None, :, None, None]
           + 2 * torch.arange(4)[None, None, :, None] + torch.arange(2)[None, None, None, :])
    col = col.permute(2, 0, 1, 3)  # [t, tile, nt, e]
    rows = torch.arange(b)[:, None]
    parts = []
    for sp in range(n_split):
        m, l = torch.full((b, 4), _NEG_BIG), torch.zeros(b, 4)
        dg = torch.zeros(b, 4)
        for ct in tfs.bwd_tiles(n_ct, n_split, sp):
            tmax = torch.full((b, 4), _NEG_BIG)
            for nt in range(8):
                for e in range(2):
                    ok = col[:, ct, nt, e] < c
                    tmax = torch.where(ok, torch.fmax(tmax, s[:, :, ct, nt, e]), tmax)
            mn = torch.fmax(m, tmax)
            base = _base(mn)
            tot = torch.zeros(b, 4)
            for nt in range(8):
                for e in range(2):
                    ok = col[:, ct, nt, e] < c
                    tot = tot + torch.where(ok, torch.exp(s[:, :, ct, nt, e] - base), 0.0)
            l = l * torch.exp(_base(m) - base) + tot
            m = mn
            if with_diag:
                for nt in range(8):
                    for e in range(2):
                        dg = torch.where(col[:, ct, nt, e] == rows, s[:, :, ct, nt, e], dg)
        for off in (1, 2):  # the quad's butterfly
            perm = torch.arange(4) ^ off
            dg = dg + dg[:, perm]
            m, l = _merge(m, l, m[:, perm], l[:, perm])
        parts.append((m[:, 0], l[:, 0], dg[:, 0]))
    m, l, dg = parts[0]
    for mo, lo, do in parts[1:]:  # the last block's merge, in split order
        m, l = _merge(m, l, mo, lo)
        dg = dg + do
    lse = _base(m) + torch.log(l)
    return (lse - dg if with_diag else lse), lse


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol * scale)


def _inputs(seed, b, c, d, scale=0.3):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(b, d)) * scale).astype(np.float32),
            (r.normal(size=(c, d)) * scale).astype(np.float32))


@pytest.mark.parametrize("b,c,d,diag,nan_row", [
    (1, 1, 64, True, False), (100, 100, 64, True, False), (300, 1000, 65, False, False),
    (50, 20, 7, False, False), (33, 33, 640, True, False), (200, 200, 64, True, True),
])
def test_emulated_kernel_matches_jax(b, c, d, diag, nan_row):
    """The emulation against ``fused_in_batch_ce`` (diagonal) or
    ``fused_lse``: B = 1, B not a multiple of the 128-row tile, C != B at
    D = 65 (two staged d chunks, 16 splits), D = 7 (one k8 step), D = 640
    (past D = 605, where whole rows at a D | 1 stride no longer fit shared
    memory) and a
    NaN row of U, whose ce and lse are NaN."""
    u, i = _inputs(b + d, b, c, d)
    if nan_row:
        u[17] = np.nan
    ce, lse = _emulate(torch.from_numpy(u), torch.from_numpy(i), diag)
    if diag:
        ce_j, lse_j = jfs.fused_in_batch_ce(jnp.asarray(u), jnp.asarray(i))
        _close(ce, ce_j)
        _close(lse, lse_j)
    else:
        _close(lse, jfs.fused_lse(jnp.asarray(u), jnp.asarray(i)))
        assert torch.equal(ce, lse)
    if nan_row:
        assert bool(lse[17].isnan()) and int(lse.isnan().sum()) == 1


def test_three_products_reach_f32_one_does_not():
    """At B = C = 512, D = 64, normal inputs: the 3xTF32 emulation's lse
    within 1e-6 of scale of an f64 logsumexp; one TF32 product (hi.hi) more
    than 1e-6 off."""
    u, i = (torch.from_numpy(a) for a in _inputs(7, 512, 512, 64, 1.0))
    want = torch.logsumexp(u.double() @ i.double().T, 1)
    scale = float(want.abs().max())
    err = lambda split: float((_emulate(u, i, False, split)[1].double() - want).abs().max()) / scale
    assert err(True) <= 1e-6
    assert err(False) > 1e-6


@pytest.mark.parametrize("b,c,d,splits", [
    (4096, 4096, 64, 8), (1, 1, 64, 1), (300, 1000, 65, 16), (65536, 4096, 64, 1), (129, 64, 7, 1),
])
def test_fwd_plan(b, c, d, splits):
    """The forward's column splits: 8 at the flagship step (32 row tiles x 8
    = 256 blocks, two an SM on 132 SMs), never more than the column tiles,
    one where the row tiles fill the card alone."""
    assert tfs.fwd_plan(b, c, d, _SMS) == splits


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32: 1 + 2^-11 (a tie) rounds up, 1 + 2^-12
    down, -(1 + 2^-11) to -(1 + 2^-10); the low 13 bits are zero."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 3.0, float("inf")])
    got = _tf32(x)
    assert got.tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 3.0, float("inf")]
    r = torch.from_numpy(np.random.default_rng(3).normal(size=1000).astype(np.float32))
    assert int((_tf32(r).view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((_tf32(r) - r).abs() / r.abs()).max()) <= 2 ** -11


def _infinite_inputs(b, c, d):
    """Normal inputs at scale 0.3 with four rows of U whose scores are not
    all finite, each the same in every sum order: row 5 has u = 1e38 at d =
    0, where I is 4 + |n| in the columns of the third 64-column tile, so its
    scores overflow to +inf there and are finite (up to about 1e38)
    elsewhere; row 6 has u = +inf at d = 0 (scores +-inf by the sign of I's
    d 0, never 0); row 7 has u = -1e38 at d = 1, where every row of I is 4 +
    |n|, so its scores overflow to -inf; row 8 has u = -inf at d = 2, where
    I is 4 + |n| too (all -inf)."""
    u, i = _inputs(b + c + d, b, c, d)
    r = np.random.default_rng(b + c)
    pos = lambda n: (4 + np.abs(r.normal(size=n))).astype(np.float32)
    i[128:192, 0] = pos(len(i[128:192]))
    i[:, 1], i[:, 2] = pos(c), pos(c)
    u[5, 0], u[6, 0], u[7, 1], u[8, 2] = 1e38, np.inf, -1e38, -np.inf
    return torch.from_numpy(u), torch.from_numpy(i)


def _same_class(got, want, tol=1e-5):
    """NaN, +inf and -inf in the same places; the finite values within
    ``tol`` of the finite values' largest magnitude."""
    got, want = (torch.from_numpy(np.array(t, np.float32)) for t in (got, want))
    assert got.shape == want.shape
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want))
    fin = want.isfinite()
    scale = float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= tol * scale


# B = C with the diagonal (four column tiles, four splits), and C != B
@pytest.mark.parametrize("b,c,diag", [(200, 200, True), (200, 300, False)])
def test_emulated_kernel_matches_plain_on_infinite_scores(b, c, diag):
    """The emulation against ``in_batch_ce_fwd_plain`` on
    ``_infinite_inputs``: lse +inf on rows 5 and 6 (a +inf score), -inf on
    rows 7 and 8 (every score -inf), ce = lse - diag in IEEE arithmetic
    (inf - inf is NaN); every other row finite and within 1e-5 of scale."""
    u, i = _infinite_inputs(b, c, 64)
    ce, lse = _emulate(u, i, diag)
    ce_p, lse_p = tfs.in_batch_ce_fwd_plain(u, i, diag)
    assert lse_p[5:7].isposinf().all() and lse_p[7:9].isneginf().all()
    assert int((~lse_p.isfinite()).sum()) == 4
    _same_class(lse, lse_p)
    _same_class(ce, ce_p)


@pytest.mark.parametrize("d", [64, 80])
def test_emulated_kernel_matches_plain_on_an_infinite_item(d):
    """An infinite value in I (row 150, d = 3): column 150's scores are
    +-inf by the sign of U's d 3, so about half of the rows have lse +inf;
    the emulation has the plain version's infinities and NaNs, the rest
    within 1e-5 of scale (D = 80: two d chunks)."""
    u, i = (torch.from_numpy(a) for a in _inputs(d, 200, 200, d))
    i[150, 3] = float("inf")
    ce, lse = _emulate(u, i, True)
    ce_p, lse_p = tfs.in_batch_ce_fwd_plain(u, i)
    assert torch.equal(lse_p.isposinf(), u[:, 3] > 0)
    _same_class(lse, lse_p)
    _same_class(ce, ce_p)


def test_plain_matches_dense_logsumexp_on_infinite_scores():
    """``in_batch_ce_fwd_plain`` on ``_infinite_inputs`` against
    ``jax.nn.logsumexp`` of the dense scores (and ce = lse - diag there);
    the JAX package's Pallas ``fused_lse`` gives NaN on the rows whose max
    is +inf and -1e30, its running max's start, on the rows of -inf
    scores: deviations of the reference that the port does not follow."""
    u, i = _infinite_inputs(200, 200, 64)
    s = jnp.asarray(u.numpy()) @ jnp.asarray(i.numpy()).T
    lse_j = jax.nn.logsumexp(s, axis=1)
    ce_p, lse_p = tfs.in_batch_ce_fwd_plain(u, i)
    _same_class(lse_p, lse_j)
    _same_class(ce_p, lse_j - jnp.diagonal(s))
    pallas = np.asarray(jfs.fused_lse(jnp.asarray(u.numpy()), jnp.asarray(i.numpy())))
    assert np.isnan(pallas[5:7]).all() and (pallas[7:9] == np.float32(-1e30)).all()


def test_infinite_input_split_takes_hi_zero():
    """Why the split puts an infinite operand in lo: with hi = inf and lo =
    0 the product hi.lo' is inf times the other operand's lo, whose sign is
    that of a rounding error, and row 6's scores come out NaN where f32
    gives +-inf; with the kernel's split they are the plain version's."""
    u, i = _infinite_inputs(200, 200, 64)
    want = u @ i.T
    kept = _scores(u, i, big_lo="zero")[6]
    assert kept.isnan().any() and not want[6].isnan().any()
    got = _scores(u, i)
    assert torch.equal(got[6], want[6])
    assert torch.equal(got[7], want[7]) and torch.equal(got[8], want[8])
