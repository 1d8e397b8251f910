"""PyTorch port: the in-batch CE forward kernel's arithmetic (B10,
``csrc/fused_softmax.cu`` ``ce_fwd_tc_kernel``) emulated in torch on the CPU
against the JAX package's ``fused_in_batch_ce`` and ``fused_lse``, whose
Pallas kernels run in interpret mode as its own tests run them.

``_emulate`` repeats the kernel's work in the kernel's order: each operand
split into TF32 hi and lo on the bits (round to nearest, ties away from
zero), the three products hi.lo, lo.hi, hi.hi of each k8 step summed on
their own and added to the running f32 score in d order; then, with
``fwd_plan``'s split of the 64-column tiles, each thread's running (max,
sum) over its 16 columns of each tile (the m16n8 accumulator layout:
columns 8 nt + 2 t + e), the four lanes of a quad merged as the
butterfly does, and the splits merged in split order.

Tolerance: 1e-5 of each output's largest magnitude (f32 sums in other
orders); NaN in the same places.  One case shows why the kernel splits its
operands: the 3xTF32 emulation lies within 1e-6 of scale of an f64
logsumexp, a single TF32 product does not.
"""

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


def _scores(u: torch.Tensor, i: torch.Tensor, split: bool = True) -> torch.Tensor:
    """S = U . I^T as the kernel sums it: per k8 step hi.lo, lo.hi, hi.hi (or
    hi.hi alone without ``split``) summed on their own, then added to the
    running score, the steps in d order."""
    (b, d), c = u.shape, i.shape[0]
    s = torch.zeros(b, c)
    for k0 in range(0, d, 8):
        a, w = u[:, k0:k0 + 8], i[:, k0:k0 + 8]
        ahi, whi = _tf32(a), _tf32(w)
        alo, wlo = _tf32(a - ahi), _tf32(w - whi)
        step = (ahi @ wlo.T + alo @ whi.T) + ahi @ whi.T if split else ahi @ whi.T
        s = s + step
    return s


def _merge(m, l, mo, lo):
    """The kernel's merge of two (max, sum) parts: each sum rescaled to the
    larger max, the products rounded, then added."""
    mn = torch.fmax(m, mo)
    return mn, l * torch.exp(m - mn) + lo * torch.exp(mo - mn)


def _emulate(u: torch.Tensor, i: torch.Tensor, with_diag: bool, split: bool = True):
    """(ce, lse) in the kernel's order of work; see the module note."""
    (b, d), c = u.shape, i.shape[0]
    bn = tfs.FWD_COLS
    n_ct = -(-c // bn)
    n_split = tfs.fwd_plan(b, c, d, _SMS)
    s = torch.full((b, n_ct * bn), float("nan"))
    s[:, :c] = _scores(u, i, split)
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
            tot = torch.zeros(b, 4)
            for nt in range(8):
                for e in range(2):
                    ok = col[:, ct, nt, e] < c
                    tot = tot + torch.where(ok, torch.exp(s[:, :, ct, nt, e] - mn), 0.0)
            l = l * torch.exp(m - mn) + tot
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
    lse = m + torch.log(l)
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
