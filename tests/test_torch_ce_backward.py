"""PyTorch port: the in-batch CE backward that computes dU and dI in one pass
over the score tiles (``ops/fused_softmax.py:in_batch_ce_bwd``, kernels B11
and B12 in one) against the JAX package on the CPU.

- ``in_batch_ce_bwd_plain`` against ``jax.vjp`` of ``fused_in_batch_ce``
  (diagonal positives) and ``fused_lse`` (no diagonal, C != B), run in
  interpret mode as the JAX package's own tests run them.
- ``bwd_plan`` and ``bwd_tiles``: every (row tile, column tile) pair is
  walked by exactly one block, and the workspace stays within its bound.
- ``_emulate``: the kernel's order of work at small tiles (partial slices
  written per block, dI's slice added to across a block's row tiles, the
  reduce summing slices in order, then the diagonal), against the JAX VJP,
  with a NaN row and a diagonal that crosses tile edges.

Tolerance: 1e-5 of each output's largest magnitude, or of one g_b p_bj x_j
term where that is larger (at B = C = 1 the exact gradient is 0); f32 sums
in another order; NaN in the same places.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_softmax as jfs
from two_tower_models_tpu_torch.ops import fused_softmax as tfs


def _close(got, want, floor, tol=1e-5):
    """Within tol of max(max |want|, floor); ``floor`` is the size of one
    g_b p_bj x_j term, for a gradient whose exact value is 0 (B = C = 1)."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, floor, 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol * scale)


def _term(g, x):
    return float(np.abs(g).max() * np.nanmax(np.abs(x)))


def _inputs(seed, b, c, d):
    r = np.random.default_rng(seed)
    u = (r.normal(size=(b, d)) * 0.3).astype(np.float32)
    i = (r.normal(size=(c, d)) * 0.3).astype(np.float32)
    return u, i, r.normal(size=(b,)).astype(np.float32)


def _jax_vjp(u, i, g, with_diag):
    fn = (lambda x, y: jfs.fused_in_batch_ce(x, y)[0]) if with_diag else jfs.fused_lse
    _, vjp = jax.vjp(fn, jnp.asarray(u), jnp.asarray(i))
    return vjp(jnp.asarray(g))


def _lse(u, i, with_diag):
    return tfs.in_batch_ce_fwd_plain(torch.from_numpy(u), torch.from_numpy(i), with_diag)[1]


# (B, C, D, diagonal): B = 1; a square batch; C != B at the logQ route's
# D = 65; D = 7 with and without the diagonal
_SHAPES = [(1, 1, 32, True), (200, 200, 32, True), (96, 300, 65, False),
           (40, 40, 7, True), (50, 20, 7, False)]


@pytest.mark.parametrize("b,c,d,diag", _SHAPES)
def test_combined_plain_matches_jax_vjp(b, c, d, diag):
    u, i, g = _inputs(b + c + d, b, c, d)
    du_j, di_j = _jax_vjp(u, i, g, diag)
    tu, ti, tg = (torch.from_numpy(a) for a in (u, i, g))
    du, di = tfs.in_batch_ce_bwd_plain(tu, ti, _lse(u, i, diag), tg, diag)
    _close(du, du_j, _term(g, i))
    _close(di, di_j, _term(g, u))
    # the wrapper takes the plain version for CPU tensors
    du_w, di_w = tfs.in_batch_ce_bwd(tu, ti, _lse(u, i, diag), tg, diag)
    assert torch.equal(du_w, du) and torch.equal(di_w, di)


@pytest.mark.parametrize("want_du,want_di", [(True, False), (False, True)], ids=["du", "di"])
def test_one_gradient_asked_for(want_du, want_di):
    """Only the gradient asked for comes back, equal to the JAX one; the
    autograd Function asks for what needs_input_grad requires."""
    b, c, d = 96, 300, 65
    u, i, g = _inputs(7, b, c, d)
    du_j, di_j = _jax_vjp(u, i, g, False)
    tu, ti, tg = (torch.from_numpy(a) for a in (u, i, g))
    du, di = tfs.in_batch_ce_bwd(tu, ti, _lse(u, i, False), tg, False, want_du, want_di)
    assert (du is None) != want_du and (di is None) != want_di
    if want_du:
        _close(du, du_j, _term(g, i))
    else:
        _close(di, di_j, _term(g, u))
    tu.requires_grad_(want_du), ti.requires_grad_(want_di)
    (tfs.fused_lse(tu, ti) * tg).sum().backward()
    assert (tu.grad is None) != want_du and (ti.grad is None) != want_di
    _close(tu.grad if want_du else ti.grad, du_j if want_du else di_j, _term(g, i if want_du else u))


# ragged shapes around the 128 x 64 tiles, with the SM counts of a small
# card, an H100 and a large card
_PLAN_SHAPES = [(1, 1), (1, 4096), (4096, 1), (100, 100), (129, 65), (4096, 4096),
                (4097, 3000), (65536, 65536), (300, 1000), (20000, 77)]


@pytest.mark.parametrize("sms", [1, 132, 1000])
def test_plan_covers_every_tile_pair_once(sms):
    for b, c in _PLAN_SHAPES:
        g_r, g_c, slices = tfs.bwd_plan(b, c, 64, sms)
        n_rt, n_ct = math.ceil(b / tfs.BWD_ROWS), math.ceil(c / tfs.BWD_COLS)
        assert 1 <= g_r <= n_rt and 1 <= g_c <= n_ct and slices == 1
        assert g_r * g_c <= max(1, sms * tfs.BWD_BLOCKS_PER_SM)
        seen = np.zeros((n_rt, n_ct), dtype=np.int64)
        for rb in range(g_r):
            for cb in range(g_c):
                rows, cols = tfs.bwd_tiles(n_rt, g_r, rb), tfs.bwd_tiles(n_ct, g_c, cb)
                assert len(rows) >= 1 and len(cols) >= 1  # no idle block
                for rt in rows:
                    seen[rt, list(cols)] += 1
        assert (seen == 1).all(), (b, c, sms)


def test_plan_workspace_within_its_bound():
    """ws_du [G_c, B, D] <= (K B + slots 128) D and ws_di [G_r, C, D] <= (K C +
    slots 64) D floats, K = slots // isqrt(slots): linear in B + C."""
    for sms in (1, 7, 132, 1000):
        slots = sms * tfs.BWD_BLOCKS_PER_SM
        k = slots // math.isqrt(slots)
        for b in (1, 2, 127, 128, 129, 1000, 4096, 50000, 262144):
            for c in (1, 63, 64, 65, 1000, 4096, 50000, 262144):
                g_r, g_c, _ = tfs.bwd_plan(b, c, 64, sms)
                assert g_c * b <= k * b + slots * tfs.BWD_ROWS, (sms, b, c)
                assert g_r * c <= k * c + slots * tfs.BWD_COLS, (sms, b, c)


def test_plan_at_the_flagship_step():
    """B = C = 4096, D = 64 on 132 SMs: 16 x 16 blocks, one wave of 256 equal
    blocks (2 row tiles by 4 column tiles each) in the 264 slots; 32 MiB of
    workspace."""
    assert tfs.bwd_plan(4096, 4096, 64, 132) == (16, 16, 1)
    assert tfs.bwd_plan(4096, 4096, 65, 132) == (16, 16, 2)
    assert (16 * 4096 * 64 + 16 * 4096 * 64) * 4 == 32 << 20


def _emulate(u, i, lse, g, with_diag, bm, bn, dz, g_r, g_c):
    """ce_bwd_kernel and ce_bwd_reduce at tiles of bm rows, bn columns and
    output slices of dz, on a g_r x g_c grid, in the kernel's order: each
    block walks its row tiles and, for each, its column tiles; S over all of
    D, g p selected to 0 outside [B, C]; dU's sum over the block's columns
    written to slice cb, dI's partial written to slice rb on the block's
    first row tile and added to on the next; then the slices summed in order
    and the diagonal subtracted.  The workspace starts as NaN, so a missed
    element shows."""
    (b, d), c = u.shape, i.shape[0]
    n_rt, n_ct = -(-b // bm), -(-c // bn)
    up = torch.zeros(n_rt * bm, d)
    up[:b] = u
    ip = torch.zeros(n_ct * bn, d)
    ip[:c] = i
    lp, gp = torch.zeros(n_rt * bm), torch.zeros(n_rt * bm)
    lp[:b], gp[:b] = lse, g
    ws_du = torch.full((g_c, b, d), float("nan"))
    ws_di = torch.full((g_r, c, d), float("nan"))
    for z in range(-(-d // dz)):
        ds = slice(z * dz, min(d, (z + 1) * dz))
        for rb in range(g_r):
            for cb in range(g_c):
                rts, cts = tfs.bwd_tiles(n_rt, g_r, rb), tfs.bwd_tiles(n_ct, g_c, cb)
                for rt in rts:
                    rows = torch.arange(rt * bm, rt * bm + bm)
                    acc = torch.zeros(bm, ds.stop - ds.start)
                    for ct in cts:
                        cols = torch.arange(ct * bn, ct * bn + bn)
                        s = up[rows] @ ip[cols].T
                        valid = (rows < b)[:, None] & (cols < c)[None, :]
                        p = torch.where(valid, torch.exp(s - lp[rows, None]) * gp[rows, None], 0.0)
                        acc += p @ ip[cols, ds]
                        part, real = p.T @ up[rows, ds], cols[cols < c]
                        prev = 0.0 if rt == rts[0] else ws_di[rb, real, ds]
                        ws_di[rb, real, ds] = prev + part[: len(real)]
                    real = rows[rows < b]
                    ws_du[cb, real, ds] = acc[: len(real)]
    du, di = torch.zeros(b, d), torch.zeros(c, d)
    for k in range(g_c):
        du = du + ws_du[k]
    for k in range(g_r):
        di = di + ws_di[k]
    if with_diag:
        n = min(b, c)
        du[:n] = du[:n] - g[:n, None] * i[:n]
        di[:n] = di[:n] - g[:n, None] * u[:n]
    return du, di


# (B, C, D, diagonal, bm, bn, dz, G_r, G_c, NaN row): the diagonal crosses
# the edges of 4-row and 3-column tiles; blocks of two row tiles; two
# output slices; a NaN row of U
_EMU = [(10, 10, 7, True, 4, 3, 5, 2, 2, None),
        (13, 29, 6, False, 4, 8, 4, 3, 2, None),
        (10, 10, 7, True, 4, 3, 5, 2, 2, 5),
        (1, 1, 3, True, 4, 3, 2, 1, 1, None)]


@pytest.mark.parametrize("b,c,d,diag,bm,bn,dz,g_r,g_c,nan_row", _EMU)
def test_kernel_order_matches_jax_vjp(b, c, d, diag, bm, bn, dz, g_r, g_c, nan_row):
    u, i, g = _inputs(b * c + d, b, c, d)
    if nan_row is not None:
        u[nan_row] = np.nan
    du_j, di_j = _jax_vjp(u, i, g, diag)
    tu, ti, tg = (torch.from_numpy(a) for a in (u, i, g))
    du, di = _emulate(tu, ti, _lse(u, i, diag), tg, diag, bm, bn, dz, g_r, g_c)
    _close(du, du_j, _term(g, i))
    _close(di, di_j, _term(g, u))
    if nan_row is not None:
        # its dU row is NaN and every column saw it; the other rows stay finite
        assert int(du.isnan().any(1).sum()) == 1 and bool(du[nan_row].isnan().all())
        assert bool(di.isnan().all())
