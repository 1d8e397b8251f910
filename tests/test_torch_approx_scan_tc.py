"""PyTorch port: the arithmetic of N1's tensor-core kernel
(``csrc/approx_scan.cu`` ``approx_scan_tc_kernel<ROWS>``) emulated in torch
on the CPU, against the plain version the CPU runs and against JAX's
``jnp.dot`` at HIGHEST precision followed by ``lax.approx_max_k``; and
``approx_scan``'s choice of kernel.

``_emulate`` repeats the kernel's work: the query split into TF32 hi and lo
(``tt::tf32_split_any``: round to nearest, ties away from zero; where hi
would be infinite, hi = 0 and lo the value cut to TF32), then per row kind
  f32 rows:  q_lo . c_hi + q_hi . c_lo + q_hi . c_hi (3xTF32, the rows split
             the same way),
  int8 rows: q_lo . c + q_hi . c, then times the row's scale,
  bf16 rows: q_lo . c' + q_hi . c, c' the rows with non-finite values 0,
each product an f32 matrix product, the small ones added first; then + 0.0
(-0 becomes +0 and every NaN the canonical one, as the plain version's f32
sums on the card give them), rows at or past ``valid_count`` at -inf, and the
strided bin max in the select's key order, a tie to the lowest row.  The
tensor cores sum in their own order, which the emulation does not repeat:
values are held within 1e-5 of each query's largest |score|, rows equal
wherever a bin's best two differ by more.  On integer grids every product
and sum is exact, so there the values are equal and NaN and +-inf land where
the plain version has them.  JAX's ``approx_max_k`` sorts exactly on the
CPU, so it is compared where the bins are the rows (M = C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu_torch.ops import approx_topk as at
from two_tower_models_tpu_torch.ops import mips_topk as mt

_INT_MIN = -(1 << 31)
_CANONICAL_NAN = 0x7FFFFFFF


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 does it: 10 mantissa bits, to
    nearest, ties away from zero; NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & 0x7FFFE000
    out = (sign | mag).to(torch.int64)
    out = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32).view(torch.float32)
    return torch.where(x.isnan(), x, out)


def _split_any(x: torch.Tensor):
    """``tt::tf32_split_any``: (hi, lo), both TF32; where hi would be
    infinite (x infinite, or finite with a TF32 rounding that overflows), hi
    = 0 and lo = x with its low 13 bits cleared."""
    hi = _tf32(x)
    big = hi.isinf()
    lo = _tf32(x - torch.where(big, 0.0, hi))
    cut = (x.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return torch.where(big, 0.0, hi), torch.where(big, cut, lo)


def _canonical(s: torch.Tensor) -> torch.Tensor:
    """s + 0.0 as the card adds it: -0 to +0, every NaN to 0x7FFFFFFF."""
    s = s + 0.0
    return torch.where(s.isnan(), torch.tensor(_CANONICAL_NAN, dtype=torch.int32).view(
        torch.float32), s)


def _scores(q: torch.Tensor, rows: torch.Tensor, kind: str, scale=None) -> torch.Tensor:
    """[B, C] scores in the kernel's arithmetic (module note)."""
    qh, ql = _split_any(q.float())
    if kind == "f32":
        ch, cl = _split_any(rows.float())
        s = (ql @ ch.T + qh @ cl.T) + qh @ ch.T
    else:
        c = rows.float()
        c_lo = c if kind == "int8" else torch.where(c.isfinite(), c, 0.0)
        s = ql @ c_lo.T + qh @ c.T
    s = _canonical(s)
    return s * scale[None, :] if scale is not None else s


def _bin_max(s: torch.Tensor, m: int, valid: int):
    """The strided bin max of scores s [B, C]: (values [B, M], rows [B, M])."""
    b, c = s.shape
    w = -(-c // m)
    s = s.clone()
    s[:, valid:] = float("-inf")
    comp = mt.f32_keys(s).long()
    comp = torch.nn.functional.pad(comp, (0, w * m - c), value=_INT_MIN)
    low = (1 << 32) - 1 - torch.arange(w * m) // m
    comp = (comp * (1 << 32) + low).view(b, w, m).amax(dim=1)
    best = (1 << 32) - 1 - (comp & 0xFFFFFFFF)
    return mt.keys_f32((comp >> 32).int()), (best * m + torch.arange(m)).int()


def _emulate(q, rows, m, kind, valid=None, scale=None):
    c = rows.shape[0]
    return _bin_max(_scores(q, rows, kind, scale), m, c if valid is None else valid)


def _inputs(seed, b, c, d, kind):
    """Normal queries and rows (int8 rows quantized per row with their
    scale; bf16 rows rounded), made with numpy."""
    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.normal(size=(b, d)).astype(np.float32))
    rows = torch.from_numpy(r.normal(size=(c, d)).astype(np.float32))
    if kind == "int8":
        sc = rows.abs().amax(-1) / 127.0
        return q, torch.round(rows / sc[:, None]).to(torch.int8), sc
    return q, rows.to(torch.bfloat16) if kind == "bf16" else rows, None


def _dense(q, rows, scale):
    s = q.double() @ rows.double().T
    return s * scale.double()[None, :] if scale is not None else s


def _held(got, want, scores, m):
    """got's values within 1e-5 of each query's largest |score| of want's,
    and got's rows equal to want's wherever a bin's best two scores differ
    by more (scores [B, C] in f64)."""
    tol = 1e-5 * want[0].abs().amax(dim=1, keepdim=True)
    assert bool(((got[0] - want[0]).abs() <= tol).all())
    b, c = scores.shape
    w = -(-c // m)
    pad = torch.nn.functional.pad(scores, (0, w * m - c), value=float("-inf"))
    top2 = torch.topk(pad.view(b, w, m), min(2, w), dim=1).values
    margin = top2[:, 0] - top2[:, 1] if w > 1 else torch.full((b, m), float("inf"))
    clear = margin > tol.double()
    assert bool((got[1] == want[1])[clear].all())
    assert int(clear.sum()) > 0.9 * clear.numel()


_SHAPES = [(130, 20000, 64, 2048), (64, 4096, 16, 128), (100, 5000, 128, 256), (1, 300, 64, 300)]


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("b,c,d,m", _SHAPES)
def test_emulated_kernel_matches_plain(kind, b, c, d, m):
    q, rows, sc = _inputs(1, b, c, d, kind)
    got = _emulate(q, rows, m, kind, scale=sc)
    want = at.approx_scan_plain(q, rows, m, scale=sc)
    _held(got, want, _dense(q, rows.float(), sc), m)


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("b,c,d", [(130, 20000, 64), (64, 4096, 16), (100, 5000, 128)])
def test_emulated_kernel_matches_jax_where_bins_are_rows(kind, b, c, d):
    """M = C: every bin is one row, so the emulated bins' top k is the top k
    of the scores; JAX's dot at HIGHEST precision and approx_max_k (an exact
    sort on the CPU) give the same values within 1e-5 of each query's scale
    and the same indices wherever the k-th and (k+1)-th differ by more."""
    k = 100
    q, rows, sc = _inputs(2, b, c, d, kind)
    vals, bins = _emulate(q, rows, c, kind, scale=sc)
    assert torch.equal(bins, torch.arange(c, dtype=torch.int32).expand(b, c))
    got_v, got_i = torch.topk(vals, k + 1, dim=1)
    rows_j = jnp.asarray(rows.float().numpy())
    s = jnp.dot(jnp.asarray(q.numpy()), rows_j.T, precision=jax.lax.Precision.HIGHEST)
    if sc is not None:
        s = s * jnp.asarray(sc.numpy())[None, :]
    want_v, want_i = jax.lax.approx_max_k(s, k, recall_target=0.95)
    want_v, want_i = torch.from_numpy(np.array(want_v)), torch.from_numpy(np.array(want_i))
    tol = 1e-5 * want_v[:, :1].abs()
    assert bool(((got_v[:, :k] - want_v).abs() <= tol).all())
    clear = (got_v[:, k - 1] - got_v[:, k]) > 2 * tol[:, 0]
    assert int(clear.sum()) > 0.9 * b
    g = torch.sort(got_i[:, :k][clear], 1).values
    assert torch.equal(g, torch.sort(want_i[clear].long(), 1).values)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_two_products_are_exact_per_term(kind):
    """Int8 and bf16 rows are exact in TF32, and so is each term of q_hi . c
    and q_lo . c: f32 products equal the f64 ones.  Their sum q_hi c + q_lo c
    is within 2^-21 |q c| of q c, where one TF32 product is only within
    2^-11."""
    q, rows, _ = _inputs(3, 64, 512, 64, kind)
    c = rows.float()
    assert torch.equal(_tf32(c), c)
    qh, ql = _split_any(q)
    for part in (qh, ql):
        prod = part[:, None, :] * c[None, :, :]
        assert torch.equal(prod.double(), part.double()[:, None, :] * c.double()[None, :, :])
    exact = q.double()[:, None, :] * c.double()[None, :, :]
    two = (qh[:, None, :] * c[None]).double() + (ql[:, None, :] * c[None]).double()
    one = (qh[:, None, :] * c[None]).double()
    assert bool(((two - exact).abs() <= 2.0**-21 * exact.abs()).all())
    assert bool(((one - exact).abs() > 2.0**-14 * exact.abs()).any())


def test_split_any_on_inf_nan_and_overflow():
    """+-inf: hi 0, lo +-inf; NaN: NaN in both; a finite value whose TF32
    rounding overflows: hi 0, lo the largest TF32 below it; elsewhere hi + lo
    within 2^-21 |x| of x, both TF32."""
    big = float(np.finfo(np.float32).max)  # (2 - 2^-23) 2^127: TF32 rounds it up to inf
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), big, -big, 1.0 / 3, -7.5e-3])
    hi, lo = _split_any(x)
    assert hi[:2].tolist() == [0.0, 0.0] and lo[:2].tolist() == [float("inf"), float("-inf")]
    assert bool(hi[2].isnan()) and bool(lo[2].isnan())
    assert hi[3:5].tolist() == [0.0, 0.0]
    assert lo[3:5].abs().tolist() == [2.0**128 - 2.0**117] * 2
    assert bool((lo[3:5] * x[3:5] > 0).all())
    fin = x[5:]
    assert torch.equal(_tf32(hi[5:]), hi[5:]) and torch.equal(_tf32(lo[5:]), lo[5:])
    assert bool(((hi[5:] + lo[5:]).double() - fin.double()).abs().le(
        2.0**-21 * fin.double().abs()).all())


def _nonfinite_grid(seed, b, c, d):
    r = np.random.default_rng(seed)
    corpus = r.integers(-2, 3, (c, d)).astype(np.float32)
    query = r.integers(-2, 3, (b, d)).astype(np.float32)
    query[: b // 2, 0] = 0  # 0 * inf in half the queries
    corpus[np.arange(0, 30) * 64 + 5, 0] = np.inf
    corpus[np.arange(30, 40) * 64 + 7, 1] = -np.inf
    corpus.view(np.int32)[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    corpus.view(np.int32)[c - 2, 5] = 0x7FC00000
    return torch.from_numpy(query), torch.from_numpy(corpus)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_emulated_kernel_on_non_finite_rows(kind):
    """Integer grid with +-inf rows, 0 * inf and NaN of both signs: every
    finite score equal to the plain version's, +-inf and NaN in its places
    (its NaN is the CPU's, of either sign; the card's f32 sums and the
    kernel's + 0.0 give the canonical NaN); then valid_count inside."""
    q, corpus = _nonfinite_grid(4, 40, 4000, 16)
    rows = corpus.to(torch.bfloat16) if kind == "bf16" else corpus
    got = _scores(q, rows, kind)
    want = q @ rows.float().T
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])
    assert bool((got[got.isnan()].view(torch.int32) == _CANONICAL_NAN).all())
    got_v, got_r = _bin_max(got, 256, 3000)
    want_v, want_r = at.approx_scan_plain(q, rows, 256, 3000)
    same = ~want_v.isnan() & ~got_v.isnan()
    assert torch.equal(got_v[same], want_v[same]) and torch.equal(got_r[same], want_r[same])


def test_bf16_lo_product_needs_finite_rows():
    """Why the bf16 instance zeroes non-finite rows for the lo product: an
    integer query has q_lo = 0, so q_lo . inf would be NaN where f32 gives
    +-inf."""
    q, corpus = _nonfinite_grid(5, 8, 4000, 16)
    q[:, 0] = 1.0
    rows = corpus.to(torch.bfloat16)
    qh, ql = _split_any(q)
    naive = ql @ rows.float().T + qh @ rows.float().T
    want = q @ rows.float().T
    assert bool(want.isinf().any()) and bool(naive.isnan()[want.isinf()].all())
    got = _scores(q, rows, "bf16")
    assert torch.equal(got[want.isinf()], want[want.isinf()])


@pytest.mark.parametrize("d", [4, 8, 12, 16, 20, 24, 64, 96, 120, 128, 132])
def test_route_for_each_width_and_row_kind(d):
    """D % 8 == 0 (int8: D % 16 == 0) and D <= 128 take the tensor cores,
    the rest the FMA kernel, whose own limits (f32 D % 4 == 0, int8 D % 16
    == 0, D <= 128) approx_scan checks; every tensor-core plan fits the
    block's shared memory, with two consumer warpgroups where B > 64 and two
    row tiles and two raw stages fit."""
    for kind in at.ROW_KINDS:
        step = 16 if kind == "int8" else 8
        want = "tc" if d <= at.MAX_D and d % step == 0 else "fma"
        assert at.scan_route(d, kind) == want
        if want == "tc":
            for b in (1, 64, 65, 1024):
                nwg, tiles, stages, smem = at.tc_plan(b, d, kind)
                assert smem == at._tc_smem(d, kind, nwg, tiles, stages) <= at.SMEM_LIMIT
                assert 2 <= tiles <= 3 and 1 <= stages <= 4
                assert nwg == 1 or b > 64
                if nwg == 1 and b > 64:
                    assert at._tc_smem(d, kind, 2, 2, 2) > at.SMEM_LIMIT
    if d == 64:  # the cells' width: two consumer warpgroups, three row tiles, four stages
        assert [at.tc_plan(1024, 64, k)[:3] for k in at.ROW_KINDS] == [(2, 3, 4)] * 3
        assert at.scan_smem_bytes(64, "f32", "tc") == 229456
        assert at.scan_smem_bytes(64, "f32", "fma") == 51200
        assert at.scan_smem_bytes(64, "int8", "fma") == 41984


def test_approx_scan_on_the_cpu_takes_plain_for_either_route():
    """A CPU tensor takes the plain version whatever ``force`` says; bf16
    rows score as their f32 widening."""
    q, rows, _ = _inputs(6, 9, 700, 16, "bf16")
    want = at.approx_scan_plain(q, rows.float(), 128)
    for force in (None, "tc", "fma"):
        got = at.approx_scan(q, rows, 128, force=force)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
