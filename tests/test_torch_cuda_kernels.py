"""PyTorch port: the CUDA kernels against their plain PyTorch versions on
the card, at shapes the main paths do not reach (ragged corpora, padded
rows, odd batches, other encoder widths, hierarchical selects, D = 65, 640
and 1024 and C != B for the CE kernels, NaN rows, rows with a +inf score
or only -inf scores), and the encoder's autograd route.

Needs an NVIDIA GPU with ``nvcc``; skips elsewhere.  It imports neither JAX
nor the JAX package, so on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: tile-max and rescore scores are f32 sums in another order than
cuBLAS's (rtol 1e-5); the CE kernels the same, relative to each output's
largest magnitude (or to one g p x term, where the exact gradient may be
0), the forward (3xTF32 on the tensor cores) also within 1e-5 of max |lse|
of a logsumexp over f64 scores at the flagship step's shape, and both
bit-equal on a repeated call (no float atomics); the encoder forward (B1), the
residual forward's output and stored residuals (B5) and the length-masked
stack (B8) at 1e-4 in f32; in bf16 the FMA kernel, which sums in the plain
version's order, within one bf16 step of each value, and the tensor-core
kernel, which sums in its own order, as B13's: every value within 1e-2 of
scale and bit-equal on repeat, and on a batch of 2^20 values of row 0 or
more (the counts come in clumps) at most 0.5% of values beyond one step
and no more values beyond one step from the same function with f64 sums
than 1.5 times the plain version's (or 1e-6 of the values, where both are
that rare); the encoder backward at 1e-4 (f32) and 3e-2 (bf16)
of each output's largest magnitude, since a bf16 rounding point that flips
by one ulp between two sum orders carries into the sums over the batch;
selections exactly.  The stack's backward (B9) and the recompute encoder
backward (B7) as the encoder backward (B6), each on the tensor cores also
against the same function with f64 sums over ten seeds.  On infinite
scores the CE kernels' NaNs and infinities in the plain version's places.  The row scatter-add (B18) at 1e-5 (f32 sums in another order),
and exactly on sums of ones; the in-place row write (B19) exactly.  The
blockwise forward (B15) on both its kernels (the tensor cores' 3xTF32 and
the FMA kernel) at rtol 1e-4, atol 1e-5 (1e-3, 1e-4 at 30 sigma),
bit-equal on repeat, and with NaN in q or k NaN where the plain version
has it; B15-B17 on inputs at an address that is not 16-byte aligned bit
for bit as on aligned ones.  The blockwise backward (B16, B17) on both
its kernels (the tensor cores' 3xTF32 and the FMA kernels) within 1e-4 of
each grad's scale of the plain backward (1e-3 at 30 sigma), at N = 1024,
H = 4096 on the first four leading indices, bit-equal on repeat, masked
keys' dk and dv exactly 0, NaN where the plain version has it.  The
approximate bin-max scan (N1) on f32 and int8 rows bit for bit on integer
grids (non-finite rows and valid_count included), within 1e-5 of scale on
normal rows with equal rows wherever a bin's best two differ by more, and
the approximate top-k through it equal to the CPU's.
"""

import math

import numpy as np
import pytest
import torch

from two_tower_models_tpu_torch.config import HistoryEncoderConfig
from two_tower_models_tpu_torch.models import history_encoder as he
from two_tower_models_tpu_torch.ops import _lib
from two_tower_models_tpu_torch.ops import approx_topk as at
from two_tower_models_tpu_torch.ops import fused_encoder as fe
from two_tower_models_tpu_torch.ops import fused_mha as fm
from two_tower_models_tpu_torch.ops import fused_softmax as fs
from two_tower_models_tpu_torch.ops import history_attention as ha
from two_tower_models_tpu_torch.ops import mips_topk as mt
from two_tower_models_tpu_torch.ops import rows_write as rw
from two_tower_models_tpu_torch.ops import scatter_add as rsa
from two_tower_models_tpu_torch.retrieval.mips import mips_topk

pytestmark = pytest.mark.cuda

_INT_MIN = -(1 << 31)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape, dev):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(dev)


def _grid(seed, *shape, dev):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-2, 3, size=shape).astype(np.float32)).to(dev)


def _assert_close(got, want, rtol, atol=0.0):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=rtol, atol=atol)


# The cells' shapes (B = 1024 serving, 4096 training; H = 32, D = 64, four
# heads, three layers); B at the edges of a tile of four examples (1, 3, 5)
# and not a multiple of it (1000, 37); H = 10 and 16 (Hp = 16, eight
# examples a tile), 40 (Hp = 48, two), 64 (one a tile of 64 rows); one
# layer (the thin one alone); one head (head width 64).  In bf16 these take
# the tensor-core kernel, but D = 32 with four heads (head width 8), which
# takes the FMA kernel.
_ENC_FWD_SHAPES = [
    (1000, 32, 64, 4, 3), (37, 10, 64, 2, 1), (64, 8, 32, 4, 2), (9, 40, 64, 4, 2),
    (1024, 32, 64, 4, 3), (4096, 32, 64, 4, 3), (1, 32, 64, 4, 3), (3, 32, 64, 4, 3),
    (5, 32, 64, 4, 3), (3, 40, 64, 4, 3), (7, 64, 64, 4, 2), (33, 16, 64, 1, 2),
]


def _enc_tc(dtype, h, d, nh, nl):
    """Whether the encoder's forward takes the tensor cores (asserting that
    ``_enc_route`` agrees): bf16, D a multiple of 32, head width of 16k, H
    <= 64 (every shape of these tests fits shared memory)."""
    tc = dtype == torch.bfloat16 and d % 32 == 0 and (d // nh) % 16 == 0 and h <= 64
    assert (fe._enc_route(dtype, h, d, nh, nl) == "tc") == tc
    return tc


def _fma_forward(name, x, side, w, nh):
    """Forward kernel ``name`` forced onto the FMA kernel (``encoder_kernel``)."""
    return fe._launch_fwd_fma(name, x.contiguous(), side, *(fe._f32(t, x.device) for t in w), nh)


def _far(a, b):
    """Values of two bf16 tensors more than one bf16 step apart."""
    return int((_bf16_steps(a, b) > 1).sum())


def _hold_tc(got, again, want):
    """A bf16 output of a tensor-core encoder kernel at the test's batch:
    every value within 1e-2 of scale of the plain version's; bit-equal on
    repeat."""
    assert torch.equal(got, again)
    _scaled_close(got, want, 1e-2)


def _hold_tc_big(got, plain, ref):
    """A bf16 output of a tensor-core encoder kernel on a batch of 2^20
    values of row 0 or more, where the counts below are more than a few
    clumps (one flipped rounding moves a row): at most 0.5% of its values
    beyond one bf16 step from the plain version's, and against the same
    function with f64 sums no more values beyond one step than 1.5 times
    the plain version's, or 1e-6 of the values where both are that rare
    (ps and p0: 0-11 of 10^8 values on an H100)."""
    assert float((_bf16_steps(got, plain) > 1).float().mean()) <= 5e-3
    far = [_far(t, ref) for t in (got, plain)]
    assert far[0] <= max(1.5 * far[1], 1e-6 * got.numel()), far


def _big(b, d):
    """The batch on which the f64-sum counts are taken: at least 2^20 values
    of row 0 [B, D], at least B examples."""
    return max(b, (1 << 20) // d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC_FWD_SHAPES)
def test_encoder_kernel_matches_plain(dev, dtype, b, h, d, nh, nl):
    """B1 against its plain version.  The FMA kernel, launched at every
    shape through its launcher, within one bf16 step; ``fused_history_encoder``
    on the route ``_enc_route`` gives (asserted, and counted as
    ``fused_history_encoder_tc`` on the tensor cores), 1e-4 in f32 and in
    bf16 held as ``_hold_tc`` and ``_hold_tc_big`` say."""
    x, w, _ = _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed=b + h)
    tc = _enc_tc(dtype, h, d, nh, nl)
    before = dict(_lib.launches)
    got = fe.fused_history_encoder(x, *w, nh)
    assert _lib.launches["fused_history_encoder"] == before.get("fused_history_encoder", 0) + 1
    assert _lib.launches["fused_history_encoder_tc"] == before.get("fused_history_encoder_tc", 0) + tc
    want = fe.fused_history_encoder_plain(x, *w, nh)
    assert got.dtype == dtype and got.shape == (b, 2, d)
    fma = _fma_forward("fused_history_encoder", x, fe._pe(w[0], x), w[1:], nh)
    if dtype == torch.float32:
        _assert_close(got, want, 1e-4, 1e-4)
        _assert_close(fma, want, 1e-4, 1e-4)
        return
    assert _bf16_ulps(fma, want) <= 1
    if not tc:
        assert torch.equal(got, fma)
        return
    _hold_tc(got, fe.fused_history_encoder(x, *w, nh), want)
    x, w, _ = _encoder_inputs(_big(b, d), h, d, nh, nl, dtype, dev, seed=b + h)
    _hold_tc_big(fe.fused_history_encoder(x, *w, nh), fe.fused_history_encoder_plain(x, *w, nh),
                 fe.fused_history_encoder_f64_sums(x, *w, nh))


def test_encoder_tc_kernel_at_unaligned_addresses(dev):
    """x and the weights at addresses that are not 16-byte aligned give the
    tensor-core kernel's y bit for bit (the wrapper copies them)."""
    x, w, _ = _encoder_inputs(9, 32, 64, 4, 3, torch.bfloat16, dev, seed=11)

    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    xo, wio, woo = odd(x), odd(w[1]), odd(w[3])
    assert all(t.data_ptr() % 16 for t in (xo, wio, woo))
    want = fe.fused_history_encoder(x, *w, 4)
    assert torch.equal(fe.fused_history_encoder(xo, w[0], wio, w[2], woo, w[4], 4), want)


# B = 1 and B off a block's 256 (or, at D = 200, 128) queries; C off a
# block's run of tiles with valid inside a tile; D from 16 to 200 (D = 200
# takes the 8-query instance)
@pytest.mark.parametrize(
    "b,c,d,valid", [(1, 4096, 64, 4096), (130, 4000, 32, 4000), (300, 4096, 16, 3000), (257, 8192, 100, 8100),
                    (1, 20000, 200, 19990), (513, 20000, 64, 19990), (100, 10000, 128, 9999),
                    (77, 6000, 200, 5950), (1000, 70000, 32, 69950), (260, 33000, 16, 32900)]
)
def test_tile_max_matches_plain_and_rescore_bitwise(dev, b, c, d, valid):
    """Tile maxes against the plain version, and, bit for bit, against the
    max of the rescore kernel's scores over the same tile: the equality the
    exact pipeline's pruning relies on."""
    q, corpus = _randn(1, b, d, dev=dev), _randn(2, c, d, dev=dev)
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    nt = -(-c // mt.TILE)
    assert m.shape == (b, nt)
    _assert_close(m, mt.tile_max_scores_plain(q, corpus, mt.TILE, valid), 1e-5, 1e-5)
    all_tiles = torch.arange(nt, device=dev, dtype=torch.int32).expand(b, nt).contiguous()
    cand = mt.gather_rescore(q, corpus, all_tiles, mt.TILE)
    rows = torch.arange(nt * mt.TILE, device=dev)
    cand = cand.masked_fill(rows >= valid, float("-inf"))
    assert torch.equal(cand.view(b, nt, mt.TILE).amax(-1), m)


def test_tile_max_propagates_nan_like_plain(dev):
    """A NaN corpus row makes its tile's max NaN for every query, as the
    plain amax does; a NaN row at or past valid_count is masked to -inf."""
    b, c, d, valid = 130, 4096, 64, 3000
    q, corpus = _randn(12, b, d, dev=dev), _randn(13, c, d, dev=dev)
    corpus[5, 7] = float("nan")  # tile 0
    corpus[1000, :] = float("nan")  # tile 7
    corpus[3500, 0] = float("nan")  # padding, tile 27
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    want = mt.tile_max_scores_plain(q, corpus, mt.TILE, valid)
    assert torch.equal(m.isnan(), want.isnan())
    assert bool(m[:, 0].isnan().all()) and bool(m[:, 7].isnan().all())
    assert not bool(m[:, 27].isnan().any())
    _assert_close(m.nan_to_num(0.0), want.nan_to_num(0.0), 1e-5, 1e-5)


@pytest.mark.parametrize("b,c,d,k", [(16, 4000, 64, 7), (130, 8192, 32, 100)])
def test_gather_rescore_matches_plain(dev, b, c, d, k):
    """Includes the ragged last tile, whose missing rows score as zeros."""
    q, corpus = _randn(3, b, d, dev=dev), _randn(4, c, d, dev=dev)
    nt = -(-c // mt.TILE)
    tidx = torch.from_numpy(np.random.default_rng(5).integers(0, nt, size=(b, k)).astype(np.int32)).to(dev)
    tidx[0, 0] = nt - 1
    got = mt.gather_rescore(q, corpus, tidx, mt.TILE)
    _assert_close(got, mt.gather_rescore_plain(q, corpus, tidx, mt.TILE), 1e-5, 1e-5)


# B = 1 and 300, k = 1 and 100, D from 16 to 200, the ragged last tile; on
# integer-grid inputs, whose sums are exact in any order
@pytest.mark.parametrize("b,c,d,k", [(16, 4000, 64, 7), (1, 4000, 16, 1), (300, 20000, 100, 1),
                                     (77, 5000, 128, 40), (64, 6000, 200, 33), (1, 20000, 64, 100)])
def test_gather_rescore_shapes_match_plain_exactly(dev, b, c, d, k):
    q, corpus = _grid(18, b, d, dev=dev), _grid(19, c, d, dev=dev)
    nt = -(-c // mt.TILE)
    tidx = torch.from_numpy(np.random.default_rng(5).integers(0, nt, size=(b, k)).astype(np.int32)).to(dev)
    tidx[0, 0] = nt - 1
    got = mt.gather_rescore(q, corpus, tidx, mt.TILE)
    assert torch.equal(got, mt.gather_rescore_plain(q, corpus, tidx, mt.TILE))


def test_mips_kernels_at_unaligned_addresses(dev):
    """Query and corpus copies at addresses 16-byte aligned no more (the
    kernels read 16 bytes at a time): the same bits as aligned ones."""
    b, c, d, k = 33, 5000, 64, 9
    q, corpus = _randn(20, b, d, dev=dev), _randn(21, c, d, dev=dev)

    def odd(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    qo, co = odd(q), odd(corpus)
    assert qo.data_ptr() % 16 and co.data_ptr() % 16
    tidx = _rescore_selection("twice", b, k, -(-c // mt.TILE), dev)
    assert torch.equal(mt.tile_max_scores(qo, co, mt.TILE, c - 3), mt.tile_max_scores(q, corpus, mt.TILE, c - 3))
    assert torch.equal(mt.gather_rescore(qo, co, tidx, mt.TILE), mt.gather_rescore(q, corpus, tidx, mt.TILE))


def _rescore_selection(case, b, k, nt, dev):
    r = np.random.default_rng(15)
    t = r.integers(0, nt, size=(b, k))
    if case == "twice":  # a row that selects one tile twice (and the ragged tile)
        t[:, 1] = t[:, 0]
        t[0, 2:4] = nt - 1
    elif case == "one-tile":  # every query on one tile
        t[:] = nt // 3
    elif case == "skewed":  # every query on the same k tiles, sorted as the pipeline does
        t[:] = np.sort(r.choice(nt, k, replace=False))
    elif case == "outside":  # indices past the last tile and negative: zero rows
        t[:, 0], t[:, -1] = nt + 5, -1
    return torch.from_numpy(t.astype(np.int32)).to(dev)


@pytest.mark.parametrize("case", ["twice", "one-tile", "skewed", "outside"])
@pytest.mark.parametrize("b,c,d,k", [(130, 20000, 64, 100), (33, 4000, 200, 5), (1, 3000, 32, 7)])
def test_gather_rescore_selections_match_plain(dev, case, b, c, d, k):
    """The inverted selection's edge cases: a tile twice in a row, one tile
    for every query (one list of B * k pairs, many work items), the
    skewed selection, and tile indices outside the corpus; integer-grid
    inputs, exact."""
    q, corpus = _grid(16, b, d, dev=dev), _grid(17, c, d, dev=dev)
    tidx = _rescore_selection(case, b, k, -(-c // mt.TILE), dev)
    got = mt.gather_rescore(q, corpus, tidx, mt.TILE)
    assert torch.equal(got, mt.gather_rescore_plain(q, corpus, tidx, mt.TILE))


@pytest.mark.parametrize("case", ["twice", "one-tile", "skewed", "outside"])
def test_invert_selection_matches_plain(dev, case):
    """The card's inverted selection equals the plain version's: counts,
    offsets, work items and their count exactly, each list's pairs as a set
    (their order inside a list is the atomics')."""
    b, k, nt = 300, 100, 8192 // 16
    tidx = _rescore_selection(case, b, k, nt, dev)
    got = mt.rescore_scratch_views(mt.invert_selection(tidx, nt).cpu(), b, k, nt)
    want = mt.rescore_scratch_views(mt.invert_selection_plain(tidx.cpu(), nt), b, k, nt)
    n_items = int(want["n_items"][0])
    for name in ("n_items", "counts", "offsets"):
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got["items"][:n_items], want["items"][:n_items])
    flat = tidx.cpu().reshape(-1).long()
    bucket = torch.where((flat >= 0) & (flat < nt), flat, nt)
    key = lambda p: bucket[p.long()] * (b * k) + p.long()
    assert torch.equal(torch.sort(key(got["pairs"])).values, key(want["pairs"]))


def _select_cases(dev):
    """{case: (rows, k)}: f32 scores, or int32 keys."""
    r = np.random.default_rng(6)
    ties = np.round(r.normal(size=(33, 8192)) * 4) / 4
    ties[0] = 0.0
    zeros = np.round(r.normal(size=(8, 300)) * 2) / 2 * 0.0  # +0.0 and -0.0 only
    nan = r.normal(size=(8, 64)).astype(np.float32)
    nan[:, 40:] = np.uint32(0xFFFFFFFF).view(np.float32)
    nan[:, 10] = np.inf
    nan[:, 11] = np.float32(np.nan)
    big = r.normal(size=(4, 12800))
    ints = r.integers(-4, 4, size=(5, 3000)).astype(np.int32)  # INT_MIN pads, INT_MAX
    ints[:, ::5], ints[:, 3], ints[1, 100:], ints[2] = _INT_MIN, (1 << 31) - 1, _INT_MIN, _INT_MIN
    straddle = np.zeros((3, 8192), np.float32)  # the k-th key's ties taken over 14 warps' runs
    straddle[:, ::31] = 0.5
    straddle[:, ::97] = 1.0
    straddle[1, 4000] = 2.0
    return {
        "ties": (ties, 100), "signed-zeros": (zeros, 250), "nan": (nan, 30),
        "pool": (big, 100), "k1": (big, 1), "k-equals-n": (nan, 64),
        "all-equal": (np.full((3, 5000), 0.5, np.float32), 100),
        "k-max": (big[:, :4096], mt.K_MAX), "k-max+1": (big[:, :4096], mt.K_MAX + 1),
        "int-extremes": (ints, 200), "n1": (np.array([[1.0], [np.nan], [-0.0]], np.float32), 1),
        "ragged": (np.round(r.normal(size=(7, 1001)) * 3) / 3, 37),
        "ties-straddle-warps": (straddle, 300),
    }


def _select_input(x, dev):
    x = np.ascontiguousarray(x if x.dtype == np.int32 else x.astype(np.float32))
    t = torch.from_numpy(x).to(dev)
    keys = t if x.dtype == np.int32 else mt.f32_keys(t).clamp_min(_INT_MIN + 1)
    return t, x.dtype != np.int32, keys


_SELECT_CASES = ["ties", "signed-zeros", "nan", "pool", "k1", "k-equals-n", "all-equal", "k-max",
                 "int-extremes", "n1", "ragged", "ties-straddle-warps"]


# the radix kernel up to K_MAX, the tournament at every k
@pytest.mark.parametrize("case,route", [(c, r) for r in ("radix", "tournament")
                                        for c in _SELECT_CASES + ["k-max+1"] * (r == "tournament")])
def test_select_routes_match_plain_exactly(dev, case, route):
    """Each select kernel, launched alone: keys and positions equal
    select_keys_plain's, one launch of its own counter."""
    x, k = _select_cases(dev)[case]
    t, is_f32, keys = _select_input(x, dev)
    name = "select_topk_radix" if route == "radix" else "select_topk"
    before = dict(_lib.launches)
    gk, gp = mt._launch_select(t, k, is_f32, route)
    assert _lib.launches[name] == before.get(name, 0) + 1
    wk, wp = mt.select_keys_plain(keys, k)
    assert torch.equal(gk, wk) and torch.equal(gp, wp)


@pytest.mark.parametrize("case", ["ties", "signed-zeros", "nan", "pool", "k1", "k-equals-n"])
def test_select_matches_plain_exactly(dev, case):
    """select_rows (the radix route at these k) and select_topk_t."""
    x, k = _select_cases(dev)[case]
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    before = dict(_lib.launches)
    keys, pos = mt.select_rows(xt, k)
    assert _lib.launches["select_topk_radix"] == before.get("select_topk_radix", 0) + 1
    assert _lib.launches["select_topk"] == before.get("select_topk", 0)
    wk, wp = mt.select_keys_plain(mt.f32_keys(xt).clamp_min(_INT_MIN + 1), k)
    assert torch.equal(keys, wk) and torch.equal(pos, wp)
    vt, it = mt.select_topk_t(xt.T.contiguous(), k)
    assert torch.equal(it.T, pos) and torch.equal(mt.f32_keys(vt.T), keys)


@pytest.mark.parametrize("k,route", [(mt.K_MAX, "radix"), (mt.K_MAX + 1, "tournament")])
def test_select_rows_takes_the_route_of_k(dev, k, route):
    x, _ = _select_cases(dev)["k-max"]
    t, _, keys = _select_input(x, dev)
    before = dict(_lib.launches)
    gk, gp = mt.select_rows(t, k)
    for name, r in (("select_topk_radix", "radix"), ("select_topk", "tournament")):
        assert _lib.launches[name] == before.get(name, 0) + (r == route)
    wk, wp = mt.select_keys_plain(keys, k)
    assert torch.equal(gk, wk) and torch.equal(gp, wp)


def test_select_hierarchical_matches_plain(dev):
    """Rows longer than the kernel's shared memory (2^17 > 56k keys) split
    into chunks and merge; ties span the chunk seams."""
    x = torch.from_numpy(np.round(np.random.default_rng(7).normal(size=(3, 1 << 17)) * 8).astype(np.float32) / 8).to(dev)
    before = dict(_lib.launches)
    keys, pos = mt.select_rows(x, 100)
    # three chunks and the merge, each on the radix route
    assert _lib.launches["select_topk_radix"] == before.get("select_topk_radix", 0) + 4
    assert _lib.launches["select_topk"] == before.get("select_topk", 0)
    wk, wp = mt.select_keys_plain(mt.f32_keys(x).clamp_min(_INT_MIN + 1), 100)
    assert torch.equal(keys, wk) and torch.equal(pos, wp)


@pytest.mark.parametrize("b,c,d,k,valid", [(300, 20000, 16, 100, None), (64, 65536, 64, 10, 60000)])
def test_pipeline_matches_dense_exactly(dev, b, c, d, k, valid):
    """Integer-grid embeddings: exact scores, constant ties; indices, tie
    order and scores equal the dense scan's."""
    corpus, q = _grid(8, c, d, dev=dev), _grid(9, b, d, dev=dev)
    before = dict(_lib.launches)
    idx, sc, emb = mt.mips_topk_exact_tiled(corpus, q, k, valid_count=valid)
    for name, n in (("tile_max_scores", 1), ("select_topk_radix", 2), ("select_topk", 0),
                    ("gather_rescore_invert", 1), ("gather_rescore", 1)):
        assert _lib.launches[name] == before.get(name, 0) + n
    ridx, rsc, remb = mips_topk(corpus, q, k, valid_count=valid)
    assert torch.equal(idx, ridx) and torch.equal(sc, rsc) and torch.equal(emb, remb)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, corpus = _randn(10, 4, 64, dev=dev), _randn(11, 1024, 64, dev=dev)
    with pytest.raises(TypeError):
        mt.tile_max_scores(q.half(), corpus.half(), mt.TILE, 1024)
    with pytest.raises(ValueError):
        mt.tile_max_scores(q, corpus, 64, 1024)
    with pytest.raises(ValueError):
        mt.gather_rescore(q, corpus.cpu(), torch.zeros(4, 2, dtype=torch.int32, device=dev), mt.TILE)
    with pytest.raises(ValueError):
        mt.select_rows(q, 65)
    with pytest.raises(TypeError):
        fe.fused_history_encoder(
            torch.zeros(2, 4, 64, dtype=torch.float16, device=dev),
            torch.zeros(4, 64, device=dev), torch.zeros(1, 64, 192, device=dev),
            torch.zeros(1, 192, device=dev), torch.zeros(1, 64, 64, device=dev),
            torch.zeros(1, 64, device=dev), 4,
        )


def _scaled_close(got, want, tol, floor=1e-30):
    """|got - want| <= tol * max(max|want|, floor), NaN where want is NaN.
    ``floor`` is the size of one term of a sum whose exact value may be 0."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    torch.testing.assert_close(got[fin], want[fin], rtol=0.0, atol=tol * max(scale, floor))


def _term(g, x):
    """The size of one g_b * p_bj * x_j term of a CE gradient (p <= 1)."""
    return float(g.abs().max() * x[~x.isnan()].abs().max())


_CE_SHAPES = [(1, 1, 64, True), (100, 100, 64, True), (4096, 4096, 64, True),
              (300, 1000, 65, False), (77, 130, 65, False), (50, 20, 7, False),
              (33, 33, 640, True), (8, 40, 1024, False), (4096, 4160, 65, False)]


@pytest.mark.parametrize("b,c,d,diag", _CE_SHAPES)
def test_ce_kernels_match_plain(dev, b, c, d, diag):
    """B10, and B11 with B12 in one backward pass plus its reduce: B not a
    multiple of the 128-row tile, C != B with D = 65 (the logQ route's
    width, two output slices; at (4096, 4160, 65) the mixed-negative step's
    own: B = 4096 rows, 64 negatives, one appended column), B = 1, D = 7,
    and D = 640 and 1024 (ten and sixteen staged d chunks in B10)."""
    u, i = _randn(20, b, d, dev=dev) * 0.3, _randn(21, c, d, dev=dev) * 0.3
    g = _randn(22, b, dev=dev)
    before = dict(_lib.launches)
    ce, lse = fs.in_batch_ce_fwd(u, i, diag)
    du, di = fs.in_batch_ce_bwd(u, i, lse, g, diag)
    for name in ("fused_in_batch_ce", "in_batch_ce_bwd", "in_batch_ce_bwd_reduce"):
        assert _lib.launches[name] == before.get(name, 0) + 1
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, i, diag)
    _scaled_close(ce, ce_p, 1e-5)
    _scaled_close(lse, lse_p, 1e-5)
    du_p, di_p = fs.in_batch_ce_bwd_plain(u, i, lse_p, g, diag)
    _scaled_close(du, du_p, 1e-5, _term(g, i))
    _scaled_close(di, di_p, 1e-5, _term(g, u))


@pytest.mark.parametrize("b,c,d,diag", _CE_SHAPES)
def test_ce_bwd_bit_equal_on_repeat_and_alone(dev, b, c, d, diag):
    """No atomics: a repeated call gives the same bits.  dU or dI asked for
    alone (one launch and one reduce each) equals the combined call's."""
    u, i = _randn(40, b, d, dev=dev) * 0.3, _randn(41, c, d, dev=dev) * 0.3
    g = _randn(42, b, dev=dev)
    _, lse = fs.in_batch_ce_fwd(u, i, diag)
    du, di = fs.in_batch_ce_bwd(u, i, lse, g, diag)
    du2, di2 = fs.in_batch_ce_bwd(u, i, lse, g, diag)
    assert torch.equal(du, du2) and torch.equal(di, di2)
    for want_du in (True, False):
        before = dict(_lib.launches)
        got = fs.in_batch_ce_bwd(u, i, lse, g, diag, want_du, not want_du)
        for name in ("in_batch_ce_bwd", "in_batch_ce_bwd_reduce"):
            assert _lib.launches[name] == before.get(name, 0) + 1
        assert (got[1] is None) if want_du else (got[0] is None)
        assert torch.equal(got[0], du) if want_du else torch.equal(got[1], di)


@pytest.mark.parametrize("b,c,d,diag", _CE_SHAPES)
def test_ce_fwd_bit_equal_on_repeat(dev, b, c, d, diag):
    """B10 merges its column splits' partials in split order, whichever
    block finishes last: a repeated call gives the same bits."""
    u, i = _randn(43, b, d, dev=dev) * 0.3, _randn(44, c, d, dev=dev) * 0.3
    ce, lse = fs.in_batch_ce_fwd(u, i, diag)
    ce2, lse2 = fs.in_batch_ce_fwd(u, i, diag)
    assert torch.equal(ce, ce2) and torch.equal(lse, lse2)


def test_ce_fwd_at_the_cell_from_f64_sums(dev):
    """B10 at the flagship step's shape (B = C = 4096, D = 64, normal inputs
    at scales 0.3 and 1): lse and ce within 1e-5 of max |lse| of a
    logsumexp over f64 scores (3xTF32: a single TF32 product is 1e-5 to
    1e-4 off), beside the plain version's error."""
    for seed, scale in ((45, 0.3), (46, 1.0)):
        u, i = _randn(seed, 4096, 64, dev=dev) * scale, _randn(seed + 10, 4096, 64, dev=dev) * scale
        s64 = u.double() @ i.double().T
        lse64 = torch.logsumexp(s64, 1)
        ce64 = lse64 - torch.diagonal(s64)
        top = float(lse64.abs().max())
        ce, lse = fs.in_batch_ce_fwd(u, i)
        ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, i)
        err = lambda got, want: float((got.double() - want).abs().max()) / top
        print(f"B10 from f64 sums at scale {scale}: lse {err(lse, lse64):.3g} ce {err(ce, ce64):.3g}; "
              f"plain lse {err(lse_p, lse64):.3g} ce {err(ce_p, ce64):.3g} (of max |lse| {top:.4f})")
        assert err(lse, lse64) <= 1e-5 and err(ce, ce64) <= 1e-5


def test_ce_fwd_at_unaligned_addresses(dev):
    """U and I at addresses 16-byte aligned no more (the kernel stages 16
    bytes at a time, the wrapper copies such inputs): the same bits as
    aligned ones, with and without the diagonal."""
    b, d = 300, 64
    u, i = _randn(47, b, d, dev=dev) * 0.3, _randn(48, b, d, dev=dev) * 0.3

    def odd(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    uo, io = odd(u), odd(i)
    assert uo.data_ptr() % 16 and io.data_ptr() % 16
    for diag in (True, False):
        got, want = fs.in_batch_ce_fwd(uo, io, diag), fs.in_batch_ce_fwd(u, i, diag)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_ce_kernels_at_the_logq_width_unaligned(dev):
    """The mixed-negative step's operands, [u, 1] and [pool, -logq] at B =
    4096, C = 4160, D = 65 (row starts every 260 bytes, one in four 16-byte
    aligned), also at base addresses 16-byte aligned no more: the forward
    and both gradients the same bits as on aligned copies, and within 1e-5
    of scale of the plain versions."""
    b, c = 4096, 4160
    u = torch.cat([_randn(60, b, 64, dev=dev) * 0.3, torch.ones(b, 1, device=dev)], 1)
    logq = torch.log(torch.rand(c, generator=torch.Generator(device=dev).manual_seed(61),
                                device=dev) * 0.01 + 1e-5)
    pool = torch.cat([_randn(62, c, 64, dev=dev) * 0.3, -logq[:, None]], 1)
    g = _randn(63, b, dev=dev).abs() / b

    def odd(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    uo, po = odd(u), odd(pool)
    assert uo.data_ptr() % 16 and po.data_ptr() % 16
    ce, lse = fs.in_batch_ce_fwd(u, pool, False)
    assert all(torch.equal(x, y) for x, y in zip(fs.in_batch_ce_fwd(uo, po, False), (ce, lse)))
    du, di = fs.in_batch_ce_bwd(u, pool, lse, g, False)
    du_o, di_o = fs.in_batch_ce_bwd(uo, po, lse, g, False)
    assert torch.equal(du, du_o) and torch.equal(di, di_o)
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, pool, False)
    _scaled_close(lse, lse_p, 1e-5)
    du_p, di_p = fs.in_batch_ce_bwd_plain(u, pool, lse_p, g, False)
    _scaled_close(du, du_p, 1e-5, _term(g, pool))
    _scaled_close(di, di_p, 1e-5, _term(g, u))


def test_ce_kernels_propagate_nan_like_plain(dev):
    """A NaN row of U: its ce and lse are NaN, its dU row is NaN and, since
    every column sees that row, so is all of dI; other rows stay finite."""
    b, d = 200, 64
    u, i = _randn(23, b, d, dev=dev), _randn(24, b, d, dev=dev)
    u[17] = float("nan")
    g = _randn(25, b, dev=dev)
    ce, lse = fs.in_batch_ce_fwd(u, i)
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, i)
    _scaled_close(ce, ce_p, 1e-5)
    _scaled_close(lse, lse_p, 1e-5)
    assert bool(ce[17].isnan()) and int(ce.isnan().sum()) == 1
    du, di = fs.in_batch_ce_bwd(u, i, lse, g)
    du_p, di_p = fs.in_batch_ce_bwd_plain(u, i, lse_p, g)
    _scaled_close(du, du_p, 1e-5, _term(g, i))
    _scaled_close(di, di_p, 1e-5, _term(g, u))
    assert int(du.isnan().any(1).sum()) == 1 and bool(di.isnan().all())


def _infinite_ce_inputs(case, b, c, d, dev):
    """U, I normal at scale 0.3 (``_randn``) with rows of U whose scores are
    not all finite, each the same in every sum order (as
    tests/test_torch_ce_forward.py:_infinite_inputs makes them): "overflow"
    row 5 has u = 1e38 at d = 0, where I is 4 + |n| in the third 64-column
    tile, so its scores are +inf there and finite (up to about 1e38)
    elsewhere; "inf" row 6 has u = +inf at d = 0 (scores +-inf by the sign
    of I's d 0); "neg-overflow" row 7 has u = -1e38 at d = 1, where every
    row of I is 4 + |n| (all scores -inf); "neg-inf" row 8 has u = -inf at
    d = 2, where I is 4 + |n| too; "all" has the four rows; "inf-item" has
    I = +inf at row 150, d = 3 instead (column 150's scores +-inf by the
    sign of U's d 3, so every row whose u there is positive has a +inf
    score)."""
    u, i = _randn(60, b, d, dev=dev) * 0.3, _randn(61, c, d, dev=dev) * 0.3
    pos = lambda seed, n: 4 + _randn(seed, n, dev=dev).abs()
    i[128:192, 0] = pos(62, len(i[128:192]))
    i[:, 1], i[:, 2] = pos(63, c), pos(64, c)
    rows = {"overflow": (5, 0, 1e38), "inf": (6, 0, math.inf), "neg-overflow": (7, 1, -1e38),
            "neg-inf": (8, 2, -math.inf)}
    for name, (r, k, v) in rows.items():
        if case in (name, "all"):
            u[r, k] = v
    if case == "inf-item":
        i[150, 3] = math.inf
    return u, i


def _same_class_close(got, want, tol, floor=1e-30):
    """NaN, +inf and -inf in the same places, the finite values within
    ``tol`` of max(the finite values' largest magnitude, ``floor``)."""
    got, want = got.float().cpu(), want.float().cpu()
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want))
    fin = want.isfinite()
    if bool(fin.any()):
        scale = max(float(want[fin].abs().max()), floor)
        assert float((got[fin] - want[fin]).abs().max()) <= tol * scale


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# every kind of row at B = C (four column tiles, four splits), C != B, and D
# = 80 (two staged d chunks, U's row tile in the ring); each kind alone
@pytest.mark.parametrize("case,b,c,d,diag", [
    ("all", 200, 200, 64, True), ("all", 200, 300, 64, False), ("all", 130, 130, 80, True),
    ("overflow", 200, 200, 64, True), ("inf", 200, 200, 64, True),
    ("neg-overflow", 200, 200, 64, True), ("neg-inf", 200, 300, 64, False),
    ("inf-item", 200, 200, 64, True), ("inf-item", 200, 200, 80, False),
])
def test_ce_kernels_match_plain_on_infinite_scores(dev, case, b, c, d, diag):
    """B10 on rows with a +inf score (lse +inf) and rows of -inf scores (lse
    -inf), ce = lse - diag in IEEE arithmetic (inf - inf is NaN), as
    ``in_batch_ce_fwd_plain`` (torch.logsumexp) gives them; then B11 + B12
    with the same lse against ``in_batch_ce_bwd_plain``: NaN and infinities
    in the same places, the finite values within 1e-5 of scale; both
    bit-equal on repeat."""
    u, i = _infinite_ce_inputs(case, b, c, d, dev)
    g = _randn(65, b, dev=dev)
    ce, lse = fs.in_batch_ce_fwd(u, i, diag)
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, i, diag)
    special = {"overflow": [5], "inf": [6], "neg-overflow": [7], "neg-inf": [8],
               "inf-item": (u[:, 3] > 0).nonzero()[:, 0].tolist()}.get(case, [5, 6, 7, 8])
    assert int((~lse_p.isfinite()).sum()) == len(special)
    _same_class_close(lse, lse_p, 1e-5)
    _same_class_close(ce, ce_p, 1e-5)
    again = fs.in_batch_ce_fwd(u, i, diag)
    assert _bits_equal(ce, again[0]) and _bits_equal(lse, again[1])
    du, di = fs.in_batch_ce_bwd(u, i, lse_p, g, diag)
    du_p, di_p = fs.in_batch_ce_bwd_plain(u, i, lse_p, g, diag)
    normal = torch.ones(b, dtype=torch.bool, device=dev)
    normal[special] = False
    _same_class_close(du, du_p, 1e-5, _term(g, i[i.isfinite().all(1)]))
    _same_class_close(di, di_p, 1e-5, _term(g, u[normal]))
    du2, di2 = fs.in_batch_ce_bwd(u, i, lse_p, g, diag)
    assert _bits_equal(du, du2) and _bits_equal(di, di2)


def test_ce_autograd_matches_plain_route(dev):
    """The two autograd Functions on the card against the CPU route; each
    backward is one launch of the fused kernel and one of its reduce."""
    u, i = _randn(26, 300, 64, dev=dev) * 0.3, _randn(27, 300, 64, dev=dev) * 0.3
    w = _randn(28, 300, dev=dev)
    grads = []
    for x, y in ((u, i), (u.cpu(), i.cpu())):
        x, y = x.clone().requires_grad_(), y.clone().requires_grad_()
        ce, _ = fs.fused_in_batch_ce(x, y)
        lse = fs.fused_lse(x, y)
        before = dict(_lib.launches)
        ((ce * w.to(x.device)).sum() + lse.sum()).backward()
        if x.device.type == "cuda":
            for name in ("in_batch_ce_bwd", "in_batch_ce_bwd_reduce"):
                assert _lib.launches[name] == before.get(name, 0) + 2
        grads.append((x.grad, y.grad))
    for got, want in zip(grads[0], grads[1]):
        _scaled_close(got, want, 1e-5)


def test_ce_wrappers_reject_what_the_kernels_do_not_take(dev):
    u, i = _randn(29, 8, 64, dev=dev), _randn(30, 8, 64, dev=dev)
    with pytest.raises(TypeError):
        fs.in_batch_ce_fwd(u.to(torch.bfloat16), i.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fs.in_batch_ce_fwd(u, i[:5])
    with pytest.raises(ValueError):
        fs.in_batch_ce_fwd(u, i[:, :32], with_diag=False)
    _, lse = fs.in_batch_ce_fwd(u, i)
    with pytest.raises(ValueError):
        fs.in_batch_ce_bwd(u, i, lse, lse, want_du=False, want_di=False)
    with pytest.raises(ValueError):
        fs.in_batch_ce_bwd(u, i, lse[:4], lse)


def _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    lim_in, lim_out = math.sqrt(6.0 / (4 * d)), math.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).to(dtype)
    weights = (
        t(r.normal(size=(h, d)) * 0.5),
        t(r.uniform(-lim_in, lim_in, (nl, d, 3 * d))),
        t(r.uniform(-0.1, 0.1, (nl, 3 * d))),
        t(r.uniform(-lim_out, lim_out, (nl, d, d))),
        t(r.uniform(-0.1, 0.1, (nl, d))),
    )
    g = t(r.normal(size=(b, 2, d)) * 0.1).to(dtype)
    return x, weights, g


_ENC_SHAPES = [(1, 32, 64, 4, 3), (37, 10, 64, 2, 1), (64, 8, 32, 4, 2), (300, 32, 64, 4, 3)]


# _ENC_SHAPES, the cells' training batch, B at the edges of a tile (3, 5)
# and not a multiple of it (1000), H = 40 (Hp = 48)
_ENC_RES_SHAPES = _ENC_SHAPES + [
    (4096, 32, 64, 4, 3), (3, 32, 64, 4, 3), (5, 32, 64, 4, 3), (1000, 32, 64, 4, 3),
    (3, 40, 64, 4, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC_RES_SHAPES)
def test_encoder_res_kernel_matches_plain(dev, dtype, b, h, d, nh, nl):
    """B5: the output and each stored residual (xs, ps, p0), held as B1's
    output is in ``test_encoder_kernel_matches_plain``: B = 1, H = 10, L = 1
    among the shapes."""
    x, w, _ = _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed=b + h)
    tc = _enc_tc(dtype, h, d, nh, nl)
    before = dict(_lib.launches)
    got = fe.fused_history_encoder_res(x, *w, nh)
    name = "fused_history_encoder_res"
    assert _lib.launches[name] == before.get(name, 0) + 1
    assert _lib.launches[name + "_tc"] == before.get(name + "_tc", 0) + tc
    want = fe.fused_history_encoder_res_plain(x, *w, nh)
    fma = _fma_forward(name, x, fe._pe(w[0], x), w[1:], nh)
    assert (got[2] is None) == (want[2] is None) == (fma[2] is None) == (nl == 1)
    again = fe.fused_history_encoder_res(x, *w, nh) if tc else fma
    for a, a2, f, e in zip(got, again, fma, want):
        if e is None:
            continue
        assert a.dtype == f.dtype == dtype and a.shape == f.shape == e.shape
        if dtype == torch.float32:
            _assert_close(a, e, 1e-4, 1e-4)
            _assert_close(f, e, 1e-4, 1e-4)
            continue
        assert _bf16_ulps(f, e) <= 1
        if tc:
            _hold_tc(a, a2, e)
        else:
            assert torch.equal(a, f)
    if tc:
        x, w, _ = _encoder_inputs(_big(b, d), h, d, nh, nl, dtype, dev, seed=b + h)
        runs = [fe.fused_history_encoder_res(x, *w, nh), fe.fused_history_encoder_res_plain(x, *w, nh),
                fe.fused_history_encoder_res_f64_sums(x, *w, nh)]
        for a, e, ref in zip(*runs):
            if ref is not None:
                _hold_tc_big(a, e, ref)


def _bf16_steps(a, b):
    """Distance between two bf16 tensors value by value, in steps of the
    bf16 number line (0 = bit-equal up to the sign of zero)."""
    keys = [torch.where(v < 0, -(v & 0x7FFF), v)
            for v in (t.contiguous().view(torch.int16).int() for t in (a, b))]
    return (keys[0] - keys[1]).abs()


def _bf16_ulps(a, b):
    """Largest distance between two bf16 tensors in steps of the bf16
    number line; NaNs must coincide."""
    assert torch.equal(a.isnan(), b.isnan())
    steps = _bf16_steps(a, b)[~a.isnan()]
    return int(steps.max()) if steps.numel() else 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC_SHAPES)
def test_encoder_bwd_kernel_matches_plain(dev, dtype, b, h, d, nh, nl):
    """B6 and its reduce on the plain version's residuals, all six outputs."""
    x, w, g = _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed=b + h + 1)
    _, xs, ps, p0 = fe.fused_history_encoder_res_plain(x, *w, nh)
    pe, w_in, b_in, w_out, _ = w
    before = dict(_lib.launches)
    got = fe.fused_history_encoder_bwd(g, xs, ps, p0, w_in, b_in, w_out, nh)
    for name in ("fused_history_encoder_bwd", "fused_history_encoder_bwd_reduce"):
        assert _lib.launches[name] == before.get(name, 0) + 1
    want = fe.fused_history_encoder_bwd_plain(g, xs, ps, p0, w_in, b_in, w_out, nh)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, tol)


def test_encoder_bwd_is_deterministic(dev):
    """Two runs on the same inputs give bit-equal weight grads: the per-block
    partials are summed in a fixed order, with no float atomics."""
    x, w, g = _encoder_inputs(1000, 32, 64, 4, 3, torch.bfloat16, dev, seed=3)
    _, xs, ps, p0 = fe.fused_history_encoder_res(x, *w, 4)
    runs = [fe.fused_history_encoder_bwd(g, xs, ps, p0, w[1], w[2], w[3], 4) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encoder_autograd_grads_match_plain_route(dev, dtype):
    """The autograd Function on the card (B5 then B6, never B1) gives the
    weight and input grads of the plain route on the CPU."""
    x, w, g = _encoder_inputs(129, 32, 64, 4, 3, dtype, dev, seed=4)
    grads = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).clone().requires_grad_() for t in (x, *w)]
        before = dict(_lib.launches)
        y = fe.fused_history_encoder(*leaves, 4)
        (y.float() * g.float().to(device)).sum().backward()
        if device.type == "cuda":
            assert _lib.launches["fused_history_encoder_res"] == before.get("fused_history_encoder_res", 0) + 1
            assert _lib.launches["fused_history_encoder_bwd"] == before.get("fused_history_encoder_bwd", 0) + 1
            assert _lib.launches["fused_history_encoder"] == before.get("fused_history_encoder", 0)
        grads.append([t.grad for t in leaves])
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, e in zip(*grads):
        _scaled_close(a, e, tol)


def test_encoder_inference_runs_the_forward_kernel(dev):
    """Serving (no grad wanted) launches B1, not B5."""
    x, w, _ = _encoder_inputs(16, 32, 64, 4, 3, torch.bfloat16, dev, seed=5)
    w = [t.requires_grad_() for t in w]
    before = dict(_lib.launches)
    with torch.inference_mode():
        fe.fused_history_encoder(x, *w, 4)
    assert _lib.launches["fused_history_encoder"] == before.get("fused_history_encoder", 0) + 1
    assert _lib.launches["fused_history_encoder_res"] == before.get("fused_history_encoder_res", 0)


def _stack_case(b, h, d, nh, nl, dtype, dev, seed, lens_kind):
    """x with rows past each length zeroed (as the encoder hands it over),
    lengths, the stacked weights and a cotangent of y0 [B, D]."""
    x, w, _ = _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed)
    r = np.random.default_rng(seed + 1)
    lens = {"mix": r.integers(1, h + 1, size=b), "ones": np.ones(b), "full": np.full(b, h)}[lens_kind]
    if lens_kind == "mix":
        lens[: min(b, 2)] = [h, 1][: min(b, 2)]
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    x = torch.where((torch.arange(h, device=dev)[None, :] < lens[:, None])[..., None], x, 0)
    g = torch.from_numpy((r.normal(size=(b, d)) * 0.1).astype(np.float32)).to(dev).to(dtype)
    return x, lens, w[1:], g


# B below and above one block's examples (8 in the forward; one block per SM
# in the backward, so above 132), the thin layer alone, length 1 everywhere,
# full lengths, the flagship's H = 32 with D = 64
_STACK_SHAPES = [
    (3, 32, 64, 4, 3, "mix"), (300, 32, 64, 4, 3, "mix"), (37, 10, 64, 2, 1, "mix"),
    (64, 8, 32, 4, 2, "ones"), (129, 12, 64, 4, 2, "full"),
]


# _STACK_SHAPES, the cells' batches, B at the edges of a tile (1, 5) and
# not a multiple of it (1000), H = 40 (Hp = 48), length 1 at the cells' H
_STACK_FWD_SHAPES = _STACK_SHAPES + [
    (1024, 32, 64, 4, 3, "mix"), (4096, 32, 64, 4, 3, "mix"), (1, 32, 64, 4, 3, "mix"),
    (5, 32, 64, 4, 3, "mix"), (1000, 32, 64, 4, 3, "mix"), (7, 40, 64, 4, 3, "mix"),
    (64, 32, 64, 4, 3, "ones"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl,lens_kind", _STACK_FWD_SHAPES)
def test_attn_stack_kernel_matches_plain(dev, dtype, b, h, d, nh, nl, lens_kind):
    """B8: y0 [B, D] held as B1's output is in
    ``test_encoder_kernel_matches_plain``."""
    x, lens, w, _ = _stack_case(b, h, d, nh, nl, dtype, dev, b + h, lens_kind)
    tc = _enc_tc(dtype, h, d, nh, nl)
    before = dict(_lib.launches)
    got = fe.fused_attn_stack_fwd(x, lens, *w, nh)
    assert _lib.launches["fused_attn_stack"] == before.get("fused_attn_stack", 0) + 1
    assert _lib.launches["fused_attn_stack_tc"] == before.get("fused_attn_stack_tc", 0) + tc
    want = fe.fused_attn_stack_fwd_plain(x, lens, *w, nh)
    assert got.dtype == dtype and got.shape == (b, d)
    fma = _fma_forward("fused_attn_stack", x, fe._lens(lens, x), w, nh)
    if dtype == torch.float32:
        _assert_close(got, want, 1e-4, 1e-4)
        _assert_close(fma, want, 1e-4, 1e-4)
        return
    assert _bf16_ulps(fma, want) <= 1
    if not tc:
        assert torch.equal(got, fma)
        return
    _hold_tc(got, fe.fused_attn_stack_fwd(x, lens, *w, nh), want)
    x, lens, w, _ = _stack_case(_big(b, d), h, d, nh, nl, dtype, dev, b + h, lens_kind)
    _hold_tc_big(fe.fused_attn_stack_fwd(x, lens, *w, nh),
                 fe.fused_attn_stack_fwd_plain(x, lens, *w, nh),
                 fe.fused_attn_stack_f64_sums(x, lens, *w, nh))


def test_attn_stack_at_full_length_is_the_encoders_row0(dev):
    """At lengths H and a zero PE, B8's output is B1's row 0, bit for bit:
    one kernel (the tensor-core one, at this shape), where every key is
    valid."""
    x, lens, w, _ = _stack_case(300, 32, 64, 4, 3, torch.bfloat16, dev, 5, "full")
    before = dict(_lib.launches)
    y1 = fe.fused_history_encoder(x, torch.zeros(32, 64, device=dev), *w, 4)
    assert torch.equal(fe.fused_attn_stack_fwd(x, lens, *w, 4), y1[:, 0])
    for name in ("fused_history_encoder_tc", "fused_attn_stack_tc"):
        assert _lib.launches[name] == before.get(name, 0) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl,lens_kind", _STACK_SHAPES)
def test_attn_stack_bwd_kernel_matches_plain(dev, dtype, b, h, d, nh, nl, lens_kind):
    """B9 and its reduce: dx and the four weight grads at 1e-4 (f32) and
    3e-2 (bf16) of each output's scale; dx exactly zero past each length."""
    x, lens, w, g = _stack_case(b, h, d, nh, nl, dtype, dev, b + h + 2, lens_kind)
    before = dict(_lib.launches)
    got = fe.fused_attn_stack_bwd(g, x, lens, *w, nh)
    for name in ("fused_attn_stack_bwd", "fused_attn_stack_bwd_reduce"):
        assert _lib.launches[name] == before.get(name, 0) + 1
    want = fe.fused_attn_stack_bwd_plain(g, x, lens, *w, nh)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, tol)
    past = torch.arange(h, device=dev)[None, :] >= lens[:, None]
    assert bool((got[0][past] == 0).all())


def test_attn_stack_bwd_is_deterministic(dev):
    x, lens, w, g = _stack_case(1000, 32, 64, 4, 3, torch.bfloat16, dev, 6, "mix")
    runs = [fe.fused_attn_stack_bwd(g, x, lens, *w, 4) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# B6 and B9 on the tensor cores alone: the cells' shape at B at the edges
# of a tile of four examples (1, 3, 5), not a multiple of it (1000) and the
# training batch (4096); H = 40 (Hp = 48, two examples a tile), H = 64 (one
# example), D = 32 with H = 16 (eight examples), the thin layer alone
_BWD_TC_SHAPES = [
    (1, 32, 64, 4, 3), (3, 32, 64, 4, 3), (5, 32, 64, 4, 3), (1000, 32, 64, 4, 3),
    (4096, 32, 64, 4, 3), (9, 40, 64, 4, 3), (7, 64, 64, 4, 2), (33, 16, 32, 2, 3),
    (20, 32, 64, 4, 1),
]


# seeds of the f64-sum comparisons of B6 and B9.  A grad's error from f64
# sums is, on one input, the sum over some 10^5 rows of a few hundred
# roundings that flip by one bf16 step, in the kernel and in the plain
# version alike, and its ratio to the plain version's is heavy-tailed both
# ways: 0.04-3.1 over single seeds, at the cells' shape too, with medians
# over ten seeds of 0.48-0.99 (scripts/torch_encoder_bwd_f64.py; an H100).
# So the grads are held by the median over ten seeds, the dx counts summed
_F64_SEEDS = tuple(range(0, 10000, 1000))


def _bwd_vs_f64(runs):
    """A tensor-core backward against the same function with f64 sums, over
    ``runs`` of (got, want, ref): the kernel's outputs (dx, then the f32
    grads), the plain version's and the f64 sums' on one input each.  dx no
    more values beyond one bf16 step, summed over the runs, than 1.5 times
    the plain version's (or 1e-6 of the values, where both are that rare);
    each grad's RMS error relative to its scale at most 1.5 times the plain
    version's, or 1e-6 of scale where both are near 0, in the median run."""
    far = [sum(_far(r[i][0], r[2][0]) for r in runs) for i in (0, 1)]
    n = sum(r[0][0].numel() for r in runs)
    rms = lambda a, e: float((a.double() - e).pow(2).mean().sqrt() / e.abs().max().clamp_min(1e-300))
    # per grad and run: the kernel's error over its bound (<= 1 passes)
    over = [[rms(r[0][j], r[2][j]) / max(1.5 * rms(r[1][j], r[2][j]), 1e-6) for r in runs]
            for j in range(1, len(runs[0][2]))]
    assert far[0] <= max(1.5 * far[1], 1e-6 * n), far
    assert all(sorted(o)[len(o) // 2] <= 1.0 for o in over), over


def _fma_bwd(name, inputs, b, h, d, nh, nl, with_pe, res_floats=0):
    """Backward ``name`` forced onto the FMA kernel (``encoder_bwd_kernel``)
    and its reduce: (dx, the grads) as the wrapper returns them."""
    dx = torch.empty((b, h, d), dtype=torch.bfloat16, device=inputs[1].device)
    grads = fe._launch_bwd_fma(name, inputs, dx, fe._grad_shapes(h, d, nl, with_pe), nh, nl,
                               res_floats)
    return (dx, *grads)


def _fma_bwd_fits(h, d, nh):
    """Whether the FMA kernel takes the shape: one example's working set
    and the layer's weights and grads in shared memory (H = 40 and 64 at D
    = 64 do not fit; the tensor cores take them)."""
    return fe._bwd_smem_bytes(h, d, nh) <= fe._SMEM_LIMIT


def _enc_bwd_case(b, h, d, nh, nl, dev, seed):
    """B6's arguments: a bf16 cotangent [B, 2, D], B5's residuals (the
    training path's forward) and the weights."""
    x, w, g = _encoder_inputs(b, h, d, nh, nl, torch.bfloat16, dev, seed)
    _, xs, ps, p0 = fe.fused_history_encoder_res(x, *w, nh)
    return g, xs, ps, p0, w[1], w[2], w[3], nh


def _counts(names, before):
    return [_lib.launches[n] - before.get(n, 0) for n in names]


@pytest.mark.parametrize("b,h,d,nh,nl", _BWD_TC_SHAPES)
def test_encoder_bwd_tc_route_alone(dev, b, h, d, nh, nl):
    """B6 on the tensor cores (``encoder_bwd_tc_kernel``): one launch of
    each counter; dx, dPE and the four weight grads within 3e-2 of scale of
    the plain version's, as the FMA kernel is where it takes the shape
    (``_fma_bwd_fits``); bit-equal on repeat; and on batches of at least
    2^23 values of dx against the backward with f64 sums (``_bwd_vs_f64``,
    over the ten ``_F64_SEEDS``)."""
    assert fe._enc_bwd_route(torch.bfloat16, h, d, nh, nl) == "tc"
    args = _enc_bwd_case(b, h, d, nh, nl, dev, b + h + 11)
    names = ["fused_history_encoder_bwd", "fused_history_encoder_bwd_tc",
             "fused_history_encoder_bwd_reduce"]
    before = dict(_lib.launches)
    got = fe.fused_history_encoder_bwd(*args)
    assert _counts(names, before) == [1, 1, 1]
    again = fe.fused_history_encoder_bwd(*args)
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = fe.fused_history_encoder_bwd_plain(*args)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, 3e-2)
    if _fma_bwd_fits(h, d, nh):
        fma = _fma_bwd("fused_history_encoder_bwd", fe._res_bwd_inputs(*args), b, h, d, nh, nl,
                       True)
        for f, e in zip((fma[0], fma[-1], *fma[1:-1]), want):  # (dx, dpe, ...) as got
            _scaled_close(f, e, 3e-2)
    runs = []
    for seed in _F64_SEEDS:
        big = _enc_bwd_case(max(b, -(-(1 << 23) // (h * d))), h, d, nh, nl, dev, b + h + 11 + seed)
        runs.append((fe.fused_history_encoder_bwd(*big), fe.fused_history_encoder_bwd_plain(*big),
                     fe.fused_history_encoder_bwd_f64_sums(*big)))
    _bwd_vs_f64(runs)


@pytest.mark.parametrize("b,h,d,nh,nl", _BWD_TC_SHAPES)
def test_attn_stack_bwd_tc_route_alone(dev, b, h, d, nh, nl):
    """B9 on the tensor cores: held as B6 in ``test_encoder_bwd_tc_route_alone``,
    and dx exact zeros past each length."""
    assert fe._enc_bwd_route(torch.bfloat16, h, d, nh, nl) == "tc"
    x, lens, w, g = _stack_case(b, h, d, nh, nl, torch.bfloat16, dev, b + h + 12, "mix")
    names = ["fused_attn_stack_bwd", "fused_attn_stack_bwd_tc", "fused_attn_stack_bwd_reduce"]
    before = dict(_lib.launches)
    got = fe.fused_attn_stack_bwd(g, x, lens, *w, nh)
    assert _counts(names, before) == [1, 1, 1]
    again = fe.fused_attn_stack_bwd(g, x, lens, *w, nh)
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = fe.fused_attn_stack_bwd_plain(g, x, lens, *w, nh)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, 3e-2)
    if _fma_bwd_fits(h, d, nh):
        inputs = fe._recompute_bwd_inputs(g, x, fe._lens(lens, x), *w, nh, enc=False)
        fma = _fma_bwd("fused_attn_stack_bwd", inputs, b, h, d, nh, nl, False,
                       fe._res_floats(h, d, nh, nl))
        for f, e in zip(fma, want):
            _scaled_close(f, e, 3e-2)
    past = torch.arange(h, device=dev)[None, :] >= lens[:, None]
    assert bool((got[0][past] == 0).all())
    runs = []
    for seed in _F64_SEEDS:
        x, lens, w, g = _stack_case(max(b, -(-(1 << 23) // (h * d))), h, d, nh, nl,
                                    torch.bfloat16, dev, b + h + 12 + seed, "mix")
        runs.append((fe.fused_attn_stack_bwd(g, x, lens, *w, nh),
                     fe.fused_attn_stack_bwd_plain(g, x, lens, *w, nh),
                     fe.fused_attn_stack_bwd_f64_sums(g, x, lens, *w, nh)))
    _bwd_vs_f64(runs)


def test_encoder_bwd_tc_at_unaligned_addresses(dev):
    """B6's and B9's tensor-core kernels read their inputs in 16-byte
    chunks; copies at addresses that are not 16-byte aligned (the wrapper
    clones them) give the same results bit for bit."""

    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    g, xs, ps, p0, wi, bi, wo, nh = _enc_bwd_case(300, 32, 64, 4, 3, dev, 13)
    got = fe.fused_history_encoder_bwd(g, xs, ps, p0, wi, bi, wo, nh)
    moved = [odd(t) for t in (g, xs, ps, p0, wi, wo)]
    assert all(t.data_ptr() % 16 for t in moved)
    go, xo, pso, p0o, wio, woo = moved
    assert all(torch.equal(a, e) for a, e in zip(
        fe.fused_history_encoder_bwd(go, xo, pso, p0o, wio, bi, woo, nh), got))
    x, lens, w, g = _stack_case(300, 32, 64, 4, 3, torch.bfloat16, dev, 14, "mix")
    got = fe.fused_attn_stack_bwd(g, x, lens, *w, 4)
    go, xo, wio, woo = (odd(t) for t in (g, x, w[0], w[2]))
    assert all(torch.equal(a, e) for a, e in zip(
        fe.fused_attn_stack_bwd(go, xo, lens, wio, w[1], woo, w[3], 4), got))


# B7 on the tensor cores alone: the cells' shape at B at the edges of a
# tile of four examples (1, 5), not a multiple of it (1000) and the
# training batch (4096); the thin layer alone; D = 32 (H = 16, eight
# examples a tile); H = 20 (Hp = 32, padded rows in every example) and 40
# (Hp = 48, two examples a tile)
_B7_TC_SHAPES = [
    (1, 32, 64, 4, 3), (5, 32, 64, 4, 3), (1000, 32, 64, 4, 3), (4096, 32, 64, 4, 3),
    (20, 32, 64, 4, 1), (33, 16, 32, 2, 3), (9, 20, 64, 4, 3), (9, 40, 64, 4, 3),
]


def _b7_fma(g, x, w, nh):
    """B7 forced onto the FMA kernel (``encoder_bwd_kernel<MODE_ENC>``): its
    outputs in the wrapper's order (dx, dpe, then the four grads)."""
    b, h, d = x.shape
    nl = w[1].shape[0]
    inputs = fe._recompute_bwd_inputs(g, x, fe._pe(w[0], x), *w[1:], nh, enc=True)
    out = _fma_bwd("fused_history_encoder_bwd_recompute", inputs, b, h, d, nh, nl, True,
                   fe._res_floats(h, d, nh, nl))
    return (out[0], out[-1], *out[1:-1])


@pytest.mark.parametrize("b,h,d,nh,nl", _B7_TC_SHAPES)
def test_encoder_recompute_bwd_tc_route_alone(dev, b, h, d, nh, nl):
    """B7 on the tensor cores (``encoder_bwd_tc_kernel<MODE_ENC>``): one
    launch of each counter; dx, dPE and the four weight grads within 3e-2
    of scale of the plain version's and of the FMA kernel's, as the FMA
    kernel is of the plain version's, where it takes the shape
    (``_fma_bwd_fits``); bit-equal on repeat; and on batches of at least
    2^23 values of dx against the backward with f64 sums
    (``fused_history_encoder_bwd_recompute_f64_sums``, ``_bwd_vs_f64`` over
    the ten ``_F64_SEEDS``)."""
    assert fe._enc_bwd_route(torch.bfloat16, h, d, nh, nl) == "tc"
    x, w, g = _encoder_inputs(b, h, d, nh, nl, torch.bfloat16, dev, seed=b + h + 15)
    args = (g, x, *w, nh)
    names = ["fused_history_encoder_bwd_recompute", "fused_history_encoder_bwd_recompute_tc",
             "fused_history_encoder_bwd_recompute_reduce"]
    before = dict(_lib.launches)
    got = fe.fused_history_encoder_bwd_recompute(*args)
    assert _counts(names, before) == [1, 1, 1]
    again = fe.fused_history_encoder_bwd_recompute(*args)
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = fe.fused_history_encoder_bwd_recompute_plain(*args)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, 3e-2)
    if _fma_bwd_fits(h, d, nh):
        fma = _b7_fma(g, x, w, nh)
        for f, a, e in zip(fma, got, want):
            _scaled_close(f, e, 3e-2)
            _scaled_close(a, f, 3e-2)
    runs = []
    for seed in _F64_SEEDS:
        xb, wb, gb = _encoder_inputs(max(b, -(-(1 << 23) // (h * d))), h, d, nh, nl,
                                     torch.bfloat16, dev, seed=b + h + 15 + seed)
        big = (gb, xb, *wb, nh)
        runs.append((fe.fused_history_encoder_bwd_recompute(*big),
                     fe.fused_history_encoder_bwd_recompute_plain(*big),
                     fe.fused_history_encoder_bwd_recompute_f64_sums(*big)))
    _bwd_vs_f64(runs)


def test_encoder_recompute_bwd_tc_at_unaligned_addresses(dev):
    """B7's tensor-core kernel reads g, x, the PE and the weights in 16-byte
    chunks; copies at addresses that are not 16-byte aligned (the wrapper
    clones them) give the same results bit for bit."""

    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    x, w, g = _encoder_inputs(300, 32, 64, 4, 3, torch.bfloat16, dev, seed=16)
    got = fe.fused_history_encoder_bwd_recompute(g, x, *w, 4)
    go, xo, peo, wio, woo = (odd(t) for t in (g, x, w[0], w[1], w[3]))
    assert all(t.data_ptr() % 16 for t in (go, xo, peo, wio, woo))
    assert all(torch.equal(a, e) for a, e in zip(
        fe.fused_history_encoder_bwd_recompute(go, xo, peo, wio, w[2], woo, w[4], 4), got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC_SHAPES)
def test_encoder_recompute_bwd_kernel_matches_plain_and_b6(dev, dtype, b, h, d, nh, nl):
    """B7 and its reduce against its plain version (1e-4 f32, 3e-2 bf16 of
    each output's scale), and against B6 on the same input, which computes
    the same VJP but rounds p: within 3e-2 of each output's scale.  f32
    takes the FMA kernel; bf16 the tensor cores but at head width 8."""
    x, w, g = _encoder_inputs(b, h, d, nh, nl, dtype, dev, seed=b + h + 3)
    before = dict(_lib.launches)
    got = fe.fused_history_encoder_bwd_recompute(g, x, *w, nh)
    for name in ("fused_history_encoder_bwd_recompute", "fused_history_encoder_bwd_recompute_reduce"):
        assert _lib.launches[name] == before.get(name, 0) + 1
    want = fe.fused_history_encoder_bwd_recompute_plain(g, x, *w, nh)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        _scaled_close(a, e, tol)
    _, xs, ps, p0 = fe.fused_history_encoder_res(x, *w, nh)
    b6 = fe.fused_history_encoder_bwd(g, xs, ps, p0, w[1], w[2], w[3], nh)
    for a, e in zip(got, b6):
        _scaled_close(a, e, 3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attn_stack_autograd_grads_match_plain_route(dev, dtype):
    """fused_attn_stack with grad wanted launches B8 then B9 on the card and
    gives the input and weight grads of the plain route on the CPU."""
    x, lens, w, g = _stack_case(129, 32, 64, 4, 3, dtype, dev, 7, "mix")
    grads = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).clone().requires_grad_() for t in (x, *w)]
        before = dict(_lib.launches)
        y = fe.fused_attn_stack(leaves[0], lens.to(device), *leaves[1:], 4)
        (y.float() * g.float().to(device)).sum().backward()
        if device.type == "cuda":
            for name in ("fused_attn_stack", "fused_attn_stack_bwd"):
                assert _lib.launches[name] == before.get(name, 0) + 1
        grads.append([t.grad for t in leaves])
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, e in zip(*grads):
        _scaled_close(a, e, tol)


def test_encoder_recompute_route_launches_b1_and_b7(dev, monkeypatch):
    """With _RESIDUAL_BWD False a training call of the encoder launches B1
    and B7, and neither B5 nor B6."""
    monkeypatch.setattr(fe, "_RESIDUAL_BWD", False)
    x, w, g = _encoder_inputs(129, 32, 64, 4, 3, torch.bfloat16, dev, seed=8)
    leaves = [t.clone().requires_grad_() for t in (x, *w)]
    before = dict(_lib.launches)
    (fe.fused_history_encoder(*leaves, 4).float() * g.float()).sum().backward()
    counts = {k: _lib.launches[k] - before.get(k, 0) for k in (
        "fused_history_encoder", "fused_history_encoder_bwd_recompute",
        "fused_history_encoder_bwd_recompute_tc", "fused_history_encoder_res",
        "fused_history_encoder_bwd")}
    assert counts == {"fused_history_encoder": 1, "fused_history_encoder_bwd_recompute": 1,
                      "fused_history_encoder_bwd_recompute_tc": 1,
                      "fused_history_encoder_res": 0, "fused_history_encoder_bwd": 0}


def test_stack_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, lens, w, g = _stack_case(8, 8, 32, 4, 2, torch.float32, dev, 9, "mix")
    with pytest.raises(ValueError):
        fe.fused_attn_stack_fwd(x, lens[:4], *w, 4)
    with pytest.raises(ValueError):
        fe.fused_attn_stack_bwd(g[:, None].expand(8, 2, 32), x, lens, *w, 4)
    with pytest.raises(ValueError):
        fe.fused_history_encoder_bwd_recompute(g, x, torch.zeros(8, 32, device=dev), *w, 4)


_SCATTER_SHAPES = [
    (300, 33, 777), (512, 64, 100), (64, 128, 4096), (2048, 64, 0), (1000, 3, 5000),
    (1 << 18, 64, 135168),
]


@pytest.mark.parametrize("v,d,n", _SCATTER_SHAPES)
def test_rows_scatter_add_kernel_matches_plain(dev, v, d, n):
    """B18 against its plain version (sums in another order: 1e-5) at
    unaligned V and D, no updates, dense collisions and the history lookup
    of a 2^18-row table; every output row written."""
    r = np.random.default_rng(v + n)
    ids = torch.from_numpy(r.integers(0, v, n)).to(dev)
    rows = _randn(v + d, n, d, dev=dev)
    before = _lib.launches["rows_scatter_add"]
    got = rsa.rows_scatter_add(ids, rows, v)
    assert _lib.launches["rows_scatter_add"] == before + 1
    assert got.shape == (v, d) and got.dtype == torch.float32
    _assert_close(got, rsa.rows_scatter_add_reference(ids, rows, v), 1e-5, 1e-5)


@pytest.mark.parametrize("n", [1000, 100_000])
def test_rows_scatter_add_kernel_sums_ones_exactly(dev, n):
    """Every update on one row: a run across many chunks sums exactly."""
    ids = torch.full((n,), 7, dtype=torch.int32, device=dev)
    got = rsa.rows_scatter_add(ids, torch.ones(n, 64, device=dev), 300)
    assert bool((got[7] == n).all()) and float(got.abs().sum()) == n * 64


def test_rows_scatter_add_kernel_skewed_stream_is_exact_and_deterministic(dev):
    """Half of N on id 0 (the padding of variable-length histories), on rows
    of small integers, whose sums are exact in any order: equal to the plain
    version, and bit-equal from call to call.  (On normal rows the 65k-term
    sum of id 0 differs between two summation orders by ~1e-5 of itself.)"""
    n, v, d = 131072, 65536, 64
    r = np.random.default_rng(11)
    ids = r.integers(0, v, n)
    ids[r.random(n) < 0.5] = 0
    ids = torch.from_numpy(ids).to(dev)
    rows = _grid(12, n, d, dev=dev)
    got = rsa.rows_scatter_add(ids, rows, v)
    assert torch.equal(got, rsa.rows_scatter_add_reference(ids, rows, v))
    assert torch.equal(got, rsa.rows_scatter_add(ids, rows, v))


def test_rows_scatter_add_kernel_drops_out_of_range_ids(dev):
    v, d = 1000, 64
    ids = torch.tensor([-5, 0, 999, 1000, 3, -1, 5000, 3, (1 << 31) - 1], device=dev)
    rows = _randn(13, ids.numel(), d, dev=dev)
    got = rsa.rows_scatter_add(ids, rows, v)
    _assert_close(got, rsa.rows_scatter_add_reference(ids, rows, v), 1e-6, 1e-6)
    others = torch.ones(v, dtype=torch.bool, device=dev)
    others[[0, 3, 999]] = False
    assert not bool(got[others].any())


@pytest.mark.parametrize("route", ["packed", "plain"])
def test_lookup_gradient_routes_launch_b18(dev, route):
    """A training lookup of a 2^18-row table, packed (rows_p * P = 2^18) or
    plain (inside the window), launches B18 once in its backward and gives
    the gradient of the plain route; below the window it launches none."""
    from two_tower_models_tpu_torch.nn import layers, packed_table

    v, d = 1 << 18, 32
    table = _randn(14, v, d, dev=dev)
    leaf = torch.nn.Parameter(packed_table.pack_table(table) if route == "packed" else table.clone())
    ids = torch.from_numpy(np.random.default_rng(15).integers(0, v, (512, 8))).to(dev)
    g = _randn(16, 512, 8, d, dev=dev)
    grads = []
    for kernel in (True, False):
        leaf.grad = None
        before = _lib.launches["rows_scatter_add"]
        if kernel:
            (packed_table.table_lookup(leaf, ids, d) * g).sum().backward()
        else:
            with layers.disable_scatter_kernel():
                (packed_table.table_lookup(leaf, ids, d) * g).sum().backward()
        assert _lib.launches["rows_scatter_add"] == before + int(kernel)
        grads.append(leaf.grad.clone())
    _assert_close(grads[0], grads[1], 1e-5, 1e-5)
    small = torch.nn.Parameter(table[: 1 << 16].clone())
    before = _lib.launches["rows_scatter_add"]
    (layers.embedding_lookup(small, ids % (1 << 16)) * g).sum().backward()
    assert _lib.launches["rows_scatter_add"] == before


def test_fixed_order_lookup_gradient_is_b18_and_bit_equal(dev):
    """The position-bias table's lookup (``fixed_order``), [100, 1] under
    4096 ids on 10 rows as in the flagship step: its backward launches B18
    once, gives the same bits on five calls (F.embedding's gave five
    results in five), and equals the plain scatter-add: exactly on sums of
    small integers, within 1e-5 of scale on normal values."""
    from two_tower_models_tpu_torch.nn import layers

    ids = torch.from_numpy(np.random.default_rng(64).integers(0, 10, 4096)).to(dev)
    for make, exact in ((_grid, True), (_randn, False)):
        leaf = torch.nn.Parameter(_randn(65, 100, 1, dev=dev))
        up = make(66, 4096, 1, dev=dev)
        seen = set()
        for _ in range(5):
            leaf.grad = None
            before = _lib.launches["rows_scatter_add"]
            with torch.enable_grad():
                (layers.embedding_lookup(leaf, ids, fixed_order=True) * up).sum().backward()
            assert _lib.launches["rows_scatter_add"] == before + 1
            seen.add(leaf.grad.cpu().numpy().tobytes())
        assert len(seen) == 1
        want = rsa.rows_scatter_add_reference(ids, up, 100)
        if exact:
            assert torch.equal(leaf.grad, want)
        else:
            _assert_close(leaf.grad, want, 1e-5, 1e-5 * float(want.abs().max()))


def _write_case(pack, n_logical, vocab, seed, dev):
    """A lazy-Adam write-back stream for a packed [vocab / P, 128] table:
    sorted logical ids with duplicates, merged into physical rows."""
    d = 128 // pack
    r = np.random.default_rng(seed)
    ids = np.sort(r.integers(0, vocab, n_logical))
    s = torch.from_numpy(ids).to(dev)
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), s[1:] == s[:-1]])
    rows = _randn(seed + 1, n_logical, d, dev=dev)
    pids, bits, vals = rw.merge_lane_blocks(s, dup, rows, pack)
    dst = _randn(seed + 2, vocab // pack, 128, dev=dev)
    return dst, pids, bits, vals, d


@pytest.mark.parametrize("pack,n,vocab", [(2, 135168, 1 << 20), (4, 4096, 4096), (2, 50_000, 4096)])
def test_rows_write_kernel_matches_plain(dev, pack, n, vocab):
    """B19 in place against its plain version, exactly: P = 2 and 4, sparse
    and dense id sets (many slots sharing each physical row)."""
    dst, pids, bits, vals, d = _write_case(pack, n, vocab, pack + n, dev)
    want = rw.rows_write_reference(dst.clone(), pids, bits, vals, d)
    got = dst.clone()
    before = _lib.launches["rows_write"]
    assert rw.rows_write(got, pids, bits, vals, d) is got
    assert _lib.launches["rows_write"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("pack,n,vocab", [(2, 135168, 1 << 20), (4, 4096, 4096), (2, 50_000, 4096)])
def test_rows_write_many_matches_three_plain_writes(dev, pack, n, vocab):
    """B19 writing a table and two moments under one plan in one launch,
    exactly as three rows_write_reference calls; the plan's own int64 ids."""
    dst, pids, bits, vals, d = _write_case(pack, n, vocab, pack + n, dev)
    assert pids.dtype == torch.int64 and bits.dtype == torch.int32
    dsts = [dst, _randn(pack + n + 3, *dst.shape, dev=dev), _randn(pack + n + 4, *dst.shape, dev=dev)]
    vals3 = [vals, vals * 0.5 + 1.0, _randn(pack + n + 5, *vals.shape, dev=dev)]
    want = [rw.rows_write_reference(a.clone(), pids, bits, v, d) for a, v in zip(dsts, vals3)]
    got = [a.clone() for a in dsts]
    before = _lib.launches["rows_write"]
    out = rw.rows_write_many(got, pids, bits, vals3, d)
    assert _lib.launches["rows_write"] == before + 1
    assert all(o is g for o, g in zip(out, got))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_arrays", [2, 3])
def test_rows_write_many_dead_slots_and_nan(dev, n_arrays):
    """Dead slots (bits 0, ids past the table or below 0) write nothing in
    any array; NaN in a live lane's old or new value comes out NaN in that
    array only; one launch."""
    dsts = [_randn(30 + j, 200, 128, dev=dev) for j in range(n_arrays)]
    dsts[0][5, 3] = float("nan")
    dsts[-1][60, 100] = float("nan")  # a dead lane: kept
    ids = torch.tensor([5, 5, 60, (1 << 31) - 1, -1, 1 << 40], dtype=torch.int64, device=dev)
    bits = torch.tensor([1, 0, 1, 1, 1, 3], dtype=torch.int32, device=dev)
    vals = [_randn(40 + j, 6, 128, dev=dev) for j in range(n_arrays)]
    vals[1][2, 7] = float("nan")
    want = [rw.rows_write_reference(a.clone(), ids, bits, v, 64) for a, v in zip(dsts, vals)]
    before = _lib.launches["rows_write"]
    got = rw.rows_write_many([a.clone() for a in dsts], ids, bits, vals, 64)
    assert _lib.launches["rows_write"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g[~w.isnan()], w[~w.isnan()])
    assert bool(got[0][5, 3].isnan() & got[1][60, 7].isnan() & got[-1][60, 100].isnan())
    none = rw.rows_write_many([a.clone() for a in dsts], ids, torch.zeros_like(bits), vals, 64)
    assert all(torch.equal(g.nan_to_num(7.0), a.nan_to_num(7.0)) for g, a in zip(none, dsts))


def test_rows_write_kernel_dead_slots_and_no_updates(dev):
    dst = _randn(17, 200, 128, dev=dev)
    big = (1 << 31) - 1
    ids = torch.tensor([5, 5, 60, big, -1], dtype=torch.int32, device=dev)
    bits = torch.tensor([1, 0, 3, 1, 1], dtype=torch.int32, device=dev)
    vals = torch.ones(5, 128, device=dev)
    got = rw.rows_write(dst.clone(), ids, bits, vals, 64)
    assert torch.equal(got, rw.rows_write_reference(dst.clone(), ids, bits, vals, 64))
    assert torch.equal(got[5, :64], torch.ones(64, device=dev)) and torch.equal(got[5, 64:], dst[5, 64:])
    none = rw.rows_write(dst.clone(), ids, torch.zeros_like(bits), vals, 64)
    assert torch.equal(none, dst)


def test_rows_write_kernel_propagates_nan_in_live_lanes(dev):
    """A NaN in a live lane's new value, and in an old value under a live
    lane, comes out NaN as in the blend old * (1 - m) + new * m."""
    dst = _randn(18, 64, 128, dev=dev)
    dst[3, 5] = float("nan")  # live lane of slot 0: old NaN * 0 is NaN
    dst[9, 100] = float("nan")  # dead lane of slot 1: kept as it is
    ids = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    bits = torch.tensor([0b01, 0b01], dtype=torch.int32, device=dev)
    vals = _randn(19, 2, 128, dev=dev)
    vals[1, 7] = float("nan")
    got = rw.rows_write(dst.clone(), ids, bits, vals, 64)
    want = rw.rows_write_reference(dst.clone(), ids, bits, vals, 64)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[3, 5].isnan()) and bool(got[9, 7].isnan()) and bool(got[9, 100].isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])


def _mha_case(b, h, d, nh, dtype, dev, seed, lens_kind):
    """One attention layer's input, lengths (None, a mix covering H and 1,
    or 1 everywhere), weights with non-zero biases and a cotangent on every
    row."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    lim_in, lim_out = math.sqrt(6.0 / (4 * d)), math.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).to(dtype)
    w = (t(r.uniform(-lim_in, lim_in, (d, 3 * d))), t(r.uniform(-0.1, 0.1, 3 * d)),
         t(r.uniform(-lim_out, lim_out, (d, d))), t(r.uniform(-0.1, 0.1, d)))
    lens = {"none": None, "mix": r.integers(1, h + 1, size=b), "ones": np.ones(b)}[lens_kind]
    if lens_kind == "mix":
        lens[: min(b, 2)] = [h, 1][: min(b, 2)]
    lens = None if lens is None else torch.from_numpy(lens.astype(np.int32)).to(dev)
    g = t(r.normal(size=(b, h, d)) * 0.1).to(dtype)
    return x, lens, w, g


def _mha_close(got, want, kind):
    """f32 at 1e-4 of the scale; bf16 y within one bf16 step; bf16 dx within
    one step but where a rounding flipped upstream (at most 0.5% of the
    values, each within 1e-2 of the scale); the f32 weight grads of bf16
    inputs at 3e-3 of their scale."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        _scaled_close(got, want, 3e-3 if kind == "grad_bf16" else 1e-4)
    elif kind == "y":
        assert _bf16_ulps(got, want) <= 1
    else:
        assert float((_bf16_steps(got, want) > 1).float().mean()) <= 5e-3
        _scaled_close(got, want, 1e-2)


# B = 1; B not a multiple of the examples per block (which come from B and
# the SM count); H = 1 and H = 10; one head; D = 128 with 8 heads (the
# weights then stay in device memory); H = 40, above a warp's 32 lanes.
# In bf16 those take B13's tensor-core kernel (H = 1, 10, 12 and 40 padded
# to 16, 16, 16 and 48 rows), as does H = 64, its longest; the last two
# take its FMA kernel (head width 8; H = 72, above the tensor-core
# kernel's 64)
_MHA_SHAPES = [
    (1, 32, 64, 4, "mix"), (1001, 32, 64, 4, "mix"), (333, 10, 64, 1, "none"),
    (37, 1, 64, 4, "none"), (64, 12, 32, 2, "ones"), (19, 16, 128, 8, "mix"),
    (9, 40, 64, 4, "none"), (5, 64, 64, 4, "mix"), (21, 24, 32, 4, "mix"),
    (7, 72, 32, 2, "mix"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,lens_kind", _MHA_SHAPES)
def test_mha_fwd_kernel_matches_plain(dev, dtype, b, h, d, nh, lens_kind):
    """B13 against its plain version: every row of y [B, H, D].  The FMA
    kernel (``mha_fwd_kernel``), launched at every shape through its
    launcher, sums in the plain version's order: bf16 y within one step.
    ``fused_mha_fwd`` takes the tensor cores for bf16 with a head width of
    16 or more, D a multiple of 32 and H <= 64 (the test asserts which
    route it took), the FMA kernel otherwise.  The tensor cores sum in f32
    in their own order, so a bf16 rounding upstream of y (q, k, v, p, the
    attention output) can flip: their y is held as dx is.  x padded with
    zero rows to Hp = round_up(H, 16), lengths clipped to H, gives the same
    rows < H bit for bit (the padded rows and keys of the kernel's tiles).
    Against the layer with f64 sums y has at most 1.5 times as many values
    beyond one step as the plain version has.  That count comes in clumps
    (one flipped rounding moves a whole row of y), so it is taken on 2^23
    values of the same H, D, heads and kind of lengths, at least B rows."""
    x, lens, w, _ = _mha_case(b, h, d, nh, dtype, dev, b + h, lens_kind)
    tc = dtype == torch.bfloat16 and h <= 64 and d % 32 == 0 and (d // nh) % 16 == 0
    before = dict(_lib.launches)
    got = fm.fused_mha_fwd(x, lens, *w, nh)
    assert _lib.launches["fused_mha_fwd"] == before.get("fused_mha_fwd", 0) + 1
    assert _lib.launches["fused_mha_fwd_tc"] == before.get("fused_mha_fwd_tc", 0) + tc
    plain = fm.fused_mha_layer_plain(x, lens, *w, nh)
    _mha_close(fm._launch_fwd_fma(*fm._fwd_inputs(x, lens, *w), nh), plain, "y")
    if not tc:
        _mha_close(got, plain, "y")
        return
    _mha_close(got, plain, "dx")
    hp = -(-h // 16) * 16
    if hp != h:
        xp = torch.zeros(b, hp, d, dtype=dtype, device=dev)
        xp[:, :h] = x
        lp = torch.full((b,), h, dtype=torch.int32, device=dev) if lens is None else lens
        assert torch.equal(fm.fused_mha_fwd(xp, lp, *w, nh)[:, :h], got)
    x, lens, w, _ = _mha_case(max(b, -(-(1 << 23) // (h * d))), h, d, nh, dtype, dev, b + h,
                              lens_kind)
    ref = fm.fused_mha_layer_f64_sums(x, lens, *w, nh)
    far = [int((_bf16_steps(t, ref) > 1).sum())
           for t in (fm.fused_mha_fwd(x, lens, *w, nh), fm.fused_mha_layer_plain(x, lens, *w, nh))]
    assert far[0] <= 1.5 * far[1], far


@pytest.mark.parametrize("lens_kind", ["none", "mix"])
@pytest.mark.parametrize("b", [1024, 4096])
def test_mha_fwd_tc_kernel_at_the_cells(dev, b, lens_kind):
    """B13's tensor-core kernel at the per-layer cells' shape (H = 32, D =
    64, 4 heads, bf16; the serving and the training batch): held against
    the plain version as dx is (``test_mha_fwd_kernel_matches_plain``);
    against the layer with f64 sums, no more values beyond one bf16 step
    than 1.5 times the plain version's own (both sum in f32, each in its
    order; 0.9-1.0 times on an H100); bit-equal on repeat; x and
    the weights at addresses that are not 16-byte aligned give the same y."""
    x, lens, w, _ = _mha_case(b, 32, 64, 4, torch.bfloat16, dev, b + 5, lens_kind)
    before = _lib.launches["fused_mha_fwd_tc"]
    got = fm.fused_mha_fwd(x, lens, *w, 4)
    again = fm.fused_mha_fwd(x, lens, *w, 4)
    assert _lib.launches["fused_mha_fwd_tc"] == before + 2
    plain = fm.fused_mha_layer_plain(x, lens, *w, 4)
    _mha_close(got, plain, "dx")
    ref = fm.fused_mha_layer_f64_sums(x, lens, *w, 4)
    far = [int((_bf16_steps(t, ref) > 1).sum()) for t in (got, plain)]
    assert far[0] <= 1.5 * far[1]
    assert torch.equal(got, again)
    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    xo, wio, woo = odd(x), odd(w[0]), odd(w[2])
    assert all(t.data_ptr() % 16 for t in (xo, wio, woo))
    assert torch.equal(fm.fused_mha_fwd(xo, lens, wio, w[1], woo, w[3], 4), got)


def _mha_bwd_vs_f64(got, want, ref, grads_vs_plain: bool = True):
    """The tensor-core B14 ``got`` against the f64-sum backward ``ref``: dx
    no more values beyond one bf16 step than 1.5 times the plain ``want``'s;
    each weight grad's RMS error relative to its scale at most 1.5 times
    the plain version's, or 1e-6, whichever is larger; without
    ``grads_vs_plain``, at most 1e-5 whatever the plain version's."""
    far = [int((_bf16_steps(t[0], ref[0]) > 1).sum()) for t in (got, want)]
    rms = [[float((a.double() - e).pow(2).mean().sqrt() / e.abs().max().clamp_min(1e-300))
            for a, e in zip(t[1:], ref[1:])] for t in (got, want)]
    assert far[0] <= 1.5 * far[1], far
    if grads_vs_plain:
        assert all(k <= max(1.5 * p, 1e-6) for k, p in zip(*rms)), rms
    else:
        assert all(k <= 1e-5 for k in rms[0]), rms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,lens_kind", _MHA_SHAPES)
def test_mha_bwd_kernel_matches_plain(dev, dtype, b, h, d, nh, lens_kind):
    """B14 and its reduce against the plain version: dx and the four
    weight grads.  The FMA kernel (``mha_bwd_kernel``), launched at every
    shape through its launcher, and ``fused_mha_bwd``, which takes the
    tensor cores for bf16 with D 32 or 64, a head width of 16 or more and
    H <= 64 (the test asserts which route it took), the FMA kernel
    otherwise.  On the tensor cores x and g padded with zero rows to Hp =
    round_up(H, 16), lengths clipped to H, give the same dx rows < H and
    grads bit for bit (the same tiles), and against the backward with f64
    sums (``_mha_bwd_vs_f64``, on 2^23 values of the same H, D, heads and
    kind of lengths, at least B rows: the counts come in clumps) dx and the
    grads are no further than 1.5 times the plain version.  The grads' part
    is not taken where every length is 1: every query row's output is then
    v at key 0, so the grads' error from f64 sums is a handful of roundings
    of v that flip, in the kernel's projection sums or in the plain
    version's, and its ratio swings either way from seed to seed
    (``scripts/torch_mha_bwd_f64.py``); dx's count stays, and the grads
    are held to an RMS error of 1e-5 of their scale (7e-8 to 6e-6 on an
    H100 over nine seeds at three shapes)."""
    x, lens, w, g = _mha_case(b, h, d, nh, dtype, dev, b + h + 1, lens_kind)
    tc = fm._bwd_route(dtype, h, d, nh) == "tc"
    assert tc == (dtype == torch.bfloat16 and d in (32, 64) and (d // nh) % 16 == 0 and h <= 64)
    before = dict(_lib.launches)
    got = fm.fused_mha_bwd(g, x, lens, *w, nh)
    for name in ("fused_mha_bwd", "fused_mha_bwd_reduce"):
        assert _lib.launches[name] == before.get(name, 0) + 1
    assert _lib.launches["fused_mha_bwd_tc"] == before.get("fused_mha_bwd_tc", 0) + tc
    want = fm.fused_mha_layer_bwd_plain(g, x, lens, *w, nh)
    kind = "grad" if dtype == torch.float32 else "grad_bf16"
    dx, grads = fm._launch_bwd_fma(*fm._bwd_inputs(g, x, lens, *w[:3]), nh)
    for t in (got, (dx, *torch.split(grads, [d * 3 * d, 3 * d, d * d, d]))):
        _mha_close(t[0], want[0], "dx")
        for a, e in zip(t[1:], want[1:]):
            _mha_close(a.reshape(e.shape), e, kind)
    if not tc:
        return
    hp = -(-h // 16) * 16
    if hp != h:
        xp, gp = (torch.zeros(b, hp, d, dtype=dtype, device=dev) for _ in range(2))
        xp[:, :h], gp[:, :h] = x, g
        lp = torch.full((b,), h, dtype=torch.int32, device=dev) if lens is None else lens
        padded = fm.fused_mha_bwd(gp, xp, lp, *w, nh)
        assert torch.equal(padded[0][:, :h], got[0])
        assert all(torch.equal(a, e) for a, e in zip(padded[1:], got[1:]))
    x, lens, w, g = _mha_case(max(b, -(-(1 << 23) // (h * d))), h, d, nh, dtype, dev, b + h + 1,
                              lens_kind)
    _mha_bwd_vs_f64(fm.fused_mha_bwd(g, x, lens, *w, nh),
                    fm.fused_mha_layer_bwd_plain(g, x, lens, *w, nh),
                    fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, nh), lens_kind != "ones")


@pytest.mark.parametrize("lens_kind", ["none", "mix"])
@pytest.mark.parametrize("b", [1024, 4096])
def test_mha_bwd_tc_kernel_at_the_cells(dev, b, lens_kind):
    """B14's tensor-core kernel at the per-layer cells' shape (H = 32, D =
    64, 4 heads, bf16): held against the plain version as
    ``test_mha_bwd_kernel_matches_plain`` holds it; against the backward
    with f64 sums on 2^23 values (``_mha_bwd_vs_f64``); bit-equal on
    repeat; the examples padded with zero rows to H = 48 (the next 16-row
    band, lengths clipped to 32) give the same dx rows bit for bit and the
    same grads within 1e-5 of scale (the tiles, so the order of the grad
    sums, change); x, g and the weights at addresses that are not 16-byte
    aligned give the same results."""
    x, lens, w, g = _mha_case(b, 32, 64, 4, torch.bfloat16, dev, b + 6, lens_kind)
    before = _lib.launches["fused_mha_bwd_tc"]
    got = fm.fused_mha_bwd(g, x, lens, *w, 4)
    again = fm.fused_mha_bwd(g, x, lens, *w, 4)
    assert _lib.launches["fused_mha_bwd_tc"] == before + 2
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = fm.fused_mha_layer_bwd_plain(g, x, lens, *w, 4)
    _mha_close(got[0], want[0], "dx")
    for a, e in zip(got[1:], want[1:]):
        _mha_close(a, e, "grad_bf16")
    xp, gp = (torch.zeros(b, 48, 64, dtype=torch.bfloat16, device=dev) for _ in range(2))
    xp[:, :32], gp[:, :32] = x, g
    lp = torch.full((b,), 32, dtype=torch.int32, device=dev) if lens is None else lens
    padded = fm.fused_mha_bwd(gp, xp, lp, *w, 4)
    assert torch.equal(padded[0][:, :32], got[0])
    for a, e in zip(padded[1:], got[1:]):
        _scaled_close(a, e, 1e-5)

    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    go, xo, wio, woo = odd(g), odd(x), odd(w[0]), odd(w[2])
    assert all(t.data_ptr() % 16 for t in (go, xo, wio, woo))
    assert all(torch.equal(a, e)
               for a, e in zip(fm.fused_mha_bwd(go, xo, lens, wio, w[1], woo, w[3], 4), got))
    if b == 4096:
        _mha_bwd_vs_f64(got, want, fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, 4))
    else:
        x, lens, w, g = _mha_case(4096, 32, 64, 4, torch.bfloat16, dev, b + 6, lens_kind)
        _mha_bwd_vs_f64(fm.fused_mha_bwd(g, x, lens, *w, 4),
                        fm.fused_mha_layer_bwd_plain(g, x, lens, *w, 4),
                        fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, 4))


def test_mha_bwd_is_deterministic(dev):
    """Two runs of B14 on the same inputs give bit-equal dx and weight
    grads: the per-block partials are summed in block order, no atomics."""
    x, lens, w, g = _mha_case(4096, 32, 64, 4, torch.bfloat16, dev, 7, "mix")
    runs = [fm.fused_mha_bwd(g, x, lens, *w, 4) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mha_autograd_matches_plain_route(dev, dtype):
    """fused_mha_layer with grad wanted on the card (B13 then B14 and its
    reduce) gives the output and grads of the plain route on the CPU.  The
    CPU's exp is not the card's, so a bf16 rounding of p can flip between
    the two and carry into y: y is held as dx is (``_mha_close``)."""
    x, lens, w, g = _mha_case(129, 32, 64, 4, dtype, dev, 8, "mix")
    outs = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).clone().requires_grad_() for t in (x, *w)]
        before = dict(_lib.launches)
        y = fm.fused_mha_layer(*leaves, 4, lengths=lens.to(device))
        y.backward(g.to(device))
        if device.type == "cuda":
            for name in ("fused_mha_fwd", "fused_mha_bwd", "fused_mha_bwd_reduce"):
                assert _lib.launches[name] == before.get(name, 0) + 1
        outs.append([y.detach().cpu(), *(t.grad.cpu() for t in leaves)])
    (yk, *gk), (yp, *gp) = outs
    _mha_close(yk, yp, "dx")
    _mha_close(gk[0], gp[0], "dx")
    for a, e in zip(gk[1:], gp[1:]):
        _mha_close(a, e, "grad" if dtype == torch.float32 else "grad_bf16")


def test_layer_tier_launches_only_b13_and_b14(dev):
    """history_encoder_apply on the per-layer tier, forward and backward:
    one B13 and one B14 (with its reduce) per layer, none of B1 and B5-B9;
    under inference_mode B13 alone, with and without lengths."""

    cfg = HistoryEncoderConfig(num_heads=4, num_layers=3, fused_kernel=True, fused_encoder=False)
    enc = he.HistoryEncoder(64, cfg, device=dev)
    enc.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    x = _randn(9, 16, 32, 64, dev=dev)
    lens = torch.randint(1, 33, (16,), device=dev)
    others = ["fused_history_encoder", "fused_history_encoder_res", "fused_history_encoder_bwd",
              "fused_history_encoder_bwd_recompute", "fused_attn_stack", "fused_attn_stack_bwd"]
    for lengths in (None, lens):
        _lib.reset_launch_counts()
        y = he.history_encoder_apply(enc, x.clone().requires_grad_(), cfg, torch.bfloat16, lengths)
        y.sum().backward()
        with torch.inference_mode():
            he.history_encoder_apply(enc, x, cfg, torch.bfloat16, lengths)
        counts = dict(_lib.launches)
        assert counts.get("fused_mha_fwd") == 6 and counts.get("fused_mha_bwd") == 3
        assert counts.get("fused_mha_fwd_tc") == 6  # every B13 on the tensor cores
        assert counts.get("fused_mha_bwd_reduce") == 3
        assert counts.get("fused_mha_bwd_tc") == 3  # every B14 on the tensor cores
        assert not any(counts.get(n) for n in others)


def test_mha_wrappers_reject_what_the_kernels_do_not_take(dev):
    """A layer whose working set does not fit in shared memory, an f16
    input, and weights of the wrong shape raise; nothing falls back."""
    x, _, w, g = _mha_case(2, 256, 64, 4, torch.bfloat16, dev, 9, "none")
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mha_fwd(x, None, *w, 4)
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mha_bwd(g, x, None, *w, 4)
    x, _, w, g = _mha_case(2, 8, 64, 4, torch.float32, dev, 10, "none")
    with pytest.raises(TypeError):
        fm.fused_mha_fwd(x.half(), None, *w, 4)
    with pytest.raises(ValueError, match="shapes"):
        fm.fused_mha_fwd(x, None, w[0][:, :96], *w[1:], 4)


def _attn_case(n, h, dh, dev, seed, lens_kind, mag=1.0):
    """q, k, v, a cotangent [N, H, Dh] f32 and lengths int32 [N] (all H,
    uniform with 1 and H among them, or all 1)."""
    r = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy((r.normal(size=(n, h, dh)) * s).astype(np.float32)).to(dev)
                  for s in (mag, mag, 1.0, 1.0))
    lens = {"full": np.full(n, h), "mix": r.integers(1, h + 1, size=n), "ones": np.ones(n)}[lens_kind]
    if lens_kind == "mix":
        lens[: min(n, 2)] = [h, 1][: min(n, 2)]
    return q, k, v, g, torch.from_numpy(lens.astype(np.int32)).to(dev)


def _attn_bwd_inputs(q, k, v, g, lens):
    out, lse = ha.blockwise_attn_fwd_plain(q, k, v, lens)
    return (q, k, v, g, lse, (g * out).sum(-1), lens)


# the flagship fold (N = B * 4 heads, H = 32, Dh = 16); H = 1; H = 33 and
# 200, not multiples of a warp's 32 rows; several tiles (384); Dh 32 and 64
_ATTN_SHAPES = [
    (4096, 32, 16, "mix"), (37, 1, 16, "full"), (9, 33, 16, "mix"), (3, 200, 32, "mix"),
    (2, 384, 64, "mix"), (5, 64, 64, "ones"), (6, 130, 16, "full"),
]


@pytest.mark.parametrize("n,h,dh,lens_kind", _ATTN_SHAPES)
def test_blockwise_attn_fwd_kernel_matches_plain(dev, n, h, dh, lens_kind):
    """B15 against its plain version: out on every row (rows past a length
    too) and the lse, f32 sums in another order (rtol 1e-4, atol 1e-5, the
    JAX package's tolerance for the blockwise kernel)."""
    q, k, v, _, lens = _attn_case(n, h, dh, dev, n + h, lens_kind)
    before = _lib.launches["blockwise_attn_fwd"]
    before_tc = _lib.launches["blockwise_attn_fwd_tc"]
    out, lse = ha.blockwise_attn_fwd(q, k, v, lens)
    assert _lib.launches["blockwise_attn_fwd"] == before + 1
    assert _lib.launches["blockwise_attn_fwd_tc"] == before_tc + (ha._fwd_route(h) == "tc")
    want_out, want_lse = ha.blockwise_attn_fwd_plain(q, k, v, lens)
    _assert_close(out, want_out, 1e-4, 1e-5)
    _assert_close(lse, want_lse, 1e-4, 1e-5)


@pytest.mark.parametrize("n,h,dh,lens_kind", _ATTN_SHAPES)
def test_blockwise_attn_bwd_kernels_match_plain(dev, n, h, dh, lens_kind):
    """B16 and B17 against the plain backward, within 1e-4 of each grad's
    scale, or of the size of one term |do| |v| where the exact grad is 0
    (H = 1: one key takes all the probability, so dq = dk = 0); masked keys
    get dk = dv = 0 exactly."""
    args = _attn_bwd_inputs(*_attn_case(n, h, dh, dev, n + h + 1, lens_kind))
    dq = ha.blockwise_attn_dq(*args)
    dk, dv = ha.blockwise_attn_dkv(*args)
    term = float(args[3].abs().max() * args[2].abs().max())
    for got, want in zip((dq, dk, dv), ha.blockwise_attn_bwd_plain(*args)):
        _scaled_close(got, want, 1e-4, floor=term)
    masked = torch.arange(h, device=dev)[None, :] >= args[-1][:, None]
    assert bool((dk[masked] == 0).all()) and bool((dv[masked] == 0).all())


@pytest.mark.parametrize("n,h,dh,lens_kind", _ATTN_SHAPES + [(4, 4096, 16, "full"),
                                                              (4, 4096, 16, "mix")])
def test_blockwise_attn_fwd_tc_route_alone(dev, n, h, dh, lens_kind):
    """B15 on the tensor cores and on the FMA kernel, each forced by
    ``_route``, against the plain version (rtol 1e-4, atol 1e-5), out on
    every row and the lse, at the edge shapes and the long history (N = 4,
    H = 4096); one launch counted on each route, the tensor-core one also
    as ``_tc``; bit-equal on repeat."""
    q, k, v, _, lens = _attn_case(n, h, dh, dev, n + h + 2, lens_kind)
    want = ha.blockwise_attn_fwd_plain(q, k, v, lens)
    for route in ("tc", "fma"):
        before = dict(_lib.launches)
        got = ha.blockwise_attn_fwd(q, k, v, lens, _route=route)
        assert _lib.launches["blockwise_attn_fwd"] == before.get("blockwise_attn_fwd", 0) + 1
        tc_count = _lib.launches["blockwise_attn_fwd_tc"] - before.get("blockwise_attn_fwd_tc", 0)
        assert tc_count == (route == "tc")
        for a, e in zip(got, want):
            _assert_close(a, e, 1e-4, 1e-5)
        again = ha.blockwise_attn_fwd(q, k, v, lens, _route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_blockwise_attn_kernels_at_unaligned_addresses(dev):
    """B15 (both routes), B16 and B17 on copies of their inputs at an
    address 4 bytes past a 16-byte boundary give the aligned inputs' bits
    (the wrappers copy such inputs; the kernels read 16 bytes at a time)."""
    q, k, v, g, lens = _attn_case(9, 40, 32, dev, 14, "mix")

    def odd(t):  # a copy at an address 16-byte aligned no more
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    for route in ("tc", "fma"):
        want = ha.blockwise_attn_fwd(q, k, v, lens, _route=route)
        qo, ko, vo = odd(q), odd(k), odd(v)
        assert all(t.data_ptr() % 16 for t in (qo, ko, vo))
        got = ha.blockwise_attn_fwd(qo, ko, vo, lens, _route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = _attn_bwd_inputs(q, k, v, g, lens)
    odd_args = (*map(odd, args[:-1]), lens)
    assert all(t.data_ptr() % 16 for t in odd_args[:-1])
    assert torch.equal(ha.blockwise_attn_dq(*odd_args), ha.blockwise_attn_dq(*args))
    for a, b in zip(ha.blockwise_attn_dkv(*odd_args), ha.blockwise_attn_dkv(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,dh", [(128, 16), (256, 64)])
@pytest.mark.parametrize("where", ["query", "key"])
def test_blockwise_attn_fwd_nan_like_plain(dev, h, dh, where):
    """B15 on both routes with the card's NaN (0x7fffffff, what every f32
    operation that makes a NaN gives here) in one query row, or in one
    valid key and in one key past its length: NaN in out and lse exactly
    where the plain version has it, the other values within rtol 1e-4,
    atol 1e-5.  (The tensor-core kernel's split reads this NaN as zeros, so
    its guard must send such a tile to the FMA chain.)"""
    q, k, v, _, lens = _attn_case(3, h, dh, dev, 23, "mix")  # lens[0] = H, lens[1] = 1
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32, device=dev).view(torch.float32)[0]
    if where == "query":
        q[2, 5, 3] = nan
    else:
        k[0, 70, 3] = nan  # valid
        k[1, 100, 0] = nan  # past the length: not read
    want = ha.blockwise_attn_fwd_plain(q, k, v, lens)
    for route in ("tc", "fma"):
        got = ha.blockwise_attn_fwd(q, k, v, lens, _route=route)
        for a, e in zip(got, want):
            assert bool(e.isnan().any())
            assert torch.equal(a.isnan(), e.isnan())
            _assert_close(torch.nan_to_num(a, 0.0), torch.nan_to_num(e, 0.0), 1e-4, 1e-5)


def _bwd_route_checks(args, want, rows, tol):
    """B16 and B17 on both routes, forced, on ``args``: the first ``rows``
    leading indices within ``tol`` of each grad's scale (or of one |do| |v|
    term) of ``want``, masked keys' dk and dv exactly 0, bit-equal on
    repeat, one launch counted on each route and the tensor-core one also
    as ``_tc``."""
    g, v, lens = args[3][:rows], args[2][:rows], args[-1][:rows]
    term = float(g.abs().max() * v.abs().max())
    masked = torch.arange(args[0].shape[1], device=lens.device)[None, :] >= lens[:, None]
    for route in ("tc", "fma"):
        before = dict(_lib.launches)
        got = (ha.blockwise_attn_dq(*args, _route=route), *ha.blockwise_attn_dkv(*args, _route=route))
        for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
            assert _lib.launches[name] == before.get(name, 0) + 1
            assert _lib.launches[name + "_tc"] - before.get(name + "_tc", 0) == (route == "tc")
        for a, e in zip(got, want):
            _scaled_close(a[:rows], e, tol, floor=term)
        assert bool((got[1][:rows][masked] == 0).all()) and bool((got[2][:rows][masked] == 0).all())
        again = (ha.blockwise_attn_dq(*args, _route=route), *ha.blockwise_attn_dkv(*args, _route=route))
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,h,dh,lens_kind", _ATTN_SHAPES + [(4, 4096, 16, "full"),
                                                              (4, 4096, 16, "mix")])
def test_blockwise_attn_bwd_routes_alone(dev, n, h, dh, lens_kind):
    """B16 and B17 on the tensor cores and on the FMA kernels, each forced
    by ``_route``, against the plain backward within 1e-4 of each grad's
    scale at the edge shapes and the long history (N = 4, H = 4096);
    masked keys' dk = dv = 0 exactly; bit-equal on repeat; one launch
    counted on each route, the tensor-core one also as ``_tc``."""
    args = _attn_bwd_inputs(*_attn_case(n, h, dh, dev, n + h + 3, lens_kind))
    _bwd_route_checks(args, ha.blockwise_attn_bwd_plain(*args), n, 1e-4)


@pytest.mark.parametrize("lens_kind", ["full", "mix"])
def test_blockwise_attn_bwd_routes_at_the_long_training_batch(dev, lens_kind):
    """N = 1024, H = 4096 (the long-history training batch's fold): both
    routes on all of it, held against the plain backward of the first four
    leading indices (the plain version of all would take 64 GiB) within
    1e-4 of scale, as test_blockwise_attn_bwd_routes_alone."""
    q, k, v, g, lens = _attn_case(1024, 4096, 16, dev, 31, lens_kind)
    out, lse = ha.blockwise_attn_fwd(q, k, v, lens)
    args = (q, k, v, g, lse, (g * out).sum(-1), lens)
    del out
    _bwd_route_checks(args, ha.blockwise_attn_bwd_plain(*(t[:4] for t in args)), 4, 1e-4)


def test_blockwise_attn_bwd_routes_at_extreme_scores(dev):
    """q and k at 30 sigma (scores of some thousands; the tensor cores'
    guard sends every tile to the plain version's FMA chain): both routes
    finite and within 1e-3 of each grad's scale of the plain backward."""
    args = _attn_bwd_inputs(*_attn_case(64, 256, 16, dev, 11, "mix", mag=30.0))
    want = ha.blockwise_attn_bwd_plain(*args)
    for route in ("tc", "fma"):
        got = (ha.blockwise_attn_dq(*args, _route=route), *ha.blockwise_attn_dkv(*args, _route=route))
        for a, e in zip(got, want):
            assert bool(a.isfinite().all())
            _scaled_close(a, e, 1e-3)


@pytest.mark.parametrize("h,dh", [(128, 16), (256, 64)])
@pytest.mark.parametrize("where", ["query", "key"])
def test_blockwise_attn_bwd_nan_like_plain(dev, h, dh, where):
    """B16 and B17 on both routes with the card's NaN in one query row or
    in one valid key (the lse and delta from the plain forward): NaN in dq,
    dk and dv exactly where the plain backward has it (its masked keys'
    dk and dv taken as the kernels' exact zeros), the other values within
    1e-4 of scale."""
    q, k, v, g, lens = _attn_case(3, h, dh, dev, 24, "mix")  # lens[0] = H, lens[1] = 1
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32, device=dev).view(torch.float32)[0]
    if where == "query":
        q[2, 5, 3] = nan
    else:
        k[0, 70, 3] = nan  # valid
    args = _attn_bwd_inputs(q, k, v, g, lens)
    masked = (torch.arange(h, device=dev)[None, :] >= lens[:, None])[..., None]
    want = [torch.where(masked, 0.0, e) if i else e
            for i, e in enumerate(ha.blockwise_attn_bwd_plain(*args))]
    for route in ("tc", "fma"):
        got = (ha.blockwise_attn_dq(*args, _route=route), *ha.blockwise_attn_dkv(*args, _route=route))
        for a, e in zip(got, want):
            assert bool(e.isnan().any())
            assert torch.equal(a.isnan(), e.isnan())
            _scaled_close(torch.nan_to_num(a, 0.0), torch.nan_to_num(e, 0.0), 1e-4)


def test_blockwise_attn_bwd_tc_at_unaligned_addresses(dev):
    """B16 and B17 on the tensor cores on copies of their inputs at an
    address 4 bytes past a 16-byte boundary give the aligned inputs'
    bits."""
    q, k, v, g, lens = _attn_case(9, 100, 32, dev, 15, "mix")

    def odd(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return o.copy_(t)

    args = _attn_bwd_inputs(q, k, v, g, lens)
    odd_args = (*map(odd, args[:-1]), lens)
    assert all(t.data_ptr() % 16 for t in odd_args[:-1])
    assert torch.equal(ha.blockwise_attn_dq(*odd_args, _route="tc"),
                       ha.blockwise_attn_dq(*args, _route="tc"))
    for a, b in zip(ha.blockwise_attn_dkv(*odd_args, _route="tc"),
                    ha.blockwise_attn_dkv(*args, _route="tc")):
        assert torch.equal(a, b)


def test_blockwise_attn_kernels_are_deterministic_and_stable(dev):
    """Two runs give bit-equal outputs and grads (no atomics); scores of
    some thousands (q and k at 30 sigma) stay finite, as the JAX package's
    extreme-score test asks, masked keys included (exp(s - lse) of a masked
    key overflows there)."""
    args = _attn_case(64, 256, 16, dev, 11, "mix", mag=30.0)
    q, k, v, g, lens = args
    before_tc = _lib.launches["blockwise_attn_fwd_tc"]
    runs = [(*ha.blockwise_attn_fwd(q, k, v, lens), ha.blockwise_attn_dq(*_attn_bwd_inputs(*args)),
             *ha.blockwise_attn_dkv(*_attn_bwd_inputs(*args))) for _ in range(2)]
    assert _lib.launches["blockwise_attn_fwd_tc"] == before_tc + 2 * (ha._fwd_route(256) == "tc")
    for a, b in zip(*runs):
        assert torch.equal(a, b) and bool(a.isfinite().all())
    _assert_close(runs[0][0], ha.blockwise_attn_fwd_plain(q, k, v, lens)[0], 1e-3, 1e-4)


def test_blockwise_autograd_matches_plain_route(dev):
    """blockwise_self_attention with grad wanted on the card (B15, then B16
    and B17) against the CPU route, bf16 inputs cast to f32 and back."""
    q, k, v, g, lens = _attn_case(50, 40, 32, dev, 12, "mix")
    outs = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).bfloat16().requires_grad_() for t in (q, k, v)]
        before = dict(_lib.launches)
        y = ha.blockwise_self_attention(*leaves, lengths=lens.to(device) + 5)  # clipped to H
        y.backward(g.to(device).bfloat16())
        if device.type == "cuda":
            for name in ("blockwise_attn_fwd", "blockwise_attn_dq", "blockwise_attn_dkv"):
                assert _lib.launches[name] == before.get(name, 0) + 1
        assert y.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in leaves)
        outs.append([y.detach().float().cpu(), *(t.grad.float().cpu() for t in leaves)])
    for a, e in zip(*outs):
        _scaled_close(a, e, 1e-2)  # one bf16 rounding of out and grads


def test_blockwise_tier_launches_b15_b16_b17(dev):
    """history_encoder_apply on the blockwise tier, forward and backward:
    one B15, B16 and B17 per layer, none of B1, B5-B9, B13, B14; under
    inference_mode B15 alone, with and without lengths."""
    cfg = HistoryEncoderConfig(num_heads=4, num_layers=3, blockwise_kernel=True,
                               fused_encoder=False)
    enc = he.HistoryEncoder(64, cfg, device=dev)
    enc.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    x = _randn(13, 16, 32, 64, dev=dev)
    lens = torch.randint(1, 33, (16,), device=dev)
    others = ["fused_history_encoder", "fused_history_encoder_res", "fused_history_encoder_bwd",
              "fused_history_encoder_bwd_recompute", "fused_attn_stack", "fused_attn_stack_bwd",
              "fused_mha_fwd", "fused_mha_bwd"]
    for lengths in (None, lens):
        _lib.reset_launch_counts()
        y = he.history_encoder_apply(enc, x.clone().requires_grad_(), cfg, torch.bfloat16, lengths)
        y.sum().backward()
        with torch.inference_mode():
            he.history_encoder_apply(enc, x, cfg, torch.bfloat16, lengths)
        counts = dict(_lib.launches)
        assert counts.get("blockwise_attn_fwd") == 6
        assert counts.get("blockwise_attn_fwd_tc", 0) == 6 * (ha._fwd_route(32) == "tc")
        assert counts.get("blockwise_attn_dq") == 3 and counts.get("blockwise_attn_dkv") == 3
        assert not any(counts.get(n) for n in others)


def test_blockwise_wrappers_reject_what_the_kernels_do_not_take(dev):
    """A head dim the kernels are not built for, bf16 tensors (the public
    function casts them; the wrappers do not) and lengths of the wrong
    type raise; nothing falls back."""
    q, k, v, _, lens = _attn_case(2, 8, 16, dev, 13, "mix")
    with pytest.raises(ValueError, match="Dh"):
        ha.blockwise_attn_fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                              v[..., :8].contiguous(), lens)
    with pytest.raises(TypeError):
        ha.blockwise_attn_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), lens)
    with pytest.raises(ValueError, match="lengths"):
        ha.blockwise_attn_fwd(q, k, v, lens.long())


@pytest.mark.parametrize("shape,p_dtype,g_dtype,offset", [
    ((1 << 16,), torch.float32, torch.float32, 0), ((1025, 130), torch.float32, torch.float32, 0),
    ((4099,), torch.float32, torch.float32, 1), ((777, 33), torch.bfloat16, torch.float32, 0),
    ((2048, 64), torch.float32, torch.bfloat16, 0), ((3, 5), torch.bfloat16, torch.bfloat16, 0),
])
def test_fused_adam_kernel_matches_plain_bit_for_bit(dev, shape, p_dtype, g_dtype, offset):
    """B20 against its plain version over three steps: p, m and v bit-equal
    (every operation rounded on its own on both sides).  Leaves that are
    not a multiple of 4 (the scalar tail), a leaf at an odd offset (no
    16-byte loads), a bf16 leaf and a bf16 gradient."""
    from two_tower_models_tpu_torch.ops import fused_adam as fa

    r = np.random.default_rng(sum(shape))
    numel = int(np.prod(shape))
    mk = lambda s, dt: torch.from_numpy((r.normal(size=numel + offset) * s).astype(np.float32)).to(
        dev).to(dt)[offset:].view(shape)
    p, m, v = mk(1.0, p_dtype), mk(1e-3, torch.float32), mk(1e-3, torch.float32).square()
    states = [[t.clone() for t in (p, m, v)] for _ in range(2)]
    for step in range(1, 4):
        g = mk(0.1, g_dtype)
        c = fa.bias_corrections(torch.tensor(step, dtype=torch.int32, device=dev))
        before = _lib.launches["fused_adam"]
        fa.fused_adam_leaf(*states[0], g, c, 1e-3)
        assert _lib.launches["fused_adam"] == before + 1
        fa.fused_adam_leaf_plain(*states[1], g, c, 1e-3)
        for a, b in zip(*states):
            assert torch.equal(a, b)


def test_tile_max_orders_non_finite_scores_like_plain(dev):
    """B2 on rows that score +-inf and NaN (+inf rows against a zeroed query
    column give 0 * inf; a -NaN row; a +NaN row): equal to its plain
    version bit for bit, and the pipeline's indices equal the dense top-k's
    (integer-grid inputs: every finite sum is exact)."""
    r = np.random.default_rng(14)
    b, c, d, k = 64, 1 << 16, 64, 100
    corpus = r.integers(-2, 3, size=(c, d)).astype(np.float32)
    query = r.integers(-2, 3, size=(b, d)).astype(np.float32)
    query[: b // 2, 0] = 0
    corpus[np.arange(0, 150) * 128 + 5, 0] = np.inf
    corpus[np.arange(150, 200) * 128 + 7, 1] = -np.inf
    corpus[3, 2], corpus[77_777 % c, 5] = -np.nan, np.nan
    cq, qq = torch.from_numpy(corpus).to(dev), torch.from_numpy(query).to(dev)
    got = mt.tile_max_scores(qq, cq, mt.TILE, c)
    want = mt.tile_max_scores_plain(qq, cq, mt.TILE, c)
    assert torch.equal(mt.f32_keys(got), mt.f32_keys(want))
    idx, _, _ = mips_topk(cq, qq, k)
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact

    got_idx, _, _ = mips_topk_exact(cq, qq, k)
    assert torch.equal(got_idx, idx)


# N1: B off the kernel's block of 64 or 128 queries (1, 100, 130), C not a
# multiple of M, M off its block of 64 bins (300, 1000), M = C, D in {16,
# 64, 128}, valid_count inside the corpus
_N1_SHAPES = [(100, 5000, 64, 256, None), (64, 4096, 16, 128, 3000), (130, 20000, 128, 2048, None),
              (1, 300, 64, 300, None), (65, 10000, 64, 1000, 9990), (200, 70000, 16, 8192, 60000)]
# the routed kernel (the tensor cores at these widths) and the FMA kernel forced
_N1_ROUTES = pytest.mark.parametrize("force", [None, "fma"], ids=["routed", "fma"])
_N1_ROWS = pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])


def _n1_inputs(seed, b, c, d, kind, dev):
    """Integer-grid queries and rows (int8 rows with per-row scales, some
    equal, so that bins tie across rows; bf16 rows the f32 grid, exact):
    every score exact."""
    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.integers(-2, 3, (b, d)).astype(np.float32)).to(dev)
    if kind != "int8":
        rows = _grid(seed + 1, c, d, dev=dev)
        return q, rows.to(torch.bfloat16) if kind == "bf16" else rows, None
    rows = torch.from_numpy(r.integers(-127, 128, (c, d)).astype(np.int8)).to(dev)
    scale = r.uniform(0.01, 0.1, c).astype(np.float32)
    scale[::7] = 0.5
    return q, rows, torch.from_numpy(scale).to(dev)


def _n1_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(mt.f32_keys(got[0]), mt.f32_keys(want[0]))


def _n1_scan(q, rows, m, valid, scale, force):
    """approx_scan with its launches checked: one N1 launch, on the
    tensor cores unless the FMA kernel was forced."""
    before = dict(_lib.launches)
    got = at.approx_scan(q, rows, m, valid, scale, force=force)
    assert _lib.launches["approx_scan"] == before.get("approx_scan", 0) + 1
    tc = _lib.launches["approx_scan_tc"] - before.get("approx_scan_tc", 0)
    assert tc == (0 if force == "fma" else 1)
    return got


@_N1_ROUTES
@_N1_ROWS
@pytest.mark.parametrize("b,c,d,m,valid", _N1_SHAPES)
def test_approx_scan_matches_plain_exactly(dev, kind, force, b, c, d, m, valid):
    q, rows, scale = _n1_inputs(30, b, c, d, kind, dev)
    got = _n1_scan(q, rows, m, valid, scale, force)
    assert got[0].shape == (b, m) and got[1].dtype == torch.int32
    _n1_equal(got, at.approx_scan_plain(q, rows, m, valid, scale))


@_N1_ROUTES
@_N1_ROWS
def test_approx_scan_on_normal_rows(dev, kind, force):
    """Sums in the kernel's order (3xTF32 or two TF32 products on the tensor
    cores, the fmaf chain on the FMA kernel) against cuBLAS's: values
    within 1e-5 of each row's scale, rows equal wherever a bin's best two
    scores differ by more."""
    b, c, d, m = 130, 1 << 16, 64, 1024
    q, rows = _randn(31, b, d, dev=dev), _randn(32, c, d, dev=dev)
    scale = None
    if kind == "int8":
        qc = rows.abs().amax(-1) / 127.0
        rows, scale = torch.round(rows / qc[:, None]).to(torch.int8), qc
    elif kind == "bf16":
        rows = rows.to(torch.bfloat16)
    got = _n1_scan(q, rows, m, None, scale, force)
    want = at.approx_scan_plain(q, rows, m, None, scale)
    tol = 1e-5 * want[0].abs().amax(dim=1, keepdim=True)
    assert bool(((got[0] - want[0]).abs() <= tol).all())
    s = q @ rows.float().T * (1 if scale is None else scale[None, :])
    second = s.scatter(1, want[1].long(), float("-inf")).view(b, c // m, m).amax(1)
    clear = (want[0] - second) > tol
    assert bool((got[1] == want[1])[clear].all()) and int(clear.sum()) > 0.9 * b * m


@_N1_ROUTES
@_N1_ROWS
def test_approx_scan_orders_non_finite_scores_like_plain(dev, kind, force):
    """Rows that score +-inf and NaN of both signs (+inf against a zeroed
    query column gives 0 * inf), valid_count inside the corpus: bit-equal.
    Int8 rows take the non-finite values in their scales instead."""
    b, c, d, m = 64, 1 << 16, 64, 2048
    r = np.random.default_rng(33)
    corpus = r.integers(-2, 3, size=(c, d)).astype(np.float32)
    query = r.integers(-2, 3, size=(b, d)).astype(np.float32)
    query[: b // 2, 0] = 0
    inf_rows, ninf_rows = np.arange(0, 150) * 128 + 5, np.arange(150, 200) * 128 + 7
    corpus[inf_rows, 0] = np.inf
    corpus[ninf_rows, 1] = -np.inf
    corpus.view(np.int32)[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    corpus.view(np.int32)[40_000, 5] = 0x7FC00000
    cq, qq, scale = torch.from_numpy(corpus).to(dev), torch.from_numpy(query).to(dev), None
    if kind == "bf16":
        cq = cq.to(torch.bfloat16)
    elif kind == "int8":
        cq = torch.from_numpy(r.integers(-127, 128, (c, d)).astype(np.int8)).to(dev)
        sc = r.uniform(0.01, 0.1, c).astype(np.float32)
        sc[inf_rows], sc[ninf_rows] = np.inf, -np.inf
        sc.view(np.int32)[3], sc.view(np.int32)[40_000] = -(1 << 22), 0x7FC00000
        scale = torch.from_numpy(sc).to(dev)
    for valid in (c, c - 3000):
        _n1_equal(_n1_scan(qq, cq, m, valid, scale, force),
                  at.approx_scan_plain(qq, cq, m, valid, scale))


@_N1_ROUTES
def test_approx_max_k_on_the_card_equals_the_cpu(dev, force):
    """N1, then B3: indices and scores equal the CPU's plain route on an
    integer grid; one launch of each."""
    b, c, d, k = 100, 1 << 16, 64, 100
    q, rows, scale = _n1_inputs(34, b, c, d, "int8", dev)
    before = dict(_lib.launches)
    got = at.approx_max_k(q, rows, k, 0.95, valid_count=c - 5, scale=scale, force=force)
    assert _lib.launches["approx_scan"] == before.get("approx_scan", 0) + 1
    assert _lib.launches["approx_scan_tc"] == before.get("approx_scan_tc", 0) + (force is None)
    assert _lib.launches["select_topk_radix"] == before.get("select_topk_radix", 0) + 1
    want = at.approx_max_k(q.cpu(), rows.cpu(), k, 0.95, valid_count=c - 5, scale=scale.cpu())
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


def test_approx_scan_routes_by_width(dev):
    """D % 8 != 0 (f32 rows, D = 20) takes the FMA kernel, bf16 rows there
    widened for it; D = 64 the tensor cores for every row kind; each bit-equal
    to plain on an integer grid, with its launch counters."""
    for d, kind, tc in ((20, "f32", 0), (20, "bf16", 0), (64, "f32", 1), (64, "int8", 1),
                        (64, "bf16", 1)):
        q, rows, scale = _n1_inputs(36, 70, 3000, d, kind, dev)
        assert at.scan_route(d, kind) == ("tc" if tc else "fma")
        before = dict(_lib.launches)
        got = at.approx_scan(q, rows, 500, 2900, scale)
        assert _lib.launches["approx_scan"] == before.get("approx_scan", 0) + 1
        assert _lib.launches["approx_scan_tc"] == before.get("approx_scan_tc", 0) + tc
        _n1_equal(got, at.approx_scan_plain(q, rows, 500, 2900, scale))


def test_mips_topk_approx_reads_bf16_rows_on_the_tensor_cores(dev):
    """A bf16 corpus goes to N1 unwidened: one tensor-core launch, and the
    result equals the f32 widening's on an integer grid."""
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_approx

    q, rows, _ = _n1_inputs(37, 100, 1 << 16, 64, "bf16", dev)
    before = dict(_lib.launches)
    got = mips_topk_approx(rows, q, 100)
    assert _lib.launches["approx_scan_tc"] == before.get("approx_scan_tc", 0) + 1
    want = mips_topk_approx(rows.float(), q, 100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dtype == torch.bfloat16


def test_approx_scan_rejects_what_the_kernel_does_not_take(dev):
    q, rows = _randn(35, 4, 64, dev=dev), _randn(36, 1024, 64, dev=dev)
    with pytest.raises(TypeError):
        at.approx_scan(q.half(), rows.half(), 128)
    with pytest.raises(ValueError):
        at.approx_scan(q, rows, 2048)  # M > C
    with pytest.raises(ValueError):
        at.approx_scan(q[:, :8], rows[:, :8].to(torch.int8), 128, None,
                       torch.ones(1024, device=dev))  # int8 rows need D % 16 == 0
    with pytest.raises(ValueError):
        at.approx_scan(_randn(37, 4, 132, dev=dev), _randn(38, 1024, 132, dev=dev), 128)
    with pytest.raises(TypeError):
        at.approx_scan(q, rows.to(torch.int8), 128, None, torch.ones(512, device=dev))
    with pytest.raises(ValueError):  # the tensor cores take D % 8 == 0 only
        at.approx_scan(q[:, :20], rows[:, :20], 128, force="tc")
    with pytest.raises(ValueError):
        at.approx_scan(q, rows, 128, force="mma")
