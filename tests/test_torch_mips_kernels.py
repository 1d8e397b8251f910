"""PyTorch port: the plain versions of the three exact-MIPS kernels
(tile-max scoring, tournament select, gather-rescore) against the JAX
package's Pallas kernels on the CPU (interpret mode, as tests/test_mips.py
runs them).

Tile-max and rescore are f32 sums taken in another order: 1e-5.  The select
orders int32 keys, so it must agree exactly, tie order included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_tower_models_tpu.ops.pallas.mips_topk as JM
import two_tower_models_tpu_torch.ops.mips_topk as TM


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, 0)))


@pytest.mark.parametrize("c,valid", [(4096, 3000), (4096, 4096), (4000, 4000)])
def test_tile_max_matches_pallas(c, valid):
    """Rows >= valid_count score -inf; a corpus that ends inside a tile
    (C=4000) is padded by the port itself and by the caller on the JAX side."""
    b, d, tile = 16, 32, 128
    corpus, query = _normal(1, (c, d)), _normal(2, (b, d))
    cp = _pad_rows(corpus, -(-c // 2048) * 2048)
    want = JM.tile_max_scores(jnp.asarray(query), jnp.asarray(cp), tile, valid)
    got = TM.tile_max_scores(torch.from_numpy(query), torch.from_numpy(corpus), tile, valid)
    nt = -(-c // tile)
    assert got.shape == (b, nt)
    want = np.asarray(want)[:, :nt]
    assert np.isneginf(want).any() == (valid < c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tile_max_propagates_nan_like_pallas():
    """A NaN row makes its tile's max NaN, as jnp.max does in the Pallas
    kernel; a NaN row at or past valid_count is masked to -inf."""
    b, c, d, tile, valid = 16, 4096, 32, 128, 3000
    corpus, query = _normal(3, (c, d)), _normal(4, (b, d))
    corpus[5, 7] = np.nan  # tile 0
    corpus[1000, :] = np.nan  # tile 7
    corpus[3500, 0] = np.nan  # padding, tile 27
    want = np.asarray(JM.tile_max_scores(jnp.asarray(query), jnp.asarray(corpus), tile, valid))
    got = TM.tile_max_scores(torch.from_numpy(query), torch.from_numpy(corpus), tile, valid).numpy()
    assert np.isnan(want[:, [0, 7]]).all() and not np.isnan(want[:, 27]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["inf-times-zero", "pos-nan-row", "neg-nan-row"])
def test_exact_pipeline_matches_dense_on_non_finite_scores(case):
    """The exact pipeline on scores that hold NaN, held against the JAX
    package's dense mips_topk (lax.top_k: -NaN ranks below -inf, +NaN above
    +inf): indices exactly, scores bit for bit.  inf-times-zero: rows with
    +inf in a column every query zeroes score 0 * inf, a -NaN on x86, in six
    tiles; the tile max took it as +NaN and those tiles crowded the true
    top rows out.  Integer-grid inputs, so every finite sum is exact."""
    from two_tower_models_tpu.retrieval.mips import mips_topk as jax_mips_topk
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact

    b, c, d, k = 4, 2048, 16, 3
    r = np.random.default_rng(11)
    corpus = r.integers(-2, 3, size=(c, d)).astype(np.float32)
    query = r.integers(-2, 3, size=(b, d)).astype(np.float32)
    if case == "inf-times-zero":
        query[:, 0] = 0
        corpus[np.arange(6) * 128 + 5, 0] = np.inf
    elif case == "pos-nan-row":
        corpus[700, 3] = np.nan
        corpus[np.arange(6) * 128 + 9, 1] = -np.inf
    else:
        corpus[700, 3] = -np.nan
        corpus[np.arange(6) * 128 + 9, 1] = np.inf
    idx, scores, _ = mips_topk_exact(torch.from_numpy(corpus), torch.from_numpy(query), k)
    widx, wscores, _ = jax_mips_topk(jnp.asarray(corpus), jnp.asarray(query), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(scores.numpy().view(np.int32), np.asarray(wscores).view(np.int32))


@pytest.mark.parametrize("d", [32, 64])
def test_gather_rescore_matches_pallas(d):
    c, b, k, tile = 4096, 16, 5, 128
    corpus, query = _normal(3, (c, d)), _normal(4, (b, d))
    tidx = np.random.default_rng(5).integers(0, c // tile, size=(b, k)).astype(np.int32)
    want = JM.gather_rescore(jnp.asarray(query), jnp.asarray(corpus), jnp.asarray(tidx), tile)
    got = TM.gather_rescore(
        torch.from_numpy(query), torch.from_numpy(corpus), torch.from_numpy(tidx), tile
    )
    assert got.shape == (b, k * tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _assert_select_equal(x: np.ndarray, k: int, x_jax_t: np.ndarray | None = None):
    """Port select_topk_t on x.T == JAX select_topk_t on x_jax_t (x.T, or
    x.T padded as the JAX kernel needs), bit for bit."""
    jt = x.T if x_jax_t is None else x_jax_t
    jv, ji = JM.select_topk_t(jnp.asarray(jt), k)
    tv, ti = TM.select_topk_t(torch.from_numpy(np.ascontiguousarray(x.T)), k)
    b = x.shape[0]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :b])
    np.testing.assert_array_equal(
        tv.numpy().view(np.int32), np.asarray(jv)[:, :b].view(np.int32)
    )
    return tv.numpy().T, ti.numpy().T


@pytest.mark.parametrize("nt,b,k", [(64, 8, 5), (256, 130, 16)])
def test_select_matches_pallas_with_ties(nt, b, k):
    x = np.round(_normal(6, (b, nt)) * 4) / 4  # many exact ties
    x[0] = 0.0  # an all-equal row: pure tie order
    spad = 0 if b <= 128 else (-b) % 128
    xt = np.pad(x.T, ((0, 0), (0, spad)), constant_values=-np.inf)
    _assert_select_equal(x, k, xt)


def test_select_signed_zero_total_order():
    """Every +0.0 ranks above every -0.0 (the case of tests/test_mips.py's
    test_select_topk_signed_zero_total_order)."""
    x = np.round(_normal(7, (16, 256)) * 2) / 2
    assert ((x == 0) & np.signbit(x)).any() and ((x == 0) & ~np.signbit(x)).any()
    v, _ = _assert_select_equal(x, 200)
    assert np.signbit(v[v == 0]).any()  # -0.0 survives the key round trip


def test_select_full_payload_negative_nan():
    """The f32 whose key is INT32_MIN (bits 0xFFFFFFFF) is clamped to
    INT32_MIN + 1, so picks stay distinct (tests/test_mips.py's
    test_select_topk_full_payload_negative_nan)."""
    k = 12
    x = _normal(8, (8, 64))
    x[:, 40:] = np.uint32(0xFFFFFFFF).view(np.float32)
    v, i = _assert_select_equal(x, k)
    assert all(len(set(r.tolist())) == k for r in i) and np.isfinite(v).all()
    allnan = np.full((8, 24), x[0, 40], np.float32)
    v, i = _assert_select_equal(allnan, 5)
    assert all(len(set(r.tolist())) == 5 for r in i)
    assert np.isnan(v).all() and (v.view(np.uint32) >> 31 == 1).all()


@pytest.mark.parametrize("nt,b,k", [(300, 16, 20), (265, 16, 20)])
def test_select_hierarchical_matches_pallas(monkeypatch, nt, b, k):
    """Rows longer than the kernel's shared-memory limit split into chunks
    and merge (265: a short tail chunk below k, padded survivors)."""
    monkeypatch.setattr(JM, "_SELECT_MAX_ROWS", 64)
    monkeypatch.setattr(TM, "SELECT_MAX_ROWS", 64)
    x = np.round(_normal(9, (b, nt)) * 2) / 2  # ties across chunk seams
    xt = np.pad(x.T, ((0, (-nt) % 8), (0, 0)), constant_values=-np.inf)
    _assert_select_equal(x, k, xt)


def test_key_map_round_trip_and_order():
    specials = np.asarray(
        [-np.inf, -1e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 1e38, np.inf], np.float32
    )
    x = np.concatenate([specials, _normal(10, (4096,)) * 1e3])
    kt = TM.f32_keys(torch.from_numpy(x))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(JM._f32_keys(jnp.asarray(x))))
    np.testing.assert_array_equal(TM.keys_f32(kt).numpy().view(np.int32), x.view(np.int32))


# -- launch plans of the tile-max and gather-rescore kernels (CPU: the plan
# is Python; the card tests run the kernels on it)


@pytest.mark.parametrize(
    "b,c,d",
    [(1024, 1 << 20, 64), (1, 4096, 64), (300, 4000, 16), (257, 8192, 100), (129, 20000, 128),
     (64, 5000, 200), (40000, 1 << 16, 64), (5, 128, 4)],
)
def test_tile_max_plan_covers_every_tile_once(b, c, d):
    """The persistent grid: every (query block, tile) pair scored by exactly
    one block, no run empty, every query in a block, shared memory within a
    block's opt-in and the SM's for the blocks planned an SM."""
    sms = 132
    qblocks, runs, per_sm, smem = TM._tile_max_plan(b, c, d, sms)
    nt = -(-c // TM.TILE)
    assert qblocks * 128 >= b > (qblocks - 1) * 128
    assert smem == TM._tile_max_smem_bytes(d) <= TM._SMEM_OPTIN
    assert per_sm in (1, 2) and per_sm * (smem + TM._SMEM_BLOCK_RESERVED) <= TM._SMEM_SM
    assert runs * qblocks <= max(per_sm * sms, qblocks)
    seen = np.zeros((qblocks, nt), np.int64)
    for blk in range(runs * qblocks):  # csrc/tile_max.cu's block-to-work map
        qb, run = blk % qblocks, blk // qblocks
        lo, hi = run * nt // runs, (run + 1) * nt // runs
        assert hi > lo
        seen[qb, lo:hi] += 1
    assert (seen == 1).all()


def test_tile_max_plan_at_the_serving_cell():
    """B = 1024, C = 2^20, D = 64 on 132 SMs: eight query blocks of 128, 33
    runs of 248-249 tiles, two blocks an SM; one an SM at D = 200."""
    assert TM._tile_max_plan(1024, 1 << 20, 64, 132) == (8, 33, 2, 102_400)
    assert TM._tile_max_plan(1024, 1 << 20, 200, 132)[1:3] == (16, 1)
    assert TM._padded(64) == 68 and TM._padded(100) == 100 and TM._padded(200) == 204


def _selection(case, b, k, nt, seed=7):
    r = np.random.default_rng(seed)
    if case == "random":
        t = r.integers(0, nt, size=(b, k))
    elif case == "sorted":
        t = np.sort(r.integers(0, nt, size=(b, k)), axis=1)
    elif case == "skewed":  # every query on the same k tiles
        t = np.broadcast_to(np.sort(r.choice(nt, k, replace=False)), (b, k))
    elif case == "one-tile":
        t = np.full((b, k), nt // 2)
    elif case == "distinct":  # one pair a tile
        t = r.permutation(nt)[: b * k].reshape(b, k)
    else:  # "outside": duplicates in a row and indices outside [0, nt)
        t = r.integers(-3, nt + 3, size=(b, k))
        t[:, -1] = t[:, 0]
    return torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))


_SEL_CASES = ["random", "sorted", "skewed", "one-tile", "distinct", "outside"]


@pytest.mark.parametrize("case", _SEL_CASES)
@pytest.mark.parametrize("b,k,nt", [(1, 1, 1), (1, 5, 40), (37, 7, 40), (130, 100, 8192 // 64)])
def test_invert_selection_plain_lists_every_pair_once(case, b, k, nt):
    """The inverted selection (csrc/gather_rescore.cu's layout, as the
    plain version writes it): every (query, slot) pair in its bucket's list
    once, the lists cut into items of at most QW pairs in order, the item
    count within ``_rescore_plan``'s bound (equal to it when every pair has
    a tile of its own)."""
    if case == "distinct":
        nt = max(nt, b * k)
    tidx = _selection(case, b, k, nt)
    bound, size = TM._rescore_plan(b, k, nt)
    scratch = TM.invert_selection(tidx, nt)  # a CPU tensor: the plain version
    assert scratch.shape == (size,) and scratch.dtype == torch.int32
    v = TM.rescore_scratch_views(scratch, b, k, nt)
    n_items = int(v["n_items"][0])
    assert n_items <= bound
    if case == "distinct":
        assert n_items == bound == b * k
    flat = tidx.reshape(-1).long()
    bucket = torch.where((flat >= 0) & (flat < nt), flat, nt)
    assert torch.equal(v["counts"].long(), torch.bincount(bucket, minlength=nt + 1))
    assert int(v["offsets"][0]) == 0 and int(v["offsets"][-1]) == b * k
    pairs = v["pairs"].long()
    assert torch.equal(torch.sort(pairs).values, torch.arange(b * k))
    assert torch.equal(bucket[pairs], torch.sort(bucket).values)  # grouped by bucket
    covered = torch.zeros(b * k, dtype=torch.long)
    for t, first, n, _ in v["items"][:n_items].tolist():
        assert 1 <= n <= TM._RS_QW
        assert int(v["offsets"][t]) <= first and first + n <= int(v["offsets"][t + 1])
        assert (first - int(v["offsets"][t])) % TM._RS_QW == 0
        assert bool((bucket[pairs[first : first + n]] == t).all())
        covered[pairs[first : first + n]] += 1
    assert bool((covered == 1).all())


def _rescore_by_items(query, corpus, tidx, tile):
    """csrc/gather_rescore.cu's rescore_kernel in torch: each work item's
    tile (zero rows past C and for the bucket outside [0, NT)) against its
    pairs' queries, each score the fmaf chain's plain counterpart."""
    b, k = tidx.shape
    c = corpus.shape[0]
    nt = max(1, -(-c // tile))
    v = TM.rescore_scratch_views(TM.invert_selection(tidx, nt), b, k, nt)
    out = torch.full((b * k, tile), float("nan"))
    for t, first, n, _ in v["items"][: int(v["n_items"][0])].tolist():
        rows = torch.zeros(tile, corpus.shape[1])
        if t < nt:
            part = corpus[t * tile : (t + 1) * tile]
            rows[: part.shape[0]] = part
        p = v["pairs"][first : first + n].long()
        out[p] = query[p // k] @ rows.T
    return out.reshape(b, k * tile)


@pytest.mark.parametrize("case", _SEL_CASES)
def test_rescore_by_items_matches_plain_and_pallas(case):
    """Scoring by the inverted selection's work items gives every output
    the plain version gives (exactly, on integer-grid inputs, ragged last
    tile and outside indices included) and the Pallas kernel's (1e-5, on
    normal inputs, indices inside the corpus)."""
    b, c, d, tile = 40, 4000, 32, 128  # B a multiple of the Pallas kernel's 8 queries
    nt = -(-c // tile)
    tidx = _selection(case if case != "distinct" else "random", b, 7, nt)
    r = np.random.default_rng(3)
    qg = torch.from_numpy(r.integers(-2, 3, size=(b, d)).astype(np.float32))
    cg = torch.from_numpy(r.integers(-2, 3, size=(c, d)).astype(np.float32))
    assert torch.equal(_rescore_by_items(qg, cg, tidx, tile), TM.gather_rescore_plain(qg, cg, tidx, tile))
    if case != "outside":
        qn, cn = _normal(4, (b, d)), _normal(5, (c, d))
        want = JM.gather_rescore(jnp.asarray(qn), jnp.asarray(_pad_rows(cn, nt * tile)),
                                 jnp.asarray(tidx.numpy()), tile)
        got = _rescore_by_items(torch.from_numpy(qn), torch.from_numpy(cn), tidx, tile)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
