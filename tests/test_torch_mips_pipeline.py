"""PyTorch port: the exact tile-max MIPS pipeline (passes 1-4 and the glue
around them) and the dense top-k against the JAX package on the CPU.

The JAX side runs ``mips_topk_exact_pallas`` with its Pallas kernels in
interpret mode, as tests/test_mips.py does.  Integer-grid embeddings make
every score an exact small integer, so the sums agree bit for bit whatever
their order and the comparison is exact: indices (tie order included) and
scores.  On normal data the scores are f32 sums in another order (1e-5)
while the indices stay exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas.mips_topk import mips_topk_exact_pallas
from two_tower_models_tpu.retrieval.mips import mips_topk as jax_mips_topk
from two_tower_models_tpu_torch.ops.mips_topk import mips_topk_exact_tiled
from two_tower_models_tpu_torch.retrieval import mips as tmips


def _grid(seed, c, b, d):
    r = np.random.default_rng(seed)
    corpus = r.integers(-2, 3, size=(c, d)).astype(np.float32)
    query = r.integers(-2, 3, size=(b, d)).astype(np.float32)
    return corpus, query


def _assert_same(got, want, exact_scores=True):
    gi, gs, ge = got
    wi, ws, we = (np.asarray(x) for x in want)
    assert gi.dtype == torch.int64
    np.testing.assert_array_equal(gi.numpy(), wi)
    if exact_scores:
        np.testing.assert_array_equal(gs.numpy(), ws)
    else:
        np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ge.numpy(), we)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_integer_grid_matches_pallas_and_dense(seed):
    """The quantized-score stress of tests/test_mips.py's
    test_exact_cross_tile_boundary_ties: scores collide constantly, so the
    tie order decides most picks."""
    corpus, query = _grid(seed, 4096, 16, 16)
    cj, qj = jnp.asarray(corpus), jnp.asarray(query)
    want = mips_topk_exact_pallas(cj, qj, 10)
    np.testing.assert_array_equal(np.asarray(want[0]), np.asarray(jax_mips_topk(cj, qj, 10)[0]))
    ct, qt = torch.from_numpy(corpus), torch.from_numpy(query)
    _assert_same(mips_topk_exact_tiled(ct, qt, 10), want)
    _assert_same(tmips.mips_topk_exact(ct, qt, 10), want)
    _assert_same(tmips.mips_topk(ct, qt, 10), want)


def test_pipeline_cross_tile_boundary_tie():
    """A tie at the k-th boundary that spans two tiles resolves to the
    lowest global index even when the higher-index row sits in the
    higher-ranked tile (tests/test_mips.py's constructed case)."""
    rng = np.random.default_rng(0)
    c, d, k = 2048, 8, 4
    corpus = rng.normal(size=(c, d)).astype(np.float32)
    query = rng.normal(size=(8, d)).astype(np.float32)
    u = (query[0] / np.linalg.norm(query[0])).astype(np.float32)
    corpus[1850] = u * 25
    corpus[1900] = u * 10
    corpus[300] = u * 10
    corpus[50] = u * 22
    corpus[600] = u * 21
    want = mips_topk_exact_pallas(jnp.asarray(corpus), jnp.asarray(query), k)
    got = mips_topk_exact_tiled(torch.from_numpy(corpus), torch.from_numpy(query), k)
    assert 300 in got[0][0].tolist() and 1900 not in got[0][0].tolist()
    _assert_same(got, want, exact_scores=False)


def test_pipeline_large_batch_matches_pallas():
    """B=4096, k=100: the shape at which the JAX pipeline blocks its
    queries for TPU scalar memory (tests/test_mips.py's
    test_exact_pallas_query_blocking_smem); the port takes the batch
    whole.  Pass 4's pool is 12,800 candidates."""
    corpus, query = _grid(3, 16384, 4096, 16)
    want = mips_topk_exact_pallas(jnp.asarray(corpus), jnp.asarray(query), 100)
    got = mips_topk_exact_tiled(torch.from_numpy(corpus), torch.from_numpy(query), 100)
    _assert_same(got, want)


@pytest.mark.parametrize(
    "c,k,valid",
    [(4096, 10, 3000), (4000, 10, 4000), (1024, 10, 700), (1024, 10, None)],
    ids=["padded-rows", "ragged-tail", "dense-fallback-padded", "dense-fallback"],
)
def test_pipeline_valid_count_and_fallback_match_pallas(c, k, valid):
    """Rows >= valid_count never come back; a corpus that ends inside a
    tile; corpora too small for tile pruning (k*128 >= C) take the dense
    scan in both packages."""
    corpus, query = _grid(4, c, 16, 16)
    want = mips_topk_exact_pallas(
        jnp.asarray(corpus), jnp.asarray(query), k, valid_count=valid
    )
    got = mips_topk_exact_tiled(
        torch.from_numpy(corpus), torch.from_numpy(query), k, valid_count=valid
    )
    _assert_same(got, want)
    if valid is not None:
        assert int(got[0].max()) < valid


def test_dense_topk_orders_signed_zeros_and_ties():
    """topk_ordered follows lax.top_k's total order: +0.0 above -0.0, ties
    to the lowest index, NaN above +inf."""
    x = np.asarray(
        [[-0.0, 0.0, 1.0, 1.0, -0.0, 0.0, np.nan, np.inf, -np.inf, 1.0]], np.float32
    )
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), 10))
    got_v, got_i = tmips.topk_ordered(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), want_v.view(np.int32))
