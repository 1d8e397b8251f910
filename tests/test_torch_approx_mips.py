"""PyTorch port: the approximate top-k (A11) and the other exact scans of
retrieval/mips.py against the JAX package on the CPU.

``approx_bins`` equals XLA's reduction output size over a grid; the bin-max
scan's plain version (what the CPU runs; the kernel N1 is held to it on the
card in tests/test_torch_cuda_kernels.py) equals a direct numpy strided bin
max bit for bit, ties, +-inf, NaN of both signs and ``valid_count``
included.  JAX's ``approx_max_k`` sorts exactly on the CPU while the port's
is approximate on every device, so the port's ``mips_topk_approx`` equals
JAX's exactly (indices, scores, tie order) where its bins number C, and
elsewhere is held by recall against JAX's result.  The exact scans equal
JAX's exactly on integer-grid inputs, whose scores are exact, at sizes that
do not divide.  Inputs are made with numpy from a seed and fed to both
sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import _jax

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.retrieval import mips as jmips
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.ops import approx_topk as at
from two_tower_models_tpu_torch.ops import mips_topk as mt
from two_tower_models_tpu_torch.retrieval import mips as tmips
from two_tower_models_tpu_torch.serving import RetrievalEngine

_INT_MIN = -(1 << 31)


def _grid(seed, *shape, lo=-2, hi=3):
    """Small integers as f32: every inner product of them is exact."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,k", [(n, k) for n in (128, 300, 1000, 4096, 16384, 10**6, 2**20)
                                 for k in (1, 10, 16, 50, 100, 400) if k <= n])
def test_approx_bins_equals_xla(n, k):
    for r in (0.8, 0.9, 0.95, 0.99, 1.0):
        want = _jax.approx_top_k_reduction_output_size(n, 2, k, r, False, -1)[0]
        assert at.approx_bins(n, k, r) == want, (n, k, r)


def test_approx_bins_check_points():
    for (n, k, r), want in {(2**20, 100, 0.95): 2048, (2**20, 400, 0.95): 8192,
                            (2**20, 50, 0.95): 1024, (10**6, 100, 0.95): 2048,
                            (1000, 10, 0.95): 256, (300, 10, 0.95): 300,
                            (2**20, 100, 1.0): 2**20}.items():
        assert at.approx_bins(n, k, r) == want


def _numpy_bin_max(query, corpus, m, valid, scale=None):
    """The strided bin max written out: bin j over rows j, j + m, ... < C,
    rows >= valid at -inf, the max in the int32 key order, the first row on
    a tie."""
    s = query.astype(np.float32) @ corpus.astype(np.float32).T
    if scale is not None:
        s = s * scale[None, :]
    s[:, valid:] = -np.inf
    bits = s.view(np.int32)
    keys = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    b, c = s.shape
    vals = np.zeros((b, m), np.float32)
    rows = np.zeros((b, m), np.int32)
    for i in range(b):
        for j in range(m):
            r = np.arange(j, c, m)
            best = r[np.argmax(keys[i, r])]  # argmax: the first of equal keys
            vals[i, j], rows[i, j] = s[i, best], best
    return vals, rows


def _nonfinite_corpus(seed, c, d):
    """An integer grid with rows that score +-inf and NaN of both signs."""
    corpus = _grid(seed, c, d)
    corpus[5, 0] = np.inf
    corpus[7, 1] = -np.inf
    corpus[c // 2, 2] = np.inf
    bits = corpus.view(np.int32)
    bits[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    bits[c - 2, 5] = 0x7FC00000  # a positive NaN
    return corpus


@pytest.mark.parametrize("case", ["ties", "nonfinite", "valid", "int8", "int8-valid", "m-equals-c"])
def test_approx_scan_plain_matches_numpy(case):
    """Bit-equal values and rows on an integer grid (many exact ties),
    C not a multiple of M."""
    c, d, b, m = 1000, 16, 12, 128
    valid = c
    query = _grid(1, b, d)
    query[: b // 2, 0] = 0  # 0 * inf: NaN in half the queries
    corpus = _nonfinite_corpus(2, c, d) if case == "nonfinite" else _grid(2, c, d)
    scale = None
    if case.startswith("int8"):
        corpus = _grid(2, c, d, lo=-127, hi=128)
        scale = np.random.default_rng(3).uniform(0.01, 0.1, c).astype(np.float32)
        scale[::7] = 0.5  # exact ties at the same int8 dot
    if case.endswith("valid"):
        valid = 777
    if case == "m-equals-c":
        m = c
    want_v, want_r = _numpy_bin_max(query, corpus, m, valid, scale)
    got_v, got_r = at.approx_scan_plain(
        _t(query), _t(corpus).to(torch.int8) if scale is not None else _t(corpus), m,
        valid_count=valid, scale=None if scale is None else _t(scale))
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(mt.f32_keys(got_v).numpy(),
                                  mt.f32_keys(torch.from_numpy(want_v)).numpy())


def test_approx_scan_plain_empty_bins_and_lowest_key():
    """Bins whose rows are all past valid_count give -inf at their first
    row; a real row holding the lowest key (the full-payload -NaN) beats
    nothing and keeps its own bin."""
    c, d, m = 300, 4, 128
    corpus = _grid(4, c, d)
    query = np.ones((2, d), np.float32)
    corpus[1] = 0.0
    corpus.view(np.int32)[1, 0] = -1  # 0xFFFFFFFF: key INT_MIN
    vals, rows = at.approx_scan_plain(_t(query), _t(corpus), m, valid_count=100)
    assert torch.isneginf(vals[:, 100:]).all()
    np.testing.assert_array_equal(rows[:, 100:].numpy(), np.tile(np.arange(100, m), (2, 1)))
    assert int(rows[0, 1]) in (1, 1 + m, 1 + 2 * m)
    vals, rows = at.approx_scan_plain(_t(query), _t(corpus[:129]), m)
    assert int(rows[0, 1]) == 1 and int(mt.f32_keys(vals)[0, 1]) == _INT_MIN


def test_approx_max_k_takes_the_bins_top_k():
    """approx_max_k = the top k of the bin maxima (ties to the lowest bin),
    then each bin's row; its scores are the rows' own scores."""
    c, d, b, k = 5000, 8, 6, 10
    corpus, query = _grid(5, c, d), _grid(6, b, d)
    m = at.approx_bins(c, k, 0.95)
    vals, rows = at.approx_scan_plain(_t(query), _t(corpus), m)
    keys, pos = mt.select_keys_plain(mt.f32_keys(vals), k)
    scores, idx = at.approx_max_k(_t(query), _t(corpus), k, 0.95)
    np.testing.assert_array_equal(idx.numpy(), torch.gather(rows, 1, pos.long()).numpy())
    np.testing.assert_array_equal(scores.numpy(), mt.keys_f32(keys).numpy())
    full = query @ corpus.T
    np.testing.assert_array_equal(scores.numpy(), np.take_along_axis(full, idx.numpy(), 1))
    with pytest.raises(ValueError, match="bins"):
        at.approx_max_k(_t(query), _t(corpus), 400, 0.1)


@pytest.mark.parametrize("c,k,r", [(128, 7, 0.95), (300, 10, 0.95), (1000, 20, 1.0), (256, 30, 0.95)])
def test_mips_topk_approx_equals_jax_where_bins_are_rows(c, k, r):
    """Where approx_bins(C, k, r) = C every bin is one row: indices, scores
    and tie order equal JAX's (which sorts exactly on the CPU)."""
    assert at.approx_bins(c, k, r) == c
    corpus, query = _grid(7, c, 16), _grid(8, 9, 16)
    ji, js, je = jmips.mips_topk_approx(jnp.asarray(corpus), jnp.asarray(query), k, r)
    ti, ts, te = tmips.mips_topk_approx(_t(corpus), _t(query), k, r)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_mips_topk_approx_recall_against_jax():
    """C = 2^14, D = 16, k = 16 at 0.9 (M = 256 bins): recall against
    JAX's result >= 0.9; every pair a true row with its own score, in
    descending order, at most one per bin."""
    c, d, b, k, r = 1 << 14, 16, 64, 16, 0.9
    m = at.approx_bins(c, k, r)
    assert m == 256
    corpus, query = _normal(9, c, d), _normal(10, b, d)
    ji, _, _ = jmips.mips_topk_approx(jnp.asarray(corpus), jnp.asarray(query), k, r)
    ti, ts, te = tmips.mips_topk_approx(_t(corpus), _t(query), k, r)
    ji = np.asarray(ji)
    recall = sum(len(set(a) & set(w)) for a, w in zip(ti.tolist(), ji.tolist())) / ji.size
    assert recall >= 0.9, recall
    idx = ti.numpy()
    np.testing.assert_allclose(ts.numpy(), np.einsum("bkd,bd->bk", corpus[idx], query),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(te.numpy(), corpus[idx])
    assert (ts[:, :-1] >= ts[:, 1:]).all()
    assert all(len(set((row % m).tolist())) == k for row in idx)


def test_mips_init():
    gen = torch.Generator().manual_seed(0)
    corpus = tmips.mips_init(gen, 100, 8, device="cpu")
    assert corpus.shape == (100, 8) and corpus.dtype == torch.float32
    again = tmips.mips_init(torch.Generator().manual_seed(0), 100, 8, torch.bfloat16, "cpu")
    assert again.dtype == torch.bfloat16
    assert torch.equal(again, corpus.to(torch.bfloat16))
    assert abs(float(corpus.std()) - 1) < 0.2


def _pair(jfn, tfn, c, b, seed):
    corpus, query = _grid(seed, c, 32), _grid(seed + 1, b, 32)
    want = jfn(jnp.asarray(corpus), jnp.asarray(query))
    got = tfn(_t(corpus), _t(query))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dense = tmips.mips_topk(_t(corpus), _t(query), got[0].shape[1])
    for g, w in zip(got, dense):  # and the port's own dense scan
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("c,b,k,nseg", [(1000, 16, 10, 8), (530, 4, 9, 8), (4096, 5, 100, 64)])
def test_segmented_topk_matches_jax(c, b, k, nseg):
    _pair(lambda cc, q: jmips.mips_topk_segmented(cc, q, k, num_segments=nseg),
          lambda cc, q: tmips.mips_topk_segmented(cc, q, k, num_segments=nseg), c, b, 11)


def test_segmented_topk_on_scores_matches_jax():
    s = _grid(12, 7, 333)
    s[0, 5] = np.inf
    s[1, 9] = -np.inf
    ws, wi = jmips.segmented_topk(jnp.asarray(s), 12, 5)
    gs, gi = tmips.segmented_topk(_t(s), 12, 5)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("c,b,k,tile,qb", [(30000, 16, 100, 128, 256), (5000, 17, 11, 64, 8),
                                           (999, 8, 50, 128, 256), (3000, 9, 7, 128, 4)])
def test_exact_tilemax_matches_jax(c, b, k, tile, qb):
    """Tile-max pruning in plain torch: equal to JAX's and to the dense scan,
    sizes that do not divide, query blocks, and the small-corpus fallback."""
    _pair(lambda cc, q: jmips.mips_topk_exact_tilemax(cc, q, k, tile=tile, chunk=4096,
                                                      query_block=qb),
          lambda cc, q: tmips.mips_topk_exact_tilemax(cc, q, k, tile=tile, chunk=4096,
                                                      query_block=qb), c, b, 13)


@pytest.mark.parametrize("c,b,k,chunk", [(1000, 16, 10, 128), (333, 4, 7, 128), (100, 3, 5, 128)])
def test_chunked_topk_matches_jax(c, b, k, chunk):
    _pair(lambda cc, q: jmips.chunked_mips_topk(cc, q, k, chunk_size=chunk),
          lambda cc, q: tmips.chunked_mips_topk(cc, q, k, chunk_size=chunk), c, b, 15)


SIZES = dict(user_id_hash_size=64, user_id_embedding_dim=16, item_id_hash_size=64,
             item_id_embedding_dim=16, user_features_size=8, item_features_size=8,
             user_value_weights=(1.0,), history_len=4, num_items=5)


def _inputs(seed, b=8):
    r = np.random.default_rng(seed)
    return (r.integers(0, 64, b).astype(np.int32), r.normal(size=(b, 8)).astype(np.float32),
            r.integers(0, 64, (b, 4)).astype(np.int32))


def _retrieve_both(cfg_j, cfg_t, corpus, seed):
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t,
                                   device="cpu")
    args = _inputs(seed + 1)
    want = np.asarray(jtt.retrieve(params, cfg_j, jnp.asarray(corpus), *args))
    got = ttt.retrieve(model, cfg_t, _t(corpus), *args, device="cpu")
    return model, args, got, want


def test_retrieve_approx_mips_matches_jax():
    """approx_mips on a 128-row corpus (one row a bin): JAX's indices exactly;
    on 4096 rows (M = 128 bins for k = 5) a valid approximate top-k."""
    cfg_j = jcfg.ModelConfig(**SIZES, approx_mips=True)
    cfg_t = tcfg.ModelConfig(**SIZES, approx_mips=True)
    _, _, got, want = _retrieve_both(cfg_j, cfg_t, _normal(20, 128, 16), 21)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    model, args, got, want = _retrieve_both(cfg_j, cfg_t, _normal(22, 4096, 16), 23)
    assert got.shape == (8, 5) and int(got.min()) >= 0 and int(got.max()) < 4096
    recall = sum(len(set(a) & set(w)) for a, w in zip(got.tolist(), want.tolist())) / want.size
    assert recall >= 0.9, recall


def test_retrieve_light_ranker_approx_matches_jax():
    """The light ranker's rerank of approx_mips' top 20 over 256 rows (one
    row a bin): JAX's indices exactly."""
    kw = dict(SIZES, approx_mips=True)
    cfgs = [c.ModelConfig(**kw, history_encoder=c.HistoryEncoderConfig(num_heads=2, num_layers=1),
                          light_ranker=c.LightRankerConfig(num_mips_items=20,
                                                           num_ranker_user_embeddings=2))
            for c in (jcfg, tcfg)]
    assert at.approx_bins(256, 20, 0.95) == 256
    _, _, got, want = _retrieve_both(*cfgs, _normal(24, 256, 16), 25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_serves_approx_mips():
    cfg_t = tcfg.ModelConfig(**SIZES, approx_mips=True)
    model = ttt.init_params(0, cfg_t, device="cpu")
    corpus = _t(_normal(26, 4096, 16))
    engine = RetrievalEngine(model, cfg_t, corpus, device="cpu")
    engine.warmup(4)
    args = _inputs(27)
    want = ttt.retrieve(model, cfg_t, corpus, *args, device="cpu")
    assert torch.equal(engine.query(*args), want)
    exact = ttt.retrieve(model, dataclasses.replace(cfg_t, approx_mips=False), corpus, *args,
                         device="cpu")
    recall = sum(len(set(a) & set(w)) for a, w in zip(want.tolist(), exact.tolist())) / exact.numel()
    assert recall >= 0.9, recall
