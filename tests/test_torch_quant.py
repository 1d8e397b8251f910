"""PyTorch port: the int8 corpus (retrieval/quant.py, A11) against the JAX
package on the CPU.

Quantization is bit-equal (q and scale, zero rows and values exactly half
way between two steps included); ``quantized_scores`` within 1e-6 relative
(two f32 dot orders); the exact pre-selection (``recall_target=None``) in
pure and rescore modes equal to JAX's on integer-grid data, whose scores
are exact, ``valid_count`` and ``row_offset`` included; the approximate one
equal to JAX's where its bins are the rows (JAX sorts exactly on the CPU).
``retrieve`` and ``RetrievalEngine(quantize=...)`` against JAX's and the
port's own paths.  Inputs are made with numpy from a seed and fed to both
sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.retrieval import quant as jq
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.ops import approx_topk as at
from two_tower_models_tpu_torch.retrieval import quant as tq
from two_tower_models_tpu_torch.retrieval.mips import mips_topk
from two_tower_models_tpu_torch.serving import RetrievalEngine


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _grid(seed, *shape, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(corpus, keep_raw=False):
    return (jq.quantize_corpus(jnp.asarray(corpus), keep_raw=keep_raw),
            tq.quantize_corpus(_t(corpus), keep_raw=keep_raw))


def _recall(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist())) / want.size


def test_quantize_corpus_bit_equal():
    """q and scale bit-equal to JAX's: a zero row, rows whose values fall
    exactly half way between two int8 steps (127 * 2.5 / 127 etc.), and a
    negative half way value (round half to even on both sides)."""
    corpus = _normal(0, 300, 16)
    corpus[7] = 0.0
    corpus[8] = [127.0, 2.5, -2.5, 3.5, -0.5, 0.5, 1.5] + [0.0] * 9
    corpus[9] = [-127.0, 126.5, -125.5] + [1.0] * 13
    jc, tc = _both(corpus, keep_raw=True)
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    assert tc.q.dtype == torch.int8 and tc.scale.dtype == torch.float32
    assert tc.shape == (300, 16) and tc.raw is not None
    assert tc.q[8, :7].tolist() == [127, 2, -2, 4, 0, 0, 2]
    assert float(tc.scale[7]) == 1.0 and int(tc.q[7].abs().max()) == 0
    assert tq.quantize_corpus(_t(corpus)).raw is None


def test_dequantize_and_quantized_scores_match_jax():
    corpus, query = _normal(1, 500, 32), _normal(2, 9, 32)
    jc, tc = _both(corpus)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = tq.dequantize(tc, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jq.dequantize(jc, dtype), np.float32))
    want = np.asarray(jq.quantized_scores(jnp.asarray(query), jc))
    np.testing.assert_allclose(tq.quantized_scores(_t(query), tc).numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["pure", "rescore"])
@pytest.mark.parametrize("valid,offset", [(None, 0), (700, 0), (900, 300)])
def test_quantized_shard_topk_exact_matches_jax(mode, valid, offset):
    """recall_target=None on an integer grid: scores, local indices and
    embeddings equal JAX's, rows past valid_count - row_offset at -inf
    through the rescore."""
    c, d, b, k = 1000, 16, 12, 10
    corpus, query = _grid(3, c, d), _grid(4, b, d)
    corpus[::5, 0] = 5.0  # ties in the quantized scores
    jc, tc = _both(corpus, keep_raw=mode == "rescore")
    want = jq.quantized_shard_topk(jc, jnp.asarray(query), k, recall_target=None, oversample=4,
                                   row_offset=offset, valid_count=valid)
    got = tq.quantized_shard_topk(tc, _t(query), k, recall_target=None, oversample=4,
                                  row_offset=offset, valid_count=valid)
    assert got[1].dtype == torch.int64
    for g, w, name in zip(got, want, ("scores", "indices", "embeddings")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if valid is not None:
        assert int(got[1].max()) < valid - offset


@pytest.mark.parametrize("mode", ["pure", "rescore"])
def test_mips_topk_quantized_exact_matches_jax(mode):
    c, d, b, k = 777, 32, 7, 9
    corpus, query = _grid(5, c, d), _grid(6, b, d)
    jc, tc = _both(corpus)
    rescore = corpus if mode == "rescore" else None
    want = jq.mips_topk_quantized(jc, jnp.asarray(query), k, recall_target=None,
                                  rescore_corpus=None if rescore is None else jnp.asarray(rescore))
    got = tq.mips_topk_quantized(tc, _t(query), k, recall_target=None,
                                 rescore_corpus=None if rescore is None else _t(rescore))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["pure", "rescore"])
def test_mips_topk_quantized_approx(mode):
    """With a recall_target: JAX's result exactly where the bins are the
    rows (C = 256, k = 10: M = 256), and at C = 2^14 (M = 512 for k = 16,
    2048 for the rescore pool of 64) a recall >= 0.9 (pure) or 0.97
    (rescore) against JAX's exact-on-the-CPU result."""
    keep = mode == "rescore"
    corpus, query = _grid(7, 256, 16), _grid(8, 6, 16)
    assert at.approx_bins(256, 10 * (4 if keep else 1), 0.95) == 256
    jc, tc = _both(corpus, keep_raw=keep)
    want = jq.mips_topk_quantized(jc, jnp.asarray(query), 10, recall_target=0.95)
    got = tq.mips_topk_quantized(tc, _t(query), 10, recall_target=0.95)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    corpus, query = _normal(9, 1 << 14, 16), _normal(10, 64, 16)
    jc, tc = _both(corpus, keep_raw=keep)
    wi, _, _ = jq.mips_topk_quantized(jc, jnp.asarray(query), 16, recall_target=0.95)
    gi, gs, ge = tq.mips_topk_quantized(tc, _t(query), 16, recall_target=0.95)
    assert _recall(gi, wi) >= (0.97 if keep else 0.9)
    assert (gs[:, :-1] >= gs[:, 1:]).all()
    rows = corpus[gi.numpy()] if keep else tq.dequantize(tc, torch.float32)[gi].numpy()
    np.testing.assert_array_equal(ge.numpy(), rows)


SIZES = dict(user_id_hash_size=64, user_id_embedding_dim=16, item_id_hash_size=96,
             item_id_embedding_dim=16, user_features_size=8, item_features_size=8,
             user_value_weights=(1.0,), history_len=4, num_items=5)


def _inputs(seed, b=8):
    r = np.random.default_rng(seed)
    return (r.integers(0, 64, b).astype(np.int32), r.normal(size=(b, 8)).astype(np.float32),
            r.integers(0, 96, (b, 4)).astype(np.int32))


def _models(seed, **kw):
    cfg_j, cfg_t = jcfg.ModelConfig(**SIZES, **kw), tcfg.ModelConfig(**SIZES, **kw)
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t,
                                   device="cpu")
    return cfg_j, cfg_t, params, model


@pytest.mark.parametrize("keep_raw", [False, True], ids=["int8", "int8_rescore"])
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
def test_retrieve_on_a_quantized_corpus_matches_jax(keep_raw, approx):
    """retrieve dispatches a QuantizedCorpus to mips_topk_quantized
    (approximate under approx_mips: 128 rows, one a bin): JAX's indices
    exactly, and the rescore mode's recall against the f32 corpus."""
    cfg_j, cfg_t, params, model = _models(11, approx_mips=approx)
    corpus = _normal(12, 128, 16)
    jc, tc = _both(corpus, keep_raw=keep_raw)
    args = _inputs(13)
    want = np.asarray(jtt.retrieve(params, cfg_j, jc, *args))
    got = ttt.retrieve(model, cfg_t, tc, *args, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    exact = ttt.retrieve(model, cfg_t, _t(corpus), *args, device="cpu")
    assert _recall(got, exact) >= (0.99 if keep_raw else 0.8)


@pytest.mark.parametrize("mode", ["int8", "int8_rescore"])
def test_engine_quantized_query(mode):
    """from_params quantizes on the engine's device; a query equals
    retrieve on the engine's corpus and nearly the f32 engine's; refresh
    quantizes the new corpus again."""
    _, cfg_t, _, model = _models(14, approx_mips=True)
    ids = torch.arange(96)
    feats = _t(_normal(15, 96, 8))
    ref = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    eng = RetrievalEngine.from_params(model, cfg_t, ids, feats, quantize=mode, device="cpu")
    assert isinstance(eng.corpus, tq.QuantizedCorpus)
    assert (eng.corpus.raw is not None) == (mode == "int8_rescore")
    want_q = tq.quantize_corpus(ref.corpus)
    assert torch.equal(eng.corpus.q, want_q.q) and torch.equal(eng.corpus.scale, want_q.scale)
    args = _inputs(16)
    eng.warmup(4)
    got = eng.query(*args)
    assert torch.equal(got, ttt.retrieve(model, cfg_t, eng.corpus, *args, device="cpu"))
    assert _recall(got, ref.query(*args)) >= (0.99 if mode == "int8_rescore" else 0.8)

    model2 = ttt.init_params(7, cfg_t, device="cpu")
    eng.refresh(model2, ids, feats)
    ref.refresh(model2, ids, feats)
    assert isinstance(eng.corpus, tq.QuantizedCorpus)
    assert (eng.corpus.raw is not None) == (mode == "int8_rescore")
    assert torch.equal(eng.corpus.q, tq.quantize_corpus(ref.corpus).q)
    assert eng.query(*args).shape == got.shape


def test_engine_takes_a_quantized_corpus_and_refuses_bad_modes():
    _, cfg_t, _, model = _models(17)
    corpus = _t(_normal(18, 96, 16))
    qc = tq.quantize_corpus(corpus)
    eng = RetrievalEngine(model, cfg_t, qc, device="cpu")
    assert eng.corpus is not qc and torch.equal(eng.corpus.q, qc.q)
    assert torch.equal(eng.query(*_inputs(19)), RetrievalEngine(
        model, cfg_t, corpus, quantize="int8", device="cpu").query(*_inputs(19)))
    with pytest.raises(ValueError, match="int8"):
        RetrievalEngine(model, cfg_t, corpus, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        RetrievalEngine.from_params(model, cfg_t, torch.arange(96), _t(_normal(20, 96, 8)),
                                    quantize="fp8", device="cpu")


def test_quantized_topk_recall_against_f32():
    """The counterpart of tests/test_quant.py's recall bounds: pure >= 0.9
    and rescore (oversample 8) >= 0.99 against the f32 scan, the rescore's
    scores the f32 products."""
    corpus, query = _normal(21, 2048, 64), _normal(22, 32, 64)
    want, _, _ = mips_topk(_t(corpus), _t(query), 20)
    got, got_s, got_e = tq.mips_topk_quantized(tq.quantize_corpus(_t(corpus)), _t(query), 20,
                                               recall_target=None)
    assert _recall(got, want) >= 0.9
    np.testing.assert_allclose(torch.einsum("bkd,bd->bk", got_e, _t(query)).numpy(),
                               got_s.numpy(), rtol=1e-3, atol=1e-3)
    want, _, _ = mips_topk(_t(corpus), _t(query), 10)
    got, got_s, got_e = tq.mips_topk_quantized(tq.quantize_corpus(_t(corpus), keep_raw=True),
                                               _t(query), 10, recall_target=None, oversample=8)
    assert _recall(got, want) >= 0.99
    np.testing.assert_array_equal(got_e.numpy(), corpus[got.numpy()])
    np.testing.assert_allclose(got_s.numpy(), np.einsum("bkd,bd->bk", corpus[got.numpy()], query),
                               rtol=1e-6, atol=1e-6)
