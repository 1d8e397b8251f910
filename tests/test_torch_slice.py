"""PyTorch port: the serving slice end to end against the JAX package on the
CPU: corpus refresh through the item tower, the user tower with the fused
history encoder, and the exact tile-max MIPS, through ``retrieve`` and
``RetrievalEngine``.

Both sides hold the same weights (JAX ``init_params`` through
``bridge.params_from_jax``) and the same inputs (numpy).  The JAX side runs
its Pallas kernels in interpret mode.  f32: embeddings and corpus at 1e-5
(the same sums in another order), indices equal on every row whose k-th and
(k+1)-th scores are clearly apart.  bf16: embeddings at 3e-2 (three encoder
layers of bf16 rounding in another order) and top-k overlap >= 0.9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu import serving as jserving
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.retrieval.mips import refresh_corpus as jax_refresh_corpus
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus
from two_tower_models_tpu_torch.serving import RetrievalEngine

C, B, D, H, L, NH, K = 4096, 16, 32, 8, 2, 4, 10
SIZES = dict(
    user_id_hash_size=512,
    user_id_embedding_dim=D,
    item_id_hash_size=C,
    item_id_embedding_dim=D,
    user_features_size=8,
    item_features_size=8,
    feature_hidden_dim=64,
    user_value_weights=(1.0, 0.5, 0.25),
    history_len=H,
    num_items=K,
)


def _configs(compute_dtype):
    j = jcfg.ModelConfig(
        **SIZES,
        history_encoder=jcfg.HistoryEncoderConfig(num_heads=NH, num_layers=L, fused_encoder=True),
        debias=jcfg.Debias.BOTH,
        compute_dtype=compute_dtype,
    )
    t = tcfg.ModelConfig(
        **SIZES,
        history_encoder=tcfg.HistoryEncoderConfig(num_heads=NH, num_layers=L, fused_encoder=True),
        debias=tcfg.Debias.BOTH,
        compute_dtype=compute_dtype,
    )
    return j, t


def _inputs(seed):
    r = np.random.default_rng(seed)
    return dict(
        catalog_ids=np.arange(C, dtype=np.int32),
        catalog_feats=r.normal(size=(C, 8)).astype(np.float32),
        uid=r.integers(0, SIZES["user_id_hash_size"], size=(B,)).astype(np.int32),
        feat=r.normal(size=(B, 8)).astype(np.float32),
        hist=r.integers(0, C, size=(B, H)).astype(np.int32),
    )


def _clear_margin_rows(user_emb, corpus, k, rel=1e-4):
    s = -np.sort(-(np.asarray(user_emb, np.float64) @ np.asarray(corpus, np.float64).T), axis=1)
    return (s[:, k - 1] - s[:, k]) > rel * np.abs(s[:, k - 1])


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a.tolist(), b.tolist())])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_retrieve_matches_jax(compute_dtype):
    cfg_j, cfg_t = _configs(compute_dtype)
    a = _inputs(11)
    params = jtt.init_params(jax.random.key(5), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")

    corpus_j = jax_refresh_corpus(
        params, cfg_j, jnp.asarray(a["catalog_ids"]), jnp.asarray(a["catalog_feats"]),
        batch_size=1024,
    )
    corpus_t = refresh_corpus(
        model, cfg_t, torch.from_numpy(a["catalog_ids"]), torch.from_numpy(a["catalog_feats"]),
        batch_size=1024,
    )
    assert corpus_t.dtype == torch.float32 and corpus_t.shape == (C, D)
    tol = 1e-5 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(corpus_t.detach().numpy(), np.asarray(corpus_j), rtol=tol, atol=tol)

    jin = [jnp.asarray(a[k]) for k in ("uid", "feat", "hist")]
    tin = [torch.from_numpy(a[k]) for k in ("uid", "feat", "hist")]
    uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *jin)
    with torch.no_grad():
        uemb_t, _ = ttt.compute_user_embedding(model, cfg_t, *tin)
    np.testing.assert_allclose(uemb_t.numpy(), np.asarray(uemb_j), rtol=tol, atol=tol)

    want = np.asarray(jtt.retrieve(params, cfg_j, corpus_j, *jin))
    got = ttt.retrieve(model, cfg_t, corpus_t.detach(), *tin, device="cpu")
    assert got.shape == (B, K) and got.dtype == torch.int64
    got = got.numpy()
    if compute_dtype == "float32":
        clear = _clear_margin_rows(uemb_j, corpus_j, K)
        assert clear.sum() >= B // 2
        np.testing.assert_array_equal(got[clear], want[clear])
    else:
        assert _overlap(got, want) >= 0.9


def test_engine_query_matches_jax_engine():
    """RetrievalEngine.from_params / warmup / query / refresh in f32, each
    against the JAX engine on the same weights and catalog."""
    cfg_j, cfg_t = _configs("float32")
    a = _inputs(12)
    params = jtt.init_params(jax.random.key(6), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ids, feats = a["catalog_ids"], a["catalog_feats"]
    eng_j = jserving.RetrievalEngine.from_params(params, cfg_j, jnp.asarray(ids), jnp.asarray(feats))
    eng_t = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    np.testing.assert_allclose(
        eng_t.corpus.numpy(), np.asarray(eng_j.corpus), rtol=1e-5, atol=1e-5
    )
    eng_t.warmup(4)

    jin = [jnp.asarray(a[k]) for k in ("uid", "feat", "hist")]
    want = np.asarray(eng_j.query(*jin))
    got = eng_t.query(a["uid"], a["feat"], a["hist"]).numpy()
    uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *jin)
    clear = _clear_margin_rows(uemb_j, eng_j.corpus, K)
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(got[clear], want[clear])

    # refresh: new weights, corpus rebuilt from them, swapped together
    params2 = jtt.init_params(jax.random.key(7), cfg_j)
    model2 = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params2), cfg_t, device="cpu")
    eng_t.refresh(model2, ids, feats)
    corpus2 = jax_refresh_corpus(params2, cfg_j, jnp.asarray(ids), jnp.asarray(feats))
    np.testing.assert_allclose(eng_t.corpus.numpy(), np.asarray(corpus2), rtol=1e-5, atol=1e-5)
    want2 = np.asarray(jtt.retrieve(params2, cfg_j, corpus2, *jin))
    got2 = eng_t.query(a["uid"], a["feat"], a["hist"]).numpy()
    uemb2, _ = jtt.compute_user_embedding(params2, cfg_j, *jin)
    clear2 = _clear_margin_rows(uemb2, corpus2, K)
    np.testing.assert_array_equal(got2[clear2], want2[clear2])


def test_engine_variable_history_needs_the_unported_kernel():
    """history_len through the fused encoder is fused_attn_stack (its plain
    version here; kernels B8 and B9 on the card).  The name is from when
    that kernel was unported and the engine raised; the test now holds the
    port to JAX: warmup(variable_history=True) serves, and queries with per-example
    lengths and id 0 past each length give JAX's indices on clear-margin
    rows, with the same f32 user embeddings at 1e-5.  The dense encoder
    serves the same lengths too."""
    cfg_j, cfg_t = _configs("float32")
    a = _inputs(13)
    params = jtt.init_params(jax.random.key(8), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ids, feats = a["catalog_ids"], a["catalog_feats"]
    eng_j = jserving.RetrievalEngine.from_params(params, cfg_j, jnp.asarray(ids), jnp.asarray(feats))
    eng_t = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    eng_t.warmup(2, variable_history=True)
    lens = np.random.default_rng(14).integers(1, H + 1, size=(B,)).astype(np.int32)
    lens[:2] = [1, H]
    hist = np.where(np.arange(H)[None, :] < lens[:, None], a["hist"], 0).astype(np.int32)
    jin = [jnp.asarray(a["uid"]), jnp.asarray(a["feat"]), jnp.asarray(hist)]
    want = np.asarray(eng_j.query(*jin, history_len=jnp.asarray(lens)))
    got = eng_t.query(a["uid"], a["feat"], hist, history_len=lens).numpy()
    uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *jin, jnp.asarray(lens))
    with torch.no_grad():
        uemb_t, _ = ttt.compute_user_embedding(
            model, cfg_t, *(torch.from_numpy(t) for t in (a["uid"], a["feat"], hist, lens))
        )
    np.testing.assert_allclose(uemb_t.numpy(), np.asarray(uemb_j), rtol=1e-5, atol=1e-5)
    clear = _clear_margin_rows(uemb_j, eng_j.corpus, K)
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(got[clear], want[clear])
    dense = dataclasses.replace(
        cfg_t, history_encoder=tcfg.HistoryEncoderConfig(num_heads=NH, num_layers=L)
    )
    RetrievalEngine(model, dense, torch.randn(C, D), device="cpu").warmup(2, variable_history=True)
