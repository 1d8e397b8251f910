"""PyTorch port: raw-key ingest (``training.ingest``) and
``RetrievalEngine.query_raw`` against the JAX package on the CPU.

The seven cases of ``tests/test_ingest.py``, each held against JAX's
function on the same keys (slots bit for bit); ``query_raw`` against JAX's
``query_raw`` on the same weights (``bridge.params_from_jax``) and the same
raw keys, top-k indices equal on every row whose k-th and (k+1)-th scores
are clearly apart (``tests/test_torch_slice.py``'s construction); and one
``make_train_step`` on an ingested batch against JAX's at 1e-4 of each
leaf's scale (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu import serving as jserving
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import ingest as jingest
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch import native
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import ingest
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

SMALL = dict(history_len=4, user_id_hash_size=128, item_id_hash_size=64,
             user_id_embedding_dim=16, item_id_embedding_dim=16)
CFG_J = jcfg.preset("two_tower_with_user_history_encoder", **SMALL)
CFG_T = tcfg.preset("two_tower_with_user_history_encoder", **SMALL)


def _same(got, want):
    assert got.dtype == np.int32 and got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(got, want)


def test_ingest_shapes_ranges_and_stability():
    users = np.array([f"u{i}" for i in range(10)])
    items = np.array([f"i{i}" for i in range(10)])
    hist = np.array([[f"i{i + j}" for j in range(4)] for i in range(10)])
    got = ingest.ingest_example_keys(CFG_T, users, items, hist)
    for g, w in zip(got, jingest.ingest_example_keys(CFG_J, users, items, hist)):
        _same(g, w)
    uid, iid, h = got
    assert uid.shape == (10,) and iid.shape == (10,) and h.shape == (10, 4)
    assert (uid >= 0).all() and (uid < CFG_T.user_id_hash_size).all()
    assert (iid >= 0).all() and (iid < CFG_T.item_id_hash_size).all()
    assert (h >= 0).all() and (h < CFG_T.item_id_hash_size).all()
    for g, w in zip(got, ingest.ingest_example_keys(CFG_T, users, items, hist)):
        np.testing.assert_array_equal(g, w)  # stable seeds: the same slots every call
    # history hashes with the ITEM seed: same key -> same slot as item keys
    np.testing.assert_array_equal(h[:, 0], ingest.hash_item_keys(hist[:, 0], CFG_T))


def test_ingest_integer_and_string_keys_dispatch():
    int_keys = np.arange(20, dtype=np.uint64) + 10**12
    _same(ingest.hash_user_keys(int_keys, CFG_T), jingest.hash_user_keys(int_keys, CFG_J))
    _same(ingest.hash_user_keys(int_keys, CFG_T),
          native.hash_ids(int_keys, CFG_T.user_id_hash_size, seed=ingest.USER_TABLE_SEED))
    signed = np.array([-1, -(1 << 63), 0, 7], np.int64)  # signed ids wrap to uint64
    _same(ingest.hash_item_keys(signed, CFG_T), jingest.hash_item_keys(signed, CFG_J))

    str_keys = [f"k{i}" for i in range(20)]
    for keys in (np.array(str_keys), np.array([k.encode() for k in str_keys])):  # U and S
        _same(ingest.hash_item_keys(keys, CFG_T), jingest.hash_item_keys(keys, CFG_J))
    _same(ingest.hash_item_keys(np.array(str_keys), CFG_T),
          native.hash_strings(str_keys, CFG_T.item_id_hash_size, seed=ingest.ITEM_TABLE_SEED))
    assert (ingest.USER_TABLE_SEED, ingest.ITEM_TABLE_SEED) == (
        jingest.USER_TABLE_SEED, jingest.ITEM_TABLE_SEED)

    for bad in (np.zeros(3, np.float32), np.array([True, False])):
        with pytest.raises(TypeError):
            jingest.hash_user_keys(bad, CFG_J)
        with pytest.raises(TypeError):
            ingest.hash_user_keys(bad, CFG_T)


def test_user_item_seeds_decorrelate():
    keys = np.array([f"key{i}" for i in range(200)])
    small = dict(user_id_hash_size=64, item_id_hash_size=64)
    cfg_j = jcfg.preset("two_tower_base_retrieval", **small)
    cfg_t = tcfg.preset("two_tower_base_retrieval", **small)
    u, i = ingest.hash_user_keys(keys, cfg_t), ingest.hash_item_keys(keys, cfg_t)
    _same(u, jingest.hash_user_keys(keys, cfg_j))
    _same(i, jingest.hash_item_keys(keys, cfg_j))
    assert (u == i).mean() < 0.2  # same raw keys land on different slot maps


def _ingested_batch(n, seed):
    """An ingested batch of n string-keyed rows, as numpy for both sides."""
    rng = np.random.default_rng(seed)
    users = np.array([f"user{i}" for i in range(n)])
    items = np.array([f"item{i}" for i in range(n)])
    hist = np.array([[f"item{(i + j) % n}" for j in range(4)] for i in range(n)])
    uid, iid, h = ingest.ingest_example_keys(CFG_T, users, items, hist)
    for g, w in zip((uid, iid, h), jingest.ingest_example_keys(CFG_J, users, items, hist)):
        _same(g, w)
    return dict(
        user_id=uid, user_features=rng.standard_normal((n, CFG_T.user_features_size)).astype(np.float32),
        user_history=h, item_id=iid,
        item_features=rng.standard_normal((n, CFG_T.item_features_size)).astype(np.float32),
        position=np.zeros((n,), np.int32), labels=np.ones((n, CFG_T.num_tasks), np.float32),
    )


def _both(seed):
    params = jtt.init_params(jax.random.key(seed), CFG_J)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), CFG_T, device="cpu")
    return params, model


def test_training_on_ingested_batch():
    """train_loss on an ingested batch: finite, and equal to JAX's on the
    same weights within 1e-5 (f32)."""
    batch = _ingested_batch(16, 0)
    params, model = _both(0)
    jloss, jm = jtt.train_loss(params, CFG_J, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        tloss, tm = ttt.train_loss(model, CFG_T, ttt.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def _engine_pair(cfg_j, cfg_t, n_catalog, seed):
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    catalog_keys = np.array([f"item{i}" for i in range(n_catalog)])
    ids = ingest.hash_item_keys(catalog_keys, cfg_t)
    _same(ids, jingest.hash_item_keys(catalog_keys, cfg_j))
    feats = np.random.default_rng(seed + 1).standard_normal(
        (n_catalog, cfg_t.item_features_size)).astype(np.float32)
    eng_j = jserving.RetrievalEngine.from_params(params, cfg_j, jnp.asarray(ids), jnp.asarray(feats))
    eng_t = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    return params, eng_j, eng_t


def test_serving_query_raw_matches_prehashed():
    _, eng_j, eng_t = _engine_pair(CFG_J, CFG_T, 40, 0)
    users = np.array([f"user{i}" for i in range(8)])
    hist = np.array([[f"item{(i + j) % 40}" for j in range(4)] for i in range(8)])
    feats = np.random.default_rng(2).standard_normal((8, CFG_T.user_features_size)).astype(np.float32)
    raw = eng_t.query_raw(users, feats, hist)
    pre = eng_t.query(torch.from_numpy(ingest.hash_user_keys(users, CFG_T)), feats,
                      torch.from_numpy(ingest.hash_item_keys(hist, CFG_T)))
    assert raw.shape == (8, CFG_T.num_items) and raw.device.type == "cpu"
    assert torch.equal(raw, pre)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(eng_j.query_raw(users, jnp.asarray(feats), hist)))


C, B, D, H, K = 4096, 16, 32, 8, 10
WIDE = dict(user_id_hash_size=512, user_id_embedding_dim=D, item_id_hash_size=C,
            item_id_embedding_dim=D, user_features_size=8, item_features_size=8,
            feature_hidden_dim=64, user_value_weights=(1.0, 0.5, 0.25), history_len=H,
            num_items=K)


def _clear_margin_rows(user_emb, corpus, k, rel=1e-4):
    s = -np.sort(-(np.asarray(user_emb, np.float64) @ np.asarray(corpus, np.float64).T), axis=1)
    return (s[:, k - 1] - s[:, k]) > rel * np.abs(s[:, k - 1])


@pytest.mark.parametrize("kind", ["str", "u64"])
def test_query_raw_matches_jax_query_raw(kind):
    """The serving slice's width (the fused encoder, Debias.BOTH, f32, a
    4096-item catalog of string keys hashed into 4096 slots, collisions
    kept): the port's query_raw against JAX's on the same raw keys."""
    cfg_j = jcfg.ModelConfig(**WIDE, history_encoder=jcfg.HistoryEncoderConfig(
        num_heads=4, num_layers=2, fused_encoder=True), debias=jcfg.Debias.BOTH)
    cfg_t = tcfg.ModelConfig(**WIDE, history_encoder=tcfg.HistoryEncoderConfig(
        num_heads=4, num_layers=2, fused_encoder=True), debias=tcfg.Debias.BOTH)
    params, eng_j, eng_t = _engine_pair(cfg_j, cfg_t, C, 5)
    np.testing.assert_allclose(eng_t.corpus.numpy(), np.asarray(eng_j.corpus), rtol=1e-5, atol=1e-5)
    r = np.random.default_rng(11)
    if kind == "str":
        users = np.array([f"user:{i:04d}@example.com" for i in r.integers(0, 10_000, B)])
        hist = np.array([f"item{i}" for i in r.integers(0, C, B * H)]).reshape(B, H)
    else:
        users = r.integers(0, 1 << 64, B, dtype=np.uint64)
        users[:2] = [0, (1 << 64) - 1]
        hist = r.integers(0, 1 << 64, (B, H), dtype=np.uint64)
    feats = r.normal(size=(B, 8)).astype(np.float32)
    want = np.asarray(eng_j.query_raw(users, jnp.asarray(feats), hist))
    got = eng_t.query_raw(users, feats, hist).numpy()
    slots = [jnp.asarray(jingest.hash_user_keys(users, cfg_j)), jnp.asarray(feats),
             jnp.asarray(jingest.hash_item_keys(hist, cfg_j))]
    uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *slots)
    clear = _clear_margin_rows(uemb_j, eng_j.corpus, K)
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(got[clear], want[clear])


def test_object_dtype_int_keys_take_the_int_path():
    """Object-dtype integer keys (pandas nullable columns, Python ints beyond
    int64) hash as integers, modulo 2^64, as JAX's do."""
    sizes = dict(user_id_hash_size=1024, user_id_embedding_dim=8, item_id_hash_size=1024,
                 item_id_embedding_dim=8, user_features_size=4, item_features_size=4,
                 user_value_weights=(1.0,))
    cfg_j, cfg_t = jcfg.ModelConfig(**sizes), tcfg.ModelConfig(**sizes)
    obj = np.array([7, 10**13, (1 << 64) + 7, 7, -1, (1 << 63) + 5], dtype=object)
    slots = ingest.hash_user_keys(obj, cfg_t)
    _same(slots, jingest.hash_user_keys(obj, cfg_j))
    ref = ingest.hash_user_keys(np.array([7, 10**13, (1 << 64) - 1, (1 << 63) + 5], np.uint64), cfg_t)
    assert slots[0] == ref[0] and slots[1] == ref[1] and slots[4] == ref[2] and slots[5] == ref[3]
    assert slots[2] == slots[0] and slots[3] == slots[0]  # mod-2^64 wrap
    mixed_str = np.array(["a", b"b"], dtype=object)
    _same(ingest.hash_user_keys(mixed_str, cfg_t), jingest.hash_user_keys(mixed_str, cfg_j))
    for bad in (np.array([7, "user_a"], dtype=object), np.array([1.5, 2.5], dtype=object)):
        with pytest.raises(TypeError):
            jingest.hash_user_keys(bad, cfg_j)
        with pytest.raises(TypeError):
            ingest.hash_user_keys(bad, cfg_t)


def test_hash_strings_rejects_non_string_keys():
    with pytest.raises(TypeError):
        jingest.hash_strings([3], 128)
    with pytest.raises(TypeError):
        native.hash_strings([3], 128)


def _adam_leaf(state):
    """optax's ScaleByAdamState inside the adam chain's state."""
    for node in state if isinstance(state, tuple) else ():
        if hasattr(node, "mu"):
            return node
        if isinstance(node, tuple):
            found = _adam_leaf(node)
            if found is not None:
                return found
    return None


def _replace_adam(state, new):
    if hasattr(state, "mu"):
        return new
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(_replace_adam(s, new) for s in state)
    return state


def test_train_step_on_ingested_batch_matches_jax():
    """One make_train_step (Adam, f32) on a batch of string keys ingested on
    both sides: metrics, params and moments within 1e-4 of JAX's.  Both
    start from one mid-training Adam state (count 3), as
    tests/test_torch_train_step.py does: from zero moments a first step
    moves a leaf by about lr whatever its gradient, and the leaves whose
    gradient is zero in exact arithmetic hold only rounding noise."""
    n = 32
    batch = _ingested_batch(n, 3)
    j_tcfg = jcfg.TrainConfig(batch_size=n, learning_rate=1e-3, donate_state=False)
    t_tcfg = tcfg.TrainConfig(batch_size=n, learning_rate=1e-3)
    jst = jstate.create_train_state(jax.random.key(4), CFG_J, j_tcfg, pack=False)
    r = np.random.default_rng(6)
    np_params = jax.tree_util.tree_map(np.asarray, jst.params)
    mu = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * 1e-3).astype(np.float32), np_params)
    nu = jax.tree_util.tree_map(lambda a: (r.uniform(0.5, 1.5, a.shape) * 1e-6).astype(np.float32), np_params)
    adam = _adam_leaf(jst.opt_state)._replace(
        count=jnp.asarray(3, jnp.int32), mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu))
    jst = jst._replace(opt_state=_replace_adam(jst.opt_state, adam))
    model = bridge.params_from_jax(np_params, CFG_T, device="cpu")
    tst = tstate.TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                            opt_state=bridge.adam_state_from_jax(3, mu, nu, model))
    common = dict(user_ids=batch["user_id"], user_features=batch["user_features"],
                  user_history=batch["user_history"], item_ids=batch["item_id"],
                  item_features=batch["item_features"], positions=batch["position"],
                  labels=batch["labels"], catalog_ids=np.arange(4, dtype=np.int32),
                  catalog_features=np.zeros((4, CFG_T.item_features_size), np.float32))
    jd = jdata.SyntheticRecData(**common)
    td = tdata.SyntheticRecData(**{k: torch.from_numpy(v) for k, v in common.items()})
    idx = np.arange(n)
    jst, jm = jstep.make_train_step(CFG_J, j_tcfg)(jst, jd, jnp.asarray(idx))
    tst, tm = tstep.make_train_step(CFG_T, t_tcfg)(tst, td, torch.from_numpy(idx))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jst.params))
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * float(np.abs(w).max()), err_msg=k)
    _, t_mu, _ = bridge.adam_state_to_jax(tst.opt_state)
    j_mu = bridge.flatten(jax.tree_util.tree_map(np.asarray, _adam_leaf(jst.opt_state).mu))
    for k, w in bridge.flatten(t_mu).items():
        np.testing.assert_allclose(w, j_mu[k], rtol=0, atol=1e-4 * float(np.abs(j_mu[k]).max()), err_msg=k)
