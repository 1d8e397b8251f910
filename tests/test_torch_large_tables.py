"""PyTorch port: the large-table slice against the JAX package on the CPU.

128-lane-packed storage (``nn.packed_table``: pack and unpack, the packed
lookup and its gradient), the scatter window of ``embedding_lookup``,
``training.sparse_tables.build_minibatch``, three dense Adam steps on
packed tables and three lazy-Adam steps on packed and on plain tables
against the JAX steps, the bridge of the lazy opt state, corpus refresh
and retrieval on a packed model, and the raises the JAX package keeps.
Tiny tables (256 rows, D = 16, so P = 8 logical rows a packed row, packed
from ``pack_tables_min_rows = 0``); both sides hold the same weights
(``bridge.params_from_jax``) and the same numpy batch, with duplicate ids
and ids that share a packed row.

Tolerances: lookups and the minitables move values and must be exact;
gradients of a lookup 1e-6 (sums of the same terms); losses 1e-6; the
train steps in f32 at 1e-4 of each leaf's largest magnitude, as
tests/test_torch_train_step.py holds the dense step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.nn import layers as jlayers
from two_tower_models_tpu.nn import packed_table as jpt
from two_tower_models_tpu.retrieval import mips as jmips
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import sparse_tables as jsparse
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.nn import layers as tlayers
from two_tower_models_tpu_torch.nn import packed_table as tpt
from two_tower_models_tpu_torch.retrieval import mips as tmips
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import sparse_tables as tsparse
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

V, D, B, H, F = 256, 16, 32, 8, 8
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V, item_id_embedding_dim=D,
    user_features_size=F, item_features_size=F, feature_hidden_dim=32,
    user_value_weights=(1.0, 0.5), history_len=H, debias="both",
)


def _configs():
    j = jcfg.ModelConfig(**SIZES, history_encoder=jcfg.HistoryEncoderConfig(num_heads=2, num_layers=1))
    t = tcfg.ModelConfig(**SIZES, history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=1))
    return j.validate(), t.validate()


def _batch_np(seed):
    """A batch with duplicate ids and ids sharing a packed row (P = 8)."""
    r = np.random.default_rng(seed)
    b = dict(
        user_id=r.integers(0, V, B).astype(np.int32),
        user_features=r.normal(size=(B, F)).astype(np.float32),
        user_history=r.integers(0, V, (B, H)).astype(np.int32),
        item_id=r.integers(0, V, B).astype(np.int32),
        item_features=r.normal(size=(B, F)).astype(np.float32),
        position=r.integers(0, 100, B).astype(np.int32),
        labels=r.binomial(1, 0.5, (B, 2)).astype(np.float32),
    )
    b["user_id"][:3] = [7, 7, 6]
    b["item_id"][:2] = [9, 10]
    b["user_history"][0, :3] = [9, 9, 255]
    return b


def _jbatch(b):
    return jtt.Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def _tbatch(b):
    return ttt.Batch(**{k: torch.from_numpy(v) for k, v in b.items()})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(got[name], np.float32), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("v,d", [(64, 32), (63, 32), (10, 64), (7, 16), (5, 128)])
def test_pack_unpack_matches_jax(v, d):
    table = np.random.default_rng(v * d).normal(size=(v, d)).astype(np.float32)
    got = tpt.pack_table(torch.from_numpy(table))
    want = np.asarray(jpt.pack_table(jnp.asarray(table)))
    assert tuple(got.shape) == tpt.packed_shape(v, d) == jpt.packed_shape(v, d)
    assert tpt.is_packed(got, d) == (tpt.pack_factor(d) > 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpt.unpack_table(got, v, d).numpy(), table)


def test_packed_lookup_and_grad_match_jax():
    """table_lookup on a packed table (and on the plain one) and the packed
    table's gradient, duplicates and packed-row partners included."""
    table = np.random.default_rng(1).normal(size=(40, 32)).astype(np.float32)
    ids = np.array([[0, 1, 8, 9, 10], [11, 8, 8, 39, 0]], np.int32)
    g = np.random.default_rng(2).normal(size=(2, 5, 32)).astype(np.float32)
    packed_j = jpt.pack_table(jnp.asarray(table))
    want_rows = jpt.table_lookup(packed_j, jnp.asarray(ids), 32)
    want_grad = jax.grad(lambda t: jnp.sum(jpt.table_lookup(t, jnp.asarray(ids), 32) * g))(packed_j)
    packed_t = torch.nn.Parameter(tpt.pack_table(torch.from_numpy(table)))
    rows = tpt.table_lookup(packed_t, torch.from_numpy(ids), 32)
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(tpt.table_lookup(torch.from_numpy(table), torch.from_numpy(ids), 32).numpy(),
                                  np.asarray(want_rows))
    (rows * torch.from_numpy(g)).sum().backward()
    assert packed_t.grad.shape == packed_t.shape
    np.testing.assert_allclose(packed_t.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)


def test_lookup_in_scatter_window_matches_jax():
    """A plain table of 2^18 rows (the window's lower edge) takes the
    lookup whose gradient is scatter_add_rows; its gradient equals the JAX
    package's custom VJP, and F.embedding's below the window."""
    v = tlayers._SCATTER_KERNEL_MIN_ROWS
    assert v == jlayers._SCATTER_KERNEL_MIN_ROWS and tlayers._SCATTER_KERNEL_MAX_ROWS == 1 << 22
    r = np.random.default_rng(3)
    table = r.normal(size=(v, 4)).astype(np.float32)
    ids = np.concatenate([r.integers(0, v, 60), [0, 0, v - 1]]).astype(np.int32)
    g = r.normal(size=(ids.size, 4)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jlayers.embedding_lookup(t, jnp.asarray(ids)) * g))(jnp.asarray(table))
    p = torch.nn.Parameter(torch.from_numpy(table))
    out = tlayers.embedding_lookup(p, torch.from_numpy(ids))
    assert out.grad_fn is not None and "Lookup" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with tlayers.disable_scatter_kernel():
        assert not tlayers._scatter_kernel_enabled
    assert tlayers._scatter_kernel_enabled


def test_packed_lookup_has_no_upper_window_edge():
    """At the window's upper edge a plain table keeps F.embedding's
    gradient, while a packed table of as many logical rows takes the lookup
    whose gradient is scatter_add_rows, carried back into the packed shape."""
    v = tlayers._SCATTER_KERNEL_MAX_ROWS
    ids = torch.tensor([[0, v - 1], [5, 5]])
    plain = torch.nn.Parameter(torch.zeros(v, 1))
    assert "Lookup" not in type(tpt.table_lookup(plain, ids, 1).grad_fn).__name__
    packed = torch.nn.Parameter(tpt.pack_table(torch.zeros(v, 1)))
    out = tpt.table_lookup(packed, ids, 1)
    assert "Lookup" in type(out.grad_fn).__name__
    out.sum().backward()
    want = torch.zeros(v, 1)
    want[[0, v - 1]], want[5] = 1.0, 2.0
    assert packed.grad.shape == packed.shape
    assert torch.equal(tpt.unpack_table(packed.grad, v, 1), want)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "plain"])
def test_build_minibatch_matches_jax(packed):
    """Minitables, remapped ids, sorted ids and duplicate masks equal the JAX
    package's; the loss on the minitables equals the full-table loss."""
    cfg_j, cfg_t = _configs()
    params = jtt.init_params(jax.random.key(0), cfg_j)
    if packed:
        params = jstate.maybe_pack_tables(params, cfg_j, jcfg.TrainConfig(pack_tables_min_rows=0))
    model = bridge.params_from_jax(_np(params), cfg_t, device="cpu")
    assert tpt.is_packed(model.item_id_table, D) == packed
    b = _batch_np(4)
    p2_j, b2_j, meta_j = jsparse.build_minibatch(cfg_j, params, _jbatch(b))
    p2_t, b2_t, meta_t = tsparse.build_minibatch(cfg_t, model, _tbatch(b))
    for name in tsparse.SPARSE_TABLE_KEYS:
        np.testing.assert_array_equal(getattr(p2_t, name).numpy(), np.asarray(p2_j[name]), err_msg=name)
        for a, w in zip(meta_t[name], meta_j[name]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=name)
    for field in ("user_id", "item_id", "user_history"):
        np.testing.assert_array_equal(getattr(b2_t, field).numpy(), np.asarray(getattr(b2_j, field)))
    assert p2_t.user_features_mlp is model.user_features_mlp
    assert model.item_id_table.shape == tuple(params["item_id_table"].shape)  # not swapped
    full, _ = ttt.train_loss(model, cfg_t, _tbatch(b))
    mini, _ = ttt.train_loss(p2_t, cfg_t, b2_t)
    want, _ = jtt.train_loss(p2_j, cfg_j, b2_j)
    np.testing.assert_allclose(float(mini.detach()), float(full.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(mini.detach()), float(want), rtol=1e-6)


def _mid_training(jst, lazy: bool, seed: int):
    """The JAX state at step 3 with moments from numpy: from zero moments a
    first Adam step moves a leaf by about lr whatever its gradient, which on
    the zero-in-exact-arithmetic leaves amplifies rounding noise."""
    r = np.random.default_rng(seed)
    mu = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray((r.normal(size=a.shape) * 1e-3).astype(np.float32)), t)
    nu = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray((r.uniform(0.5, 1.5, a.shape) * 1e-6).astype(np.float32)), t)
    three = jnp.asarray(3, jnp.int32)
    dense = jst.opt_state["dense"] if lazy else jst.opt_state
    adam = dense[0]._replace(count=three, mu=mu(dense[0].mu), nu=nu(dense[0].nu))
    opt = (adam, *dense[1:])
    if lazy:
        tables = jst.opt_state["tables"]
        opt = {"dense": opt, "tables": {"mu": mu(tables["mu"]), "nu": nu(tables["nu"])}}
    return jst._replace(step=three, opt_state=opt)


def _jax_lazy_np(opt_state):
    adam = opt_state["dense"][0]
    return {"dense": (np.asarray(adam.count), _np(adam.mu), _np(adam.nu)),
            "tables": _np(opt_state["tables"])}


@pytest.mark.parametrize(
    "lazy,packed", [(False, True), (True, True), (True, False)],
    ids=["dense-packed", "lazy-packed", "lazy-plain"],
)
def test_three_steps_follow_jax(lazy, packed):
    """Three make_train_step steps in f32 against the JAX step: metrics,
    params and every moment after each step.  The lazy opt state crosses
    the bridge both ways, and back unchanged."""
    cfg_j, cfg_t = _configs()
    kw = dict(batch_size=B, learning_rate=1e-3, lazy_table_adam=lazy, pack_tables=packed,
              pack_tables_min_rows=0)
    j_tcfg = jcfg.TrainConfig(**kw, donate_state=False)
    t_tcfg = tcfg.TrainConfig(**kw)
    jst = _mid_training(jstate.create_train_state(jax.random.key(7), cfg_j, j_tcfg), lazy, 8)
    model = bridge.params_from_jax(_np(jst.params), cfg_t, device="cpu")
    assert tpt.is_packed(model.user_id_table, D) == packed
    if lazy:
        np_state = _jax_lazy_np(jst.opt_state)
        opt = bridge.lazy_state_from_jax(np_state, model)
        back = bridge.lazy_state_to_jax(opt)
        _assert_tree_close(bridge.flatten(back), bridge.flatten(np_state), 0.0)
    else:
        adam = jst.opt_state[0]
        opt = bridge.adam_state_from_jax(adam.count, _np(adam.mu), _np(adam.nu), model)
    tst = tstate.TrainState(step=torch.tensor(3, dtype=torch.int32), params=model, opt_state=opt)

    b = {k: np.concatenate([_batch_np(20 + i)[k] for i in range(3)]) for k in _batch_np(0)}
    jd = jdata.SyntheticRecData(
        user_ids=b["user_id"], user_features=b["user_features"], user_history=b["user_history"],
        item_ids=b["item_id"], item_features=b["item_features"], positions=b["position"],
        labels=b["labels"], catalog_ids=np.arange(4), catalog_features=np.zeros((4, F), np.float32),
    )
    td = tdata.SyntheticRecData(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in jd))
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    for i in range(3):
        idx = np.arange(i * B, (i + 1) * B)
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _assert_tree_close({n: p.detach().numpy() for n, p in model.named_parameters()},
                           bridge.flatten(_np(jst.params)), 1e-4)
        if lazy:
            got, want = bridge.lazy_state_to_jax(tst.opt_state), _jax_lazy_np(jst.opt_state)
            assert int(got["dense"][0]) == int(want["dense"][0])
        else:
            adam = jst.opt_state[0]
            got = bridge.adam_state_to_jax(tst.opt_state)
            want = (np.asarray(adam.count), _np(adam.mu), _np(adam.nu))
            assert int(got[0]) == int(want[0])
        _assert_tree_close(bridge.flatten(got), bridge.flatten(want), 1e-4)
    assert int(tst.step) == int(jst.step) == 6


def test_packed_model_refreshes_and_retrieves():
    """refresh_corpus and retrieve accept a packed model: the corpus equals
    the JAX package's on the same packed params, and retrieval equals the
    plain model's."""
    cfg_j, cfg_t = _configs()
    cfg_j = dataclasses.replace(cfg_j, num_items=5)
    cfg_t = dataclasses.replace(cfg_t, num_items=5)
    params = jtt.init_params(jax.random.key(9), cfg_j)
    packed = jstate.maybe_pack_tables(params, cfg_j, jcfg.TrainConfig(pack_tables_min_rows=0))
    model = bridge.params_from_jax(_np(packed), cfg_t, device="cpu")
    plain = bridge.params_from_jax(_np(params), cfg_t, device="cpu")
    assert tpt.is_packed(model.item_id_table, D) and not tpt.is_packed(plain.item_id_table, D)
    r = np.random.default_rng(10)
    ids, feats = np.arange(V, dtype=np.int32), r.normal(size=(V, F)).astype(np.float32)
    want = np.asarray(jmips.refresh_corpus(packed, cfg_j, jnp.asarray(ids), jnp.asarray(feats)))
    with torch.inference_mode():
        corpus = tmips.refresh_corpus(model, cfg_t, torch.from_numpy(ids), torch.from_numpy(feats))
        assert torch.equal(corpus, tmips.refresh_corpus(plain, cfg_t, torch.from_numpy(ids),
                                                        torch.from_numpy(feats)))
    np.testing.assert_allclose(corpus.numpy(), want, rtol=1e-5, atol=1e-5)
    b = _batch_np(11)
    args = (b["user_id"], b["user_features"], b["user_history"])
    got = ttt.retrieve(model, cfg_t, corpus, *args, device="cpu")
    assert got.shape == (B, 5)
    assert torch.equal(got, ttt.retrieve(plain, cfg_t, corpus, *args, device="cpu"))


@pytest.mark.parametrize("min_rows,dim,shards,packs", [
    (256, 16, 1, True), (257, 16, 1, False), (0, 48, 1, False), (0, 16, 3, False), (0, 16, 4, True),
])
def test_maybe_pack_tables_follows_jax(min_rows, dim, shards, packs):
    """Packing needs at least pack_tables_min_rows rows, a dim dividing 128
    and physical rows that split over the model shards, as in JAX.
    create_train_state packs as one shard does, and not at all with
    pack_tables=False."""
    sizes = dict(SIZES, user_id_embedding_dim=dim, item_id_embedding_dim=dim)
    train = dict(pack_tables_min_rows=min_rows)
    cfg_j, cfg_t = jcfg.ModelConfig(**sizes), tcfg.ModelConfig(**sizes)
    params = jtt.init_params(jax.random.key(0), cfg_j)
    jp = jstate.maybe_pack_tables(params, cfg_j, jcfg.TrainConfig(**train), shards)
    model = ttt.init_params(0, cfg_t, device="cpu")
    tstate.maybe_pack_tables(model, cfg_t, tcfg.TrainConfig(**train), shards)
    assert tuple(model.item_id_table.shape) == tuple(jp["item_id_table"].shape)
    assert tpt.is_packed(model.item_id_table, dim) == packs
    one_shard = jstate.maybe_pack_tables(params, cfg_j, jcfg.TrainConfig(**train))
    st = tstate.create_train_state(0, cfg_t, tcfg.TrainConfig(**train), device="cpu")
    assert tuple(st.params.item_id_table.shape) == tuple(one_shard["item_id_table"].shape)
    st = tstate.create_train_state(0, cfg_t, tcfg.TrainConfig(**train, pack_tables=False), device="cpu")
    assert not tpt.is_packed(st.params.item_id_table, dim)


def test_lazy_raises_where_jax_raises():
    """Lazy Adam with a gradient clip, and lazy with fused Adam, raise in
    both packages, with the same exception types."""
    cfg_j, cfg_t = _configs()
    clip = dict(lazy_table_adam=True, grad_clip_norm=1.0)
    with pytest.raises(NotImplementedError, match="lazy_table_adam"):
        jstate.make_optimizer(jcfg.TrainConfig(**clip))
    with pytest.raises(NotImplementedError, match="lazy_table_adam"):
        tstate.make_optimizer(tcfg.TrainConfig(**clip))
    with pytest.raises(NotImplementedError, match="lazy_table_adam"):
        tstate.create_train_state(0, cfg_t, tcfg.TrainConfig(**clip), device="cpu")
    fused = dict(lazy_table_adam=True, fused_adam=True)
    with pytest.raises(ValueError, match="exclusive"):
        jstep.make_train_step(cfg_j, jcfg.TrainConfig(**fused))
    with pytest.raises(ValueError, match="exclusive"):
        tstep.make_train_step(cfg_t, tcfg.TrainConfig(**fused))
