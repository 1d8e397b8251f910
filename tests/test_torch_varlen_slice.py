"""PyTorch port: variable-length histories end to end against the JAX
package on the CPU.  The history encoder's fused tier under ``lengths``,
``train_loss`` and its gradients with ``Batch.history_len``, three Adam
steps on variable-length data, ``retrieve`` with ``history_len``, and the
data module (``DataConfig``, ``make_synthetic_data``, ``epoch_batches``).

Both sides hold the same weights (``bridge.params_from_jax``) and the same
numpy inputs; the JAX side runs its Pallas kernels in interpret mode, the
port its kernels' plain versions.  Tolerances are those of
tests/test_torch_encoder.py (encoder output: 1e-5 f32, 3e-2 bf16) and
tests/test_torch_train_step.py (loss and each grad leaf relative to its
scale: 1e-4 f32, 1e-2 bf16; Adam trajectory 1e-4); retrieved indices
exactly on rows whose k-th and (k+1)-th scores are clearly apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (
    TOL,
    _adam_leaf,
    _assert_tree_close,
    _both,
    _configs,
    _replace_adam,
)
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import history_encoder as jhe
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import history_encoder as the
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

B, H, D, V, F = 64, 8, 32, 512, 16


def _lengths(r, b, h):
    """Lengths in [1, h] covering h, 1 and a mix."""
    lens = r.integers(1, h + 1, size=(b,)).astype(np.int32)
    lens[:2] = [h, 1]
    return lens


def _varlen_batch(seed):
    """A training batch with per-example lengths and id 0 past each one."""
    r = np.random.default_rng(seed)
    lens = _lengths(r, B, H)
    hist = r.integers(0, V, (B, H))
    return dict(
        user_id=r.integers(0, V, B).astype(np.int32),
        user_features=r.normal(size=(B, F)).astype(np.float32),
        user_history=np.where(np.arange(H)[None, :] < lens[:, None], hist, 0).astype(np.int32),
        item_id=r.integers(0, V, B).astype(np.int32),
        item_features=r.normal(size=(B, F)).astype(np.float32),
        position=r.integers(0, 100, B).astype(np.int32),
        labels=r.binomial(1, 0.5, (B, 3)).astype(np.float32),
        history_len=lens,
    )


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_history_encoder_lengths_fused_matches_jax(use_pe, cd):
    """history_encoder_apply with lengths on the fused tier: PE at each
    example's length, the f32 mean, and fused_attn_stack (its plain
    version) against the JAX fused tier."""
    b, h, d, nh, nl = 16, 12, 32, 4, 3
    jc = jcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, use_positional_encoding=use_pe,
                                   fused_encoder=True)
    tc = tcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, use_positional_encoding=use_pe,
                                   fused_encoder=True)
    jparams = jhe.history_encoder_init(jax.random.key(3), d, jc)
    enc = the.HistoryEncoder(d, tc)
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    r = np.random.default_rng(4)
    x = r.normal(size=(b, h, d)).astype(np.float32)
    lens = _lengths(r, b, h)
    want = jhe.history_encoder_apply(jparams, jnp.asarray(x), jc, None if cd is None else jnp.bfloat16,
                                     lengths=jnp.asarray(lens))
    got = the.history_encoder_apply(enc, torch.from_numpy(x), tc,
                                    None if cd is None else torch.bfloat16,
                                    lengths=torch.from_numpy(lens))
    assert got.shape == (b, 2, d) and got.dtype == torch.float32
    tol = 1e-5 if cd is None else 3e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_loss_varlen_matches_jax(compute_dtype):
    """train_loss of the shrunk flagship with Batch.history_len: metrics
    and every grad leaf against jax.value_and_grad(train_loss)."""
    cfg_j, cfg_t = _configs(compute_dtype=compute_dtype)
    params, model = _both(cfg_j, cfg_t, seed=21)
    batch = _varlen_batch(22)
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    )
    model.zero_grad()
    loss, tm = ttt.train_loss(model, cfg_t, ttt.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}))
    loss.backward()
    tol = TOL[compute_dtype]
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    _assert_tree_close(
        {n: p.grad.numpy() for n, p in model.named_parameters()},
        bridge.flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg)),
        tol, ttt.ZERO_GRAD_LEAVES,
    )


def test_three_adam_steps_varlen_follow_jax():
    """make_train_step in f32 on data with history_lens: params, the first
    Adam moment and metrics after each of three steps, from one mid-training
    Adam state on both sides (see tests/test_torch_train_step.py)."""
    cfg_j, cfg_t = _configs()
    j_tcfg = jcfg.TrainConfig(batch_size=B, learning_rate=1e-3, donate_state=False)
    t_tcfg = tcfg.TrainConfig(batch_size=B, learning_rate=1e-3)
    jst = jstate.create_train_state(jax.random.key(23), cfg_j, j_tcfg, pack=False)
    r = np.random.default_rng(24)
    np_params = jax.tree_util.tree_map(np.asarray, jst.params)
    mu = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * 1e-3).astype(np.float32), np_params)
    nu = jax.tree_util.tree_map(lambda a: (r.uniform(0.5, 1.5, a.shape) * 1e-6).astype(np.float32), np_params)
    adam = _adam_leaf(jst.opt_state)._replace(
        count=jnp.asarray(3, jnp.int32), mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu),
    )
    jst = jst._replace(opt_state=_replace_adam(jst.opt_state, adam))
    model = bridge.params_from_jax(np_params, cfg_t, device="cpu")
    tst = tstate.TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                            opt_state=bridge.adam_state_from_jax(3, mu, nu, model))
    b = _varlen_batch(25)
    fields = dict(
        user_ids=b["user_id"], user_features=b["user_features"], user_history=b["user_history"],
        item_ids=b["item_id"], item_features=b["item_features"], positions=b["position"],
        labels=b["labels"], catalog_ids=np.arange(4), catalog_features=np.zeros((4, F), np.float32),
        history_lens=b["history_len"],
    )
    jd = jdata.SyntheticRecData(**{k: jnp.asarray(v) for k, v in fields.items()})
    td = tdata.SyntheticRecData(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()})
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    idx = np.arange(B)
    for _ in range(3):
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _assert_tree_close(
            {n: p.detach().numpy() for n, p in model.named_parameters()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, jst.params)), 1e-4,
        )
        _, t_mu, _ = bridge.adam_state_to_jax(tst.opt_state)
        _assert_tree_close(bridge.flatten(t_mu),
                           bridge.flatten(jax.tree_util.tree_map(np.asarray, _adam_leaf(jst.opt_state).mu)), 1e-4)


def test_retrieve_varlen_matches_jax():
    """retrieve with history_len through the fused encoder (f32): the same
    user embeddings at 1e-5 and the same indices on clear-margin rows."""
    c, k = 2048, 10
    sizes = dict(user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=c,
                 item_id_embedding_dim=D, user_features_size=F, item_features_size=F,
                 feature_hidden_dim=64, history_len=H, num_items=k)
    cfg_j = jcfg.ModelConfig(**sizes, history_encoder=jcfg.HistoryEncoderConfig(
        num_heads=4, num_layers=2, fused_encoder=True))
    cfg_t = tcfg.ModelConfig(**sizes, history_encoder=tcfg.HistoryEncoderConfig(
        num_heads=4, num_layers=2, fused_encoder=True))
    params = jtt.init_params(jax.random.key(26), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    r = np.random.default_rng(27)
    corpus = r.normal(size=(c, D)).astype(np.float32)
    lens = _lengths(r, 32, H)
    hist = np.where(np.arange(H)[None, :] < lens[:, None], r.integers(0, c, (32, H)), 0).astype(np.int32)
    ins = [r.integers(0, V, 32).astype(np.int32), r.normal(size=(32, F)).astype(np.float32), hist, lens]
    want = np.asarray(jtt.retrieve(params, cfg_j, jnp.asarray(corpus), *map(jnp.asarray, ins[:3]),
                                   history_len=jnp.asarray(lens)))
    got = ttt.retrieve(model, cfg_t, torch.from_numpy(corpus), *ins[:3], history_len=lens,
                       device="cpu").numpy()
    uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *map(jnp.asarray, ins))
    with torch.no_grad():
        uemb_t, _ = ttt.compute_user_embedding(model, cfg_t, *map(torch.from_numpy, ins))
    np.testing.assert_allclose(uemb_t.numpy(), np.asarray(uemb_j), rtol=1e-5, atol=1e-5)
    s = -np.sort(-(np.asarray(uemb_j, np.float64) @ corpus.T.astype(np.float64)), axis=1)
    clear = (s[:, k - 1] - s[:, k]) > 1e-4 * np.abs(s[:, k - 1])
    assert clear.sum() >= 16
    np.testing.assert_array_equal(got[clear], want[clear])


def test_data_config_mirrors_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.DataConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.DataConfig)}
    assert jf == tf


@pytest.mark.parametrize("skew", [0.0, 1.0], ids=["uniform", "zipf"])
def test_make_synthetic_data_properties(skew):
    """Shapes and ranges, lengths in [1, H] with id 0 past each length, the
    8-group affinity in the labels (fair coins without it), Zipf ids in
    range with the head ahead of the tail, and catalog_logq equal to the
    JAX package's formula on the same item ids (1e-6, f32 logs)."""
    cfg = tcfg.DataConfig(num_samples=6000, num_users=500, num_items=300, feature_dim=8,
                          history_len=12, num_tasks=3, seed=5, variable_history=True,
                          popularity_skew=skew)
    d = tdata.make_synthetic_data(cfg, device="cpu")
    n, h, c = cfg.num_samples, cfg.history_len, cfg.num_items
    assert d.labels.shape == (n, 3) and set(d.labels.unique().tolist()) <= {0.0, 1.0}
    assert d.user_features.shape == d.item_features.shape == (n, 8)
    assert d.catalog_features.shape == (c, 8) and torch.equal(d.catalog_ids, torch.arange(c))
    lens = d.history_lens
    assert int(lens.min()) == 1 and int(lens.max()) == h
    past = torch.arange(h)[None, :] >= lens[:, None]
    assert bool((d.user_history[past] == 0).all()) and int(d.user_history.max()) < c
    assert 0 <= int(d.item_ids.min()) and int(d.item_ids.max()) < c
    assert 0 <= int(d.positions.min()) and int(d.positions.max()) < cfg.max_position
    on = (d.user_ids % 8 == d.item_ids % 8)
    assert abs(float(d.labels[on].mean()) - 0.8) < 0.05
    assert abs(float(d.labels[~on].mean()) - 0.1) < 0.05
    counts = torch.bincount(d.item_ids, minlength=c)
    if skew:
        assert int(counts[:10].sum()) > 5 * int(counts[-10:].sum())
    ids = jnp.asarray(d.item_ids.numpy())
    want = jnp.log((jnp.bincount(ids, length=c).astype(jnp.float32) + 1.0) / (n + c))
    np.testing.assert_allclose(d.catalog_logq.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    again = tdata.make_synthetic_data(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))  # a function of the seed
    coins = tdata.make_synthetic_data(cfg, structured=False, label_cols=2, device="cpu")
    assert coins.labels.shape == (n, 2) and abs(float(coins.labels.mean()) - 0.5) < 0.05

    gen = torch.Generator().manual_seed(0)
    batches = list(tdata.epoch_batches(gen, n, 1024))
    assert len(batches) == n // 1024 and all(b.shape == (1024,) for b in batches)
    seen = torch.cat(batches)
    assert seen.unique().numel() == seen.numel() and int(seen.max()) < n
