"""PyTorch port: the per-layer attention tier end to end against the JAX
package on the CPU.  ``HistoryEncoderConfig(fused_kernel=True,
fused_encoder=False)`` runs every attention layer through
``fused_mha_layer`` (B13 forward, B14 backward; their plain versions
here): ``history_encoder_apply`` with and without PE and lengths, the
truncated-run property of the tier, ``train_loss`` and its gradients,
three Adam steps, and ``RetrievalEngine.query`` with and without
``history_len``.

Both sides hold the same weights (``bridge``) and the same numpy inputs;
the JAX side runs its Pallas kernels in interpret mode.  Tolerances are
those of tests/test_torch_encoder.py (encoder output: 1e-5 f32, 3e-2
bf16: a layer's output rounds to bf16 before the next), of
tests/test_history_lengths.py for the truncated runs (rtol 2e-4, atol
2e-5: another attention formulation in f32), and of
tests/test_torch_train_step.py (loss and each grad leaf relative to its
scale: 1e-4 f32, 1e-2 bf16; the Adam trajectory 1e-4); retrieved indices
exactly on rows whose k-th and (k+1)-th scores are clearly apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import _clear_margin_rows
from tests.test_torch_slice import _configs as _serve_configs
from tests.test_torch_slice import _inputs as _serve_inputs
from tests.test_torch_train_step import (
    TOL,
    _adam_leaf,
    _assert_tree_close,
    _batch_np,
    _both,
    _configs,
    _replace_adam,
)
from tests.test_torch_varlen_slice import _lengths, _varlen_batch
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import history_encoder as jhe
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.retrieval.mips import refresh_corpus as jax_refresh_corpus
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import history_encoder as the
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

LAYER = dict(fused_kernel=True, fused_encoder=False)  # the per-layer tier


def _layer_tier(cfg_j, cfg_t):
    """The model configs with their history encoder on the per-layer tier."""
    return tuple(
        dataclasses.replace(c, history_encoder=dataclasses.replace(c.history_encoder, **LAYER))
        for c in (cfg_j, cfg_t)
    )


def _encoders(d, nh, nl, seed, **cfg_kw):
    jc = jcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, **cfg_kw)
    tc = tcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, **cfg_kw)
    jparams = jhe.history_encoder_init(jax.random.key(seed), d, jc)
    enc = the.HistoryEncoder(d, tc)
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return jc, jparams, tc, enc


def _encode_both(jc, jparams, tc, enc, x, cd, lens):
    want = jhe.history_encoder_apply(
        jparams, jnp.asarray(x), jc, None if cd is None else jnp.bfloat16,
        lengths=None if lens is None else jnp.asarray(lens),
    )
    got = the.history_encoder_apply(
        enc, torch.from_numpy(x), tc, None if cd is None else torch.bfloat16,
        lengths=None if lens is None else torch.from_numpy(lens),
    )
    assert got.shape == want.shape and got.dtype == torch.float32
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_history_encoder_apply_layer_tier_matches_jax(use_pe, with_lens, cd):
    """history_encoder_apply on the per-layer tier: the PE (at each
    example's length under lengths), the zeroing, the f32 mean and the
    fused_mha_layer calls (one a layer), each cast to the compute dtype and back."""
    b, h, d, nh, nl = 16, 12, 32, 4, 2
    jc, jparams, tc, enc = _encoders(d, nh, nl, seed=31, use_positional_encoding=use_pe,
                                     **LAYER)
    r = np.random.default_rng(32)
    x = r.normal(size=(b, h, d)).astype(np.float32)
    lens = _lengths(r, b, h) if with_lens else None
    got, want = _encode_both(jc, jparams, tc, enc, x, cd, lens)
    tol = 1e-5 if cd is None else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
def test_layer_tier_equals_truncated_runs(use_pe):
    """As tests/test_history_lengths.py holds its fused_layer tier: with
    lengths, each example equals the dense encoder run on its truncated
    history (mean over L, keys masked, PE flipped at L); grads of the
    history are zero past each length and not zero before it."""
    h, d, nh, nl, b = 12, 16, 2, 2, 8
    cfg = tcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, use_positional_encoding=use_pe,
                                    **LAYER)
    enc = the.HistoryEncoder(d, cfg)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    r = np.random.default_rng(2)
    lens = torch.from_numpy(_lengths(r, b, h))
    emb = torch.from_numpy(r.normal(size=(b, h, d)).astype(np.float32)).requires_grad_()
    got = the.history_encoder_apply(enc, emb, cfg, lengths=lens)
    dense = dataclasses.replace(cfg, fused_kernel=False)
    with torch.no_grad():
        for i in range(b):
            n = int(lens[i])
            want = the.history_encoder_apply(enc, emb[i : i + 1, :n], dense)
            np.testing.assert_allclose(got[i].detach().numpy(), want[0].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=f"example {i} L={n}")
    (got**2).sum().backward()
    for i in range(b):
        n = int(lens[i])
        assert bool((emb.grad[i, n:] == 0).all())
        assert float(emb.grad[i, :n].abs().max()) > 0


@pytest.mark.parametrize("compute_dtype,varlen", [("float32", False), ("bfloat16", True)],
                         ids=["f32-full", "bf16-varlen"])
def test_train_loss_layer_tier_matches_jax(compute_dtype, varlen):
    """train_loss of the shrunk flagship on the per-layer tier (and the
    fused loss): metrics and every grad leaf against
    jax.value_and_grad(train_loss); in f32 on full histories, in bf16 on
    Batch.history_len (f32 on history_len: the Adam steps below)."""
    cfg_j, cfg_t = _layer_tier(*_configs(compute_dtype=compute_dtype))
    params, model = _both(cfg_j, cfg_t, seed=35)
    batch = _varlen_batch(36) if varlen else _batch_np(36)
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    )
    model.zero_grad()
    loss, tm = ttt.train_loss(model, cfg_t, ttt.Batch(**{k: torch.from_numpy(v)
                                                         for k, v in batch.items()}))
    loss.backward()
    tol = TOL[compute_dtype]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    _assert_tree_close(
        {n: p.grad.numpy() for n, p in model.named_parameters()},
        bridge.flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg)),
        tol, ttt.ZERO_GRAD_LEAVES,
    )


def test_three_adam_steps_layer_tier_follow_jax():
    """make_train_step in f32 on the per-layer tier, on variable-length
    data: params, the first Adam moment and metrics after each of three
    steps, from one mid-training Adam state on both sides (see
    tests/test_torch_train_step.py)."""
    cfg_j, cfg_t = _layer_tier(*_configs())
    b = _varlen_batch(37)
    n = b["user_id"].shape[0]
    j_tcfg = jcfg.TrainConfig(batch_size=n, learning_rate=1e-3, donate_state=False)
    t_tcfg = tcfg.TrainConfig(batch_size=n, learning_rate=1e-3)
    jst = jstate.create_train_state(jax.random.key(38), cfg_j, j_tcfg, pack=False)
    r = np.random.default_rng(39)
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
    fields = dict(
        user_ids=b["user_id"], user_features=b["user_features"], user_history=b["user_history"],
        item_ids=b["item_id"], item_features=b["item_features"], positions=b["position"],
        labels=b["labels"], catalog_ids=np.arange(4),
        catalog_features=np.zeros((4, b["item_features"].shape[1]), np.float32),
        history_lens=b["history_len"],
    )
    jd = jdata.SyntheticRecData(**{k: jnp.asarray(v) for k, v in fields.items()})
    td = tdata.SyntheticRecData(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()})
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    idx = np.arange(n)
    for _ in range(3):
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _assert_tree_close(
            {k: p.detach().numpy() for k, p in model.named_parameters()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, jst.params)), 1e-4,
        )
        _, t_mu, _ = bridge.adam_state_to_jax(tst.opt_state)
        _assert_tree_close(bridge.flatten(t_mu),
                           bridge.flatten(jax.tree_util.tree_map(np.asarray, _adam_leaf(jst.opt_state).mu)), 1e-4)


def test_engine_query_layer_tier_matches_jax():
    """RetrievalEngine.from_params / warmup / query in f32 on the per-layer
    tier, without and with history_len (id 0 past each length): JAX's user
    embeddings at 1e-5, and on clear-margin rows the indices of the exact
    top k of JAX's embeddings against JAX's corpus (which is what the JAX
    engine's exact MIPS returns)."""
    cfg_j, cfg_t = _layer_tier(*_serve_configs("float32"))
    a = _serve_inputs(40)
    params = jtt.init_params(jax.random.key(41), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ids, feats = a["catalog_ids"], a["catalog_feats"]
    corpus_j = np.asarray(jax_refresh_corpus(params, cfg_j, jnp.asarray(ids), jnp.asarray(feats)))
    eng_t = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    np.testing.assert_allclose(eng_t.corpus.numpy(), corpus_j, rtol=1e-5, atol=1e-5)
    eng_t.warmup(2)
    eng_t.warmup(2, variable_history=True)
    b, h = a["hist"].shape
    k = cfg_t.num_items
    varlen = _lengths(np.random.default_rng(42), b, h)
    for lens in (None, varlen):
        hist = a["hist"] if lens is None else np.where(
            np.arange(h)[None, :] < lens[:, None], a["hist"], 0).astype(np.int32)
        jin = [jnp.asarray(a["uid"]), jnp.asarray(a["feat"]), jnp.asarray(hist)]
        uemb_j, _ = jtt.compute_user_embedding(params, cfg_j, *jin,
                                               None if lens is None else jnp.asarray(lens))
        uemb_j = np.asarray(uemb_j)
        got = eng_t.query(a["uid"], a["feat"], hist, history_len=lens).numpy()
        with torch.no_grad():
            uemb_t, _ = ttt.compute_user_embedding(
                model, cfg_t, *(torch.from_numpy(t) for t in (a["uid"], a["feat"], hist)),
                None if lens is None else torch.from_numpy(lens),
            )
        np.testing.assert_allclose(uemb_t.numpy(), uemb_j, rtol=1e-5, atol=1e-5)
        scores = uemb_j.astype(np.float64) @ corpus_j.astype(np.float64).T
        want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        clear = _clear_margin_rows(uemb_j, corpus_j, k)
        assert clear.sum() >= b // 2
        np.testing.assert_array_equal(np.sort(got[clear], axis=1), np.sort(want[clear], axis=1))
