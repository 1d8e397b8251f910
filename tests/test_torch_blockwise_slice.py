"""PyTorch port: the blockwise attention tier end to end against the JAX
package on the CPU.  ``HistoryEncoderConfig(blockwise_kernel=True,
fused_encoder=False)`` runs every attention layer's attention through
``blockwise_self_attention`` (B15 forward; B16, B17 backward; their plain
versions here) between the layer's projections, with two heads folded
into the leading axis (n = b * heads + head) and the lengths repeated per
head: ``history_encoder_apply`` with and without PE and lengths, the
truncated-run property, ``train_loss`` and its gradients, and
``RetrievalEngine.query`` with and without ``history_len``.  With
``fused_kernel`` set too, the per-layer fused kernel runs, as the JAX
``mha_apply`` reads ``fused`` first.

Both sides hold the same weights (``bridge``) and the same numpy inputs;
the JAX side runs its Pallas kernels in interpret mode.  Tolerances are
those of tests/test_torch_layer_slice.py: the encoder output 1e-5 f32 and
3e-2 bf16, the truncated runs rtol 2e-4 and atol 2e-5, the loss and each
grad leaf relative to its scale 1e-4 f32 and 1e-2 bf16; retrieved indices
exactly on rows whose k-th and (k+1)-th scores are clearly apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_layer_slice import _encode_both, _encoders
from tests.test_torch_slice import _clear_margin_rows
from tests.test_torch_slice import _configs as _serve_configs
from tests.test_torch_slice import _inputs as _serve_inputs
from tests.test_torch_train_step import TOL, _assert_tree_close, _batch_np, _both, _configs
from tests.test_torch_varlen_slice import _lengths, _varlen_batch
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.retrieval.mips import refresh_corpus as jax_refresh_corpus
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import history_encoder as the
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.nn import attention as tattn
from two_tower_models_tpu_torch.serving import RetrievalEngine

BLOCKWISE = dict(blockwise_kernel=True, fused_encoder=False)  # the blockwise tier


def _blockwise_tier(cfg_j, cfg_t):
    """The model configs with their history encoder on the blockwise tier."""
    return tuple(
        dataclasses.replace(c, history_encoder=dataclasses.replace(c.history_encoder, **BLOCKWISE))
        for c in (cfg_j, cfg_t)
    )


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_history_encoder_apply_blockwise_tier_matches_jax(use_pe, with_lens, cd):
    """history_encoder_apply on the blockwise tier, two heads of distinct
    lengths per example: the fold order of heads and lengths, the PE (at
    each example's length under lengths), the zeroing and the f32 mean."""
    b, h, d, nh, nl = 16, 12, 32, 2, 2
    jc, jparams, tc, enc = _encoders(d, nh, nl, seed=51, use_positional_encoding=use_pe,
                                     **BLOCKWISE)
    r = np.random.default_rng(52)
    x = r.normal(size=(b, h, d)).astype(np.float32)
    lens = _lengths(r, b, h) if with_lens else None
    got, want = _encode_both(jc, jparams, tc, enc, x, cd, lens)
    tol = 1e-5 if cd is None else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_blockwise_tier_equals_truncated_runs():
    """As tests/test_history_lengths.py holds its tiers: with lengths, each
    example equals the dense encoder run on its truncated history; grads of
    the history are zero past each length and not zero before it."""
    h, d, nh, nl, b = 12, 16, 2, 2, 8
    cfg = tcfg.HistoryEncoderConfig(num_heads=nh, num_layers=nl, **BLOCKWISE)
    enc = the.HistoryEncoder(d, cfg)
    enc.reset_parameters(torch.Generator().manual_seed(1))
    r = np.random.default_rng(53)
    lens = torch.from_numpy(_lengths(r, b, h))
    emb = torch.from_numpy(r.normal(size=(b, h, d)).astype(np.float32)).requires_grad_()
    got = the.history_encoder_apply(enc, emb, cfg, lengths=lens)
    dense = dataclasses.replace(cfg, blockwise_kernel=False)
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


@pytest.mark.parametrize(
    "compute_dtype,varlen",
    [("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)],
    ids=["f32-full", "f32-varlen", "bf16-full", "bf16-varlen"],
)
def test_train_loss_blockwise_tier_matches_jax(compute_dtype, varlen):
    """train_loss of the shrunk flagship on the blockwise tier (and the
    fused loss): metrics and every grad leaf against
    jax.value_and_grad(train_loss), on full histories and on
    Batch.history_len."""
    cfg_j, cfg_t = _blockwise_tier(*_configs(compute_dtype=compute_dtype))
    params, model = _both(cfg_j, cfg_t, seed=55)
    batch = _varlen_batch(56) if varlen else _batch_np(56)
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


def test_engine_query_blockwise_tier_matches_jax():
    """RetrievalEngine.from_params / warmup / query in f32 on the blockwise
    tier, without and with history_len (id 0 past each length): JAX's user
    embeddings at 1e-5, and on clear-margin rows the indices of the exact
    top k of JAX's embeddings against JAX's corpus."""
    cfg_j, cfg_t = _blockwise_tier(*_serve_configs("float32"))
    a = _serve_inputs(60)
    params = jtt.init_params(jax.random.key(61), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ids, feats = a["catalog_ids"], a["catalog_feats"]
    corpus_j = np.asarray(jax_refresh_corpus(params, cfg_j, jnp.asarray(ids), jnp.asarray(feats)))
    eng_t = RetrievalEngine.from_params(model, cfg_t, ids, feats, device="cpu")
    eng_t.warmup(2)
    eng_t.warmup(2, variable_history=True)
    b, h = a["hist"].shape
    k = cfg_t.num_items
    varlen = _lengths(np.random.default_rng(62), b, h)
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


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
def test_fused_kernel_wins_over_blockwise(monkeypatch, with_lens):
    """fused_kernel and blockwise_kernel both set: every layer runs
    fused_mha_layer (its plain version here) and never
    blockwise_self_attention, as the JAX mha_apply reads ``fused`` first;
    the output equals JAX's at 1e-5."""
    b, h, d, nh, nl = 6, 10, 32, 2, 2
    jc, jparams, tc, enc = _encoders(d, nh, nl, seed=57, fused_kernel=True, **BLOCKWISE)
    calls = {"fused": 0, "blockwise": 0}
    for name, key in (("fused_mha_layer", "fused"), ("blockwise_self_attention", "blockwise")):
        def spy(*args, _f=getattr(tattn, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(tattn, name, spy)
    r = np.random.default_rng(58)
    x = r.normal(size=(b, h, d)).astype(np.float32)
    lens = _lengths(r, b, h) if with_lens else None
    got, want = _encode_both(jc, jparams, tc, enc, x, None, lens)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert calls == {"fused": nl, "blockwise": 0}
