"""PyTorch port: the streaming logQ frequency estimator
(``training.freq_estimator``) and the train state's ``rng`` and
``logq_state`` against the JAX package on the CPU.

``freq_update`` and ``freq_log_prob`` over 50 Zipf batches from one state,
the bridge of the estimator state, ``create_train_state``'s checks, and,
on the port alone, the exact resume of ``rng`` and ``logq_state`` through a
checkpoint, a K-step dispatch against K single steps, and the plain path
that draws nothing.

Tolerance: the JAX package adds 1.0 once per occurrence of a slot, the port
adds the slot's integer count once, so the two round differently where a
sum crosses a power of two inside a batch (one unit in the last place at
most, decayed after); the counts, the total and log p are held at 1e-6
relative (log p at 1e-6 absolute).  The port against itself: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.training import freq_estimator as jfe
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.training import checkpoint as tckpt
from two_tower_models_tpu_torch.training import freq_estimator as tfe
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep
from two_tower_models_tpu_torch.training.data import make_synthetic_data

MODEL = tcfg.preset(
    "two_tower_with_user_history_encoder", user_id_hash_size=64, item_id_hash_size=64,
    user_id_embedding_dim=16, item_id_embedding_dim=16, user_features_size=8,
    item_features_size=8, feature_hidden_dim=32, history_len=4,
    history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=1),
    user_value_weights=(1.0, 0.5), mixed_negatives=8, logq_correction=True,
)
DATA = tcfg.DataConfig(num_samples=256, num_users=64, num_items=64, feature_dim=8,
                       history_len=4, num_tasks=2, popularity_skew=1.0)
TRAIN = tcfg.TrainConfig(batch_size=32, learning_rate=1e-3, streaming_logq=True,
                         logq_decay=0.9, seed=3)


def _zipf(c, n, seed):
    p = 1.0 / np.arange(1, c + 1)
    return np.random.default_rng(seed).choice(c, size=n, p=p / p.sum()).astype(np.int32)


@pytest.mark.parametrize("c,b,decay", [(200, 64, 0.99), (64, 4096, 0.999), (500, 256, 0.9)],
                         ids=["C200-B64", "C64-B4096", "C500-B256"])
def test_freq_update_and_log_prob_match_jax_over_50_zipf_batches(c, b, decay):
    """50 Zipf batches folded in from one state; at B = 4096 over 64 slots
    the head slot takes hundreds of occurrences a batch and its count
    crosses powers of two, where the two libraries' rounding differs."""
    jest, test = jfe.init_freq_estimator(c), tfe.init_freq_estimator(c)
    upd = jax.jit(lambda e, pos: jfe.freq_update(e, pos, decay))
    for i in range(50):
        pos = _zipf(c, b, i)
        jest = upd(jest, jnp.asarray(pos))
        test = tfe.freq_update(test, torch.from_numpy(pos), decay)
    np.testing.assert_allclose(test.counts.numpy(), np.asarray(jest.counts), rtol=1e-6)
    np.testing.assert_allclose(float(test.total), float(jest.total), rtol=1e-6)
    np.testing.assert_allclose(tfe.freq_log_prob(test).numpy(), np.asarray(jfe.freq_log_prob(jest)),
                               rtol=0, atol=1e-6)


def test_estimator_bridge_round_trip():
    r = np.random.default_rng(1)
    counts, total = r.uniform(0, 50, 30).astype(np.float32), np.float32(123.25)
    est = bridge.freq_state_from_jax(counts, total, "cpu")
    assert est.counts.dtype == est.total.dtype == torch.float32 and est.total.shape == ()
    got_c, got_t = bridge.freq_state_to_jax(est)
    np.testing.assert_array_equal(got_c, counts)
    assert got_t == total
    want = jfe.freq_log_prob(jfe.FreqEstimatorState(jnp.asarray(counts), jnp.asarray(total)))
    np.testing.assert_allclose(tfe.freq_log_prob(est).numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("logq,catalog", [(False, 64), (True, None)], ids=["no-logq", "no-catalog"])
def test_create_train_state_refuses_where_jax_does(logq, catalog):
    """streaming_logq needs logq_correction and a catalog size, on both
    sides with the same message."""
    j_model = jcfg.ModelConfig(logq_correction=logq)
    t_model = tcfg.ModelConfig(logq_correction=logq)
    with pytest.raises(ValueError) as want:
        jstate.create_train_state(jax.random.key(0), j_model,
                                  jcfg.TrainConfig(streaming_logq=True), catalog_size=catalog)
    with pytest.raises(ValueError) as got:
        tstate.create_train_state(0, t_model, tcfg.TrainConfig(streaming_logq=True), device="cpu",
                                  catalog_size=catalog)
    assert str(got.value) == str(want.value)


def test_create_train_state_holds_rng_and_estimator():
    st = tstate.create_train_state(0, MODEL, TRAIN, device="cpu", catalog_size=64)
    assert isinstance(st.rng, torch.Generator)
    assert st.logq_state.counts.shape == (64,) and float(st.logq_state.counts.abs().sum()) == 0
    plain = tstate.create_train_state(0, MODEL, dataclasses.replace(TRAIN, streaming_logq=False),
                                      device="cpu")
    assert plain.logq_state is None
    again = tstate.create_train_state(0, MODEL, TRAIN, device="cpu", catalog_size=64)
    assert torch.equal(again.rng.get_state(), st.rng.get_state())


def _run(state, step, data, lo, hi, b=32):
    with torch.enable_grad():
        for i in range(lo, hi):
            state, _ = step(state, data, torch.arange(i * b, (i + 1) * b) % data.num_samples)
    return state


def _tensors(state):
    return {k: v.detach().clone() for k, v in tckpt.state_tensors(state).items()}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("lazy", [False, True], ids=["adam", "lazy"])
def test_checkpoint_resumes_rng_and_estimator_bit_equal(tmp_path, async_save, lazy):
    """Two steps, a checkpoint, two more; the checkpoint restored into a
    state from another seed and the same two steps run again: every tensor
    of the state bit-equal, ``rng`` and ``logq`` among them."""
    tc = dataclasses.replace(TRAIN, lazy_table_adam=lazy)
    cfg = tcfg.resolve_kernel_flags(MODEL, "cpu")
    data = make_synthetic_data(DATA, label_cols=cfg.num_tasks, device="cpu")
    step = tstep.make_train_step(cfg, tc)
    state = _run(tstate.create_train_state(0, cfg, tc, device="cpu", catalog_size=64),
                 step, data, 0, 2)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=async_save, device="cpu")
    mgr.save(state)
    saved = _tensors(state)
    assert {"rng", "logq.counts", "logq.total"} <= saved.keys()
    want = _tensors(_run(state, step, data, 2, 4))
    template = tstate.create_train_state(9, cfg, tc, device="cpu", catalog_size=64)
    restored = mgr.restore_latest(template)
    mgr.close()
    _assert_equal(_tensors(restored), saved)
    _assert_equal(_tensors(_run(restored, step, data, 2, 4)), want)


def test_k_step_dispatch_equals_single_steps():
    """steps_per_dispatch = 2 with negatives and the streaming estimator:
    each of the K steps draws its own negatives and folds its own batch in,
    so the state after one [2, B] dispatch is bit-equal to two single
    steps'."""
    cfg = tcfg.resolve_kernel_flags(MODEL, "cpu")
    data = make_synthetic_data(DATA, label_cols=cfg.num_tasks, device="cpu")
    one = tstep.make_train_step(cfg, TRAIN)
    two = tstep.make_train_step(cfg, dataclasses.replace(TRAIN, steps_per_dispatch=2))
    a = _run(tstate.create_train_state(0, cfg, TRAIN, device="cpu", catalog_size=64),
             one, data, 0, 2)
    b = tstate.create_train_state(0, cfg, TRAIN, device="cpu", catalog_size=64)
    with torch.enable_grad():
        b, metrics = two(b, data, torch.arange(64).view(2, 32))
    assert int(b.step) == 2 and bool(torch.isfinite(metrics["loss"]))
    _assert_equal(_tensors(b), _tensors(a))


def test_plain_path_draws_nothing():
    """With both features off the step leaves ``rng`` where it was and keeps
    no estimator, as the JAX step gates its key split."""
    cfg = tcfg.resolve_kernel_flags(
        dataclasses.replace(MODEL, mixed_negatives=0, logq_correction=False), "cpu")
    tc = dataclasses.replace(TRAIN, streaming_logq=False)
    data = make_synthetic_data(DATA, label_cols=cfg.num_tasks, device="cpu")
    state = tstate.create_train_state(0, cfg, tc, device="cpu")
    before = state.rng.get_state()
    state = _run(state, tstep.make_train_step(cfg, tc), data, 0, 2)
    assert torch.equal(state.rng.get_state(), before) and state.logq_state is None
