"""PyTorch port: the training loop against the JAX package on the CPU.

``train`` end to end (epoch losses, recall@k and the final params), the
loop's gate rule, ``make_eval_recall_fn`` and the CLI's ``config_from_args``,
each against its JAX counterpart.  The port's loop is fed the JAX run's own
initial state and data (``bridge.params_from_jax``); the JAX side runs its
XLA path on the CPU (AUTO kernel flags resolve off there, as the port's do
on the CPU).

Tolerances: epoch losses within 1e-5 relative, recall exactly equal, and
final params within 1e-4 of each leaf's largest magnitude (the three Adam
steps of ``tests/test_torch_train_step.py``).  With one batch an epoch
(``num_samples == batch_size``) the in-batch loss does not depend on the
batch's order, so the two loops' different shuffles do not matter.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import loop as jloop
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu.utils.logging import JsonlLogger as JLogger
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import loop as tloop
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep
from two_tower_models_tpu_torch.utils.logging import JsonlLogger

D, V, F, H = 16, 128, 8, 8
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V,
    item_id_embedding_dim=D, user_features_size=F, item_features_size=F,
    feature_hidden_dim=32, user_value_weights=(1.0, 0.5, 0.25), history_len=H,
    debias_aux_weight=1.0 / 64,
)
DATA = dict(num_samples=64, num_users=64, num_items=V, feature_dim=F, history_len=H,
            num_tasks=3)
TRAIN = dict(batch_size=64, num_epochs=3, log_every=0, seed=5)


def _exps():
    j = jcfg.ExperimentConfig(
        model=jcfg.preset("two_tower_with_debiasing", **SIZES,
                          history_encoder=jcfg.HistoryEncoderConfig(num_heads=2, num_layers=2)),
        data=jcfg.DataConfig(**DATA), train=jcfg.TrainConfig(**TRAIN),
    )
    t = tcfg.ExperimentConfig(
        model=tcfg.preset("two_tower_with_debiasing", **SIZES,
                          history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=2)),
        data=tcfg.DataConfig(**DATA), train=tcfg.TrainConfig(**TRAIN),
    )
    return j, t


def _to_port_data(d) -> tdata.SyntheticRecData:
    return tdata.SyntheticRecData(
        *(None if a is None else torch.from_numpy(np.array(a)) for a in d)
    )


def _with_adam(opt_state, adam):
    """``opt_state`` (optax's adam chain state) with its ScaleByAdamState
    replaced by ``adam``."""
    if hasattr(opt_state, "mu"):
        return adam
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_with_adam(s, adam) for s in opt_state)
    return opt_state


@pytest.fixture(scope="module")
def runs():
    """One JAX ``train`` and one port ``train`` from the same initial state
    and data.  The state is the JAX ``create_train_state``'s with a
    mid-training Adam state (count 3, moments from numpy) in place of the
    zero one, in both loops: from zero moments a first Adam step moves a
    parameter by about lr whatever its gradient's size, which turns the
    rounding noise of the gradients that are zero in exact arithmetic (the
    keys' bias, ``ttt.ZERO_GRAD_LEAVES``) into steps of either sign."""
    exp_j, exp_t = _exps()
    mc = jcfg.resolve_kernel_flags(exp_j.model)
    data_j = jdata.make_synthetic_data(exp_j.data, structured=True, label_cols=mc.num_tasks)
    state_j = jstate.create_train_state(jax.random.key(exp_j.train.seed), mc, exp_j.train,
                                        catalog_size=data_j.catalog_ids.shape[0])
    params_np = jax.tree_util.tree_map(np.asarray, state_j.params)
    r = np.random.default_rng(6)
    mu = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * 1e-3).astype(np.float32),
                                params_np)
    nu = jax.tree_util.tree_map(
        lambda a: (r.uniform(0.5, 1.5, a.shape) * 1e-6).astype(np.float32), params_np)
    adam = next(s for s in state_j.opt_state if hasattr(s, "mu"))._replace(
        count=jax.numpy.asarray(3, jax.numpy.int32),
        mu=jax.tree_util.tree_map(jax.numpy.asarray, mu),
        nu=jax.tree_util.tree_map(jax.numpy.asarray, nu),
    )
    state_j = state_j._replace(opt_state=_with_adam(state_j.opt_state, adam))

    def port_state(seed, model_cfg, train_cfg, device, catalog_size=None):
        model = bridge.params_from_jax(params_np, model_cfg, device=device)
        return tstate.TrainState(torch.zeros((), dtype=torch.int32), model,
                                 bridge.adam_state_from_jax(3, mu, nu, model))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", lambda *a, **k: state_j)
        j_summary = jloop.train(exp_j, JLogger(echo=False))
        mp.setattr(tloop, "create_train_state", port_state)
        mp.setattr(tloop, "make_synthetic_data", lambda *a, **k: _to_port_data(data_j))
        t_summary = tloop.train(exp_t, JsonlLogger(echo=False), device="cpu")
    return j_summary, t_summary


def test_train_epoch_losses_match_jax(runs):
    j, t = runs
    assert t["epoch_numbers"] == j["epoch_numbers"] == [0, 1, 2]
    np.testing.assert_allclose(t["epoch_losses"], j["epoch_losses"], rtol=1e-5)
    assert t["epoch_losses"][-1] < t["epoch_losses"][0]
    assert t["preempted"] is False and int(t["state"].step) == 3


def test_train_recall_matches_jax(runs):
    j, t = runs
    assert t["recall_at_k"] == pytest.approx(j["recall_at_k"], abs=0.0)


def test_train_final_params_match_jax(runs):
    j, t = runs
    got = bridge.flatten(bridge.params_to_jax(t["state"].params))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, j["state"].params))
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("every", [0, 1, 3, 4, 10])
def test_hits_gate_matches_jax(every):
    for executed in (1, 2, 3, 4):
        for g in range(executed, 40):
            assert tloop._hits_gate(every, g, executed) == jloop._hits_gate(every, g, executed)


def test_eval_recall_fn_matches_jax():
    """make_eval_recall_fn on bridged params, one corpus and one batch."""
    mj = jcfg.preset("two_tower_with_debiasing", **SIZES)
    mt = tcfg.preset("two_tower_with_debiasing", **SIZES)
    mt = tcfg.resolve_kernel_flags(mt, "cpu")
    params = jtt.init_params(jax.random.key(1), jcfg.resolve_kernel_flags(mj))
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), mt, device="cpu")
    r = np.random.default_rng(0)
    b, c, k = 96, 256, 20
    corpus = r.normal(size=(c, D)).astype(np.float32)
    batch_np = dict(
        user_id=r.integers(0, V, b).astype(np.int32),
        user_features=r.normal(size=(b, F)).astype(np.float32),
        user_history=r.integers(0, V, (b, H)).astype(np.int32),
        item_id=r.integers(0, c, b).astype(np.int32),
        item_features=r.normal(size=(b, F)).astype(np.float32),
        position=r.integers(0, 10, b).astype(np.int32),
        labels=r.binomial(1, 0.5, (b, 3)).astype(np.float32),
    )
    want = float(jstep.make_eval_recall_fn(jcfg.resolve_kernel_flags(mj), k)(
        params, jax.numpy.asarray(corpus), jtt.Batch(**batch_np)))
    got = tstep.make_eval_recall_fn(mt, k)(
        model, torch.from_numpy(corpus),
        ttt.Batch(**{n: torch.from_numpy(a) for n, a in batch_np.items()}))
    assert got.shape == ()
    assert float(got) == want
    assert 0.0 < want < 1.0


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "two_tower_with_debiasing", "--num_epochs", "3", "--embedding_dim", "16",
     "--checkpoint_dir", "/x/ckpt", "--steps_per_dispatch", "4", "--eval_every", "7"],
    ["--preset", "two_tower_with_user_history_encoder", "--compute_dtype", "bfloat16",
     "--variable_history", "--popularity_skew", "0.8", "--noise_labels",
     "--grad_clip_norm", "1.5", "--mesh_data", "2", "--gspmd", "--tower_tp",
     "--sparse_table_grads", "on", "--seed", "9", "--debug_nans"],
])
def test_config_from_args_matches_jax(argv):
    want = jloop.config_from_args(jloop.build_argparser().parse_args(argv))
    got = tloop.config_from_args(tloop.build_argparser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
