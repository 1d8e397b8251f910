"""PyTorch port: training the light ranker, KD and the reward model against
the JAX package on the CPU, and through the checkpoint and the loop.

Three ``make_train_step`` Adam steps against ``jstep.make_train_step``,
dense, K = 2 a dispatch and lazy (plain tables, no packing), with and
without 8 mixed negatives and the oracle logQ correction (the port's draw
returns the slots of the JAX step's own key, so both sides extend each
batch alike).  Both sides start from one mid-training state (count 3,
moments from numpy) through the bridge.  Metrics, params and moments after
each dispatch at 1e-4 of each leaf's scale, as
tests/test_torch_mixed_negatives.py holds them; the moments of the leaves
in ``zero_grad_leaves(cfg)`` and, under the light ranker, the attention's
key bias against ``ZERO_GRAD_FLOOR`` times the top leaf (``_leaves_close``).  Then a checkpoint round trip with the new leaves,
bit for bit, the loop's exact resume for each preset, and the trainer CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.training import checkpoint as tckpt
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import loop as tloop
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep
from two_tower_models_tpu_torch.utils.logging import JsonlLogger

V, D, B, H, F, BP, C, T = 128, 16, 32, 4, 8, 8, 96, 2
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V, item_id_embedding_dim=D,
    user_features_size=F, item_features_size=F, feature_hidden_dim=32,
    user_value_weights=(1.0, 0.5), history_len=H, num_items=5,
)
LR, KD, RM = ("two_tower_plus_light_ranker", "two_tower_plus_light_ranker_kd",
              "two_tower_with_main_ranker_reward")


def _configs(name, **kw):
    pairs = []
    for c in (jcfg, tcfg):
        over = {**SIZES, **kw, "history_encoder": c.HistoryEncoderConfig(num_heads=2, num_layers=1)}
        if name != RM:
            over["light_ranker"] = c.LightRankerConfig(num_mips_items=20,
                                                       num_ranker_user_embeddings=3)
        pairs.append(c.preset(name, **over))
    return tuple(pairs)


def _data_np(seed, cfg, n=6 * B):
    """n samples whose items come from a catalog of C sorted ids, hard
    labels (and KD's soft labels), and an oracle catalog_logq."""
    r = np.random.default_rng(seed)
    catalog_ids = np.sort(r.choice(V, C, replace=False)).astype(np.int32)
    pos = r.integers(0, C, n)
    labels = r.binomial(1, 0.5, (n, T)).astype(np.float32)
    if cfg.kd:
        labels = np.concatenate([labels, r.uniform(0, 1, (n, T)).astype(np.float32)], 1)
    counts = np.bincount(pos, minlength=C)
    return dict(
        user_ids=r.integers(0, V, n).astype(np.int32),
        user_features=r.normal(size=(n, F)).astype(np.float32),
        user_history=r.integers(0, V, (n, H)).astype(np.int32),
        item_ids=catalog_ids[pos],
        item_features=r.normal(size=(n, F)).astype(np.float32),
        positions=r.integers(0, 100, n).astype(np.int32),
        labels=labels,
        catalog_ids=catalog_ids,
        catalog_features=r.normal(size=(C, F)).astype(np.float32),
        history_lens=None,
        catalog_logq=np.log((counts + 1.0) / (n + C)).astype(np.float32),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mid_training(jst, lazy: bool, seed: int):
    """The JAX state at step 3 with moments from numpy (from zero moments a
    first Adam step moves a leaf by about lr whatever its gradient)."""
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


def _jax_opt(jst, lazy: bool):
    if lazy:
        adam = jst.opt_state["dense"][0]
        return {"dense": (np.asarray(adam.count), _np(adam.mu), _np(adam.nu)),
                "tables": _np(jst.opt_state["tables"])}
    adam = jst.opt_state[0]
    return (np.asarray(adam.count), _np(adam.mu), _np(adam.nu))


def _leaves_close(got: dict, want: dict, tol: float, cfg=None):
    """Each leaf within tol of its own scale.  For ``cfg``, the leaves of
    ``zero_grad_leaves(cfg)`` within tol of ZERO_GRAD_FLOOR times the top
    leaf, and under the light ranker so the key third of each attention
    layer's ``in_proj.b``: a bias on every key shifts all of a query's
    scores alike, so its gradient is zero in exact arithmetic too (about
    1e-6 here, against 6 and 40 for the query and value thirds), and the
    light ranker's unnormalised example weights make its rounding noise
    reach 1e-3 of the moments' scale and, through Adam's division by
    sqrt(nu), of the bias's own."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    floor = () if cfg is None else ttt.zero_grad_leaves(cfg)
    key_bias = cfg is not None and cfg.light_ranker is not None
    bad = {}
    for name, w in want.items():
        g, w = np.asarray(got[name], np.float32), np.asarray(w, np.float32)
        atol = np.full(w.shape, tol * float(np.abs(w).max()), np.float32)
        if any(name.endswith(f) for f in floor):
            atol[:] = tol * ttt.ZERO_GRAD_FLOOR * top
        elif key_bias and name.endswith("in_proj.b"):
            third = w.shape[0] // 3
            atol[third:2 * third] = tol * ttt.ZERO_GRAD_FLOOR * top
        over = np.abs(g - w) - atol
        if over.max() > 0:
            bad[name] = (float(np.abs(g - w).max()), int(np.argmax(over)))
    assert not bad, f"leaves beyond {tol} of their scale (max abs error, index): {bad}"


# K = 2 runs six steps, and at the preset's combined_debias_min of 1e-3 the
# sixth leaves the two sides apart: from random weights many examples' user
# estimates sit at that clamp, where an example's weight nuv / e moves by
# nuv / e^2 = 1e6 nuv per unit of e, so the rounding differences of five
# steps decide which examples clamp, and every leaf's moments part (the
# first two dispatches agree to 1e-4).  The K = 2 case takes a clamp of 0.1
# (weights up to 10 nuv); the dense and lazy cases keep the preset's.
STEP_CASES = {
    "kd-dense": (KD, {}, False),
    "kd-K2": (KD, {"steps_per_dispatch": 2}, False),
    "kd-lazy-mns+logq": (KD, {"lazy_table_adam": True}, True),
    "lightranker-dense-mns+logq": (LR, {}, True),
    "reward-dense": (RM, {}, False),
    "reward-lazy": (RM, {"lazy_table_adam": True}, False),
    "reward-dense-mns+logq": (RM, {}, True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_follow_jax(case, monkeypatch):
    """Three dispatches of make_train_step in f32 against the JAX step:
    metrics, params and moments (table moments too on the lazy path) after
    each; with K = 2 a dispatch takes [K, B] indices and runs two steps."""
    name, train_kw, negs = STEP_CASES[case]
    lazy = train_kw.get("lazy_table_adam", False)
    k = train_kw.get("steps_per_dispatch", 1)
    clamp = {"combined_debias_min": 0.1} if k > 1 else {}
    cfg_j, cfg_t = _configs(name, mixed_negatives=BP if negs else 0, logq_correction=negs,
                            **clamp)
    kw = dict(batch_size=B, learning_rate=1e-3, pack_tables=False, **train_kw)
    j_tcfg = jcfg.TrainConfig(**kw, donate_state=False)
    t_tcfg = tcfg.TrainConfig(**kw)
    d = _data_np(16, cfg_j)
    jd = jdata.SyntheticRecData(**{k_: None if v is None else jnp.asarray(v) for k_, v in d.items()})
    td = tdata.SyntheticRecData(**{k_: None if v is None else torch.from_numpy(np.array(v))
                                   for k_, v in d.items()})
    jst = _mid_training(jstate.create_train_state(jax.random.key(17), cfg_j, j_tcfg, pack=False,
                                                  catalog_size=C), lazy, 18)
    model = bridge.params_from_jax(_np(jst.params), cfg_t, device="cpu")
    opt = _jax_opt(jst, lazy)
    opt = (bridge.lazy_state_from_jax(opt, model) if lazy
           else bridge.adam_state_from_jax(*opt, model))
    tst = tstate.TrainState(step=torch.tensor(3, dtype=torch.int32), params=model, opt_state=opt,
                            rng=torch.Generator())
    slots = []
    monkeypatch.setattr(tdata, "draw_negative_slots", lambda *a: slots.pop(0))
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    for i in range(3):
        if negs:
            _, sub = jax.random.split(jst.rng)
            slots.append(torch.from_numpy(np.array(jax.random.randint(sub, (BP,), 0, C))))
        idx = np.arange(i * k * B, (i + 1) * k * B).reshape((k, B) if k > 1 else (B,))
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        assert not slots
        assert set(tm) == set(jm)
        for m in jm:
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-4, err_msg=m)
        _leaves_close({n: p.detach().numpy() for n, p in model.named_parameters()},
                      bridge.flatten(_np(jst.params)), 1e-4, cfg_t)
        got = (bridge.lazy_state_to_jax(tst.opt_state) if lazy
               else bridge.adam_state_to_jax(tst.opt_state))
        _leaves_close(bridge.flatten(got), bridge.flatten(_jax_opt(jst, lazy)), 1e-4, cfg_t)
    assert int(tst.step) == int(jst.step) == 3 + 3 * k


def _trained_state(cfg, train_cfg, steps=2):
    state = tstate.create_train_state(0, cfg, train_cfg, device="cpu", catalog_size=C)
    d = _data_np(19, cfg)
    td = tdata.SyntheticRecData(**{k: None if v is None else torch.from_numpy(np.array(v))
                                   for k, v in d.items()})
    step = tstep.make_train_step(cfg, train_cfg)
    with torch.enable_grad():
        for i in range(steps):
            state, _ = step(state, td, torch.arange(i * B, (i + 1) * B))
    return state


@pytest.mark.parametrize("name,lazy", [(LR, False), (KD, False), (RM, False), (RM, True)],
                         ids=["lightranker", "kd", "reward", "reward-lazy"])
def test_checkpoint_round_trip_with_the_new_leaves(tmp_path, name, lazy):
    """Save after two steps, restore into a fresh template: every tensor,
    the ranker tower's, the head's and the proxy's and their moments among
    them, bit-equal."""
    _, cfg = _configs(name)
    cfg = tcfg.resolve_kernel_flags(cfg, "cpu")
    tc = tcfg.TrainConfig(batch_size=B, lazy_table_adam=lazy, pack_tables=False)
    state = _trained_state(cfg, tc)
    want = {k: v.detach().clone() for k, v in tckpt.state_tensors(state).items()}
    new = {"light_ranker_head.w", "ranker_user_tower.w"} if name != RM else {"proxy_ranker.w"}
    assert {f"params.{n}" for n in new} <= set(want)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    assert mgr.save(state)
    template = tstate.create_train_state(9, cfg, tc, device="cpu", catalog_size=C)
    restored = mgr.restore_latest(template)
    mgr.close()
    got = tckpt.state_tensors(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


class _Quiet(JsonlLogger):
    def __init__(self):
        super().__init__(echo=False)


def _exp(name, ckpt, epochs):
    _, model = _configs(name)
    data = tcfg.DataConfig(num_samples=256, num_users=64, num_items=64, feature_dim=F,
                           history_len=H, num_tasks=T)
    train = tcfg.TrainConfig(batch_size=B, num_epochs=epochs, log_every=0, seed=3,
                             checkpoint_dir=ckpt)
    return tcfg.ExperimentConfig(model=model, data=data, train=train)


@pytest.mark.parametrize("name", [LR, KD, RM], ids=["lightranker", "kd", "reward"])
def test_loop_resume_matches_an_uninterrupted_run(tmp_path, name):
    """training.loop.train on each preset (KD's data with 2T label columns):
    one epoch with a checkpoint, then the same call for two epochs restores
    it and ends bit-equal to a two-epoch run left uninterrupted."""
    whole = tloop.train(_exp(name, str(tmp_path / "a"), 2), _Quiet(), device="cpu")
    first = tloop.train(_exp(name, str(tmp_path / "b"), 1), _Quiet(), device="cpu")
    assert first["epoch_numbers"] == [0] and np.isfinite(first["final_loss"])
    resumed = tloop.train(_exp(name, str(tmp_path / "b"), 2), _Quiet(), device="cpu")
    assert resumed["epoch_numbers"] == [1]
    got, want = (tckpt.state_tensors(s["state"]) for s in (resumed, whole))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_trains_the_light_ranker(tmp_path, capsys):
    """The README's first trainer command, --preset two_tower_plus_light_ranker,
    at a small size on the CPU: epoch lines and recall."""
    argv = ["--preset", "two_tower_plus_light_ranker", "--num_epochs", "2", "--num_samples",
            "128", "--embedding_dim", "16", "--user_history_seqlen", "4", "--device", "cpu"]
    summary = tloop.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Epoch [1/2] - Loss: ") and out[2].startswith("recall@100: ")
    assert summary["state"].params.light_ranker_head.w.shape == (2 * 16 + 4 + 1, 1)
    assert all(np.isfinite(summary["epoch_losses"]))
