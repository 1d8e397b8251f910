"""PyTorch port: the training slice against the JAX package on the CPU.

``train_loss`` (loss, metrics and every grad leaf against
``jax.value_and_grad(train_loss)``), three ``make_train_step`` Adam steps
against the JAX step, ``TrainConfig``'s fields, and JAX's gradient rules at
ties.  Both sides hold the same weights (``bridge.params_from_jax``) and
the same numpy batch; the JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.

Tolerances, per leaf, relative to the leaf's largest magnitude: f32 at
1e-4 (measured gap 1.3e-6); bf16 at 1e-2 (measured gap 8.7e-6 here: the
plain versions round where the Pallas kernels do, so only f32 sums differ
in order).  Under bf16 compute the weight grads themselves are rounded to
bf16 (the cotangent of each operand's cast), so a sum taken in another
order can flip one rounding by an ulp, up to 2^-7 of the value; the card
does (4.6e-3 of a leaf's scale, card against CPU at the flagship), and
chip_smoke.py holds the card to the same 1e-2.  The gradient leaves that
are zero in exact arithmetic (``ttt.ZERO_GRAD_LEAVES``) hold only rounding
noise on both sides; they are held relative to ``ttt.ZERO_GRAD_FLOOR``
times the largest magnitude over all leaves instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

B, H, D, V, F = 64, 8, 32, 512, 16
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V,
    item_id_embedding_dim=D, user_features_size=F, item_features_size=F,
    feature_hidden_dim=64, user_value_weights=(1.0, 0.5, 0.25), history_len=H,
)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _configs(debias="both", history=True, compute_dtype="float32", fused=True):
    kw = dict(SIZES, debias=debias, compute_dtype=compute_dtype, fused_loss=fused)
    j, t = dict(kw), dict(kw)
    if history:
        j["history_encoder"] = jcfg.HistoryEncoderConfig(num_heads=2, num_layers=2, fused_encoder=fused)
        t["history_encoder"] = tcfg.HistoryEncoderConfig(num_heads=2, num_layers=2, fused_encoder=fused)
    return jcfg.ModelConfig(**j).validate(), tcfg.ModelConfig(**t).validate()


def _batch_np(seed):
    r = np.random.default_rng(seed)
    return dict(
        user_id=r.integers(0, V, B).astype(np.int32),
        user_features=r.normal(size=(B, F)).astype(np.float32),
        user_history=r.integers(0, V, (B, H)).astype(np.int32),
        item_id=r.integers(0, V, B).astype(np.int32),
        item_features=r.normal(size=(B, F)).astype(np.float32),
        position=r.integers(0, 100, B).astype(np.int32),
        labels=r.binomial(1, 0.5, (B, 3)).astype(np.float32),
    )


def _both(cfg_j, cfg_t, seed):
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    return params, model


def _port_loss(model, cfg_t, batch):
    tb = ttt.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()})
    model.zero_grad()
    loss, metrics = ttt.train_loss(model, cfg_t, tb)
    loss.backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()}


def _assert_tree_close(got: dict, want: dict, tol: float, zero_leaves=()):
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        scale = ttt.ZERO_GRAD_FLOOR * top if name in zero_leaves else float(np.abs(w).max())
        np.testing.assert_allclose(
            np.asarray(got[name], np.float32), w, rtol=0, atol=tol * scale, err_msg=name
        )


def _check_train_loss(cfg_j, cfg_t, seed, tol):
    params, model = _both(cfg_j, cfg_t, seed)
    batch = _batch_np(seed + 1)
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    )
    tm, tg = _port_loss(model, cfg_t, batch)
    assert set(tm) == set(jm) == {"loss", "softmax_ce", "debias_aux_loss", "nuv_mean"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    _assert_tree_close(
        {n: g.numpy() for n, g in tg.items()},
        bridge.flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg)),
        tol, ttt.ZERO_GRAD_LEAVES,
    )


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_loss_flagship_matches_jax(compute_dtype):
    """The flagship shrunk to CPU size: history encoder and loss through the
    fused kernels' plain versions, Debias.BOTH."""
    _check_train_loss(*_configs(compute_dtype=compute_dtype), seed=1, tol=TOL[compute_dtype])


@pytest.mark.parametrize(
    "debias,history", [("none", False), ("user", True), ("position", True)],
    ids=["two_tower_base_retrieval", "debias_user", "debias_position"],
)
def test_train_loss_presets_match_jax(debias, history):
    _check_train_loss(*_configs(debias=debias, history=history), seed=2, tol=TOL["float32"])


def test_gradients_at_ties_follow_jax():
    """Two rows tied at the batch max (their gradients split, as jnp.max's
    do), a position estimate exactly at its clip floor and a nuv exactly at
    nuv_min (jnp.clip passes half the gradient at a tie)."""
    cfg_j, cfg_t = _configs(debias="position", history=False, fused=False)
    params, _ = _both(cfg_j, cfg_t, seed=3)
    table = np.asarray(params["position_bias_table"]).copy()
    table[7, 0] = np.float32(cfg_j.position_debias_min)  # est at its floor
    table[8, 0] = 1.0
    table[9, 0] = 0.5
    params = dict(params, position_bias_table=jnp.asarray(table))
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    batch = _batch_np(4)
    batch["labels"][:] = 0.0
    batch["position"][:] = 9
    batch["labels"][:2] = 1.0  # rows 0 and 1 tie at the batch max
    batch["position"][:2] = 9
    batch["labels"][2] = [1e-6, 0.0, 0.0]  # nuv = 1e-6 / 1.0: at nuv_min
    batch["position"][2] = 8
    batch["labels"][3] = [1.0, 0.0, 0.0]
    batch["position"][3] = 7
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    )
    tm, tg = _port_loss(model, cfg_t, batch)
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]), rtol=1e-5)
    want = np.asarray(jg["position_bias_table"])
    got = tg["position_bias_table"].numpy()
    assert want[7, 0] != 0 and want[8, 0] != 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    _assert_tree_close(
        {n: g.numpy() for n, g in tg.items()},
        bridge.flatten(jax.tree_util.tree_map(np.asarray, jg)), TOL["float32"], ttt.ZERO_GRAD_LEAVES,
    )


def test_train_config_mirrors_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.TrainConfig)}
    assert jf == tf


def _adam_leaf(state):
    """optax's ScaleByAdamState inside an adam or clip+adam chain state."""
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


@pytest.mark.parametrize("clip,k", [(None, 1), (1.0, 1), (None, 2)], ids=["noclip", "clip1", "noclip-k2"])
def test_three_adam_steps_follow_jax(clip, k):
    """make_train_step in f32 on the shrunk flagship: params, Adam moments
    and metrics after each of three dispatches.  With steps_per_dispatch
    k = 2 a dispatch takes [k, B] indices into k batches and runs k steps,
    its metrics averaged over them, as the JAX step's scan does.  Both sides
    start from the same mid-training Adam state (count 3, moments from
    numpy), carried over by the bridge: from zero moments a first Adam step
    moves a parameter by about lr whatever the size of its gradient, so on
    the leaf whose gradient is zero in exact arithmetic it would amplify
    rounding noise."""
    cfg_j, cfg_t = _configs()
    j_tcfg = jcfg.TrainConfig(batch_size=B, learning_rate=1e-3, grad_clip_norm=clip,
                              steps_per_dispatch=k, donate_state=False)
    t_tcfg = tcfg.TrainConfig(batch_size=B, learning_rate=1e-3, grad_clip_norm=clip,
                              steps_per_dispatch=k)
    jst = jstate.create_train_state(jax.random.key(5), cfg_j, j_tcfg, pack=False)
    r = np.random.default_rng(6)
    np_params = jax.tree_util.tree_map(np.asarray, jst.params)
    mu = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * 1e-3).astype(np.float32), np_params)
    nu = jax.tree_util.tree_map(lambda a: (r.uniform(0.5, 1.5, a.shape) * 1e-6).astype(np.float32), np_params)
    adam = _adam_leaf(jst.opt_state)._replace(
        count=jnp.asarray(3, jnp.int32), mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu),
    )
    jst = jst._replace(opt_state=_replace_adam(jst.opt_state, adam))

    model = bridge.params_from_jax(np_params, cfg_t, device="cpu")
    tst = tstate.TrainState(
        step=torch.zeros((), dtype=torch.int32), params=model,
        opt_state=bridge.adam_state_from_jax(3, mu, nu, model),
    )
    batches = [_batch_np(7 + j) for j in range(k)]
    b = {key: np.concatenate([x[key] for x in batches]) for key in batches[0]}
    jd = jdata.SyntheticRecData(
        user_ids=b["user_id"], user_features=b["user_features"], user_history=b["user_history"],
        item_ids=b["item_id"], item_features=b["item_features"], positions=b["position"],
        labels=b["labels"], catalog_ids=np.arange(4), catalog_features=np.zeros((4, F), np.float32),
    )
    td = tdata.SyntheticRecData(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in jd))
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    idx = np.arange(k * B).reshape(k, B) if k > 1 else np.arange(B)
    for _ in range(3):
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _assert_tree_close(
            {n: p.detach().numpy() for n, p in model.named_parameters()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, jst.params)), 1e-4,
        )
        count, t_mu, _ = bridge.adam_state_to_jax(tst.opt_state)
        j_adam = _adam_leaf(jst.opt_state)
        assert int(count) == int(j_adam.count)
        _assert_tree_close(bridge.flatten(t_mu), bridge.flatten(jax.tree_util.tree_map(np.asarray, j_adam.mu)), 1e-4)
    assert int(tst.step) == 3 * k


@pytest.mark.parametrize("rows,n,d", [(100, 4096, 1), (100, 300, 3)], ids=["position", "small"])
def test_fixed_order_lookup_gradient_matches_jax(rows, n, d):
    """The position-bias table's lookup takes its gradient through
    ``scatter_add_rows`` in a fixed order (``fixed_order``: B18 on the card,
    the plain scatter-add here), at phase 4's shape: 4096 ids on 10 of its
    100 rows.  Against ``jax.grad`` of the JAX package's lookup at 1e-6 of
    scale in f32."""
    from two_tower_models_tpu.nn import layers as jlayers
    from two_tower_models_tpu_torch.nn import layers as tlayers

    r = np.random.default_rng(rows + n + d)
    table = r.normal(size=(rows, d)).astype(np.float32)
    ids = r.integers(0, 10, n).astype(np.int32)
    up = r.normal(size=(n, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jlayers.embedding_lookup(t, jnp.asarray(ids)) * up))(
        jnp.asarray(table))
    leaf = torch.from_numpy(table).requires_grad_()
    out = tlayers.embedding_lookup(leaf, torch.from_numpy(ids), fixed_order=True)
    assert type(out.grad_fn).__name__ == "_LookupBackward"
    (out * torch.from_numpy(up)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
