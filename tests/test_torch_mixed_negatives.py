"""PyTorch port: mixed negatives and the logQ correction against the JAX
package on the CPU.

``_extended_ce`` on both routes (the fused route's augmented column through
``fused_lse``'s plain version, the JAX side's Pallas kernel in interpret
mode; the plain route's materialised logits), the batch extension's fill
(``fill_extended_batch``) handed the JAX draw's own slots, the draw itself,
``attach_streaming_logq``, ``train_loss`` with every grad leaf, and three
dense and three lazy-Adam steps fed the same extended batches (the port's
draw returns the slots of the JAX step's own key).  Weights cross through
``bridge.params_from_jax``; data is made with numpy and handed to both
sides.

Tolerances: ``_extended_ce`` and its gradients at 1e-5 of each output's
scale in f32, 1e-2 in bf16 (bf16 operands; both sides sum exact products in
f32, in another order), and the bf16 corrections, which both sides round to
the pool's dtype, at 1e-5; ids and features of the fill exactly, its
corrections at 1e-6 relative (``logaddexp`` and ``log`` in f32 on two
libraries); ``train_loss`` and the steps as tests/test_torch_train_step.py
holds them, 1e-4 of each leaf's scale in f32 and 1e-2 in bf16.
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
from two_tower_models_tpu.training import freq_estimator as jfe
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training.freq_estimator import init_freq_estimator
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

V, D, B, H, F, BP, C = 128, 16, 32, 4, 8, 8, 96
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V, item_id_embedding_dim=D,
    user_features_size=F, item_features_size=F, feature_hidden_dim=32,
    user_value_weights=(1.0, 0.5), history_len=H, debias="both",
)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _configs(**kw):
    kw = {**SIZES, "mixed_negatives": BP, "logq_correction": True, **kw}
    j = jcfg.ModelConfig(**kw, history_encoder=jcfg.HistoryEncoderConfig(num_heads=2, num_layers=1))
    t = tcfg.ModelConfig(**kw, history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=1))
    return j.validate(), t.validate()


def _data_np(seed, n=4 * B):
    """n samples whose items come from a catalog of C sorted ids that are
    not their positions (so the searchsorted matters), with Zipf-like
    repeats, and an oracle catalog_logq."""
    r = np.random.default_rng(seed)
    catalog_ids = np.sort(r.choice(V, C, replace=False)).astype(np.int32)
    p = 1.0 / np.arange(1, C + 1)
    p /= p.sum()
    pos = r.choice(C, n, p=p)
    counts = np.bincount(pos, minlength=C)
    return dict(
        user_ids=r.integers(0, V, n).astype(np.int32),
        user_features=r.normal(size=(n, F)).astype(np.float32),
        user_history=r.integers(0, V, (n, H)).astype(np.int32),
        item_ids=catalog_ids[pos],
        item_features=r.normal(size=(n, F)).astype(np.float32),
        positions=r.integers(0, 100, n).astype(np.int32),
        labels=r.binomial(1, 0.5, (n, 2)).astype(np.float32),
        catalog_ids=catalog_ids,
        catalog_features=r.normal(size=(C, F)).astype(np.float32),
        history_lens=None,
        catalog_logq=np.log((counts + 1.0) / (n + C)).astype(np.float32),
    )


def _jdata(d):
    return jdata.SyntheticRecData(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})


def _tdata(d):
    return tdata.SyntheticRecData(**{k: None if v is None else torch.from_numpy(np.array(v))
                                     for k, v in d.items()})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(got, want, tol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=err_msg)


def _ce_inputs(seed, dtype, negs=True, logq=True):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=(n, D)).astype(np.float32) * 0.5 for n in (B, B, BP)]
    ilq = np.log(r.uniform(0.01, 0.2, B)).astype(np.float32) if logq else None
    nlq = np.log(r.uniform(0.001, 0.05, BP)).astype(np.float32) if logq and negs else None
    if not negs:
        arrs[2] = None
    j = [None if a is None else jnp.asarray(a, dtype) for a in arrs]
    t = [None if a is None else torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
         for a in arrs]
    lq = [None if a is None else (jnp.asarray(a), torch.from_numpy(a)) for a in (ilq, nlq)]
    return j, t, lq, r.uniform(0.5, 1.5, B).astype(np.float32)


def _jax_ce(cfg_j, j, lq, w):
    def f(u, i, n):
        ce = jtt._extended_ce(cfg_j, u, i, None, n, *(None if x is None else x[0] for x in lq))
        return jnp.sum(ce * w), ce

    argnums = (0, 1, 2) if j[2] is not None else (0, 1)
    (_, ce), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(*j)
    return np.asarray(ce), [np.asarray(g, np.float32) for g in grads]


def _port_ce(cfg_t, t, lq, w):
    ce = ttt._extended_ce(cfg_t, t[0], t[1], None, t[2], *(None if x is None else x[1] for x in lq))
    (ce * torch.from_numpy(w)).sum().backward()
    return ce.detach().numpy(), [x.grad.float().numpy() for x in t if x is not None]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("dtype,fields", [("float32", "negs+logq"), ("bfloat16", "negs+logq"),
                                          ("float32", "negs"), ("float32", "logq")])
def test_extended_ce_matches_jax(fused, dtype, fields):
    """ce and its gradients in u, the in-batch items and the negatives, on
    both routes: the fused one through the rectangular LSE (C = B + B', one
    appended column), the plain one over materialised logits."""
    cfg_j, cfg_t = _configs(fused_loss=fused)
    j, t, lq, w = _ce_inputs(1, dtype, negs="negs" in fields, logq="logq" in fields)
    ce_j, g_j = _jax_ce(cfg_j, j, lq, w)
    ce_t, g_t = _port_ce(cfg_t, t, lq, w)
    tol = 1e-5 if dtype == "float32" else 1e-2
    _scaled(ce_t, ce_j, tol, "ce")
    assert len(g_t) == len(g_j)
    for name, a, b in zip(("u", "items", "negatives"), g_t, g_j):
        _scaled(a, b, tol, name)


def test_extended_ce_rounds_corrections_like_jax():
    """bf16 embeddings: both routes round the corrections to the pool's
    dtype (bf16 here), so they agree with each other and with the JAX
    package's plain route to 1e-5 of scale, where an unrounded correction
    would be off by up to half a bf16 step of log q (about 2e-3 of it)."""
    cfg_j, _ = _configs(fused_loss=False)
    j, t, lq, w = _ce_inputs(2, "bfloat16")
    ce_j, _ = _jax_ce(cfg_j, j, lq, w)
    got = []
    for fused in (True, False):
        _, cfg_t = _configs(fused_loss=fused)
        got.append(ttt._extended_ce(cfg_t, t[0], t[1], None, t[2], lq[0][1], lq[1][1]).detach().numpy())
    _scaled(got[0], got[1], 1e-6, "fused vs plain")
    _scaled(got[1], ce_j, 1e-5, "port vs JAX")
    unrounded = ttt._extended_ce(_configs(fused_loss=False)[1], *(x.float() for x in t[:2]), None,
                                 t[2].float(), lq[0][1], lq[1][1])
    assert np.abs(unrounded.detach().numpy() - ce_j).max() > 1e-5 * np.abs(ce_j).max()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_precomputed_scores_match_jax(fused):
    """The precomputed-scores route (the reward model's): the [B, B] logits
    handed in, the diagonal as the positive, the negatives' logits appended,
    whatever ``fused_loss`` says; ce and its gradients in u, the items and
    the negatives against the JAX function at 1e-5 of scale."""
    cfg_j, cfg_t = _configs(fused_loss=fused)
    j, t, lq, w = _ce_inputs(3, "float32")

    def f(u, i, n):
        ce = jtt._extended_ce(cfg_j, u, i, u @ i.T, n, lq[0][0], lq[1][0])
        return jnp.sum(ce * w), ce

    (_, ce_j), g_j = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*j)
    ce_t = ttt._extended_ce(cfg_t, t[0], t[1], t[0] @ t[1].T, t[2], lq[0][1], lq[1][1])
    (ce_t * torch.from_numpy(w)).sum().backward()
    _scaled(ce_t.detach().numpy(), np.asarray(ce_j), 1e-5, "ce")
    for name, x, g in zip(("u", "items", "negatives"), t, g_j):
        _scaled(x.grad.numpy(), np.asarray(g), 1e-5, name)


@pytest.mark.parametrize("stacked", [False, True], ids=["B", "KxB"])
@pytest.mark.parametrize("arm", ["mns+logq", "mns", "logq"])
def test_fill_matches_jax_extend_batch(stacked, arm):
    """The port's fill handed the JAX draw's slots: negative ids and
    features exactly, item_logq and neg_logq (the mixed proposal log(B p +
    B'/C)) at 1e-6 relative; a [K, B] batch gets a draw per row."""
    bp = BP if arm.startswith("mns") else 0
    cfg_j, cfg_t = _configs(mixed_negatives=bp, logq_correction="logq" in arm)
    d = _data_np(4)
    jd, td = _jdata(d), _tdata(d)
    idx = np.arange(3 * B).reshape(3, B) if stacked else np.arange(B, 2 * B)
    key = jax.random.key(11)
    jb = jdata.extend_batch(cfg_j, jd, jdata.gather_batch(jd, jnp.asarray(idx)), key)
    slots = None
    if bp:
        slots = torch.from_numpy(np.asarray(jax.random.randint(key, idx.shape[:-1] + (bp,), 0, C)))
    tb = tdata.fill_extended_batch(cfg_t, td, tdata.gather_batch(td, torch.from_numpy(idx)), slots)
    for name in ("neg_item_id", "neg_item_features"):
        if bp:
            np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
        else:
            assert getattr(tb, name) is None and getattr(jb, name) is None
    for name in ("item_logq", "neg_logq"):
        want = getattr(jb, name)
        if want is None:
            assert getattr(tb, name) is None, name
        else:
            np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(want), rtol=1e-6,
                                       err_msg=name)


def test_extend_batch_is_a_no_op_with_both_features_off():
    """No negatives, no correction: the batch comes back as it went in and
    the generator is not drawn from."""
    _, cfg_t = _configs(mixed_negatives=0, logq_correction=False)
    td = _tdata(_data_np(5))
    batch = tdata.gather_batch(td, torch.arange(B))
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    assert tdata.extend_batch(cfg_t, td, batch, gen) is batch
    assert torch.equal(gen.get_state(), before)


def test_negative_draw_is_uniform_and_repeatable():
    """The slots are uniform over [0, C): over 20,000 draws of B' slots each
    slot's count within 5 sigma of its mean; the same generator state gives
    the same slots, and a [K, B] batch a [K, B'] draw."""
    _, cfg_t = _configs()
    td = _tdata(_data_np(6))
    batch = tdata.gather_batch(td, torch.arange(B))
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    slots = torch.stack([tdata.draw_negative_slots(cfg_t, td, batch, gen) for _ in range(20000)])
    assert slots.shape == (20000, BP) and slots.dtype == torch.int64
    assert int(slots.min()) == 0 and int(slots.max()) == C - 1
    counts = torch.bincount(slots.reshape(-1), minlength=C).double()
    mean = slots.numel() / C
    assert float((counts - mean).abs().max()) <= 5 * (mean * (1 - 1 / C)) ** 0.5
    gen.set_state(state)
    assert torch.equal(tdata.draw_negative_slots(cfg_t, td, batch, gen), slots[0])
    stacked = tdata.gather_batch(td, torch.arange(2 * B).view(2, B))
    assert tdata.draw_negative_slots(cfg_t, td, stacked, gen).shape == (2, BP)


def test_draw_for_idx_is_a_function_of_the_schedule():
    """``extend_batch_for_idx``: the same seed and first sample index give
    the same negatives; another first index another draw."""
    _, cfg_t = _configs()
    td = _tdata(_data_np(8))
    idx = torch.arange(B)
    a, b = (tdata.extend_batch_for_idx(cfg_t, td, tdata.gather_batch(td, i), 5, i)
            for i in (idx, idx.clone()))
    c = tdata.extend_batch_for_idx(cfg_t, td, tdata.gather_batch(td, idx + 1), 5, idx + 1)
    assert torch.equal(a.neg_item_id, b.neg_item_id) and torch.equal(a.neg_logq, b.neg_logq)
    assert not torch.equal(a.neg_item_id, c.neg_item_id)


@pytest.mark.parametrize("bp", [BP, 0], ids=["mns", "no-mns"])
def test_attach_streaming_logq_matches_jax(bp):
    """From one estimator state (random decayed counts through the bridge):
    the corrections from its current estimate and the state after the
    batch folds in."""
    cfg_j, cfg_t = _configs(mixed_negatives=bp)
    tc_j = jcfg.TrainConfig(streaming_logq=True, logq_decay=0.99)
    tc_t = tcfg.TrainConfig(streaming_logq=True, logq_decay=0.99)
    d = _data_np(9)
    jd, td = _jdata(d), _tdata(d)
    r = np.random.default_rng(10)
    counts, total = (r.uniform(0, 30, C).astype(np.float32), np.float32(900.5))
    key = jax.random.key(12)
    jb = jdata.extend_batch(dataclasses.replace(cfg_j, logq_correction=False), jd,
                            jdata.gather_batch(jd, jnp.arange(B)), key)
    jb, jest = jdata.attach_streaming_logq(cfg_j, tc_j, jb, jfe.FreqEstimatorState(
        jnp.asarray(counts), jnp.asarray(total)), jd.catalog_ids)
    tb = tdata.gather_batch(td, torch.arange(B))
    if bp:
        tb = tb._replace(neg_item_id=torch.from_numpy(np.asarray(jb.neg_item_id)))
    tb, test = tdata.attach_streaming_logq(cfg_t, tc_t, tb,
                                           bridge.freq_state_from_jax(counts, total, "cpu"),
                                           td.catalog_ids)
    for name in ("item_logq", "neg_logq"):
        want = getattr(jb, name)
        if want is None:
            assert getattr(tb, name) is None
        else:
            np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(want), rtol=1e-6)
    got_c, got_t = bridge.freq_state_to_jax(test)
    np.testing.assert_allclose(got_c, np.asarray(jest.counts), rtol=1e-6)
    np.testing.assert_allclose(got_t, np.asarray(jest.total), rtol=1e-6)


@pytest.mark.parametrize("compute_dtype,fused", [("float32", True), ("bfloat16", True),
                                                 ("float32", False)],
                         ids=["f32-fused", "bf16-fused", "f32-plain"])
def test_train_loss_with_negatives_and_logq_matches_jax(compute_dtype, fused):
    """train_loss on an extended batch (the JAX draw, handed to both sides
    as numpy): the loss, its metrics and every grad leaf, the negatives'
    item-tower gradients included."""
    cfg_j, cfg_t = _configs(compute_dtype=compute_dtype, fused_loss=fused)
    d = _data_np(13)
    jd = _jdata(d)
    jb = jdata.extend_batch(cfg_j, jd, jdata.gather_batch(jd, jnp.arange(B)), jax.random.key(14))
    nb = {k: np.asarray(v) for k, v in jb._asdict().items() if v is not None}
    params = jtt.init_params(jax.random.key(15), cfg_j)
    model = bridge.params_from_jax(_np(params), cfg_t, device="cpu")
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in nb.items()}))
    loss, tm = ttt.train_loss(model, cfg_t, ttt.Batch(**{k: torch.from_numpy(v) for k, v in nb.items()}))
    loss.backward()
    tol = TOL[compute_dtype]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    want = bridge.flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg))
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        scale = ttt.ZERO_GRAD_FLOOR * top if name in ttt.ZERO_GRAD_LEAVES else None
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=tol * (scale or float(np.abs(w).max())), err_msg=name)


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


def _leaf_close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for name, w in want.items():
        _scaled(got[name], w, tol, name)


@pytest.mark.parametrize("lazy,streaming", [(False, False), (True, False), (False, True)],
                         ids=["dense", "lazy", "dense-streaming"])
def test_three_steps_follow_jax(lazy, streaming, monkeypatch):
    """Three make_train_step steps in f32 with 8 mixed negatives and the
    logQ correction (the oracle's, or the streaming estimator's) against the
    JAX step: the port's draw returns the slots of the JAX step's own key
    (``split(state.rng)``), so both sides extend each batch alike; metrics,
    params, moments and the estimator after each step."""
    cfg_j, cfg_t = _configs()
    kw = dict(batch_size=B, learning_rate=1e-3, lazy_table_adam=lazy, pack_tables=False,
              streaming_logq=streaming, logq_decay=0.9)
    j_tcfg = jcfg.TrainConfig(**kw, donate_state=False)
    t_tcfg = tcfg.TrainConfig(**kw)
    d = _data_np(16)
    jd, td = _jdata(d), _tdata(d)
    jst = _mid_training(jstate.create_train_state(jax.random.key(17), cfg_j, j_tcfg, pack=False,
                                                  catalog_size=C), lazy, 18)
    model = bridge.params_from_jax(_np(jst.params), cfg_t, device="cpu")
    if lazy:
        adam = jst.opt_state["dense"][0]
        opt = bridge.lazy_state_from_jax(
            {"dense": (np.asarray(adam.count), _np(adam.mu), _np(adam.nu)),
             "tables": _np(jst.opt_state["tables"])}, model)
    else:
        adam = jst.opt_state[0]
        opt = bridge.adam_state_from_jax(adam.count, _np(adam.mu), _np(adam.nu), model)
    est = init_freq_estimator(C) if streaming else None
    tst = tstate.TrainState(step=torch.tensor(3, dtype=torch.int32), params=model, opt_state=opt,
                            rng=torch.Generator(), logq_state=est)
    slots = []
    monkeypatch.setattr(tdata, "draw_negative_slots", lambda *a: slots.pop(0))
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    for i in range(3):
        _, sub = jax.random.split(jst.rng)
        slots.append(torch.from_numpy(np.asarray(jax.random.randint(sub, (BP,), 0, C))))
        idx = np.arange(i * B, (i + 1) * B)
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        assert not slots
        assert set(tm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _leaf_close({n: p.detach().numpy() for n, p in model.named_parameters()},
                    bridge.flatten(_np(jst.params)), 1e-4)
        if lazy:
            got = bridge.lazy_state_to_jax(tst.opt_state)
            adam = jst.opt_state["dense"][0]
            want = {"dense": (np.asarray(adam.count), _np(adam.mu), _np(adam.nu)),
                    "tables": _np(jst.opt_state["tables"])}
        else:
            got = bridge.adam_state_to_jax(tst.opt_state)
            adam = jst.opt_state[0]
            want = (np.asarray(adam.count), _np(adam.mu), _np(adam.nu))
        _leaf_close(bridge.flatten(got), bridge.flatten(want), 1e-4)
        if streaming:
            counts, total = bridge.freq_state_to_jax(tst.logq_state)
            np.testing.assert_allclose(counts, np.asarray(jst.logq_state.counts), rtol=1e-6)
            np.testing.assert_allclose(total, np.asarray(jst.logq_state.total), rtol=1e-6)
        else:
            assert tst.logq_state is None
    assert int(tst.step) == int(jst.step) == 6
