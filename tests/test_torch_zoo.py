"""PyTorch port: the rest of the model zoo against the JAX package on the CPU.

The light ranker (its train terms and its rerank), KD, the reward model, the
precomputed-scores route of the loss, registered user-embedding arms and
``models/zoo.py``.  Weights cross through ``bridge.params_from_jax``; batches
are made with numpy from a seed and handed to both sides.

Tolerances: ``train_loss``, its metrics and every grad leaf at 1e-4 of each
leaf's scale in f32 and 1e-2 in bf16, as tests/test_torch_train_step.py
holds them (the leaves of ``zero_grad_leaves(cfg)`` against
``ZERO_GRAD_FLOOR`` times the top leaf); the loss terms alone at 1e-5 of
scale; rerank indices exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.models import zoo as jzoo
from two_tower_models_tpu.nn.layers import linear_apply as j_linear_apply
from two_tower_models_tpu.nn.layers import linear_init as j_linear_init
from two_tower_models_tpu.nn.packed_table import table_lookup as j_table_lookup
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.models import zoo as tzoo
from two_tower_models_tpu_torch.nn.layers import Linear, linear_apply
from two_tower_models_tpu_torch.nn.packed_table import table_lookup
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

V, D, B, H, F, BP, T = 128, 16, 32, 4, 8, 8, 2
NI, NU, NUM_ITEMS = 20, 3, 5
SIZES = dict(
    user_id_hash_size=V, user_id_embedding_dim=D, item_id_hash_size=V, item_id_embedding_dim=D,
    user_features_size=F, item_features_size=F, feature_hidden_dim=32,
    user_value_weights=(1.0, 0.5), history_len=H, num_items=NUM_ITEMS,
)
NEW_PRESETS = ("two_tower_plus_light_ranker", "two_tower_plus_light_ranker_kd",
               "two_tower_with_main_ranker_reward")
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
ROUTES = {"f32-fused": ("float32", True), "bf16-fused": ("bfloat16", True),
          "f32-plain": ("float32", False)}
ARM = "zoo_test_proj"


def _configs(name, **kw):
    """The preset at the test's sizes, a one-layer two-head encoder, and a
    light ranker of NI candidates and NU embeddings where it has one."""
    pairs = []
    for c in (jcfg, tcfg):
        over = {**SIZES, **kw, "history_encoder": c.HistoryEncoderConfig(num_heads=2, num_layers=1)}
        if "light_ranker" in name:
            over["light_ranker"] = c.LightRankerConfig(num_mips_items=NI,
                                                       num_ranker_user_embeddings=NU)
        pairs.append(c.preset(name, **over))
    return tuple(pairs)


def _batch_np(seed, cfg, negs: bool = False):
    """One batch as numpy: hard labels in the first T columns and, under KD,
    soft labels in [0, 1] in the next T; with ``negs`` BP mixed negatives
    and log proposal probabilities for the logQ correction."""
    r = np.random.default_rng(seed)
    labels = r.binomial(1, 0.5, (B, T)).astype(np.float32)
    if cfg.kd:
        labels = np.concatenate([labels, r.uniform(0, 1, (B, T)).astype(np.float32)], 1)
    nb = dict(
        user_id=r.integers(0, V, B).astype(np.int32),
        user_features=r.normal(size=(B, F)).astype(np.float32),
        user_history=r.integers(0, V, (B, H)).astype(np.int32),
        item_id=r.integers(0, V, B).astype(np.int32),
        item_features=r.normal(size=(B, F)).astype(np.float32),
        position=r.integers(0, 100, B).astype(np.int32),
        labels=labels,
    )
    if negs:
        nb.update(
            neg_item_id=r.integers(0, V, BP).astype(np.int32),
            neg_item_features=r.normal(size=(BP, F)).astype(np.float32),
            item_logq=np.log(r.uniform(0.01, 0.2, B)).astype(np.float32),
            neg_logq=np.log(r.uniform(0.001, 0.05, BP)).astype(np.float32),
        )
    return nb


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(got, want, tol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=err_msg)


def _loss_and_grads_match(cfg_j, cfg_t, params, nb, tol):
    """jax.value_and_grad(train_loss) against the port's loss and backward
    on the bridged weights: metrics (same names), every grad leaf."""
    model = bridge.params_from_jax(_np(params), cfg_t, device="cpu")
    (_, jm), jg = jax.value_and_grad(jtt.train_loss, has_aux=True)(
        params, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in nb.items()}))
    loss, tm = ttt.train_loss(model, cfg_t, ttt.Batch(**{k: torch.from_numpy(v)
                                                        for k, v in nb.items()}))
    loss.backward()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    want = bridge.flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg))
    top = max(float(np.abs(w).max()) for w in want.values())
    floor = ttt.zero_grad_leaves(cfg_t)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        w = want[name]
        scale = ttt.ZERO_GRAD_FLOOR * top if name in floor else float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol * scale, err_msg=name)
    return tm


@pytest.mark.parametrize("sampling", ["in-batch", "mns+logq"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", NEW_PRESETS)
def test_train_loss_matches_jax(name, route, sampling):
    """train_loss of the three presets: the loss, every metric (the light
    ranker's BCE, KD's loss, the reward KL and the proxy's BCE among them)
    and every grad leaf, on the fused route (the JAX side's Pallas kernels
    in interpret mode) and the plain one, with and without 8 mixed
    negatives and the logQ correction (the reward model's loss takes its
    precomputed [B, B] scores through ``_extended_ce`` there)."""
    dtype, fused = ROUTES[route]
    negs = sampling == "mns+logq"
    cfg_j, cfg_t = _configs(name, compute_dtype=dtype, fused_loss=fused,
                            mixed_negatives=BP if negs else 0, logq_correction=negs)
    params = jtt.init_params(jax.random.key(1), cfg_j)
    tm = _loss_and_grads_match(cfg_j, cfg_t, params, _batch_np(2, cfg_j, negs), TOL[dtype])
    extra = {"two_tower_plus_light_ranker": {"light_ranker_bce"},
             "two_tower_plus_light_ranker_kd": {"light_ranker_bce", "kd_loss"},
             "two_tower_with_main_ranker_reward": {"reward_kl", "proxy_ranker_bce"}}[name]
    assert extra <= set(tm)


def test_bce_with_logits_matches_jax():
    """The BCE's value and gradient, with logits exactly at 0 (where the
    maximum's gradient splits in half and |x|'s is 1, as JAX's are) and far
    out."""
    r = np.random.default_rng(3)
    logits = np.concatenate([r.normal(size=60) * 4, [0.0, 0.0, 40.0, -40.0]]).astype(np.float32)
    targets = r.uniform(0, 1, logits.shape).astype(np.float32)
    jv, jg = jax.value_and_grad(jtt._bce_with_logits)(jnp.asarray(logits), jnp.asarray(targets))
    x = torch.from_numpy(logits).requires_grad_()
    tv = ttt._bce_with_logits(x, torch.from_numpy(targets))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


def test_reward_terms_decomposed_equal_naive_pairwise():
    """The reward terms' decomposition over [Wu; Wi; ws] with the task axis
    folded into the value weights equals the naive evaluation, which builds
    the [B, B, 2*DI + 1] pair features and the [B, B, T] logits (float64):
    the KL and the proxy's BCE at 1e-5."""
    _, cfg_t = _configs("two_tower_with_main_ranker_reward")
    model = ttt.init_params(0, cfg_t, device="cpu")
    r = np.random.default_rng(4)
    bs = 6
    u, it = (r.normal(size=(bs, D)).astype(np.float32) for _ in range(2))
    s = u @ it.T
    labels = r.binomial(1, 0.5, (bs, T)).astype(np.float32)
    _, m = ttt._reward_model_terms(model, cfg_t, *(torch.from_numpy(a) for a in (u, it, s, labels)))
    w = model.proxy_ranker.w.detach().double().numpy()
    b = model.proxy_ranker.b.detach().double().numpy()
    feats = np.concatenate([np.repeat(u[:, None], bs, 1), np.repeat(it[None], bs, 0),
                            s[:, :, None]], 2).astype(np.float64)
    logits = feats @ w + b  # [B, B, T]
    vm = logits @ np.asarray(cfg_t.user_value_weights)
    p = np.exp(vm - vm.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    s64 = s.astype(np.float64)
    log_q = s64 - s64.max(1, keepdims=True)
    log_q -= np.log(np.exp(log_q).sum(1, keepdims=True))
    kl = np.mean(np.sum(p * (np.log(np.maximum(p, 1e-30)) - log_q), 1))
    diag = logits[np.arange(bs), np.arange(bs)]
    bce = np.mean(np.maximum(diag, 0) - diag * labels + np.log1p(np.exp(-np.abs(diag))))
    np.testing.assert_allclose(float(m["reward_kl"].detach()), kl, rtol=1e-5)
    np.testing.assert_allclose(float(m["proxy_ranker_bce"].detach()), bce, rtol=1e-5)


def test_reward_terms_keep_no_pairwise_graph():
    """The ranker's top probabilities take no gradient: the proxy's weights
    get theirs from the diagonal BCE alone (the KL's part is zero, as under
    JAX's stop_gradient), and the scores get the KL's."""
    _, cfg_t = _configs("two_tower_with_main_ranker_reward")
    model = ttt.init_params(0, cfg_t, device="cpu")
    r = np.random.default_rng(5)
    u, it = (torch.from_numpy(r.normal(size=(8, D)).astype(np.float32)) for _ in range(2))
    s = (u @ it.T).requires_grad_()
    labels = torch.ones(8, T)
    _, m = ttt._reward_model_terms(model, cfg_t, u, it, s, labels)
    g_kl = torch.autograd.grad(m["reward_kl"], [s, model.proxy_ranker.w], allow_unused=True)
    assert g_kl[1] is None and float(g_kl[0].abs().max()) > 0


def _retrieve_pair(name, seed, corpus_rows):
    cfg_j, cfg_t = _configs(name)
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(_np(params), cfg_t, device="cpu")
    nb = _batch_np(seed + 1, cfg_j)
    corpus = np.random.default_rng(seed + 2).normal(size=(corpus_rows, D)).astype(np.float32)
    want = np.asarray(jtt.retrieve(params, cfg_j, jnp.asarray(corpus), nb["user_id"],
                                   nb["user_features"], nb["user_history"]))
    return cfg_t, model, nb, torch.from_numpy(corpus), want


@pytest.mark.parametrize("corpus_rows", [200, 4096], ids=["dense", "tiled"])
@pytest.mark.parametrize("name", NEW_PRESETS[:2])
def test_rerank_matches_jax(name, corpus_rows):
    """retrieve with the light ranker: MIPS top NI, the head's rerank, the
    top num_items, indices equal to the JAX package's exactly (KD's aux
    logits dropped), over a corpus the dense scan takes and one the
    tile-max pipeline takes (NI * 128 < C)."""
    cfg_t, model, nb, corpus, want = _retrieve_pair(name, 6, corpus_rows)
    got = ttt.retrieve(model, cfg_t, corpus, nb["user_id"], nb["user_features"],
                       nb["user_history"], device="cpu")
    assert got.shape == (B, NUM_ITEMS) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_serves_the_light_ranker():
    """RetrievalEngine on the light ranker: warmup runs the rerank, and a
    query equals retrieve's indices (so the JAX package's)."""
    cfg_t, model, nb, corpus, want = _retrieve_pair("two_tower_plus_light_ranker_kd", 7, 200)
    engine = RetrievalEngine(model, cfg_t, corpus, device="cpu")
    engine.warmup(4)
    got = engine.query(nb["user_id"], nb["user_features"], nb["user_history"])
    np.testing.assert_array_equal(got.numpy(), want)


def _register_arm():
    """The same arm on both sides: the id-table lookup through one more
    Linear [DU, DU], its weights at ``user_embedding_ext.proj``."""

    def j_init(key, cfg):
        return {"proj": j_linear_init(key, cfg.user_id_embedding_dim, cfg.user_id_embedding_dim)}

    def j_apply(params, cfg, user_id):
        emb = j_table_lookup(params["user_id_table"], user_id, cfg.user_id_embedding_dim)
        return j_linear_apply(params["user_embedding_ext"]["proj"], emb)

    def t_init(generator, cfg, device):
        ext = torch.nn.Module()
        ext.proj = Linear(cfg.user_id_embedding_dim, cfg.user_id_embedding_dim, device=device)
        ext.proj.reset_parameters(generator)
        return ext

    def t_apply(model, cfg, user_id):
        emb = table_lookup(model.user_id_table, user_id, cfg.user_id_embedding_dim)
        return linear_apply(model.user_embedding_ext.proj, emb)

    jtt.register_user_embedding_arm(ARM, j_apply, j_init)
    ttt.register_user_embedding_arm(ARM, t_apply, t_init)


@pytest.mark.parametrize("name", ["two_tower_base_retrieval", "two_tower_plus_light_ranker"])
def test_user_embedding_arm_matches_jax(name):
    """A registered arm on both sides: the bridge carries
    ``user_embedding_ext`` both ways bit for bit, the port's own init builds
    the same leaves, the loss and every grad leaf (the arm's included) match
    JAX's, and the arm's own module draws from the generator."""
    _register_arm()
    cfg_j, cfg_t = _configs(name, user_embedding_arm=ARM)
    params = jtt.init_params(jax.random.key(8), cfg_j)
    assert "user_embedding_ext" in params
    tree = _np(params)
    model = bridge.params_from_jax(tree, cfg_t, device="cpu")
    back = bridge.params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    own = ttt.init_params(0, cfg_t, device="cpu")
    assert jax.tree_util.tree_map(np.shape, bridge.params_to_jax(own)) == \
        jax.tree_util.tree_map(np.shape, tree)
    again = ttt.init_params(0, cfg_t, device="cpu")
    other = ttt.init_params(1, cfg_t, device="cpu")
    w = own.user_embedding_ext.proj.w
    assert torch.equal(w, again.user_embedding_ext.proj.w)
    assert not torch.equal(w, other.user_embedding_ext.proj.w)
    assert float(w.abs().max()) <= 1 / np.sqrt(D)
    _loss_and_grads_match(cfg_j, cfg_t, params, _batch_np(9, cfg_j), TOL["float32"])


def test_lazy_step_refuses_a_custom_arm():
    """The lazy step swaps the id tables for minitables, which a custom arm
    cannot assume: it raises, as the JAX package's does."""
    _register_arm()
    _, cfg_t = _configs("two_tower_base_retrieval", user_embedding_arm=ARM)
    with pytest.raises(NotImplementedError, match="user_embedding_arm"):
        tstep.make_train_step(cfg_t, tcfg.TrainConfig(lazy_table_adam=True))
    dense = tstep.make_train_step(cfg_t, tcfg.TrainConfig())
    assert callable(dense)


BUILDERS = {
    "two_tower_base_retrieval": {},
    "two_tower_with_user_history_encoder": {"user_history_seqlen": H},
    "two_tower_with_position_debiased_weights": {"user_history_seqlen": H},
    "two_tower_with_user_debiased_weights": {"user_history_seqlen": H},
    "two_tower_with_debiasing": {"user_history_seqlen": H},
    "two_tower_plus_light_ranker": {"user_history_seqlen": H, "num_mips_items": NI,
                                    "num_ranker_user_embeddings": NU},
    "two_tower_plus_light_ranker_with_kd": {"user_history_seqlen": H, "num_mips_items": NI,
                                            "num_ranker_user_embeddings": NU},
    "two_tower_with_main_ranker_reward": {"user_history_seqlen": H},
}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_zoo_builder_matches_jax(builder):
    """Each builder's config equals the JAX builder's field by field (AUTO
    kernel flags resolved: off on the CPU on both sides), and the handle's
    init, train_forward, forward and towers run: finite loss, [B,
    num_items] indices in range."""
    sizes = {k: v for k, v in SIZES.items() if k != "history_len"}
    kw = {**sizes, **BUILDERS[builder]}
    j = getattr(jzoo, builder)(**kw)
    t = getattr(tzoo, builder)(**kw, device="cpu")
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert t.cfg.fused_loss is False and t.device == "cpu"
    params = t.init(0)
    assert isinstance(params, ttt.TwoTowerModel)
    nb = _batch_np(10, t.cfg)
    if t.cfg.history_len != H:
        nb["user_history"] = np.zeros((B, t.cfg.history_len), np.int32)
    batch = ttt.Batch(**{k: torch.from_numpy(v) for k, v in nb.items()})
    loss, metrics = t.train_forward(params, batch)
    assert np.isfinite(float(loss.detach())) and "loss" in metrics
    corpus = torch.randn(200, D, generator=torch.Generator().manual_seed(0))
    top = t.forward(params, corpus, batch.user_id, batch.user_features, batch.user_history)
    assert top.shape == (B, NUM_ITEMS) and int(top.min()) >= 0 and int(top.max()) < 200
    with torch.no_grad():
        u, ranker = t.compute_user_embedding(params, batch.user_id, batch.user_features,
                                             batch.user_history)
        items = t.compute_item_embeddings(params, batch.item_id, batch.item_features)
    assert u.shape == items.shape == (B, D)
    assert (ranker is None) == (t.cfg.light_ranker is None)


def test_from_preset_and_device_resolution():
    """from_preset takes the preset's config, resolved on the handle's
    device; on CUDA the AUTO flags turn the kernels on (no card needed to
    resolve them)."""
    t = tzoo.from_preset("two_tower_plus_light_ranker_kd", device="cpu", **SIZES)
    assert t.cfg.kd and t.cfg.light_ranker == tcfg.LightRankerConfig()
    on_gpu = tzoo.from_preset("two_tower_plus_light_ranker_kd", **SIZES)
    assert on_gpu.device == "cuda" and on_gpu.cfg.fused_loss is True
    assert on_gpu.cfg.history_encoder.fused_encoder is True


def test_zero_grad_leaves_by_config():
    """Only the reward model drops the floor for the two item-tower biases;
    the light ranker keeps it (its retrieval term is not max-normalised)."""
    for name in tcfg.PRESET_NAMES:
        want = () if name == "two_tower_with_main_ranker_reward" else ttt.ZERO_GRAD_LEAVES
        assert ttt.zero_grad_leaves(tcfg.preset(name)) == want


def test_create_train_state_holds_the_new_leaves():
    """A train state of each new preset holds Adam moments for the ranker's
    and the proxy's leaves, as the JAX package's optax state does."""
    for name in NEW_PRESETS:
        cfg_j, cfg_t = _configs(name)
        st = tstate.create_train_state(0, cfg_t, tcfg.TrainConfig(), device="cpu")
        jst = jstate.create_train_state(jax.random.key(0), cfg_j, jcfg.TrainConfig(), pack=False)
        want = set(bridge.flatten(_np(jst.opt_state[0].mu)))
        assert set(st.opt_state.mu) == want == {n for n, _ in st.params.named_parameters()}
