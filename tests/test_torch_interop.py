"""PyTorch port: reference-checkpoint interop (``interop.py``) against the
JAX package's on the CPU.

For the seven configs of ``tests/test_interop.py`` a reference-layout
state_dict is made with numpy from a seed (names and shapes: the reference's
modules, as JAX's export gives them).  The port's import is held against
JAX's import carried across by ``bridge.params_from_jax``, bit for bit on
every mapped parameter; the parameters with no reference counterpart
(``proxy_ranker``, the KD head's aux columns) against the port's own
``init_params(seed, ...)``; the port's export against JAX's, key for key and
bit for bit; ``strict``'s exceptions against JAX's on the same bad inputs;
and ``train_loss`` of the imported model against JAX's within 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu import interop as jinterop
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch import interop
from two_tower_models_tpu_torch.models import two_tower as ttt

BASE = dict(
    user_id_hash_size=64, user_id_embedding_dim=12,
    item_id_hash_size=96, item_id_embedding_dim=8,
    user_features_size=5, item_features_size=6,
    user_value_weights=(1.0, 0.5), num_items=4, history_len=6,
)
SEED = 3


def _config(m, name):
    hist = dict(history_encoder=m.HistoryEncoderConfig())
    return {
        "base": lambda: m.ModelConfig(**BASE),
        "history": lambda: m.ModelConfig(**BASE, **hist),
        "debias_both": lambda: m.ModelConfig(**BASE, **hist, debias=m.Debias.BOTH),
        "debias_user": lambda: m.ModelConfig(**BASE, **hist, debias=m.Debias.USER),
        "light_ranker": lambda: m.ModelConfig(**BASE, **hist, debias=m.Debias.BOTH,
                                              light_ranker=m.LightRankerConfig()),
        "kd": lambda: m.ModelConfig(**BASE, **hist, debias=m.Debias.BOTH,
                                    light_ranker=m.LightRankerConfig(), kd=True),
        "reward": lambda: m.ModelConfig(**BASE, **hist, debias=m.Debias.BOTH, reward_model=True),
    }[name]()


NAMES = ["base", "history", "debias_both", "debias_user", "light_ranker", "kd", "reward"]
# port parameters that no reference entry reaches
UNMAPPED = {"reward": ("proxy_ranker.w", "proxy_ranker.b")}


def _reference_state_dict(cfg_j, seed):
    """A state_dict in the reference's layout, values drawn with numpy."""
    layout = jinterop.reference_state_dict_from_params(jtt.init_params(jax.random.key(0), cfg_j), cfg_j)
    r = np.random.default_rng(seed)
    return {k: (r.standard_normal(v.shape) * 0.1).astype(np.float32) for k, v in layout.items()}


def _imports(name, seed=10):
    cfg_j, cfg_t = _config(jcfg, name), _config(tcfg, name)
    sd = _reference_state_dict(cfg_j, seed)
    jparams = jinterop.params_from_reference_state_dict(sd, cfg_j, key=jax.random.key(SEED))
    from_jax = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg_t, device="cpu")
    model = interop.params_from_reference_state_dict(sd, cfg_t, seed=SEED, device="cpu")
    return cfg_j, cfg_t, sd, jparams, from_jax, model


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", NAMES)
def test_import_matches_jax_import(name):
    cfg_j, cfg_t, sd, _, from_jax, model = _imports(name)
    fresh = dict(ttt.init_params(SEED, cfg_t, device="cpu").named_parameters())
    want = dict(from_jax.named_parameters())
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    t = cfg_t.num_tasks
    for leaf, p in got.items():
        assert p.dtype == want[leaf].dtype and p.shape == want[leaf].shape, leaf
        if leaf in UNMAPPED.get(name, ()):
            np.testing.assert_array_equal(_np(p), _np(fresh[leaf]), err_msg=leaf)
            assert not np.array_equal(_np(p), _np(want[leaf])), leaf  # JAX's init differs
        elif cfg_t.kd and leaf.startswith("light_ranker_head."):
            hard = (slice(None), slice(0, t)) if leaf.endswith(".w") else slice(0, t)
            aux = (slice(None), slice(t, None)) if leaf.endswith(".w") else slice(t, None)
            np.testing.assert_array_equal(_np(p)[hard], _np(want[leaf])[hard], err_msg=leaf)
            np.testing.assert_array_equal(_np(p)[aux], _np(fresh[leaf])[aux], err_msg=leaf)
        else:
            np.testing.assert_array_equal(_np(p), _np(want[leaf]), err_msg=leaf)
    # every reference entry landed: the mapped leaves hold the state_dict's values
    np.testing.assert_array_equal(_np(got["user_tower_head.w"]), sd["user_tower_arch.weight"].T)
    if cfg_t.history_encoder is not None:
        np.testing.assert_array_equal(
            _np(got["history_encoder.attn_layers.0.in_proj.w"]),
            sd["user_history_encoder.multihead_attn_layers.0.in_proj_weight"].T)


@pytest.mark.parametrize("name", NAMES)
def test_export_matches_jax_export(name):
    cfg_j, cfg_t, sd, jparams, _, model = _imports(name)
    got = interop.reference_state_dict_from_params(model, cfg_t)
    want = jinterop.reference_state_dict_from_params(jparams, cfg_j)
    assert list(got) == list(want) and set(got) == set(sd)
    for k, w in want.items():
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), sd[k], err_msg=k)  # the exact inverse


@pytest.mark.parametrize("name", NAMES)
def test_imported_train_loss_matches_jax(name):
    """The imported model's train_loss against JAX's imported params'.  The
    parameters no reference entry reaches come from each package's own
    init (other generators), so they take JAX's values here first."""
    cfg_j, cfg_t, _, jparams, from_jax, model = _imports(name)
    want = dict(from_jax.named_parameters())
    with torch.no_grad():
        for leaf in UNMAPPED.get(name, ()):
            dict(model.named_parameters())[leaf].copy_(want[leaf])
        if cfg_t.kd:
            t = cfg_t.num_tasks
            model.light_ranker_head.w[:, t:] = want["light_ranker_head.w"][:, t:]
            model.light_ranker_head.b[t:] = want["light_ranker_head.b"][t:]
    r = np.random.default_rng(0)
    n = 16
    t_cols = cfg_t.num_tasks * (2 if cfg_t.kd else 1)
    batch = dict(
        user_id=r.integers(0, 64, n).astype(np.int32),
        user_features=r.normal(size=(n, 5)).astype(np.float32),
        user_history=r.integers(0, 96, (n, 6)).astype(np.int32),
        item_id=r.integers(0, 96, n).astype(np.int32),
        item_features=r.normal(size=(n, 6)).astype(np.float32),
        position=r.integers(0, 100, n).astype(np.int32),
        labels=r.integers(0, 2, (n, t_cols)).astype(np.float32),
    )
    jloss, jm = jtt.train_loss(jparams, cfg_j, jtt.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        tloss, tm = ttt.train_loss(model, cfg_t, ttt.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def _bad_inputs(sd):
    extra = dict(sd)
    extra["position_bias_net_user_value.weight"] = np.zeros((100, 1), np.float32)
    missing = dict(sd)
    del missing["user_tower_arch.weight"]
    bad_shape = dict(sd)
    bad_shape["user_tower_arch.weight"] = np.zeros((3, 3), np.float32)
    bad_bias = dict(sd)
    bad_bias["item_id_embedding_arch.weight"] = np.zeros((95, 8), np.float32)
    return {"extra": extra, "missing": missing, "bad_shape": bad_shape, "bad_table": bad_bias}


def _outcome(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
@pytest.mark.parametrize("case", ["extra", "missing", "bad_shape", "bad_table"])
def test_strict_errors_match_jax(case, strict):
    cfg_j, cfg_t = _config(jcfg, "base"), _config(tcfg, "base")
    sd = _bad_inputs(_reference_state_dict(cfg_j, 1))[case]
    want = _outcome(lambda: jinterop.params_from_reference_state_dict(
        sd, cfg_j, key=jax.random.key(SEED), strict=strict))
    got = _outcome(lambda: interop.params_from_reference_state_dict(
        sd, cfg_t, seed=SEED, strict=strict, device="cpu"))
    assert got is want
    assert want is {("extra", True): KeyError, ("missing", True): KeyError}.get(
        (case, strict), ValueError if case.startswith("bad") else None)
    if case == "missing" and not strict:  # an absent entry keeps the fresh init
        model = interop.params_from_reference_state_dict(sd, cfg_t, seed=11, strict=False, device="cpu")
        np.testing.assert_array_equal(
            _np(model.user_tower_head.w), _np(ttt.init_params(11, cfg_t, device="cpu").user_tower_head.w))


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
@pytest.mark.parametrize("drop", [(), ("light_ranker.weight",), ("light_ranker.bias",),
                                  ("light_ranker.weight", "light_ranker.bias")],
                         ids=["none", "weight", "bias", "both"])
def test_kd_head_missing_columns_match_jax(drop, strict):
    """KD imports the T hard columns only: the same exception types as JAX's
    when they are absent, and the aux columns keep the fresh init."""
    cfg_j, cfg_t = _config(jcfg, "kd"), _config(tcfg, "kd")
    sd = {k: v for k, v in _reference_state_dict(cfg_j, 2).items() if k not in drop}
    want = _outcome(lambda: jinterop.params_from_reference_state_dict(
        sd, cfg_j, key=jax.random.key(SEED), strict=strict))
    got = _outcome(lambda: interop.params_from_reference_state_dict(
        sd, cfg_t, seed=SEED, strict=strict, device="cpu"))
    assert got is want
    if want is None:
        model = interop.params_from_reference_state_dict(sd, cfg_t, seed=SEED, strict=strict, device="cpu")
        fresh = ttt.init_params(SEED, cfg_t, device="cpu")
        t = cfg_t.num_tasks
        head = _np(model.light_ranker_head.w)
        np.testing.assert_array_equal(head[:, t:], _np(fresh.light_ranker_head.w)[:, t:])
        if "light_ranker.weight" in sd:
            np.testing.assert_array_equal(head[:, :t], sd["light_ranker.weight"].T)
        else:
            np.testing.assert_array_equal(head, _np(fresh.light_ranker_head.w))


def test_accepts_torch_tensors_and_a_bf16_model():
    """torch tensors of any dtype are read as f32; a bf16 model's params take
    each entry cast once from f32, as JAX's astype does."""
    cfg_j = _config(jcfg, "history")
    sd = _reference_state_dict(cfg_j, 4)
    as_torch = {k: torch.from_numpy(v) for k, v in sd.items()}
    cfg_t = _config(tcfg, "history")
    a = interop.params_from_reference_state_dict(sd, cfg_t, device="cpu")
    b = interop.params_from_reference_state_dict(as_torch, cfg_t, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    import dataclasses

    cfg_jb = dataclasses.replace(cfg_j, param_dtype="bfloat16")
    cfg_tb = dataclasses.replace(cfg_t, param_dtype="bfloat16")
    jb = jinterop.params_from_reference_state_dict(sd, cfg_jb)
    tb = interop.params_from_reference_state_dict(as_torch, cfg_tb, device="cpu")
    want = bridge.flatten(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jb))
    for n, p in tb.named_parameters():
        assert p.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(p.detach().float().numpy(), want[n], err_msg=n)
    back = interop.reference_state_dict_from_params(tb, cfg_tb)
    want_sd = jinterop.reference_state_dict_from_params(jb, cfg_jb)
    for k, w in want_sd.items():
        np.testing.assert_array_equal(back[k].numpy(), w, err_msg=k)
