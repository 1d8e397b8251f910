"""PyTorch port: one-pass fused Adam (B20) against the JAX package on the
CPU.

``ops.fused_adam.fused_adam_step`` against the JAX package's
``fused_adam_step`` (its Pallas kernel in interpret mode, as
tests/test_fused_adam.py runs it) over three steps on that test's tree: a
leaf on the kernel path (1024 x 128), an odd-shaped leaf and small ones on
the plain formula.  Also against the port's ``Adam``, which divides by the
bias corrections where the fused update multiplies by their reciprocals;
``make_train_step`` with ``fused_adam=True`` against the JAX step; and the
two errors that keep fused Adam apart from clipping and lazy Adam.
Tolerance: 1e-6, tests/test_fused_adam.py's (the reciprocal against the
division, another pow); the train step 1e-4 of each leaf's scale, as
tests/test_torch_train_step.py holds the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_fused_adam import LR
from tests.test_fused_adam import _tree as _jax_tree
from tests.test_torch_train_step import (
    B,
    F,
    _adam_leaf,
    _assert_tree_close,
    _batch_np,
    _configs,
    _replace_adam,
)
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.ops.pallas.fused_adam import fused_adam_step as jax_fused_adam_step
from two_tower_models_tpu.training import data as jdata
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training import step as jstep
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.ops import _lib
from two_tower_models_tpu_torch.ops import fused_adam as tfa
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

TOL = 1e-6


def _flat(tree) -> dict:
    """{path: numpy} of a JAX pytree, keyed by its path string."""
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _port_state(params: dict) -> tstate.AdamState:
    zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
    return tstate.AdamState(torch.zeros((), dtype=torch.int32), zeros(), zeros())


def _grads(params, step):
    return jax.tree_util.tree_map(lambda p: jnp.cos(p + step).astype(p.dtype), params)


def _assert_close(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {name}")


def test_fused_adam_step_matches_jax_over_three_steps():
    """Three steps of the port's fused_adam_step against the JAX package's:
    params, both moments and the count.  The 1024 x 128 leaf goes through
    the kernel's wrapper (its plain version on the CPU), the others through
    the plain formula."""
    params = _jax_tree()
    jp, js = params, optax.adam(LR).init(params)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in _flat(params).items()}
    ts = _port_state(tp)
    for step in range(3):
        g = _grads(jp, step)
        jp, js = jax_fused_adam_step(jp, g, js, learning_rate=LR)
        ts = tfa.fused_adam_step(tp, {n: torch.from_numpy(np.array(a)) for n, a in _flat(g).items()},
                                 ts, LR)
        _assert_close(tp, _flat(jp), "params")
        _assert_close(ts.mu, _flat(js[0].mu), "mu")
        _assert_close(ts.nu, _flat(js[0].nu), "nu")
        assert int(ts.count) == int(js[0].count) == step + 1
    assert sum(p.numel() >= tfa._MIN_KERNEL_ELEMS for p in tp.values()) == 1


def test_fused_adam_step_matches_port_adam():
    """The fused update and the port's Adam from one state, three steps:
    within 1e-6 (the reciprocal bias corrections against the division)."""
    flat = {n: torch.from_numpy(np.array(a)) for n, a in _flat(_jax_tree(1)).items()}
    model = torch.nn.Module()
    for i, (n, p) in enumerate(flat.items()):
        model.register_parameter(f"p{i}", torch.nn.Parameter(p.clone()))
    fused = {f"p{i}": p.clone() for i, p in enumerate(flat.values())}
    adam, sa, sf = tstate.Adam(LR), _port_state(fused), _port_state(fused)
    for step in range(3):
        g = {n: torch.cos(p.detach() + step) for n, p in model.named_parameters()}
        sf = tfa.fused_adam_step(fused, g, sf, LR)
        sa = adam.update(model, g, sa)
        _assert_close(fused, {n: p.detach().numpy() for n, p in model.named_parameters()}, "params")
        _assert_close(sf.nu, {n: t.numpy() for n, t in sa.nu.items()}, "nu")
    assert torch.equal(sf.count, sa.count)


def test_plain_leaf_matches_the_pallas_kernel():
    """The plain version against the Pallas kernel alone, one leaf through
    three steps, including a bf16 leaf (computed in f32, rounded once)."""
    from two_tower_models_tpu.ops.pallas.fused_adam import _adam_leaf_kernel

    r = np.random.default_rng(3)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        p0 = r.normal(size=(300, 64)).astype(np.float32)
        jp, jm, jv = jnp.asarray(p0, jdt), jnp.zeros((300, 64)), jnp.zeros((300, 64))
        tp, tm, tv = torch.from_numpy(p0).to(dtype), torch.zeros(300, 64), torch.zeros(300, 64)
        for t in range(1, 4):
            g = r.normal(size=(300, 64)).astype(np.float32)
            c = tfa.bias_corrections(torch.tensor(t, dtype=torch.int32))
            jp, jm, jv = _adam_leaf_kernel(jp, jm, jv, jnp.asarray(g), jnp.asarray(c.numpy())[None],
                                           LR, 0.9, 0.999, 1e-8)
            tfa.fused_adam_leaf(tp, tm, tv, torch.from_numpy(g), c, LR)
            for a, b in ((tp, jp), (tm, jm), (tv, jv)):
                np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                           rtol=TOL, atol=TOL)
        assert tp.dtype == dtype


def test_train_step_fused_adam_follows_jax():
    """make_train_step with fused_adam=True in f32 on the shrunk flagship
    with a 4096-row item table (131,072 elements: the kernel's wrapper),
    three steps from one mid-training Adam state on both sides: params, the
    first moment and the metrics (see tests/test_torch_train_step.py)."""
    cfg_j, cfg_t = (dataclasses.replace(c, item_id_hash_size=4096) for c in _configs())
    j_tcfg = jcfg.TrainConfig(batch_size=B, learning_rate=1e-3, fused_adam=True, donate_state=False)
    t_tcfg = tcfg.TrainConfig(batch_size=B, learning_rate=1e-3, fused_adam=True)
    jst = jstate.create_train_state(jax.random.key(15), cfg_j, j_tcfg, pack=False)
    r = np.random.default_rng(16)
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
    b = _batch_np(17)
    jd = jdata.SyntheticRecData(
        user_ids=b["user_id"], user_features=b["user_features"], user_history=b["user_history"],
        item_ids=b["item_id"], item_features=b["item_features"], positions=b["position"],
        labels=b["labels"], catalog_ids=np.arange(4), catalog_features=np.zeros((4, F), np.float32),
    )
    td = tdata.SyntheticRecData(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in jd))
    jfn, tfn = jstep.make_train_step(cfg_j, j_tcfg), tstep.make_train_step(cfg_t, t_tcfg)
    assert isinstance(tstate.make_optimizer(t_tcfg), tstate.FusedAdam)
    idx = np.arange(B)
    for _ in range(3):
        jst, jm = jfn(jst, jd, jnp.asarray(idx))
        tst, tm = tfn(tst, td, torch.from_numpy(idx))
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
        _assert_tree_close(
            {k: p.detach().numpy() for k, p in model.named_parameters()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, jst.params)), 1e-4,
        )
        count, t_mu, _ = bridge.adam_state_to_jax(tst.opt_state)
        j_adam = _adam_leaf(jst.opt_state)
        assert int(count) == int(j_adam.count)
        _assert_tree_close(bridge.flatten(t_mu),
                           bridge.flatten(jax.tree_util.tree_map(np.asarray, j_adam.mu)), 1e-4)


def test_fused_adam_stays_apart_from_clipping_and_lazy_adam():
    """The default is off (plain Adam); fused Adam with grad_clip_norm and
    with lazy_table_adam raises, as in the JAX package."""
    assert not tcfg.TrainConfig().fused_adam
    assert type(tstate.make_optimizer(tcfg.TrainConfig())) is tstate.Adam
    with pytest.raises(ValueError, match="grad_clip_norm is incompatible with fused_adam"):
        tstate.make_optimizer(tcfg.TrainConfig(fused_adam=True, grad_clip_norm=1.0))
    _, cfg_t = _configs()
    with pytest.raises(ValueError, match="exclusive"):
        tstep.make_train_step(cfg_t, tcfg.TrainConfig(fused_adam=True, lazy_table_adam=True))


def test_launch_count_stays_zero_on_the_cpu():
    """On the CPU the wrapper takes the plain version and counts nothing:
    the count is of kernel launches."""
    before = _lib.launches["fused_adam"]
    t = torch.ones(1 << 16)
    tfa.fused_adam_leaf(t, torch.zeros_like(t), torch.zeros_like(t), t.clone(),
                        tfa.bias_corrections(torch.tensor(1, dtype=torch.int32)), LR)
    assert _lib.launches["fused_adam"] == before
