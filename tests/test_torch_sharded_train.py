"""PyTorch port: the explicit sharded training step (A13b) as a step, against
the JAX package and the port's single-device step, on the CPU.

Four gloo ranks (``tests/torch_sharded_worker.py``, one spawn for the whole
file) run ``parallel.train_step.make_sharded_train_step`` on meshes
(1, 4), (2, 2) and (4, 1), on ``tests/test_parallel.py``'s ``CFG`` and the
same ``bridge.params_from_jax`` weights and numpy batches as the JAX side,
and ``chip_smoke.py``'s phase 15b-15e legs at a tiny width.  Held:

* the step's loss and metrics within 1e-5 relative of JAX's explicit
  ``make_sharded_train_step`` on every mesh (``grad_norm`` aside);
* JAX's explicit-step ``grad_norm`` at n_data times the single-device
  one (the reference's deviation, ROADMAP.md C), the port's at one;
* the parameters after three steps within 1e-4 of each leaf's scale of
  JAX's single-device ``make_train_step`` (the elements whose gradient is
  below 1e-4 of the leaf's largest at any of the three steps, and the two
  leaves zero in exact arithmetic, are left out: Adam moves every element
  by about lr whatever its gradient's size, so there f32 noise decides the
  sign; JAX's note, ``tests/test_parallel.py``);
* replicated leaves, and each table shard's replicas, bit-equal on every
  rank after the steps; K steps a dispatch, fused Adam and the three
  ``sparse_table_grads`` modes against the plain step;
* a gloo world of one, in this process, bit-equal to the port's
  ``make_train_step`` (metrics and parameters), and every raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_batch
from tests.test_parallel import CFG
from tests.torch_sharded_worker import SMOKE15_SIZES, port_cfg, run_ranks
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.parallel import mesh as jmesh
from two_tower_models_tpu.parallel import sharding as jsh
from two_tower_models_tpu.parallel import train_step as jts
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu.training.data import SyntheticRecData as JData
from two_tower_models_tpu.training.step import make_train_step as j_make_train_step
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.parallel import mesh as tmesh
from two_tower_models_tpu_torch.parallel import sharding as tsh
from two_tower_models_tpu_torch.parallel import train_step as tts
from two_tower_models_tpu_torch.training import data as tdata
from two_tower_models_tpu_torch.training import state as tstate
from two_tower_models_tpu_torch.training import step as tstep

B = 32
MESHES = ((1, 4), (2, 2), (4, 1))
CFG_T = port_cfg(CFG)
J_TRAIN = jcfg.TrainConfig(batch_size=B, learning_rate=1e-3, donate_state=False)
BATCHES = [make_batch(jax.random.key(1 + k), CFG, B) for k in range(3)]


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _np_batch(batch) -> dict:
    return {k: np.asarray(v) for k, v in batch._asdict().items() if v is not None}


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _j_state():
    """A fresh JAX TrainState from key 0 (JAX's steps donate theirs)."""
    return jstate.create_train_state(jax.random.key(0), CFG, J_TRAIN)


STATE_DICT = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, _j_state().params), CFG_T,
                                    device="cpu").state_dict()
NP_BATCHES = [_np_batch(b) for b in BATCHES]

# name -> (mesh, steps, TrainConfig kwargs, MeshConfig kwargs)
STEPS = {f"plain_{_tag(m)}": (m, 3 if m == (2, 2) else 1, {}, {}) for m in MESHES}
STEPS.update({
    "k3_2x2": ((2, 2), 3, {"steps_per_dispatch": 3}, {}),
    "fused_adam_2x2": ((2, 2), 3, {"fused_adam": True}, {}),
    "sparse_on_2x2": ((2, 2), 3, {}, {"sparse_table_grads": "on"}),
    "sparse_off_2x2": ((2, 2), 3, {}, {"sparse_table_grads": "off"}),
})


def _step_cases():
    cases = []
    for name, (mesh, n, train, mesh_kw) in STEPS.items():
        batches = NP_BATCHES[:n]
        if train.get("steps_per_dispatch"):  # one dispatch of [K, B] fields
            batches = [{k: np.stack([b[k] for b in batches]) for k in batches[0]}]
        cases.append({"name": name, "kind": "steps", "mesh": mesh, "cfg": CFG_T,
                      "state": STATE_DICT, "batches": batches,
                      "train": {"learning_rate": 1e-3, **train}, "mesh_kw": mesh_kw})
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _step_cases() + [{"name": "smoke15", "kind": "smoke15", "mesh": (2, 2)}]
    return run_ranks(cases, tmp_path_factory.mktemp("sharded_train"))


@pytest.fixture(scope="module")
def jax_explicit_steps():
    """JAX's make_sharded_train_step, one step on each mesh: its metrics."""
    out = {}
    for m in MESHES:
        mesh = jmesh.make_mesh(jcfg.MeshConfig(*m))
        step = jts.make_sharded_train_step(CFG, J_TRAIN, mesh, jcfg.MeshConfig(*m))
        _, metrics = step(jsh.shard_state(_j_state(), mesh), BATCHES[0])
        out[m] = {k: float(v) for k, v in metrics.items()}
    return out


def _single_device_grads():
    """jax.grad of train_loss on the first batch, one device: (grads, their
    global norm)."""
    g = jax.jit(jax.grad(lambda p: jtt.train_loss(p, CFG, BATCHES[0])[0]))(_j_state().params)
    return g, float(optax.global_norm(g))


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_step_metrics_match_jax_explicit_step(ranks, jax_explicit_steps, mesh):
    """loss, softmax_ce, debias_aux_loss and nuv_mean within 1e-5 relative
    of JAX's explicit step; every metric the same on every rank; the
    port's grad_norm within 1e-5 of the single-device gradient's norm."""
    want = jax_explicit_steps[mesh]
    got = ranks[0][f"plain_{_tag(mesh)}"]["metrics"][0]
    assert set(got) == set(want)
    for k in want:
        if k != "grad_norm":
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)
        for r in range(1, 4):
            assert torch.equal(ranks[r][f"plain_{_tag(mesh)}"]["metrics"][0][k], got[k])
    np.testing.assert_allclose(float(got["grad_norm"]), _single_device_grads()[1], rtol=1e-5)


def test_jax_explicit_step_scales_grad_norm_by_n_data(jax_explicit_steps):
    """The reference's deviation, pinned: JAX's explicit step reads
    grad_norm at n_data times the single-device gradient's (its psum
    adjoints under check_vma=False), within 1e-3 relative; the loss agrees."""
    norm = _single_device_grads()[1]
    loss = float(jtt.train_loss(_j_state().params, CFG, BATCHES[0])[0])
    for (d, m), metrics in jax_explicit_steps.items():
        np.testing.assert_allclose(metrics["grad_norm"], d * norm, rtol=1e-3)
        np.testing.assert_allclose(metrics["loss"], loss, rtol=1e-5)


_TRAJECTORY = {}


def _j_trajectory():
    """The JAX package's single-device make_train_step over the three
    BATCHES: (the parameters after them, the gradients each step took)."""
    if not _TRAJECTORY:
        cols = ("user_id", "user_features", "user_history", "item_id", "item_features",
                "position", "labels")
        cat = {k: jnp.concatenate([getattr(b, k) for b in BATCHES]) for k in cols}
        data = JData(user_ids=cat["user_id"], user_features=cat["user_features"],
                     user_history=cat["user_history"], item_ids=cat["item_id"],
                     item_features=cat["item_features"], positions=cat["position"],
                     labels=cat["labels"], catalog_ids=jnp.arange(4),
                     catalog_features=jnp.zeros((4, CFG.item_features_size)))
        step = j_make_train_step(CFG, J_TRAIN)
        grad = jax.jit(jax.grad(lambda p, b: jtt.train_loss(p, CFG, b)[0]))
        state, grads = _j_state(), []
        for k, b in enumerate(BATCHES):
            grads.append(_flat(grad(state.params, b)))
            state, _ = step(state, data, jnp.arange(k * B, (k + 1) * B))
        _TRAJECTORY.update(params=_flat(state.params), grads=grads)
    return _TRAJECTORY["params"], _TRAJECTORY["grads"]


def _assembled(ranks, name, mesh):
    specs = tsh.param_pspecs(ttt.TwoTowerModel(CFG_T, device="meta"))
    out = {}
    for leaf, spec in specs.items():
        blocks = [ranks[m][name]["params"][leaf] for m in range(mesh[1])]
        out[leaf] = (torch.cat(blocks) if spec else blocks[0]).numpy()
    return out


def _kept_close(got: dict, want: dict, tol: float) -> None:
    """Each leaf within ``tol`` of its scale on the elements whose
    single-device gradient is, at each of the three steps, 0 or at least
    1e-4 of the leaf's largest (the module's docstring says why), at least
    half of each leaf (the attention's key bias, a third of in_proj.b, has a
    gradient zero in exact arithmetic: a softmax does not move under a
    shift of a row); the leaves zero in exact arithmetic (ZERO_GRAD_LEAVES)
    left out."""
    grads = _j_trajectory()[1]
    for leaf, w in want.items():
        if leaf in ttt.ZERO_GRAD_LEAVES:
            continue
        keep = np.ones(w.shape, bool)
        for g in grads:
            g = np.abs(g[leaf])
            keep &= (g == 0) | (g >= 1e-4 * g.max())
        assert keep.mean() >= 0.5, leaf
        np.testing.assert_allclose(got[leaf][keep], w[keep], rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=leaf)


def test_three_steps_match_jax_single_device_step(ranks):
    """The parameters after three steps on (2, 2) against JAX's single-device
    make_train_step on the same three global batches, 1e-4 of each leaf's
    scale (``_kept_close``)."""
    _kept_close(_assembled(ranks, "plain_2x2", (2, 2)), _j_trajectory()[0], 1e-4)


@pytest.mark.parametrize("name", list(STEPS))
def test_replicas_stay_bit_equal(ranks, name):
    """After the steps every rank's replicated leaves equal rank 0's, and
    each table shard equals its replica on the other data ranks, bit for
    bit; the step count advanced once a step."""
    mesh, n = STEPS[name][:2]
    specs = tsh.param_pspecs(ttt.TwoTowerModel(CFG_T, device="meta"))
    for r in range(4):
        res = ranks[r][name]
        assert int(res["step"]) == n
        same = r % mesh[1]
        for leaf, spec in specs.items():
            ref = ranks[0 if not spec else same][name]["params"][leaf]
            assert torch.equal(res["params"][leaf], ref), (leaf, r)


def test_k_steps_a_dispatch_equal_single_steps(ranks):
    """steps_per_dispatch = 3 on [3, B] fields: the parameters of three
    single steps bit for bit, its metrics the mean of theirs."""
    got = _assembled(ranks, "k3_2x2", (2, 2))
    want = _assembled(ranks, "plain_2x2", (2, 2))
    for leaf in want:
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    single = ranks[0]["plain_2x2"]["metrics"]
    k3 = ranks[0]["k3_2x2"]["metrics"][0]
    assert set(k3) == set(single[0])
    for key in k3:
        np.testing.assert_allclose(float(k3[key]), float(torch.stack([m[key] for m in single])
                                                         .mean()), rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["fused_adam_2x2", "sparse_on_2x2", "sparse_off_2x2"])
def test_step_variants_match_the_plain_step(ranks, name):
    """Fused Adam (B20's plain version here) and the sparse exchange forced
    on or off give the plain step's parameters after three steps within
    1e-5 of each leaf's scale (``_kept_close``: f32 sums in another order
    start the trajectories apart in the last bits), and its loss."""
    _kept_close(_assembled(ranks, name, (2, 2)), _assembled(ranks, "plain_2x2", (2, 2)), 1e-5)
    for a, b in zip(ranks[0][name]["metrics"], ranks[0]["plain_2x2"]["metrics"]):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)


def test_chip_smoke_sharded_training_legs_on_the_cpu(ranks):
    """chip_smoke.py's phase 15b-15e on four gloo ranks at SMOKE15_SIZES:
    every leg runs on every rank and passes its checks (launch counts and
    times are the card's alone)."""
    legs = {"train 4x1", "train 2x2", "train 1x4", "train 2x2 sparse on",
            "train 2x2 sparse off", "train 2x2 all_to_all", "train 2x2 tower_tp",
            "train 2x2 K=4", "train 2x2 mns+logq", "train 2x2 lightranker", "train 2x2 kd",
            "train 2x2 reward", "train 2x2 4M packed"}
    for r in ranks:
        res = r["smoke15"]
        assert res["failures"] == []
        assert legs <= set(res["launches"]), sorted(res["launches"])
    assert SMOKE15_SIZES["SHARD_STEPS"] >= 2


def _port_state(device="cpu"):
    model = ttt.TwoTowerModel(CFG_T, device=device)
    model.load_state_dict(STATE_DICT)
    tx = tstate.make_optimizer(tcfg.TrainConfig(learning_rate=1e-3))
    return tstate.TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                             opt_state=tx.init(model))


def test_world_of_one_is_the_single_device_step(tmp_path):
    """A gloo world of one, mesh (1, 1), in this process: three sharded
    steps equal three make_train_step steps bit for bit, metrics and
    parameters, with the plain and the fused loss."""
    tmesh.init_process_group(0, 1, f"file://{tmp_path / 'store'}", device="cpu")
    try:
        mesh = tmesh.single_device_mesh("cpu")
        tbs = [ttt.Batch(**{k: torch.from_numpy(v.copy()) for k, v in b.items()})
               for b in NP_BATCHES]
        data = tdata.SyntheticRecData(
            user_ids=torch.cat([b.user_id for b in tbs]),
            user_features=torch.cat([b.user_features for b in tbs]),
            user_history=torch.cat([b.user_history for b in tbs]),
            item_ids=torch.cat([b.item_id for b in tbs]),
            item_features=torch.cat([b.item_features for b in tbs]),
            positions=torch.cat([b.position for b in tbs]),
            labels=torch.cat([b.labels for b in tbs]),
            catalog_ids=torch.arange(4), catalog_features=torch.zeros(4, 8))
        for fused in (False, True):
            cfg = dataclasses.replace(CFG_T, fused_loss=fused)
            train = tcfg.TrainConfig(learning_rate=1e-3)
            ref, st = _port_state(), tsh.shard_state(_port_state(), cfg, mesh)
            single = tstep.make_train_step(cfg, train)
            sharded = tts.make_sharded_train_step(cfg, train, mesh, tcfg.MeshConfig())
            for k, b in enumerate(tbs):
                ref, want = single(ref, data, torch.arange(k * B, (k + 1) * B))
                st, got = sharded(st, b)
                assert list(got) == list(want)
                for key in want:
                    assert torch.equal(got[key], want[key]), (fused, k, key)
            for (n, p), (_, q) in zip(st.params.named_parameters(), ref.params.named_parameters()):
                assert torch.equal(p, q), n
            assert torch.equal(st.step, ref.step)
    finally:
        torch.distributed.destroy_process_group()


class _Mesh:
    """A mesh's shape alone: the step's raises come before any collective."""

    def __init__(self, d, m):
        self.shape = (d, m)

    def size(self, i):
        return self.shape[i]


def test_sharded_step_raises():
    """JAX's raises (a custom user arm, tower_tp over an indivisible hidden
    dim, ring with the reward model or without global negatives,
    grad_clip_norm), the ring itself (A13c), a config of another mesh, a
    batch that does not split, a lazy-Adam state and a block of another
    mesh."""
    train = tcfg.TrainConfig()
    make = lambda cfg=CFG_T, t=train, mesh=(2, 2), **kw: tts.make_sharded_train_step(
        cfg, t, _Mesh(*mesh), tcfg.MeshConfig(*mesh, **kw))
    with pytest.raises(NotImplementedError, match="user_embedding_arm"):
        make(dataclasses.replace(CFG_T, user_embedding_arm="custom"))
    with pytest.raises(ValueError, match="tower_tp needs feature_hidden_dim"):
        make(dataclasses.replace(CFG_T, feature_hidden_dim=30), mesh=(1, 4), tower_tp=True)
    with pytest.raises(ValueError, match="incompatible with reward_model"):
        make(dataclasses.replace(CFG_T, reward_model=True), ring_negatives=True)
    with pytest.raises(ValueError, match="requires global_negatives"):
        make(ring_negatives=True, global_negatives=False)
    with pytest.raises(NotImplementedError, match="grad_clip_norm"):
        make(t=tcfg.TrainConfig(grad_clip_norm=1.0))
    with pytest.raises(NotImplementedError, match="A13c"):
        make(ring_negatives=True)
    with pytest.raises(ValueError, match="mesh_cfg is 1x4"):
        tts.make_sharded_train_step(CFG_T, train, _Mesh(2, 2), tcfg.MeshConfig(1, 4))
    tb = ttt.Batch(**{k: torch.from_numpy(v.copy()) for k, v in NP_BATCHES[0].items()})
    with pytest.raises(ValueError, match="does not split over 3"):
        tts.local_batch(tb, 0, 3)
    assert tts.local_batch(tb, 1, 2).user_id.shape == (B // 2,)
    lazy = tstate.create_train_state(0, CFG_T, tcfg.TrainConfig(lazy_table_adam=True), "cpu")
    with pytest.raises(ValueError, match="dense Adam"):
        tsh.state_pspecs(lazy)
    with pytest.raises(ValueError, match="shard the state for this mesh"):
        tts.check_mesh_tables(_port_state().params, CFG_T, 2, local=True)
    tts.check_mesh_tables(_port_state().params, CFG_T, 1, local=True)
