"""PyTorch port: the gradients of the explicit sharded training step (A13b)
against the JAX package on the CPU.

Four gloo ranks (``tests/torch_sharded_worker.py``, one spawn for the whole
file) run the lookups' backward, the sparse gradient exchange,
``shard_state`` and ``parallel.train_step.sharded_grads`` (the step's
reduced gradients) on meshes (2, 2), (1, 4) and (4, 1).  They are held
against the JAX package on the same numpy inputs and
``bridge.params_from_jax`` weights:

* the lookups' table gradients against ``jnp.take``'s gradient, 1e-6, and
  bit-equal on the rows of ids that occur once;
* the sparse exchange against the dense all-reduce of the same gradient,
  1e-6 (f32 sums in another order);
* ``state_pspecs`` against JAX's and ``shard_state``'s blocks bit-equal to
  JAX's ``shard_state`` shards on four of conftest's eight virtual devices;
* every gradient leaf of the eight presets (and tower_tp, the all-to-all
  lookup, variable-length histories, mixed negatives with logQ) against
  the single-device ``jax.grad(two_tower.train_loss)`` on the global batch
  within JAX's own tolerance for its sharded gradients (rtol 5e-4, atol
  1e-6, 5e-5 for the light ranker's presets: ``tests/test_parallel.py``),
  and ``grad_norm`` within 1e-5 relative of that gradient's global norm;
* the fused loss's step metrics within 1e-5 relative of JAX's
  ``make_sharded_train_step`` on every mesh (its ``grad_norm`` aside, which
  JAX scales by the mesh: ``test_torch_sharded_train.py`` pins that).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.conftest import make_batch
from tests.test_parallel import ALL_PRESETS, CFG, _small_preset
from tests.torch_sharded_worker import port_cfg, run_ranks
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.parallel import mesh as jmesh
from two_tower_models_tpu.parallel import sharding as jsh
from two_tower_models_tpu.parallel import sparse_grads as jsg
from two_tower_models_tpu.parallel import train_step as jts
from two_tower_models_tpu.training import state as jstate
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.nn.packed_table import pack_table
from two_tower_models_tpu_torch.parallel import sharding as tsh
from two_tower_models_tpu_torch.parallel import sparse_grads as tsg
from two_tower_models_tpu_torch.training.state import Adam, TrainState

B = 32


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _jmesh(shape):
    return jmesh.make_mesh(jcfg.MeshConfig(*shape))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    """{dotted path: numpy leaf} of a JAX pytree (the port's parameter names)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in leaves}


def _np_batch(batch) -> dict:
    return {k: np.asarray(v) for k, v in batch._asdict().items() if v is not None}


def _assemble(ranks, name, key, leaf, spec, mesh):
    """The full leaf from the ranks of data row 0 (rank m holds block m)."""
    blocks = [ranks[m][name][key][leaf] for m in range(mesh[1])]
    axes = [i for i, a in enumerate(spec) if a == "model"]
    return (torch.cat(blocks, axes[0]) if axes else blocks[0]).numpy()


# ---- (a) the lookups' backward ---------------------------------------------
TABLE = _normal(40, 64, 16)
IDS = np.random.default_rng(41).integers(0, 64, 40)
IDS[:6] = (3, 3, 3, 17, 63, 0)  # repeats and the edges
G = _normal(42, 40, 16)
LAYOUTS = {"plain": TABLE, "packed": pack_table(torch.from_numpy(TABLE)).numpy()}
LOOKUPS = {f"{s}_{lay}_{_tag(m)}": (s, lay, m) for s in ("psum", "all_to_all")
           for lay in LAYOUTS for m in ((2, 2), (1, 4))}


def _lookup_cases():
    return [{"name": name, "kind": "lookup_grad", "mesh": m, "table": LAYOUTS[lay], "ids": IDS,
             "g": G, "strategy": s, "dim": 16} for name, (s, lay, m) in LOOKUPS.items()]


# ---- (b) the sparse exchange -----------------------------------------------
EX_IDS = [np.random.default_rng(50 + d).integers(0, 64, 24) for d in range(4)]
for d in range(4):
    EX_IDS[d][:3] = (5, 5, 40)  # repeated within a rank and across the ranks
EX_G = [_normal(60 + d, 24, 16) for d in range(4)]
EXCHANGES = {"plain_2x2": ("plain", (2, 2)), "packed_2x2": ("packed", (2, 2)),
             "plain_4x1": ("plain", (4, 1)), "packed_4x1": ("packed", (4, 1))}


def _exchange_cases():
    return [{"name": f"ex_{name}", "kind": "exchange", "mesh": m, "table": LAYOUTS[lay],
             "ids": EX_IDS, "g": EX_G, "dim": 16} for name, (lay, m) in EXCHANGES.items()]


# ---- (c) the state's layout -------------------------------------------------
STATES = {"2x2_tp": ((2, 2), True), "1x4": ((1, 4), False)}
CFG_T = port_cfg(CFG)


def _jax_state():
    """JAX's TrainState of CFG with random moments (seeded numpy)."""
    st = jstate.create_train_state(jax.random.key(0), CFG, jcfg.TrainConfig())
    rng = np.random.default_rng(70)
    rand = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    adam = st.opt_state[0]
    opt = (adam._replace(mu=rand(adam.mu), nu=rand(adam.nu)), *st.opt_state[1:])
    return st._replace(opt_state=opt)


J_STATE = _jax_state()


def _state_cases():
    adam = J_STATE.opt_state[0]
    model = bridge.params_from_jax(_np_tree(J_STATE.params), CFG_T, device="cpu")
    mu, nu = _flat(_np_tree(adam.mu)), _flat(_np_tree(adam.nu))
    return [{"name": f"state_{name}", "kind": "state", "mesh": m, "cfg": CFG_T,
             "state": model.state_dict(), "mu": mu, "nu": nu, "tp": tp}
            for name, (m, tp) in STATES.items()]


# ---- (e), (f) gradients of the zoo, (d) the fused step ----------------------
def _hist_len_batch(cfg, batch):
    lens = np.random.default_rng(80).integers(1, cfg.history_len + 1, B)
    hist = np.where(np.arange(cfg.history_len)[None, :] < lens[:, None],
                    np.asarray(batch.user_history), 0)
    return batch._replace(user_history=jnp.asarray(hist), history_len=jnp.asarray(lens))


def _mns_batch(cfg, batch):
    rng = np.random.default_rng(81)
    n = cfg.mixed_negatives
    return batch._replace(
        neg_item_id=jnp.asarray(rng.integers(0, cfg.item_id_hash_size, n)),
        neg_item_features=jnp.asarray(_normal(82, n, cfg.item_features_size)),
        item_logq=jnp.asarray(np.log(rng.uniform(0.01, 0.2, B)).astype(np.float32)),
        neg_logq=jnp.asarray(np.log(rng.uniform(0.01, 0.2, n)).astype(np.float32)),
    )


def _grad_variants():
    """name -> (JAX config, JAX batch, mesh, mesh kwargs, lookup strategy)."""
    out = {}
    for name in ALL_PRESETS:
        cfg = _small_preset(name)
        cols = cfg.num_tasks * (2 if cfg.kd else 1)
        out[name] = (cfg, make_batch(jax.random.key(1), cfg, B, num_label_cols=cols), (2, 2),
                     {}, "psum")
    batch = make_batch(jax.random.key(1), CFG, B)
    out["tower_tp_1x4"] = (CFG, batch, (1, 4), {"tower_tp": True}, "psum")
    out["all_to_all_2x2"] = (CFG, batch, (2, 2), {}, "all_to_all")
    out["history_len_4x1"] = (CFG, _hist_len_batch(CFG, batch), (4, 1), {}, "psum")
    mns = dataclasses.replace(CFG, mixed_negatives=8, logq_correction=True)
    out["mns_logq_2x2"] = (mns, _mns_batch(mns, make_batch(jax.random.key(1), mns, B)), (2, 2),
                           {"sparse_table_grads": "on"}, "psum")
    return out


VARIANTS = _grad_variants()
_PARAMS = {}


def _j_params(cfg):
    key = repr(cfg)
    if key not in _PARAMS:
        _PARAMS[key] = jtt.init_params(jax.random.key(0), cfg)
    return _PARAMS[key]


def _grad_cases():
    cases = []
    for name, (cfg, batch, mesh, kw, strategy) in VARIANTS.items():
        cfg_t = port_cfg(cfg)
        model = bridge.params_from_jax(_np_tree(_j_params(cfg)), cfg_t, device="cpu")
        cases.append({"name": f"grads_{name}", "kind": "grads", "mesh": mesh, "mesh_kw": kw,
                      "cfg": cfg_t, "state": model.state_dict(), "batch": _np_batch(batch),
                      "strategy": strategy})
    return cases


FUSED = dataclasses.replace(CFG, fused_loss=True)
FUSED_MESHES = ((1, 4), (2, 2), (4, 1))
FUSED_BATCH = make_batch(jax.random.key(1), FUSED, B)


def _fused_cases():
    cfg_t = port_cfg(FUSED)
    model = bridge.params_from_jax(_np_tree(J_STATE.params), cfg_t, device="cpu")
    return [{"name": f"fused_{_tag(m)}", "kind": "steps", "mesh": m, "cfg": cfg_t,
             "state": model.state_dict(), "batches": [_np_batch(FUSED_BATCH)],
             "train": {"learning_rate": 1e-3}} for m in FUSED_MESHES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = (_lookup_cases() + _exchange_cases() + _state_cases() + _grad_cases()
             + _fused_cases())
    return run_ranks(cases, tmp_path_factory.mktemp("sharded_grads"))


# ---- tests -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_lookup_gradient_matches_take(ranks, name):
    """Each model rank's shard gradient, assembled, is jnp.take's gradient of
    sum(rows * G) (1e-6; bit-equal on the rows of ids that occur once), the
    same on every data rank, with no collective in the backward."""
    strategy, layout, mesh = LOOKUPS[name]
    want = np.asarray(jax.grad(lambda t: jnp.sum(jnp.take(t, IDS, axis=0) * G))(
        jnp.asarray(TABLE)))
    blocks = [ranks[r][name]["grad"] for r in range(4)]
    n = mesh[1]
    for r in range(n, 4):  # the other data rows hold the same gradient
        assert torch.equal(blocks[r], blocks[r % n])
    got = torch.cat(blocks[:n]).reshape(-1, 16).numpy()  # packed: the logical view
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ids, counts = np.unique(IDS, return_counts=True)
    once = ids[counts == 1]
    np.testing.assert_array_equal(got[once], want[once])
    untouched = np.setdiff1d(np.arange(64), IDS)
    assert not got[untouched].any()


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_sparse_exchange_equals_dense_all_reduce(ranks, name):
    """sparse_grad_exchange of each rank's dense lookup gradient (each data
    rank its own ids, repeated within and across ranks) equals the dense
    all-reduce over data within 1e-6, on every rank, plain and packed."""
    for r in range(4):
        res = ranks[r][f"ex_{name}"]
        np.testing.assert_allclose(res["sparse"].numpy(), res["dense"].numpy(), rtol=0,
                                   atol=1e-6)
        assert res["sparse"].shape == res["dense"].shape


def test_touched_ids_and_counts_match_jax():
    """table_touched_ids' lengths equal touched_id_counts (and JAX's), with
    and without the history encoder and mixed negatives."""
    for name, (cfg, batch, *_) in VARIANTS.items():
        cfg_t = port_cfg(cfg)
        tb = ttt.Batch(**{k: torch.from_numpy(v) for k, v in _np_batch(batch).items()})
        got = {k: v.numel() for k, v in tsg.table_touched_ids(cfg_t, tb).items()}
        want = {k: int(v.size) for k, v in jsg.table_touched_ids(cfg, batch).items()}
        assert got == want == tsg.touched_id_counts(cfg_t, B) == jsg.touched_id_counts(cfg, B), name
        for k, v in tsg.table_touched_ids(cfg_t, tb).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jsg.table_touched_ids(cfg, batch)[k]))


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("rows", [64, 1 << 16, 1 << 22])
def test_sparse_table_grad_names_match_jax(mode, rows):
    """The tables each mode sends through the exchange, on a rank's shapes
    (plain and packed shards of 64 to 2^22 rows, B_local 4096, H 32, data
    1, 2 and 4), equal JAX's."""
    from types import SimpleNamespace

    for d, m in ((1, 4), (2, 2), (4, 1)):
        cfg = jcfg.ModelConfig(user_id_hash_size=rows, item_id_hash_size=rows,
                               user_id_embedding_dim=64, item_id_embedding_dim=64,
                               history_len=32, history_encoder=jcfg.HistoryEncoderConfig())
        pack = 2 if rows >= 1 << 22 else 1
        shard = jax.ShapeDtypeStruct((rows // m // pack, 64 * pack), jnp.float32)
        jb = SimpleNamespace(user_id=jnp.zeros(4096, jnp.int32),
                             item_id=jnp.zeros(4096, jnp.int32),
                             user_history=jnp.zeros((4096, 32), jnp.int32), neg_item_id=None)
        tb = SimpleNamespace(user_id=torch.zeros(4096, dtype=torch.int32),
                             item_id=torch.zeros(4096, dtype=torch.int32),
                             user_history=torch.zeros(4096, 32, dtype=torch.int32),
                             neg_item_id=None)
        want = jsg.sparse_table_grad_names(
            cfg, jcfg.MeshConfig(d, m, sparse_table_grads=mode), jb,
            {"user_id_table": shard, "item_id_table": shard})
        t_shard = torch.empty(shard.shape, device="meta")
        got = tsg.sparse_table_grad_names(
            port_cfg(cfg), tcfg.MeshConfig(d, m, sparse_table_grads=mode), tb,
            SimpleNamespace(user_id_table=t_shard, item_id_table=t_shard))
        assert got == want, (d, m)
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        tsg.sparse_table_grad_names(port_cfg(cfg), tcfg.MeshConfig(2, 2, sparse_table_grads="x"),
                                    tb, SimpleNamespace(user_id_table=t_shard,
                                                        item_id_table=t_shard))


@pytest.mark.parametrize("tp", [False, True], ids=["plain", "tower_tp"])
def test_state_pspecs_match_jax(tp):
    """Every parameter's and Adam moment's spec equals JAX's state_pspecs;
    step, count and rng replicate."""
    specs = jsh.state_pspecs(J_STATE, tp)
    model = bridge.params_from_jax(_np_tree(J_STATE.params), CFG_T, device="cpu")
    st = TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                    opt_state=Adam(1e-3).init(model))
    got = tsh.state_pspecs(st, tp)
    jp = {k: tuple(v) for k, v in _flat(specs.params).items()}
    assert got.params == jp
    adam = specs.opt_state[0]
    assert got.opt_state.mu == {k: tuple(v) for k, v in _flat(adam.mu).items()} == jp
    assert got.opt_state.nu == {k: tuple(v) for k, v in _flat(adam.nu).items()} == jp
    assert got.step == got.opt_state.count == got.rng == tuple(specs.step) == ()
    assert tuple(adam.count) == ()


@pytest.mark.parametrize("name", list(STATES))
def test_shard_state_blocks_match_jax(ranks, name):
    """Each rank's parameters and moments are bit-equal to JAX's shard_state
    shards on the device at the rank's mesh position."""
    mesh_shape, tp = STATES[name]
    mesh = _jmesh(mesh_shape)
    placed = jsh.shard_state(J_STATE, mesh, tp)
    adam = placed.opt_state[0]
    trees = {"params": _flat(placed.params), "mu": _flat(adam.mu), "nu": _flat(adam.nu)}
    for r in range(4):
        dev = mesh.devices[r // mesh_shape[1], r % mesh_shape[1]]
        got = ranks[r][f"state_{name}"]
        for key, tree in trees.items():
            assert set(got[key]) == set(tree)
            for leaf, arr in tree.items():
                (shard,) = [s for s in arr.addressable_shards if s.device == dev]
                np.testing.assert_array_equal(got[key][leaf].numpy(), np.asarray(shard.data),
                                              err_msg=f"{key} {leaf} rank {r}")


def _j_grads(name):
    cfg, batch = VARIANTS[name][:2]
    fn = jax.jit(jax.grad(lambda p: jtt.train_loss(p, cfg, batch)[0]))
    return fn(_j_params(cfg))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_grads_match_single_device(ranks, name):
    """Every leaf of the step's reduced gradients (assembled over model)
    equals the single-device jax.grad of train_loss on the global batch
    within JAX's tolerance for its sharded gradients, on every data rank;
    grad_norm is their global norm within 1e-5 relative, the same on every
    rank.  The light ranker's presets take JAX's atol for them, 5e-5: their
    retrieval term is not max-normalised, and its f32 reassociation noise
    reaches 1e-5 absolute on the cancelling leaves."""
    cfg, _, mesh, kw, _ = VARIANTS[name]
    j_grads = _j_grads(name)
    want = _flat(_np_tree(j_grads))
    res = ranks[0][f"grads_{name}"]
    model = ttt.TwoTowerModel(port_cfg(cfg), device="meta")
    specs = tsh.param_pspecs(model, kw.get("tower_tp", False))
    assert set(res["grads"]) == set(want)
    atol = 5e-5 if cfg.light_ranker is not None else 1e-6
    for leaf, w in want.items():
        got = _assemble(ranks, f"grads_{name}", "grads", leaf, specs[leaf], mesh)
        if got.shape != w.shape:  # a packed table's gradient: its logical view
            got = got.reshape(w.shape)
        np.testing.assert_allclose(got, w, rtol=5e-4, atol=atol, err_msg=leaf)
    norm = float(optax.global_norm(j_grads))
    for r in range(4):
        g = ranks[r][f"grads_{name}"]
        assert float(g["metrics"]["grad_norm"]) == float(res["metrics"]["grad_norm"])
        for leaf in want:
            same = r % mesh[1]  # the rank of data row 0 holding the same block
            assert torch.equal(g["grads"][leaf], ranks[same][f"grads_{name}"]["grads"][leaf])
    np.testing.assert_allclose(float(res["metrics"]["grad_norm"]), norm, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_fused_steps():
    """JAX's make_sharded_train_step, fused loss, one step on each mesh."""
    out = {}
    tcfg_j = jcfg.TrainConfig(batch_size=B, learning_rate=1e-3)
    for m in FUSED_MESHES:
        state = jstate.create_train_state(jax.random.key(0), FUSED, tcfg_j)
        mesh = _jmesh(m)
        step = jts.make_sharded_train_step(FUSED, tcfg_j, mesh, jcfg.MeshConfig(*m))
        _, metrics = step(jsh.shard_state(state, mesh), FUSED_BATCH)
        out[m] = {k: float(v) for k, v in metrics.items()}
    return out


@pytest.mark.parametrize("mesh", FUSED_MESHES, ids=_tag)
def test_fused_step_metrics_match_jax_explicit_step(ranks, jax_fused_steps, mesh):
    """The fused loss's step: loss, softmax_ce, debias_aux_loss and nuv_mean
    within 1e-5 relative of JAX's explicit step, the same on every rank."""
    want = jax_fused_steps[mesh]
    got = ranks[0][f"fused_{_tag(mesh)}"]["metrics"][0]
    assert set(got) == set(want)
    for k in want:
        if k != "grad_norm":
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)
        for r in range(1, 4):
            assert torch.equal(ranks[r][f"fused_{_tag(mesh)}"]["metrics"][0][k], got[k])
