"""PyTorch port: sharded serving (A13a) against the JAX package on the CPU.

The port runs a mesh as one process a rank: four gloo ranks
(``tests/torch_sharded_worker.py``, one spawn for the whole file) run the
sharded refresh and recall and ``RetrievalEngine.from_params(mesh=...)`` on
meshes (2, 2) and (1, 4); the JAX package runs the same functions under
``shard_map`` on the first four of ``conftest.py``'s eight virtual CPU
devices, on the same numpy inputs and ``bridge.params_from_jax`` weights.

Integer outputs are held exactly: indices and recall (the shard scan's tie
order and scores are in ``test_torch_sharded_lookup.py``).  The refreshed
rows are held within 1e-5 of scale (two f32 dot orders).  Under
``tower_tp`` the all-reduce sums in another order than one matmul, so
indices are held where the scores leave a margin.  Every rank must return the same answer.  A world of one is held
bit for bit against the port's single-device engine, in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sharded_worker import SMOKE_SIZES, run_ranks, run_smoke_ranks
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.parallel import mesh as jmesh
from two_tower_models_tpu.parallel import retrieval as jpr
from two_tower_models_tpu.retrieval import mips as jmips
from two_tower_models_tpu.serving import RetrievalEngine as JEngine
from two_tower_models_tpu.training.step import make_eval_recall_fn as j_recall_fn
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.models.two_tower import Batch as TBatch
from two_tower_models_tpu_torch.parallel import mesh as tmesh
from two_tower_models_tpu_torch.parallel.retrieval import pad_catalog
from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, sharded_mips_topk
from two_tower_models_tpu_torch.serving import RetrievalEngine
from two_tower_models_tpu_torch.training.step import make_eval_recall_fn

MESHES = ((2, 2), (1, 4))
SIZES = dict(
    user_id_hash_size=64, user_id_embedding_dim=16, item_id_hash_size=64,
    item_id_embedding_dim=16, user_features_size=8, item_features_size=8,
    feature_hidden_dim=32, user_value_weights=(1.0, 0.5), history_len=8,
)
CATALOG = 90  # pads to 92 over four ranks
QUERIES = 16


def _cfgs(light_ranker=False, **kw):
    """(JAX config, port config) of the JAX package's sharded tests."""
    out = []
    for m in (jcfg, tcfg):
        extra = dict(kw, history_encoder=m.HistoryEncoderConfig(num_heads=2, num_layers=1))
        if light_ranker:
            extra.update(light_ranker=m.LightRankerConfig(num_mips_items=16), num_items=4)
        out.append(m.ModelConfig(**SIZES, **extra))
    return tuple(out)


def _params(cfg_j, cfg_t, seed=0):
    params = jtt.init_params(jax.random.key(seed), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    return params, model


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _catalog(seed, c=CATALOG):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SIZES["item_id_hash_size"], c), _normal(seed + 1, c, 8)


def _queries(seed, b=QUERIES):
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(0, SIZES["user_id_hash_size"], b),
        "user_features": _normal(seed + 1, b, 8),
        "user_history": rng.integers(0, SIZES["item_id_hash_size"], (b, SIZES["history_len"])),
    }


def _recall(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist())) / want.size


# ---- refresh, recall and engine cases --------------------------------------
CFG_J, CFG_T = _cfgs()
PARAMS_J, MODEL_T = _params(CFG_J, CFG_T)
STATE = MODEL_T.state_dict()
IDS, FEATS = _catalog(3)
Q = _queries(9)
HLEN = np.random.default_rng(5).integers(1, SIZES["history_len"] + 1, QUERIES)

ENGINES = {  # name -> (config kwargs, mesh, engine kwargs, with history_len)
    "plain_2x2": ({}, (2, 2), {}, False),
    "plain_1x4": ({}, (1, 4), {}, False),
    "light_ranker_2x2": ({"light_ranker": True}, (2, 2), {}, False),
    "light_ranker_1x4": ({"light_ranker": True}, (1, 4), {}, False),
    "history_len_2x2": ({}, (2, 2), {}, True),
    "int8_1x4": ({}, (1, 4), {"quantize": "int8"}, False),
    "int8_rescore_2x2": ({}, (2, 2), {"quantize": "int8_rescore"}, False),
    "approx_2x2": ({"approx_mips": True, "num_items": 8}, (2, 2), {}, False),
}
TP_ENGINES = {"tower_tp_1x4": (1, 4), "tower_tp_2x2": (2, 2)}
OTHER_STATE_SEED = 7


def _engine_models(name):
    kw = ENGINES[name][0]
    cfg_j, cfg_t = _cfgs(**kw)
    params_j, model_t = _params(cfg_j, cfg_t)
    return cfg_j, cfg_t, params_j, model_t


def _cases():
    cases = []
    for mesh in MESHES:
        tag = f"{mesh[0]}x{mesh[1]}"
        for tp in (False, True):
            cases.append({"name": f"refresh_{tag}_tp{int(tp)}", "kind": "refresh", "mesh": mesh,
                          "cfg": CFG_T, "state": STATE, "ids": IDS, "feats": FEATS,
                          "tower_tp": tp, "batch_size": 16})
        cases.append({"name": f"recall_{tag}", "kind": "recall", "mesh": mesh, "cfg": CFG_T,
                      "state": STATE, "ids": RECALL_IDS, "feats": RECALL_FEATS,
                      "batch": RECALL_BATCH, "top_k": 10})
    for name, (_, mesh, kw, hlen) in ENGINES.items():
        _, cfg_t, _, model_t = _engine_models(name)
        cases.append({"name": name, "kind": "engine", "mesh": mesh, "cfg": cfg_t,
                      "state": model_t.state_dict(), "ids": IDS, "feats": FEATS, **Q, **kw,
                      "history_len": HLEN if hlen else None})
    for name, mesh in TP_ENGINES.items():
        cases.append({"name": name, "kind": "engine", "mesh": mesh, "cfg": CFG_T, "state": STATE,
                      "ids": IDS, "feats": FEATS, **Q, "tower_tp": True})
    other = _params(CFG_J, CFG_T, OTHER_STATE_SEED)[1].state_dict()
    cases.append({"name": "refresh_engine_2x2", "kind": "engine", "mesh": (2, 2), "cfg": CFG_T,
                  "state": STATE, "ids": IDS, "feats": FEATS, **Q, "refresh_state": other})
    return cases


def _recall_inputs():
    rng = np.random.default_rng(21)
    ids, feats = _catalog(22, 120)
    b = 32
    batch = _queries(23, b)
    item = rng.integers(0, SIZES["item_id_hash_size"], b)
    item[:8] = ids[:8]  # engaged items that are in the catalog
    batch.update(item_id=item, item_features=_normal(24, b, 8),
                 position=rng.integers(0, 10, b),
                 labels=(rng.random((b, CFG_T.num_tasks)) < 0.5).astype(np.float32))
    return ids, feats, batch


RECALL_IDS, RECALL_FEATS, RECALL_BATCH = _recall_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_cases(), tmp_path_factory.mktemp("sharded_serving"))


def _same_on_every_rank(ranks, name, key):
    first = ranks[0][name][key]
    for r in ranks[1:]:
        assert torch.equal(r[name][key], first), (name, key)
    return first.numpy()


# ---- tests -------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("tp", [False, True], ids=["psum", "tower_tp"])
def test_sharded_refresh_matches_jax(ranks, mesh, tp):
    """The rows of every rank, in shard order, within 1e-5 of scale of
    JAX's sharded refresh; each rank holds C/n rows and V/n_model rows of
    the user table."""
    name = f"refresh_{mesh[0]}x{mesh[1]}_tp{int(tp)}"
    res = sorted((r[name] for r in ranks), key=lambda x: x["shard"])
    assert [x["shard"] for x in res] == [0, 1, 2, 3]
    assert all(x["rows"].shape == (23, 16) for x in res)
    assert all(x["user_rows"] == 64 // mesh[1] for x in res)
    got = torch.cat([x["rows"] for x in res]).numpy()
    jm = jmesh.make_mesh(jcfg.MeshConfig(*mesh))
    ids, feats, valid = jpr.pad_catalog(jnp.asarray(IDS), jnp.asarray(FEATS), jm)
    want = np.asarray(jpr.make_sharded_refresh_fn(CFG_J, jm, tower_tp=tp)(PARAMS_J, ids, feats))
    assert res[0]["valid"] == valid == CATALOG
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_recall_matches_jax_and_single_device(ranks, mesh):
    name = f"recall_{mesh[0]}x{mesh[1]}"
    got = float(_same_on_every_rank(ranks, name, "recall"))
    jm = jmesh.make_mesh(jcfg.MeshConfig(*mesh))
    ids, feats, valid = jpr.pad_catalog(jnp.asarray(RECALL_IDS), jnp.asarray(RECALL_FEATS), jm)
    corpus = jpr.make_sharded_refresh_fn(CFG_J, jm)(PARAMS_J, ids, feats)
    jbatch = jtt.Batch(**{k: jnp.asarray(v) for k, v in RECALL_BATCH.items()})
    want = float(jpr.make_sharded_recall_fn(CFG_J, jm, 10)(PARAMS_J, corpus, jbatch, valid))
    single_corpus = jmips.refresh_corpus(PARAMS_J, CFG_J, jnp.asarray(RECALL_IDS),
                                         jnp.asarray(RECALL_FEATS))
    assert want == pytest.approx(float(j_recall_fn(CFG_J, 10)(PARAMS_J, single_corpus, jbatch)))
    tbatch = TBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in RECALL_BATCH.items()})
    t_corpus = ttt.compute_item_embeddings(MODEL_T, CFG_T, torch.from_numpy(RECALL_IDS),
                                           torch.from_numpy(RECALL_FEATS))
    port_single = float(make_eval_recall_fn(CFG_T, 10)(MODEL_T, t_corpus, tbatch))
    assert got == pytest.approx(want, abs=1e-6) and got == pytest.approx(port_single, abs=1e-6)
    assert 0 < got < 1


_JAX_ENGINES = {}  # (config, mesh, weights' seed, engine kwargs) -> JAX's mesh engine


def _jax_engine(cfg_j, params_j, mesh, seed=0, **kw):
    """JAX's mesh engine for ``params_j`` (drawn from ``seed``), built once
    for each key: the tests that share one query it again."""
    key = (cfg_j, mesh, seed, tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        jm = jmesh.make_mesh(jcfg.MeshConfig(*mesh))
        _JAX_ENGINES[key] = JEngine.from_params(params_j, cfg_j, jnp.asarray(IDS),
                                                jnp.asarray(FEATS), mesh=jm, **kw)
    return _JAX_ENGINES[key]


def _jquery(engine, hlen=None):
    return np.asarray(engine.query(*(jnp.asarray(Q[k]) for k in Q),
                                   history_len=None if hlen is None else jnp.asarray(hlen)))


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_on_a_mesh_matches_jax(ranks, name):
    """RetrievalEngine.from_params(mesh=...) against JAX's mesh engine on
    the same weights and catalog: the same indices (as sets per row under
    approx_mips, as JAX's own test holds them), and the same on every rank."""
    kw_cfg, mesh, kw, hlen = ENGINES[name]
    cfg_j, _, params_j, _ = _engine_models(name)
    got = _same_on_every_rank(ranks, name, "indices")
    want = _jquery(_jax_engine(cfg_j, params_j, mesh, **kw), HLEN if hlen else None)
    assert got.shape == want.shape
    if cfg_j.approx_mips:
        for g, w in zip(got, want):
            assert set(g.tolist()) == set(w.tolist())
    else:
        np.testing.assert_array_equal(got, want)
    if hlen:  # the lengths change the answer
        assert (got != _jquery(_jax_engine(cfg_j, params_j, mesh, **kw))).any()


@pytest.mark.parametrize("name", list(TP_ENGINES))
def test_engine_tower_tp_matches_jax(ranks, name):
    """tower_tp: the all-reduce sums the MLP in another order than one
    matmul, on both sides, so each row's indices are held equal where the
    port's single-device scores of the top num_items + 1 are at least 1e-5
    apart, and the recall is at least 0.999."""
    got = _same_on_every_rank(ranks, name, "indices")
    want = _jquery(_jax_engine(CFG_J, PARAMS_J, TP_ENGINES[name], tower_tp=True))
    corpus = ttt.compute_item_embeddings(MODEL_T, CFG_T, torch.from_numpy(IDS),
                                         torch.from_numpy(FEATS))
    user, _ = ttt.compute_user_embedding(MODEL_T, CFG_T, *(torch.from_numpy(Q[k]) for k in Q))
    top = torch.sort(user @ corpus.T, dim=1, descending=True).values[:, : CFG_T.num_items + 1]
    clear = ((top[:, :-1] - top[:, 1:]).min(dim=1).values > 1e-5).numpy()
    assert clear.sum() >= QUERIES // 2
    np.testing.assert_array_equal(got[clear], want[clear])
    assert _recall(got, want) >= 0.999


def test_engine_refresh_on_a_mesh(ranks):
    """refresh with other weights on the same catalog equals JAX's mesh
    engine built from those weights."""
    got = _same_on_every_rank(ranks, "refresh_engine_2x2", "refreshed")
    params_j, _ = _params(CFG_J, CFG_T, OTHER_STATE_SEED)
    np.testing.assert_array_equal(
        got, _jquery(_jax_engine(CFG_J, params_j, (2, 2), seed=OTHER_STATE_SEED)))
    before = _same_on_every_rank(ranks, "refresh_engine_2x2", "indices")
    assert (got != before).any()


def test_world_of_one_is_the_single_device_engine(tmp_path):
    """A gloo world of one, mesh (1, 1), in this process: from_params on
    the mesh equals the port's single-device engine bit for bit, and
    sharded_mips_topk on the whole corpus equals mips_topk_exact, scores
    included; a catalog that does not change size refreshes, one that does
    raises."""
    tmesh.init_process_group(0, 1, f"file://{tmp_path / 'store'}", device="cpu")
    try:
        mesh = tmesh.single_device_mesh("cpu")
        args = [torch.from_numpy(Q[k]) for k in Q]
        for kw in ({}, {"quantize": "int8_rescore"}):
            ref = RetrievalEngine.from_params(MODEL_T, CFG_T, IDS, FEATS, device="cpu", **kw)
            eng = RetrievalEngine.from_params(MODEL_T, CFG_T, IDS, FEATS, mesh=mesh,
                                              device="cpu", **kw)
            assert torch.equal(eng.query(*args), ref.query(*args))
            assert torch.equal(eng.query(*args, history_len=torch.from_numpy(HLEN)),
                               ref.query(*args, history_len=torch.from_numpy(HLEN)))
        corpus = torch.from_numpy(_normal(30, 3000, 16))
        query = torch.from_numpy(_normal(31, 8, 16))
        got = sharded_mips_topk(corpus, query, 5, valid_count=2990)
        want = mips_topk_exact(corpus[:2990], query, 5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        eng = RetrievalEngine(MODEL_T, CFG_T, ref.corpus.raw, mesh=mesh, device="cpu")
        assert torch.equal(eng.query(*args), RetrievalEngine(
            MODEL_T, CFG_T, ref.corpus.raw, device="cpu").query(*args))
        eng.refresh(MODEL_T, IDS, FEATS)
        with pytest.raises(ValueError, match="changed size"):
            eng.refresh(MODEL_T, IDS[:-1], FEATS[:-1])
        with pytest.raises(ValueError, match="mesh"):  # a cpu mesh does not serve on cuda
            tmesh.make_mesh(tcfg.MeshConfig(1, 1), "cuda")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_mesh(tcfg.MeshConfig(2, 2), "cpu")
        assert pad_catalog(IDS, FEATS, mesh)[2] == CATALOG
    finally:
        torch.distributed.destroy_process_group()


def test_chip_smoke_four_card_legs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 14b-14e on four gloo ranks at a tiny width
    (``SMOKE_SIZES``): every leg runs on every rank and passes its checks
    (the launch counts are checked on the card alone)."""
    res = run_smoke_ranks(tmp_path)
    c = SMOKE_SIZES["CORPUS"]
    legs = {f"sharded exact 1x4 C={c}", f"sharded exact 2x2 C={c}", f"sharded exact 1x4 C={c - 3}",
            "sharded approx_mips 1x4", "sharded int8 1x4", "sharded int8_rescore 1x4",
            "sharded tower_tp 1x4", "sharded tower_tp 2x2", "sharded all_to_all 1x4",
            "sharded history_len 2x2", "sharded light ranker 2x2"}
    for r in res:
        assert r["failures"] == []
        assert legs <= set(r["launches"])
