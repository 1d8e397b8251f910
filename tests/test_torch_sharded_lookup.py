"""PyTorch port: the sharded lookups, towers, parameter layout and shard
scan of sharded serving (A13a) against the JAX package on the CPU.

Four gloo ranks (``tests/torch_sharded_worker.py``, one spawn for the whole
file) run ``parallel.embedding``'s lookups, ``parallel.train_step``'s towers
and ``retrieval.mips.sharded_mips_topk`` on meshes (2, 2) and (1, 4); the JAX
package runs the same functions under ``shard_map`` on the first four of
``conftest.py``'s eight virtual CPU devices, on the same numpy inputs and
``bridge.params_from_jax`` weights.

The lookups are bit-equal on plain and 128-lane-packed shards (a -0.0
entry comes back +0.0 from the psum on both sides).  The towers are held
within 1e-5 of scale (f32 dot orders; under ``tower_tp`` the all-reduce
sums in another order than one matmul), and the two lookup strategies give
bit-equal towers.  The shard scan's indices are exact, tie order included
(integer-grid inputs, whose scores are exact, so ties are real); scores are
bit-equal on the grid, within 1e-6 relative elsewhere.  The approximate
shard scan equals JAX's where its bins are the rows and is held by recall
elsewhere (JAX's approx_max_k sorts exactly on the CPU: the recorded CPU
deviation of A11).  Every rank must return the same answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.torch_sharded_worker import run_ranks
from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.models import two_tower as jtt
from two_tower_models_tpu.parallel import embedding as jemb
from two_tower_models_tpu.parallel import mesh as jmesh
from two_tower_models_tpu.parallel import retrieval as jpr
from two_tower_models_tpu.parallel import sharding as jsh
from two_tower_models_tpu.parallel import train_step as jts
from two_tower_models_tpu.retrieval import mips as jmips
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.models import two_tower as ttt
from two_tower_models_tpu_torch.nn.packed_table import pack_table
from two_tower_models_tpu_torch.parallel import sharding as tsh

MESHES = ((2, 2), (1, 4))
SIZES = dict(
    user_id_hash_size=64, user_id_embedding_dim=16, item_id_hash_size=64,
    item_id_embedding_dim=16, user_features_size=8, item_features_size=8,
    feature_hidden_dim=32, user_value_weights=(1.0, 0.5), history_len=8,
)
B = 12


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _grid(seed, *shape, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def _pad(corpus, n=4):
    return np.pad(corpus, ((0, (-corpus.shape[0]) % n), (0, 0)))


def _recall(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist())) / want.size


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _jmesh(shape):
    return jmesh.make_mesh(jcfg.MeshConfig(*shape))


# ---- lookups ------------------------------------------------------------------
TABLE = _normal(40, 64, 16)
TABLE[3, 5] = -0.0  # comes back +0.0 from a psum over more than one rank
TABLE[17, 0] = -0.0
LOOKUP_IDS = np.random.default_rng(41).integers(0, 64, 40)
LOOKUP_IDS[:4] = (3, 3, 17, 63)  # repeats and the edges
LAYOUTS = {"plain": TABLE, "packed": pack_table(torch.from_numpy(TABLE)).numpy()}
LOOKUPS = {f"{s}_{lay}_{_tag(m)}": (s, lay, m) for s in ("psum", "all_to_all")
           for lay in LAYOUTS for m in MESHES}


def _lookup_cases():
    return [{"name": name, "kind": "lookup", "mesh": m, "table": LAYOUTS[lay],
             "ids": LOOKUP_IDS, "strategy": s, "dim": 16} for name, (s, lay, m) in LOOKUPS.items()]


# ---- towers -------------------------------------------------------------------
def _cfgs(light_ranker=False, **kw):
    out = []
    for m in (jcfg, tcfg):
        extra = dict(kw, history_encoder=m.HistoryEncoderConfig(num_heads=2, num_layers=1))
        if light_ranker:
            extra.update(light_ranker=m.LightRankerConfig(num_mips_items=16), num_items=4)
        out.append(m.ModelConfig(**SIZES, **extra))
    return tuple(out)


def _tower_inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(0, 64, B), "user_features": _normal(seed + 1, B, 8),
        "user_history": rng.integers(0, 64, (B, SIZES["history_len"])),
        "item_id": rng.integers(0, 64, B), "item_features": _normal(seed + 2, B, 8),
    }


TOWERS = {  # name -> (light ranker, mesh, tp, with history_len)
    "2x2": (False, (2, 2), False, False),
    "1x4_hlen": (False, (1, 4), False, True),
    "1x4_tp": (False, (1, 4), True, False),
    "2x2_tp_hlen": (False, (2, 2), True, True),
    "2x2_light_ranker": (True, (2, 2), False, False),
}
TOWER_IN = _tower_inputs(50)
TOWER_HLEN = np.random.default_rng(53).integers(1, SIZES["history_len"] + 1, B)


def _tower_models(name):
    cfg_j, cfg_t = _cfgs(light_ranker=TOWERS[name][0])
    params = jtt.init_params(jax.random.key(1), cfg_j)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    return cfg_j, cfg_t, params, model


def _tower_cases():
    cases = []
    for name, (_, mesh, tp, hlen) in TOWERS.items():
        _, cfg_t, _, model = _tower_models(name)
        for strategy in ("psum", "all_to_all"):
            cases.append({"name": f"{name}_{strategy}", "kind": "towers", "mesh": mesh,
                          "cfg": cfg_t, "state": model.state_dict(), **TOWER_IN, "tp": tp,
                          "strategy": strategy, "history_len": TOWER_HLEN if hlen else None})
    return cases


# ---- sharded_mips_topk cases -----------------------------------------------
# name -> (corpus [C, D] before padding, query, k, recall_target, quantize, mesh)
def _mips_inputs():
    cases = {}
    for mesh in MESHES:
        tag = f"{mesh[0]}x{mesh[1]}"
        # the JAX test's padded tuple-axes case: 98 rows pad to 100 (dense branch)
        cases[f"dense_grid_{tag}"] = (_grid(0, 98, 16), _grid(1, 12, 16), 7, None, None, mesh)
        cases[f"dense_normal_{tag}"] = (_normal(2, 98, 16), _normal(3, 12, 16), 7, None, None, mesh)
        # k * 128 < C/n = 640: the tile-max branch; 2557 rows cut the last shard's valid count
        cases[f"tiled_grid_{tag}"] = (_grid(4, 2557, 16), _grid(5, 8, 16), 4, None, None, mesh)
        # C/n = 25 rows <= 128: the approximate scan's bins are the rows
        cases[f"approx_rows_{tag}"] = (_grid(6, 98, 16), _grid(7, 12, 16), 7, 0.95, None, mesh)
        for mode in ("int8", "int8_rescore"):
            cases[f"{mode}_grid_{tag}"] = (_grid(8, 98, 16), _grid(9, 12, 16), 7, None, mode, mesh)
    cases["int8_approx_rows_1x4"] = (_grid(10, 98, 16), _grid(11, 12, 16), 7, 0.95, "int8", (1, 4))
    # C/n = 2048 rows, k = 10 at 0.95: 256 bins a shard, held by recall
    cases["approx_bins_1x4"] = (_normal(12, 8192, 16), _normal(13, 16, 16), 10, 0.95, None, (1, 4))
    return cases


MIPS = _mips_inputs()


def _mips_case(name):
    corpus, query, k, rt, quantize, mesh = MIPS[name]
    return {"name": name, "kind": "mips", "mesh": mesh, "corpus": _pad(corpus), "query": query,
            "k": k, "valid_count": corpus.shape[0], "recall_target": rt, "quantize": quantize}


def _jax_mips(name):
    corpus, query, k, rt, quantize, mesh_shape = MIPS[name]
    mesh = jmesh.make_mesh(jcfg.MeshConfig(*mesh_shape))
    c = jnp.asarray(_pad(corpus))
    if quantize:
        c = jpr.quantize_corpus_sharded(c, mesh, quantize == "int8_rescore")
    f = lambda cs, q: jmips.sharded_mips_topk(cs, q, k, jpr.ALL_AXES,
                                              valid_count=corpus.shape[0], recall_target=rt)
    out = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(jpr._corpus_specs(c), P()),
                                out_specs=P(), check_vma=False))(c, jnp.asarray(query))
    return [np.asarray(x, np.float32) if i else np.asarray(x) for i, x in enumerate(out)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _lookup_cases() + _tower_cases() + [_mips_case(name) for name in MIPS]
    return run_ranks(cases, tmp_path_factory.mktemp("sharded_lookup"))


def _same_on_every_rank(ranks, name, key):
    first = ranks[0][name][key]
    for r in ranks[1:]:
        assert torch.equal(r[name][key], first), (name, key)
    return first.numpy()


# ---- tests -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_sharded_lookup_matches_jax_bit_for_bit(ranks, name):
    strategy, layout, mesh = LOOKUPS[name]
    got = _same_on_every_rank(ranks, name, "rows")
    fn = {"psum": jemb.psum_lookup, "all_to_all": jemb.all_to_all_lookup}[strategy]
    want = np.asarray(jax.jit(jax.shard_map(
        lambda t, i: fn(t, i, "model", 16), mesh=_jmesh(mesh),
        in_specs=(P("model", None), P()), out_specs=P(), check_vma=False,
    ))(jnp.asarray(LAYOUTS[layout]), jnp.asarray(LOOKUP_IDS)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, TABLE[LOOKUP_IDS])  # -0.0 == +0.0 here
    negzero = np.signbit(got[:2, 5]) if strategy == "psum" else None
    if negzero is not None:  # the psum's zeros turn -0.0 into +0.0
        assert not negzero.any()


@pytest.mark.parametrize("name", list(TOWERS))
def test_sharded_towers_match_jax(ranks, name):
    """_user_tower (and the ranker embeddings) and _item_tower against
    JAX's under shard_map within 1e-5 of scale; psum and all_to_all
    lookups give bit-equal towers."""
    light, mesh, tp, hlen = TOWERS[name]
    cfg_j, _, params, _ = _tower_models(name)
    got = {k: _same_on_every_rank(ranks, f"{name}_psum", k)
           for k in ("user", "item") + (("ranker",) if light else ())}
    for k in got:
        np.testing.assert_array_equal(got[k], _same_on_every_rank(ranks, f"{name}_all_to_all", k))
    jm = _jmesh(mesh)
    specs = jsh.param_pspecs(params, tp)
    inp = {k: jnp.asarray(v) for k, v in TOWER_IN.items()}
    lens = jnp.asarray(TOWER_HLEN) if hlen else None

    def towers(p, uid, uf, uh, iid, itf, hl):
        user, ranker = jts._user_tower(p, cfg_j, uid, uf, uh, "psum", tp, hl)
        return user, ranker, jts._item_tower(p, cfg_j, iid, itf, "psum", tp)

    user, ranker, item = jax.jit(jax.shard_map(
        towers, mesh=jm, in_specs=(specs, P(), P(), P(), P(), P(), P()), out_specs=P(),
        check_vma=False,
    ))(params, inp["user_id"], inp["user_features"], inp["user_history"], inp["item_id"],
       inp["item_features"], lens)
    want = {"user": user, "item": item, "ranker": ranker}
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("tp", [False, True], ids=["psum", "tower_tp"])
@pytest.mark.parametrize("name", tcfg.PRESET_NAMES)
def test_param_pspecs_match_jax(name, tp):
    """The port's layout rule names the same split for every leaf of every
    preset as JAX's param_pspecs (shapes from eval_shape: nothing is drawn)."""
    cfg_j = jcfg.preset(name)
    shapes = jax.eval_shape(lambda: jtt.init_params(jax.random.key(0), cfg_j))
    leaves = jax.tree_util.tree_flatten_with_path(
        jsh.param_pspecs(shapes, tp), is_leaf=lambda x: isinstance(x, P))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in leaves}
    model = ttt.TwoTowerModel(tcfg.preset(name), device="meta")
    assert tsh.param_pspecs(model, tp) == want


@pytest.mark.parametrize("name", [n for n in MIPS if n != "approx_bins_1x4"])
def test_sharded_mips_topk_matches_jax(ranks, name):
    """Indices exactly, the tie order of the grid cases included; scores
    bit-equal on the grid, 1e-6 relative on normal inputs; rows equal."""
    idx = _same_on_every_rank(ranks, name, "idx")
    scores = _same_on_every_rank(ranks, name, "scores")
    emb = _same_on_every_rank(ranks, name, "emb")
    j_idx, j_scores, j_emb = _jax_mips(name)
    np.testing.assert_array_equal(idx, j_idx)
    if "normal" in name:
        np.testing.assert_allclose(scores, j_scores, rtol=1e-6)
        np.testing.assert_allclose(emb.astype(np.float32), j_emb, rtol=1e-6)
    else:
        np.testing.assert_array_equal(scores, j_scores)
        np.testing.assert_array_equal(emb.astype(np.float32), j_emb)
    corpus, query, k = MIPS[name][:3]
    assert idx.max() < corpus.shape[0]  # padded rows never win
    if "int8" not in name:  # the exact scan over the unpadded corpus
        want = jmips.mips_topk(jnp.asarray(corpus), jnp.asarray(query), k)[0]
        if "approx" in name or "grid" in name:
            np.testing.assert_array_equal(idx, np.asarray(want))


def test_sharded_approx_scan_recall(ranks):
    """256 bins a shard of 2048 rows: recall@10 against JAX's sharded scan
    (exact on the CPU) at least 0.9, the gate of the single-device test."""
    name = "approx_bins_1x4"
    idx = _same_on_every_rank(ranks, name, "idx")
    j_idx = _jax_mips(name)[0]
    assert _recall(idx, j_idx) >= 0.9


