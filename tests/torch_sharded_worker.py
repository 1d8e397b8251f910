"""The ranks of the port's sharded serving and training CPU tests.

``run_ranks(cases, tmp_path)`` starts ``world`` processes (spawn), joins
them in a gloo world over a ``file://`` store under ``tmp_path``, runs every
case on every rank and returns each rank's results, [rank][case name].  A
case is a dict: ``name``, ``kind`` (a key of ``_KINDS``), ``mesh`` (data,
model) and the kind's inputs as numpy arrays, port configs and state dicts.

``run_smoke_ranks(tmp_path)`` runs ``chip_smoke.py``'s four-card legs
(phase 14b-14e) the same way on the CPU, at ``SMOKE_SIZES``; the case kind
``smoke15`` runs phase 15b-15e's at ``SMOKE15_SIZES``.

A spawned child imports this module to find its target, so it imports
torch, numpy and the port only, never JAX.
"""

from __future__ import annotations

import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT = 120.0


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _model(case):
    from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel

    model = TwoTowerModel(case["cfg"])
    model.load_state_dict(case["state"])
    return model.eval()


def _mips(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.retrieval import quantize_corpus_sharded, shard_corpus
    from two_tower_models_tpu_torch.retrieval.mips import sharded_mips_topk

    shard = shard_corpus(_t(case["corpus"]), mesh, dev)
    if case.get("quantize"):
        shard = quantize_corpus_sharded(shard, mesh, case["quantize"] == "int8_rescore")
    idx, scores, emb = sharded_mips_topk(shard, _t(case["query"]), case["k"],
                                         valid_count=case.get("valid_count"),
                                         recall_target=case.get("recall_target"))
    return {"idx": idx, "scores": scores, "emb": emb}


def _refresh(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.retrieval import make_sharded_refresh_fn, pad_catalog
    from two_tower_models_tpu_torch.parallel.sharding import shard_params

    cfg, tp = case["cfg"], case.get("tower_tp", False)
    local = shard_params(_model(case), cfg, mesh, tp, dev)
    ids, feats, valid = pad_catalog(_t(case["ids"]), _t(case["feats"]), mesh)
    rows = make_sharded_refresh_fn(cfg, mesh, tower_tp=tp, batch_size=case.get("batch_size", 4096))(
        local, ids, feats)
    d, m = mesh.get_coordinate()
    return {"rows": rows, "valid": valid, "shard": d * mesh.size(1) + m,
            "user_rows": local.user_id_table.shape[0]}


def _recall(case, mesh, dev):
    from two_tower_models_tpu_torch.models.two_tower import Batch
    from two_tower_models_tpu_torch.parallel.retrieval import (
        make_sharded_recall_fn,
        make_sharded_refresh_fn,
        pad_catalog,
    )
    from two_tower_models_tpu_torch.parallel.sharding import shard_params

    cfg = case["cfg"]
    local = shard_params(_model(case), cfg, mesh, False, dev)
    ids, feats, valid = pad_catalog(_t(case["ids"]), _t(case["feats"]), mesh)
    rows = make_sharded_refresh_fn(cfg, mesh)(local, ids, feats)
    batch = Batch(**{k: _t(v) for k, v in case["batch"].items()})
    recall = make_sharded_recall_fn(cfg, mesh, case["top_k"])(local, rows, batch, valid)
    return {"recall": recall}


def _engine(case, mesh, dev):
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    kw = dict(tower_tp=case.get("tower_tp", False), quantize=case.get("quantize"), device=dev)
    eng = RetrievalEngine.from_params(_model(case), case["cfg"], _t(case["ids"]),
                                      _t(case["feats"]), mesh=mesh, **kw)
    q = [_t(case[k]) for k in ("user_id", "user_features", "user_history")]
    out = {"indices": eng.query(*q, history_len=_t(case.get("history_len")))}
    if case.get("refresh_state") is not None:  # refresh with other weights, same catalog
        other = _model({"cfg": case["cfg"], "state": case["refresh_state"]})
        eng.refresh(other, _t(case["ids"]), _t(case["feats"]))
        out["refreshed"] = eng.query(*q, history_len=_t(case.get("history_len")))
    return out


def _lookup(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.embedding import sharded_embedding_lookup

    table = _t(case["table"])  # the full (possibly packed) table
    n = mesh.size(1)
    m = mesh.get_local_rank("model")
    rows = table.shape[0] // n
    shard = table[m * rows : (m + 1) * rows].clone()
    out = sharded_embedding_lookup(shard, _t(case["ids"]), mesh.get_group("model"),
                                   case["strategy"], case.get("dim"))
    return {"rows": out}


def _towers(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.sharding import shard_params
    from two_tower_models_tpu_torch.parallel.train_step import _item_tower, _user_tower

    cfg, tp, strategy = case["cfg"], case.get("tp", False), case.get("strategy", "psum")
    local = shard_params(_model(case), cfg, mesh, tp, dev)
    with torch.inference_mode():
        user, ranker = _user_tower(local, cfg, mesh, _t(case["user_id"]),
                                   _t(case["user_features"]), _t(case["user_history"]),
                                   strategy, tp, _t(case.get("history_len")))
        item = _item_tower(local, cfg, mesh, _t(case["item_id"]), _t(case["item_features"]),
                           strategy, tp)
    return {"user": user, "ranker": ranker, "item": item}


def _shard_block(case, mesh, key="table"):
    """This rank's block of the full table ``case[key]`` over ``model``."""
    table = _t(case[key])
    n, m = mesh.size(1), mesh.get_local_rank("model")
    rows = table.shape[0] // n
    return table[m * rows : (m + 1) * rows].clone()


def _lookup_grad(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.embedding import sharded_embedding_lookup

    shard = _shard_block(case, mesh).requires_grad_()
    out = sharded_embedding_lookup(shard, _t(case["ids"]), mesh.get_group("model"),
                                   case["strategy"], case.get("dim"))
    out.backward(_t(case["g"]))
    return {"grad": shard.grad}


def _exchange(case, mesh, dev):
    """The sparse exchange of this rank's dense lookup gradient (its data
    rank's ids and cotangent) beside the dense all-reduce of it."""
    from torch import distributed as dist

    from two_tower_models_tpu_torch.parallel.embedding import sharded_embedding_lookup
    from two_tower_models_tpu_torch.parallel.sparse_grads import sparse_grad_exchange

    d = mesh.get_local_rank("data")
    ids = _t(case["ids"][d])
    shard = _shard_block(case, mesh).requires_grad_()
    sharded_embedding_lookup(shard, ids, mesh.get_group("model"), "psum", case["dim"]).backward(
        _t(case["g"][d]))
    dense = shard.grad.clone()
    dist.all_reduce(dense, group=mesh.get_group("data"))
    sparse = sparse_grad_exchange(shard.grad, ids, mesh.get_group("data"),
                                  mesh.get_group("model"), case["dim"])
    return {"sparse": sparse, "dense": dense}


def _train_state(case):
    """The full TrainState of ``case``: its model, Adam's moments
    (``case["mu"]``/``["nu"]`` by name, else zeros), step 0."""
    from two_tower_models_tpu_torch.training.state import Adam, AdamState, TrainState

    model = _model(case)
    opt = Adam(1.0).init(model)
    if case.get("mu") is not None:
        opt = AdamState(opt.count, {k: _t(v) for k, v in case["mu"].items()},
                        {k: _t(v) for k, v in case["nu"].items()})
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=model, opt_state=opt)


def _mesh_cfg(case):
    from two_tower_models_tpu_torch.config import MeshConfig

    return MeshConfig(*case["mesh"], **case.get("mesh_kw", {}))


def _state(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.sharding import shard_state

    st = shard_state(_train_state(case), case["cfg"], mesh, case.get("tp", False), dev)
    return {"params": {k: p.detach() for k, p in st.params.named_parameters()},
            "mu": st.opt_state.mu, "nu": st.opt_state.nu}


def _batch(b):
    from two_tower_models_tpu_torch.models.two_tower import Batch

    return Batch(**{k: _t(v) for k, v in b.items()})


def _grads(case, mesh, dev):
    from two_tower_models_tpu_torch.parallel.sharding import shard_state
    from two_tower_models_tpu_torch.parallel.train_step import sharded_grads

    mcfg = _mesh_cfg(case)
    st = shard_state(_train_state(case), case["cfg"], mesh, mcfg.tower_tp, dev)
    names, grads, metrics = sharded_grads(st.params, case["cfg"], mcfg, mesh,
                                          _batch(case["batch"]), case.get("strategy", "psum"))
    return {"grads": dict(zip(names, grads)), "metrics": metrics}


def _steps(case, mesh, dev):
    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.parallel.sharding import shard_state
    from two_tower_models_tpu_torch.parallel.train_step import make_sharded_train_step

    mcfg = _mesh_cfg(case)
    st = shard_state(_train_state(case), case["cfg"], mesh, mcfg.tower_tp, dev)
    step = make_sharded_train_step(case["cfg"], TrainConfig(**case.get("train", {})), mesh, mcfg,
                                   case.get("strategy", "psum"))
    metrics = []
    for b in case["batches"]:
        st, m = step(st, _batch(b))
        metrics.append(m)
    return {"metrics": metrics, "step": st.step,
            "params": {k: p.detach() for k, p in st.params.named_parameters()}}


def _smoke15(case, mesh, dev):
    """chip_smoke.py's phase 15b-15e legs at ``SMOKE15_SIZES`` on this
    rank's world."""
    import chip_smoke

    for name, value in SMOKE15_SIZES.items():
        setattr(chip_smoke, name, value)
    ctx = chip_smoke.ShardRank(torch, torch.distributed.get_rank(),
                               torch.distributed.get_world_size(), dev, 0, 2)
    chip_smoke.train_rank_legs(ctx)
    return {"failures": ctx.failures, "launches": ctx.launches}


_KINDS = {"mips": _mips, "refresh": _refresh, "recall": _recall, "engine": _engine,
          "lookup": _lookup, "towers": _towers, "lookup_grad": _lookup_grad,
          "exchange": _exchange, "state": _state, "grads": _grads, "steps": _steps,
          "smoke15": _smoke15}


def _rank_main(rank: int, world: int, store: str, cases, out: str) -> None:
    torch.set_num_threads(1)
    from torch import distributed as dist

    from two_tower_models_tpu_torch.config import MeshConfig
    from two_tower_models_tpu_torch.parallel.mesh import init_process_group, make_mesh

    results = {}
    try:
        dev = init_process_group(rank, world, f"file://{store}", device="cpu")
        meshes = {}
        for case in cases:
            shape = tuple(case["mesh"])
            if shape not in meshes:  # every rank builds the meshes in the same order
                meshes[shape] = make_mesh(MeshConfig(*shape), "cpu")
            results[case["name"]] = _KINDS[case["kind"]](case, meshes[shape], dev)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # the rank's traceback goes to the test, which fails on it
        torch.save({"error": traceback.format_exc()}, out)
        raise SystemExit(1)
    torch.save(results, out)


def run_ranks(cases, tmp_path, world: int = 4):
    """[rank][case name] -> that case's outputs on that rank."""
    tmp = Path(tmp_path)
    return _spawn(_rank_main, (world, str(tmp / "store"), cases), tmp, world)


def _spawn(target, args, tmp: Path, world: int):
    """``target(rank, *args, out)`` in ``world`` spawned processes; each
    rank's saved result, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, *args, outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    # until all are done, one has failed (the others then wait in a
    # collective), or the time is up
    while time.monotonic() < deadline:
        if all(not p.is_alive() for p in procs):
            break
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.1)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = [torch.load(path, weights_only=False) if Path(path).exists() else None
               for path in outs]
    for r, res in enumerate(results):
        if res is not None and "error" in res:
            raise RuntimeError(f"rank {r} failed:\n{res['error']}")
    if alive:
        raise RuntimeError(f"{len(alive)} of {world} ranks did not finish in {JOIN_TIMEOUT} s")
    for r, (p, res) in enumerate(zip(procs, results)):
        if p.exitcode != 0 or res is None:
            raise RuntimeError(f"rank {r} exited with {p.exitcode}")
    return results


# chip_smoke.py phase 14b-14e at a tiny width, on the CPU (the legs' logic
# and checks; the card's kernels and their launches only run on four cards)
SMOKE_SIZES = {"CORPUS": 4096, "BATCH": 64, "TRAIN_ROWS": 512, "TOPK": 4}
# and phase 15b-15e's (the flagship's widths; 256 table rows, 32 a rank's
# batch, 4096 rows for the packed leg, 2 timed steps)
SMOKE15_SIZES = {"TRAIN_ROWS": 256, "SHARD_TRAIN_B": 32, "SHARD_TABLE_ROWS": 4096,
                 "SHARD_STEPS": 2, "MNS_NEGATIVES": 8, "HIST": 8}


def _smoke_rank_main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    import chip_smoke

    for name, value in SMOKE_SIZES.items():
        setattr(chip_smoke, name, value)
    try:
        # phase 15b-15e's legs run in tests/test_torch_sharded_train.py's spawn
        res = chip_smoke.shard_rank_main(torch, rank, world, port, 0, 2, device="cpu", train=False)
    except Exception:
        torch.save({"error": traceback.format_exc()}, out)
        raise SystemExit(1)
    torch.save(res, out)


def run_smoke_ranks(tmp_path, world: int = 4):
    """Each rank's {"failures": [...], "launches": {...}} from chip_smoke's
    four-card legs run on the CPU at ``SMOKE_SIZES``."""
    import chip_smoke

    return _spawn(_smoke_rank_main, (world, chip_smoke.free_port()), Path(tmp_path), world)


def port_cfg(jc):
    """The port's ``ModelConfig`` of a JAX package's one, field for field
    (the two mirror each other: ``tests/test_torch_port_basics.py``)."""
    import dataclasses

    from two_tower_models_tpu_torch import config as tcfg

    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    for name, cls in (("history_encoder", tcfg.HistoryEncoderConfig),
                      ("light_ranker", tcfg.LightRankerConfig)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tcfg.ModelConfig(**kw)
