"""Mesh-sharded corpus refresh, recall@k eval and serving retrieval.

Port of ``two_tower_models_tpu/parallel/retrieval.py:49-245``, one process
a rank (``parallel.mesh``): every rank calls these functions with the same
arguments, and ``params`` is the rank's block of the model
(``parallel.sharding.shard_params``).

  * ``make_sharded_refresh_fn`` -- the catalog embeds data-parallel through
    the item tower (table lookups over the ``model`` exchange) and each rank
    keeps only its C/n rows of the corpus, row-sharded over every rank in
    the order of ``P(("data", "model"))``: the full [C, DI] matrix never sits
    on one device.
  * ``make_sharded_recall_fn`` -- eval queries data-sharded, the corpus
    scanned shard-locally (``retrieval.mips.sharded_mips_topk``), hit counts
    summed over ``data``.
  * ``make_sharded_retrieval_fn`` -- serving: queries the same on every
    rank, each rank scans its C/n rows, the candidates merge exactly; the
    light ranker's rerank reuses ``models.two_tower.retrieve_from_embeddings``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from two_tower_models_tpu_torch.config import ModelConfig
from two_tower_models_tpu_torch.models.two_tower import retrieve_from_embeddings
from two_tower_models_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_shape
from two_tower_models_tpu_torch.parallel.train_step import _item_tower, _user_tower
from two_tower_models_tpu_torch.retrieval.mips import all_gather_stacked, sharded_mips_topk
from two_tower_models_tpu_torch.retrieval.quant import QuantizedCorpus, quantize_corpus

ALL_AXES = (DATA_AXIS, MODEL_AXIS)


def _mesh_size(mesh) -> int:
    n_data, n_model = mesh_shape(mesh)
    return n_data * n_model


def _all_axes_index(mesh) -> int:
    """This rank's shard along ``ALL_AXES``: d * n_model + m, the row-major
    order of ``P(("data", "model"))``."""
    d, m = mesh.get_coordinate()
    return d * mesh_shape(mesh)[1] + m


def _corpus_specs(corpus):
    """The corpus's shard rule: every leaf ([C, D] rows, int8 codes, raw
    rescore rows, [C] scales) splits on dim 0 over all axes.  A spec tree of
    the corpus's shape, a tensor or a ``QuantizedCorpus``."""
    spec = lambda x: None if x is None else ((ALL_AXES, None) if x.ndim == 2 else (ALL_AXES,))
    if isinstance(corpus, QuantizedCorpus):
        return QuantizedCorpus(*(spec(t) for t in corpus))
    return spec(corpus)


def shard_corpus(corpus, mesh, device):
    """This rank's rows of a global corpus (a [C, D] tensor or a
    ``QuantizedCorpus``, C a multiple of the mesh size) on ``device``, by
    ``_corpus_specs``."""
    n, r = _mesh_size(mesh), _all_axes_index(mesh)

    def cut(x, spec):
        if x is None:
            return None
        x = torch.as_tensor(x)
        if spec[0] == ALL_AXES:
            if x.shape[0] % n:
                raise ValueError(f"a corpus of {x.shape[0]} rows does not split over {n} ranks; "
                                 "pad it (parallel.retrieval.pad_catalog) and pass valid_count")
            rows = x.shape[0] // n
            x = x[r * rows : (r + 1) * rows]
        return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)

    specs = _corpus_specs(corpus)
    if isinstance(corpus, QuantizedCorpus):
        return QuantizedCorpus(*(cut(t, s) for t, s in zip(corpus, specs)))
    return cut(corpus, specs)


def quantize_corpus_sharded(corpus_shard: torch.Tensor, mesh, keep_raw: bool) -> QuantizedCorpus:
    """Quantize a row-sharded corpus where it lies: per-row symmetric int8
    is row-local, so each rank quantizes its own rows and nothing moves
    between ranks."""
    del mesh  # every rank's rows are its own; JAX's signature
    return quantize_corpus(corpus_shard, keep_raw=keep_raw)


def pad_catalog(catalog_ids, catalog_features, mesh):
    """Pad the catalog with zero rows to a multiple of the mesh size.
    Returns (ids, features, valid_count); padded rows are masked to -inf
    inside ``sharded_mips_topk``."""
    ids = torch.as_tensor(catalog_ids)
    feats = torch.as_tensor(catalog_features)
    c = ids.shape[0]
    pad = (-c) % _mesh_size(mesh)
    if pad:
        ids = F.pad(ids, (0, pad))
        feats = F.pad(feats, (0, 0, 0, pad))
    return ids, feats, c


def make_sharded_refresh_fn(model_cfg: ModelConfig, mesh, lookup_strategy: str = "psum",
                            tower_tp: bool = False, batch_size: int = 4096):
    """(params, padded_ids, padded_features) -> this rank's [C/n, DI] f32
    rows of the corpus.  Rank (d, m) embeds data group d's C/n_data rows,
    ``batch_size`` at a time, with the other ranks of its ``model`` group
    (the lookups and the TP all-reduce need them all on the same rows), and
    keeps the m-th C/n of them: the rows of ``P(("data", "model"))``, with
    no exchange."""
    n_data, n_model = mesh_shape(mesh)
    d, m = mesh.get_coordinate()

    def refresh(params, ids, feats):
        c = ids.shape[0]
        if c % (n_data * n_model):
            raise ValueError(f"{c} catalog rows do not split over {n_data * n_model} ranks; "
                             "pad them (pad_catalog)")
        dev = params.item_id_table.device
        per_data, per_rank = c // n_data, c // (n_data * n_model)
        own_lo, own_hi = m * per_rank, (m + 1) * per_rank  # within the data group's rows
        ids = torch.as_tensor(ids)[d * per_data : (d + 1) * per_data].to(dev)
        feats = torch.as_tensor(feats)[d * per_data : (d + 1) * per_data].to(dev).float()
        parts = []
        with torch.inference_mode():
            for s in range(0, per_data, batch_size):
                rows = _item_tower(params, model_cfg, mesh, ids[s : s + batch_size],
                                   feats[s : s + batch_size], lookup_strategy, tower_tp)
                lo, hi = max(s, own_lo), min(s + batch_size, own_hi)
                if lo < hi:
                    parts.append(rows[lo - s : hi - s])
        return torch.cat(parts)

    return refresh


def make_sharded_recall_fn(model_cfg: ModelConfig, mesh, top_k: int = 100,
                           lookup_strategy: str = "psum", tower_tp: bool = False):
    """Sharded recall@k: (params, corpus_shard, batch, valid_count) -> 0-d
    f32 tensor, the same on every rank.  ``batch`` is the whole eval batch
    on every rank; data group d takes its B/n_data examples.  Semantics as
    ``training.step.make_eval_recall_fn``'s (a hit is the engaged item among
    the top k; only positive examples count).  The queries all-gather over
    ``data`` (the corpus shards span both axes, so the merge needs every
    rank on the same queries), then each rank keeps its own rows' hits."""
    n_data, _ = mesh_shape(mesh)
    n_total = _mesh_size(mesh)

    def run(params, corpus_shard, batch, valid_count: int):
        dev = params.item_id_table.device
        b = batch.user_id.shape[0]
        if b % n_data:
            raise ValueError(f"the eval batch ({b}) must split over the data axis ({n_data})")
        b_local = b // n_data
        d = mesh.get_local_rank(DATA_AXIS)
        own = lambda x: None if x is None else torch.as_tensor(x)[d * b_local : (d + 1) * b_local].to(dev)
        with torch.inference_mode():
            user_emb, _ = _user_tower(
                params, model_cfg, mesh, own(batch.user_id), own(batch.user_features).float(),
                own(batch.user_history), lookup_strategy, tower_tp, own(batch.history_len),
            )  # [B_local, DI]
            q_global = all_gather_stacked(user_emb, mesh.get_group(DATA_AXIS)).reshape(b, -1)
            rows = (corpus_shard.q if isinstance(corpus_shard, QuantizedCorpus)
                    else corpus_shard).shape[0]
            k = min(top_k, rows * n_total)
            indices, _, _ = sharded_mips_topk(corpus_shard, q_global, k,
                                              valid_count=valid_count, embeddings=False)
            indices = indices[d * b_local : (d + 1) * b_local]
            hit = (indices == own(batch.item_id)[:, None]).any(dim=1)
            positive = (own(batch.labels)[:, : model_cfg.num_tasks] > 0).any(dim=1)
            counts = torch.stack([(hit & positive).sum(), positive.sum()])
            dist.all_reduce(counts, group=mesh.get_group(DATA_AXIS))
            return counts[0] / counts[1].clamp_min(1)

    return run


def make_sharded_retrieval_fn(model_cfg: ModelConfig, mesh, lookup_strategy: str = "psum",
                              tower_tp: bool = False):
    """Serving: (params, corpus_shard, user_id, user_features, user_history,
    history_len, valid_count) -> [B, num_items] global corpus indices, the
    same on every rank; ``history_len`` may be None.  The queries are the
    same on every rank, each rank scans its C/n rows (the approximate scan
    under ``approx_mips``), and the candidates merge exactly; the rows are
    all-gathered only for the light ranker's rerank."""
    rt = model_cfg.mips_recall_target if model_cfg.approx_mips else None
    with_rows = model_cfg.light_ranker is not None

    def run(params, corpus_shard, uid, ufeat, uhist, hlen, valid_count: int):
        dev = params.item_id_table.device
        on = lambda x: None if x is None else torch.as_tensor(x).to(dev)
        with torch.inference_mode():
            user_emb, ranker_embs = _user_tower(
                params, model_cfg, mesh, on(uid), on(ufeat).float(), on(uhist),
                lookup_strategy, tower_tp, on(hlen),
            )
            topk_fn = lambda q, k: sharded_mips_topk(
                corpus_shard, q, k, valid_count=valid_count, recall_target=rt,
                embeddings=with_rows,
            )
            return retrieve_from_embeddings(params, model_cfg, user_emb, ranker_embs, topk_fn)

    return run
