"""Serving-side retrieval engine.

Port of ``two_tower_models_tpu/serving.py:RetrievalEngine``.  The corpus
is the trained item tower over the catalog
(``retrieval.mips.refresh_corpus``); queries run the user tower and the
MIPS that ``models.two_tower.retrieve`` dispatches to: the exact tile-max
kernels, or under ``cfg.approx_mips`` the approximate top-k (the bin-max
kernel N1, then B3).  ``quantize="int8"`` serves from a symmetric per-row
int8 corpus (``retrieval.quant``), quantized on the engine's device;
``"int8_rescore"`` keeps the f32 rows and rescores an oversampled pool.
PyTorch runs eagerly, so there is nothing to compile per batch size:
``warmup`` builds and loads the CUDA kernels and runs one batch, so the
first real query does not pay for them.  ``query_raw`` serves from raw
entity keys through the host hasher of ``training.ingest``.

With ``mesh`` (a ``parallel.mesh.make_mesh`` DeviceMesh, one process a
rank) the engine is SPMD: every rank builds it and queries it with the same
arguments and gets the same [B, num_items] answer.  Each rank holds its
block of the model (the id tables row-sharded over ``model``, and with
``tower_tp`` the feature MLPs split) and C/n rows of the corpus, and queries
run ``parallel.retrieval.make_sharded_retrieval_fn``: the towers over the
sharded lookups, each rank's scan of its rows, an all-gather and an exact
merge.  ``quantize`` composes with it (each rank quantizes its own rows).
On the card the mesh runs over NCCL, on ``cuda:<rank>``; ``device="cpu"``
takes a gloo mesh.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, retrieve
from two_tower_models_tpu_torch.parallel.mesh import mesh_device
from two_tower_models_tpu_torch.parallel.retrieval import (
    make_sharded_refresh_fn,
    make_sharded_retrieval_fn,
    pad_catalog,
    quantize_corpus_sharded,
    shard_corpus,
)
from two_tower_models_tpu_torch.parallel.sharding import shard_params
from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus
from two_tower_models_tpu_torch.retrieval.quant import QuantizedCorpus, quantize_corpus
from two_tower_models_tpu_torch.training.ingest import hash_item_keys, hash_user_keys

QUANTIZE_MODES = (None, "int8", "int8_rescore")


def _check_options(mesh, tower_tp, quantize) -> None:
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize must be int8|int8_rescore, got {quantize!r}")
    if tower_tp and mesh is None:
        raise ValueError("tower_tp splits the feature MLPs over a mesh's model axis: pass mesh")


def _quantized(corpus, quantize, mesh=None):
    """``corpus`` as ``quantize`` serves it: each rank quantizes its own rows
    on a mesh; a ``QuantizedCorpus`` is served as it is."""
    if quantize is None or isinstance(corpus, QuantizedCorpus):
        return corpus
    keep_raw = quantize == "int8_rescore"
    if mesh is None:
        return quantize_corpus(corpus, keep_raw=keep_raw)
    return quantize_corpus_sharded(corpus, mesh, keep_raw)


def _build(params, cfg, ids, feats, batch_size, dev, mesh, tower_tp):
    """(this rank's model, its corpus rows, the valid count) from the full
    model and the catalog: the whole corpus on one device, or on a mesh the
    rank's block of the model and its rows of the padded catalog."""
    if mesh is None:
        params = params.to(dev).eval()
        corpus = _embed_catalog(params, cfg, ids, feats, batch_size, dev)
        return params, corpus, corpus.shape[0]
    local = shard_params(params, cfg, mesh, tower_tp, dev)
    ids, feats, valid = pad_catalog(ids, feats, mesh)
    refresh = make_sharded_refresh_fn(cfg, mesh, tower_tp=tower_tp, batch_size=batch_size)
    return local, refresh(local, ids, feats), valid


class RetrievalEngine:
    """Frozen (model, corpus) on one device, or on each rank of a mesh.
    ``valid_count`` marks the real corpus rows (the rest is padding) and
    defaults to all of them.  On a mesh ``corpus`` is the global [C, DI]
    corpus (or ``QuantizedCorpus``), C a multiple of the mesh size: each
    rank moves only its own rows to its device."""

    def __init__(
        self,
        params: TwoTowerModel,
        cfg: ModelConfig,
        corpus,  # [C, DI], or a QuantizedCorpus served as it is
        mesh=None,
        valid_count: int | None = None,
        tower_tp: bool = False,
        quantize: str | None = None,
        device="cuda",
    ):
        _check_options(mesh, tower_tp, quantize)
        rows = corpus.shape[0]  # the global corpus's
        if mesh is None:
            dev = resolve_device(device)
            params = params.to(dev).eval()
            if isinstance(corpus, QuantizedCorpus):  # served as it is, on this device
                corpus = QuantizedCorpus(*(None if t is None else t.to(dev) for t in corpus))
            else:
                corpus = corpus.to(dev)
        else:
            dev = mesh_device(mesh, device)
            params = shard_params(params, cfg, mesh, tower_tp, dev)
            corpus = shard_corpus(corpus, mesh, dev)
        self._serve(params, cfg, corpus, rows if valid_count is None else valid_count,
                    quantize, dev, mesh, tower_tp)

    def _serve(self, params, cfg, corpus, valid_count, quantize, dev, mesh=None, tower_tp=False):
        """Set the engine up on this rank's ``params`` and ``corpus`` rows."""
        corpus = _quantized(corpus, quantize, mesh)
        self._device = dev
        self._quantize = quantize
        # (params, corpus) live in ONE reference so refresh() swaps them
        # together: a query racing a refresh never scores new user
        # embeddings against an old-space corpus.
        self._state = (params, corpus)
        self._cfg = cfg
        self._mesh = mesh
        self._tower_tp = tower_tp
        self._valid_count = int(valid_count)
        self._sharded = None if mesh is None else make_sharded_retrieval_fn(
            cfg, mesh, tower_tp=tower_tp
        )

    @classmethod
    def from_params(
        cls,
        params: TwoTowerModel,
        cfg: ModelConfig,
        catalog_ids,
        catalog_features,
        embed_batch_size: int = 4096,
        mesh=None,
        tower_tp: bool = False,
        quantize: str | None = None,
        device="cuda",
    ) -> "RetrievalEngine":
        """Build the corpus from the trained item tower, then serve it.  On
        a mesh the catalog is padded to a multiple of the mesh size and each
        rank embeds only what its own rows need (``make_sharded_refresh_fn``)."""
        _check_options(mesh, tower_tp, quantize)
        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        params, corpus, valid = _build(params, cfg, catalog_ids, catalog_features,
                                       embed_batch_size, dev, mesh, tower_tp)
        engine = cls.__new__(cls)
        engine._serve(params, cfg, corpus, valid, quantize, dev, mesh, tower_tp)
        return engine

    @property
    def corpus(self):
        """The served corpus: [C, DI] f32, or a ``QuantizedCorpus``; on a
        mesh this rank's C/n rows of it."""
        return self._state[1]

    def query(self, user_id, user_features, user_history, history_len=None) -> torch.Tensor:
        """Top ``cfg.num_items`` corpus indices per user, [B, num_items].  On
        a mesh every rank calls it with the same batch."""
        params, corpus = self._state  # one read of the matched pair
        if self._sharded is not None:
            return self._sharded(params, corpus, user_id, user_features, user_history,
                                 history_len, self._valid_count)
        return retrieve(
            params, self._cfg, corpus, user_id, user_features, user_history,
            history_len=history_len, device=self._device,
        )

    def query_raw(self, user_keys, user_features, history_keys, history_len=None):
        """Serve from RAW entity keys: user keys [B] and history keys [B, H]
        (uint64 surrogate ids or str/bytes, newest first) hash on the host
        with the training ingest's per-table seeds (``training.ingest``),
        the slots go to the engine's device, and ``query`` runs on them."""
        dev = self._device
        return self.query(
            torch.as_tensor(hash_user_keys(user_keys, self._cfg), device=dev),
            user_features,
            torch.as_tensor(hash_item_keys(history_keys, self._cfg), device=dev),
            history_len,
        )

    def warmup(self, batch_size: int, variable_history: bool = False) -> None:
        """Build the kernels and run one zero batch of ``batch_size``."""
        cfg, dev = self._cfg, self._device
        uid = torch.zeros((batch_size,), dtype=torch.int64, device=dev)
        ufeat = torch.zeros((batch_size, cfg.user_features_size), device=dev)
        uhist = torch.zeros((batch_size, cfg.history_len), dtype=torch.int64, device=dev)
        self.query(uid, ufeat, uhist)
        if variable_history:
            self.query(
                uid, ufeat, uhist,
                history_len=torch.full((batch_size,), cfg.history_len, device=dev),
            )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def refresh(self, params: TwoTowerModel, catalog_ids, catalog_features,
                embed_batch_size: int = 4096) -> None:
        """Swap in new params and a corpus rebuilt (and quantized again)
        from them; the corpus is built before the single (params, corpus)
        reference swaps.  On a mesh ``params`` is the full model again, and
        the catalog must keep its size (the valid count)."""
        mesh = self._mesh
        params, corpus, valid = _build(params, self._cfg, catalog_ids, catalog_features,
                                       embed_batch_size, self._device, mesh, self._tower_tp)
        if mesh is not None and valid != self._valid_count:
            raise ValueError(f"the catalog changed size across refresh ({self._valid_count} "
                             f"-> {valid} rows); build a new engine")
        self._state = (params, _quantized(corpus, self._quantize, mesh))


def _embed_catalog(params, cfg, ids, feats, batch_size, dev) -> torch.Tensor:
    with torch.inference_mode():
        return refresh_corpus(
            params, cfg, torch.as_tensor(ids).to(dev),
            torch.as_tensor(feats).to(dev).float(), batch_size=batch_size,
        )
