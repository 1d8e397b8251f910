"""Serving-side retrieval engine.

Port of ``two_tower_models_tpu/serving.py:RetrievalEngine`` for one device
(``mesh=None``).  The corpus is the trained item tower over the catalog
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
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, retrieve
from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus
from two_tower_models_tpu_torch.retrieval.quant import QuantizedCorpus, quantize_corpus
from two_tower_models_tpu_torch.training.ingest import hash_item_keys, hash_user_keys

QUANTIZE_MODES = (None, "int8", "int8_rescore")


def _single_device_only(mesh, tower_tp, quantize) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded serving (mesh) is not ported yet (ROADMAP.md, queue A, A13 'Multi-device')"
        )
    if tower_tp:
        raise NotImplementedError(
            "tensor-parallel towers are not ported yet (ROADMAP.md, queue A, A13 'Multi-device')"
        )
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize must be int8|int8_rescore, got {quantize!r}")


def _quantized(corpus: torch.Tensor, quantize):
    if quantize is None:
        return corpus
    return quantize_corpus(corpus, keep_raw=quantize == "int8_rescore")


class RetrievalEngine:
    """Frozen (model, corpus) on one device.  ``valid_count`` marks the real
    corpus rows and defaults to all of them."""

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
        _single_device_only(mesh, tower_tp, quantize)
        self._device = resolve_device(device)
        params = params.to(self._device).eval()
        if isinstance(corpus, QuantizedCorpus):  # served as it is, on this device
            corpus = QuantizedCorpus(*(None if t is None else t.to(self._device) for t in corpus))
        else:
            corpus = _quantized(corpus.to(self._device), quantize)
        self._quantize = quantize
        # (params, corpus) live in ONE reference so refresh() swaps them
        # together: a query racing a refresh never scores new user
        # embeddings against an old-space corpus.
        self._state = (params, corpus)
        self._cfg = cfg
        self._valid_count = int(corpus.shape[0] if valid_count is None else valid_count)

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
        """Build the corpus from the trained item tower, then serve it."""
        _single_device_only(mesh, tower_tp, quantize)
        dev = resolve_device(device)
        params = params.to(dev)
        corpus = _embed_catalog(params, cfg, catalog_ids, catalog_features, embed_batch_size, dev)
        return cls(params, cfg, corpus, quantize=quantize, device=dev)

    @property
    def corpus(self):
        """The served corpus: [C, DI] f32, or a ``QuantizedCorpus``."""
        return self._state[1]

    def query(self, user_id, user_features, user_history, history_len=None) -> torch.Tensor:
        """Top ``cfg.num_items`` corpus indices per user, [B, num_items]."""
        params, corpus = self._state  # one read of the matched pair
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
        reference swaps."""
        params = params.to(self._device).eval()
        corpus = _embed_catalog(
            params, self._cfg, catalog_ids, catalog_features, embed_batch_size, self._device
        )
        self._state = (params, _quantized(corpus, self._quantize))


def _embed_catalog(params, cfg, ids, feats, batch_size, dev) -> torch.Tensor:
    with torch.inference_mode():
        return refresh_corpus(
            params, cfg, torch.as_tensor(ids).to(dev),
            torch.as_tensor(feats).to(dev).float(), batch_size=batch_size,
        )
