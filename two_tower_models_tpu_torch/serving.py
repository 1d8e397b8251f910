"""Serving-side retrieval engine.

Port of ``two_tower_models_tpu/serving.py:RetrievalEngine`` for one device
(``mesh=None``) and a raw f32 corpus (``quantize=None``).  The corpus is the
trained item tower over the catalog (``retrieval.mips.refresh_corpus``);
queries run the user tower and the exact tile-max MIPS kernels.  PyTorch
runs eagerly, so there is nothing to compile per batch size: ``warmup``
builds and loads the CUDA kernels and runs one batch, so the first real
query does not pay for them.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, retrieve
from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus


def _single_device_only(mesh, quantize) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded serving (mesh) is not ported yet (ROADMAP.md, queue A, 'Multi-device')"
        )
    if quantize is not None:
        raise NotImplementedError(
            "the int8 corpus (quantize) is not ported yet "
            "(ROADMAP.md, queue A, 'Approximate and int8 MIPS')"
        )


class RetrievalEngine:
    """Frozen (model, corpus) on one device.  ``valid_count`` marks the real
    corpus rows and defaults to all of them."""

    def __init__(
        self,
        params: TwoTowerModel,
        cfg: ModelConfig,
        corpus: torch.Tensor,
        mesh=None,
        valid_count: int | None = None,
        tower_tp: bool = False,
        quantize: str | None = None,
        device="cuda",
    ):
        _single_device_only(mesh, quantize)
        if tower_tp:
            raise NotImplementedError(
                "tensor-parallel towers are not ported yet (ROADMAP.md, queue A, 'Multi-device')"
            )
        self._device = resolve_device(device)
        params = params.to(self._device).eval()
        corpus = corpus.to(self._device)
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
        _single_device_only(mesh, quantize)
        dev = resolve_device(device)
        params = params.to(dev)
        corpus = _embed_catalog(params, cfg, catalog_ids, catalog_features, embed_batch_size, dev)
        return cls(params, cfg, corpus, tower_tp=tower_tp, device=dev)

    @property
    def corpus(self) -> torch.Tensor:
        return self._state[1]

    def query(self, user_id, user_features, user_history, history_len=None) -> torch.Tensor:
        """Top ``cfg.num_items`` corpus indices per user, [B, num_items]."""
        params, corpus = self._state  # one read of the matched pair
        return retrieve(
            params, self._cfg, corpus, user_id, user_features, user_history,
            history_len=history_len, device=self._device,
        )

    def query_raw(self, user_keys, user_features, history_keys, history_len=None):
        raise NotImplementedError(
            "raw-key serving (the ingest hasher) is not ported yet "
            "(ROADMAP.md, queue A, 'Raw-key ingest')"
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
        """Swap in new params and a corpus rebuilt from them; the corpus is
        built before the single (params, corpus) reference swaps."""
        params = params.to(self._device).eval()
        corpus = _embed_catalog(
            params, self._cfg, catalog_ids, catalog_features, embed_batch_size, self._device
        )
        self._state = (params, corpus)


def _embed_catalog(params, cfg, ids, feats, batch_size, dev) -> torch.Tensor:
    with torch.inference_mode():
        return refresh_corpus(
            params, cfg, torch.as_tensor(ids).to(dev),
            torch.as_tensor(feats).to(dev).float(), batch_size=batch_size,
        )
