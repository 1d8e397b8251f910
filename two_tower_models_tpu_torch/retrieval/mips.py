"""Exact maximum-inner-product search over an item corpus.

Port of ``two_tower_models_tpu/retrieval/mips.py``: the dense scan
``mips_topk``, the fast exact path ``mips_topk_exact`` (the tile-max kernel
pipeline, ``ops.mips_topk``) and the chunked corpus ``refresh_corpus``.

Tie order: ``torch.topk`` promises none, and a float compare treats -0.0
and +0.0 as equal, while ``lax.top_k`` orders by the float total order and
breaks ties by the lowest index.  ``topk_ordered`` selects on the monotone
int32 key of each score joined with its inverted index, so every value is
distinct and the order is lax.top_k's.
"""

from __future__ import annotations

import torch

from two_tower_models_tpu_torch.ops.mips_topk import (
    f32_keys,
    mips_topk_exact_tiled,
    select_keys_plain,
)

_CHUNK_ELEMS = 1 << 27  # most (query, row) scores the dense scan holds at once


def topk_ordered(scores: torch.Tensor, k: int):
    """(values [R, k], indices [R, k] int64) of each row's top k, in
    lax.top_k's order: descending total order, ties to the lowest index."""
    _, pos = select_keys_plain(f32_keys(scores), k)
    idx = pos.long()
    return torch.gather(scores, 1, idx), idx


def mips_topk(
    corpus: torch.Tensor,  # [C, DI]
    query: torch.Tensor,  # [B, DI]
    k: int,
    valid_count: int | None = None,  # rows >= this are padding
):
    """Exact top-k by inner product: (indices [B, k] int64, scores [B, k]
    f32, embeddings [B, k, DI]).  Scores are f32 products of the inputs as
    given (bf16 inputs are exact in f32).  Queries are scanned in chunks so
    the [chunk, C] score block stays bounded."""
    c = corpus.shape[0]
    k = min(k, c)
    cf = corpus.float()
    rows = max(1, _CHUNK_ELEMS // max(c, 1))
    idx_parts, score_parts = [], []
    for b0 in range(0, query.shape[0], rows):
        s = query[b0 : b0 + rows].float() @ cf.T
        if valid_count is not None and valid_count < c:
            s[:, valid_count:] = float("-inf")
        v, i = topk_ordered(s, k)
        idx_parts.append(i)
        score_parts.append(v)
    if not idx_parts:
        empty = torch.empty((0, k), dtype=torch.int64, device=query.device)
        return empty, empty.float(), corpus[empty]
    idx = torch.cat(idx_parts)
    return idx, torch.cat(score_parts), corpus[idx]


def mips_topk_exact(corpus: torch.Tensor, query: torch.Tensor, k: int):
    """The fast exact path: the tile-max kernel pipeline
    (``ops.mips_topk.mips_topk_exact_tiled``), equal to ``mips_topk``
    including tie order; small corpora take the dense scan."""
    return mips_topk_exact_tiled(corpus, query, k)


def refresh_corpus(
    params,
    cfg,
    item_ids: torch.Tensor,  # [C] catalog ids
    item_features: torch.Tensor,  # [C, II]
    batch_size: int = 4096,
) -> torch.Tensor:
    """Re-embed the catalog through the item tower, ``batch_size`` items at
    a time, -> [C, DI] f32."""
    from two_tower_models_tpu_torch.models.two_tower import compute_item_embeddings

    parts = [
        compute_item_embeddings(
            params, cfg, item_ids[i : i + batch_size], item_features[i : i + batch_size]
        )
        for i in range(0, item_ids.shape[0], batch_size)
    ]
    return torch.cat(parts)
