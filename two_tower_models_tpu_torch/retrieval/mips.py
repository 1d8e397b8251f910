"""Maximum-inner-product search over an item corpus.

Port of ``two_tower_models_tpu/retrieval/mips.py`` on one device: the random
corpus ``mips_init``; the dense scan ``mips_topk``; the fast exact path
``mips_topk_exact`` (the tile-max kernel pipeline, ``ops.mips_topk``); the
other exact scans in plain torch, ``mips_topk_segmented`` (over
``segmented_topk``), ``mips_topk_exact_tilemax`` (the same pruning as the
kernels, query-blocked) and ``chunked_mips_topk``; the serving path
``mips_topk_approx`` (``ops.approx_topk``: the bin-max kernel N1, then B3);
the chunked corpus ``refresh_corpus``; and ``sharded_mips_topk``, the scan of
a corpus row-sharded over the ranks of a process group (one a device), each
rank's top k then an all-gather and an exact merge.

Tie order: ``torch.topk`` promises none, and a float compare treats -0.0
and +0.0 as equal, while ``lax.top_k`` orders by the float total order and
breaks ties by the lowest index.  ``topk_ordered`` selects on the monotone
int32 key of each score joined with its inverted index, so every value is
distinct and the order is lax.top_k's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.config import resolve_device
from two_tower_models_tpu_torch.ops.approx_topk import approx_max_k
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


def mips_init(generator: torch.Generator, corpus_size: int, embedding_dim: int,
              dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Random corpus [C, DI], N(0, 1) from ``generator`` (which must live on
    ``device``); refresh it with ``refresh_corpus`` after training."""
    dev = resolve_device(device)
    return torch.randn(corpus_size, embedding_dim, generator=generator, device=dev).to(dtype)


def _scores(corpus: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """[B, C] f32 inner products (bf16 inputs are exact in f32)."""
    return query.float() @ corpus.float().T


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
        s = _scores(cf, query[b0 : b0 + rows])
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


def sharded_mips_topk(
    corpus_shard,  # [C/n, DI] rows, or this shard's QuantizedCorpus
    query: torch.Tensor,  # [B, DI], the same on every rank
    k: int,
    group=None,  # the process group the corpus is sharded over (None: the world)
    valid_count: int | None = None,  # GLOBAL rows < this are real; the rest pad
    recall_target: float | None = None,  # None = exact; else the local approximate top-k
    oversample: int = 4,  # the int8_rescore pool factor
    embeddings: bool = True,
):
    """Top-k over a corpus row-sharded over ``group``: (indices [B, k]
    int64 global rows, scores [B, k] f32, embeddings [B, k, DI] or None).

    Every rank of ``group`` calls it with the same query; rank s holds
    global rows [s * C/n, (s+1) * C/n).  Each rank takes its local top k,
    then the candidates of every rank are all-gathered and merged with one
    exact top k, ties to the lower rank and so to the lower global index
    (``_merge_shard_candidates``).  The local scan follows the JAX
    package's three branches: a ``QuantizedCorpus`` goes to
    ``quantized_shard_topk`` with the global ``valid_count`` and the
    shard's row offset; an exact scan of a shard with ``k * 128 < C/n``
    rows to the tile-max kernels (B2, B3, B4) with the shard's own valid
    count; anything else to the dense scores masked at global row >=
    ``valid_count``, then the ordered top k or, with a ``recall_target``,
    the approximate top-k (N1, then B3).

    ``embeddings=False`` all-gathers no rows and returns None for them:
    JAX's ``jit`` drops that gather where the caller ignores the rows, and
    the port, run eagerly, is told so."""
    shard = dist.get_rank(group)
    local_top, local_idx, local_emb, n_local = _shard_topk(
        corpus_shard, query, k, shard, valid_count, recall_target, oversample
    )
    return _merge_shard_candidates(
        local_top, local_idx, local_emb if embeddings else None, shard, n_local, k, group
    )


def _shard_topk(corpus_shard, query, k, shard, valid_count, recall_target, oversample):
    """The local scan of ``sharded_mips_topk`` on shard ``shard``: (scores
    [B, kk], shard-local rows [B, kk], embeddings [B, kk, DI], C/n)."""
    from two_tower_models_tpu_torch.retrieval.quant import QuantizedCorpus, quantized_shard_topk

    if isinstance(corpus_shard, QuantizedCorpus):
        n_local = corpus_shard.q.shape[0]
        local_top, local_idx, local_emb = quantized_shard_topk(
            corpus_shard, query, min(k, n_local), recall_target=recall_target,
            oversample=oversample, row_offset=shard * n_local, valid_count=valid_count,
        )
        return local_top, local_idx, local_emb, n_local
    n_local = corpus_shard.shape[0]
    kk = min(k, n_local)
    local_valid = (
        None if valid_count is None else max(0, min(int(valid_count) - shard * n_local, n_local))
    )
    if recall_target is None and kk * 128 < n_local:
        # a large shard: the tile-max kernel pipeline, with the shard's valid rows
        local_idx, local_top, local_emb = mips_topk_exact_tiled(
            corpus_shard, query, kk, valid_count=local_valid
        )
    elif recall_target is None:
        local_idx, local_top, local_emb = mips_topk(corpus_shard, query, kk, valid_count=local_valid)
    else:
        rows = (corpus_shard if corpus_shard.dtype in (torch.float32, torch.bfloat16)
                else corpus_shard.float())
        local_top, local_idx = approx_max_k(query, rows, kk, recall_target, valid_count=local_valid)
        local_emb = corpus_shard[local_idx]
    return local_top, local_idx, local_emb, n_local


def all_gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *t.shape]: ``t`` of every rank of ``group``, in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def _merge_shard_candidates(
    local_top: torch.Tensor,  # [B, kk] this shard's candidate scores
    local_idx: torch.Tensor,  # [B, kk] shard-local row indices
    local_emb,  # [B, kk, DI], or None
    shard: int,
    n_local: int,
    k: int,
    group,
):
    """All-gather every shard's candidates (f32 scores, int64 global rows,
    rows in their own dtype) in rank order, lay them out [B, n * kk]
    shard-major within each row, and take the top k in lax.top_k's order:
    ties go to the lower position, which is the lower global index."""
    global_idx = local_idx.long() + shard * n_local
    b = local_top.shape[0]
    cand_scores = all_gather_stacked(local_top.float(), group)  # [n, B, kk]
    cand_idx = all_gather_stacked(global_idx, group)
    cand_scores = cand_scores.movedim(0, 1).reshape(b, -1)  # [B, n*kk]
    cand_idx = cand_idx.movedim(0, 1).reshape(b, -1)
    k = min(k, cand_scores.shape[1])
    top_scores, merge_idx = topk_ordered(cand_scores, k)  # [B, k]
    top_idx = torch.gather(cand_idx, 1, merge_idx)
    top_emb = None
    if local_emb is not None:
        cand_emb = all_gather_stacked(local_emb, group)  # [n, B, kk, DI]
        cand_emb = cand_emb.movedim(0, 1).reshape(b, -1, cand_emb.shape[-1])
        top_emb = torch.gather(cand_emb, 1, merge_idx[:, :, None].expand(-1, -1, cand_emb.shape[-1]))
    return top_idx, top_scores, top_emb


def segmented_topk(scores: torch.Tensor, k: int, num_segments: int):
    """(values [B, k], indices [B, k] int64): the exact top k of ``scores``
    [B, C] through each of ``num_segments`` segments' top k (C padded with
    -inf to a multiple), then the top k of those candidates, segment by
    segment in order, so ties keep lax.top_k's lowest index."""
    b, c = scores.shape
    seg = -(-c // num_segments)
    pad = seg * num_segments - c
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    kk = min(k, seg)
    loc_s, loc_i = topk_ordered(scores.reshape(b * num_segments, seg), kk)
    offs = (torch.arange(num_segments, device=scores.device) * seg)[None, :, None]
    cand_s = loc_s.reshape(b, -1)
    cand_i = (loc_i.reshape(b, num_segments, kk) + offs).reshape(b, -1)
    top_s, sel = topk_ordered(cand_s, k)
    return top_s, torch.gather(cand_i, 1, sel)


def mips_topk_segmented(corpus: torch.Tensor, query: torch.Tensor, k: int,
                        num_segments: int = 64):
    """Exact MIPS through ``segmented_topk``, a query chunk at a time:
    (indices [B, k] int64, scores [B, k] f32, embeddings [B, k, DI])."""
    c = corpus.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(c, 1))
    idx, sc = [], []
    for b0 in range(0, query.shape[0], rows):
        v, i = segmented_topk(_scores(corpus, query[b0 : b0 + rows]), k, num_segments)
        idx.append(i)
        sc.append(v)
    top_idx = torch.cat(idx)
    return top_idx, torch.cat(sc), corpus[top_idx]


def mips_topk_exact_tilemax(
    corpus: torch.Tensor,  # [C, DI]
    query: torch.Tensor,  # [B, DI]
    k: int,
    tile: int = 128,
    chunk: int = 131072,
    query_block: int = 256,
):
    """Exact MIPS by tile-max pruning in plain torch, ``query_block``
    queries at a time: each tile's max score (chunk by chunk, so a block
    holds [query_block, chunk] scores), the k best tiles, sorted ascending
    so the candidates are in global index order, then the top k of their
    rows' scores, each summed in d order as pass 1's GEMM sums it.  Equal
    to ``mips_topk`` including tie order (the exactness note of
    ``ops.mips_topk``); small corpora take the dense scan."""
    c, di = corpus.shape
    k = min(k, c)
    n_tiles = -(-c // tile)
    if k * tile >= c or n_tiles < k:
        return mips_topk(corpus, query, k)
    chunk = min(chunk, n_tiles * tile)
    chunk = -(-chunk // tile) * tile
    pad = (-c) % chunk if c > chunk else (n_tiles * tile - c)
    corpus_p = torch.nn.functional.pad(corpus, (0, 0, 0, pad)) if pad else corpus
    c_pad = corpus_p.shape[0]
    tiles = corpus_p.view(c_pad // tile, tile, di)
    dev = query.device

    def topk_block(q):
        qb = q.shape[0]
        maxes = []
        for r0 in range(0, c_pad, chunk):
            s = _scores(corpus_p[r0 : r0 + chunk], q)
            col = torch.arange(r0, r0 + chunk, device=dev)
            s = s.masked_fill((col >= c)[None, :], float("-inf"))
            maxes.append(s.view(qb, chunk // tile, tile).amax(dim=-1))
        _, tile_idx = topk_ordered(torch.cat(maxes, dim=1), k)
        tile_idx = torch.sort(tile_idx, dim=1).values
        cand = tiles[tile_idx]  # [qb, k, tile, DI]
        # one multiply-add a d, in d order: the order in which a GEMM of
        # depth DI sums each score (cuBLAS's f32 GEMM, and the kernels'
        # fmaf chain), so a row's score here is its bits in pass 1; a sum
        # in another order could differ by an ulp and drop a true winner
        cand_d = cand.float().permute(3, 0, 1, 2).contiguous()  # [DI, qb, k, tile]
        qf = q.float()
        cand_scores = torch.zeros(cand.shape[:3], device=dev)
        for j in range(di):
            cand_scores.addcmul_(cand_d[j], qf[:, j, None, None])
        cand_gidx = tile_idx[:, :, None] * tile + torch.arange(tile, device=dev)
        cand_scores = cand_scores.masked_fill(cand_gidx >= c, float("-inf"))
        top_s, sel = topk_ordered(cand_scores.reshape(qb, k * tile), k)
        top_i = torch.gather(cand_gidx.reshape(qb, k * tile), 1, sel)
        return top_i, top_s

    idx, sc = [], []
    for b0 in range(0, query.shape[0], query_block):
        i, v = topk_block(query[b0 : b0 + query_block])
        idx.append(i)
        sc.append(v)
    top_idx = torch.cat(idx)
    return top_idx, torch.cat(sc), corpus[top_idx]


def mips_topk_approx(corpus: torch.Tensor, query: torch.Tensor, k: int,
                     recall_target: float = 0.95):
    """The serving path: the approximate top k (``ops.approx_topk``: the
    bin-max kernel over ``approx_bins(C, k, recall_target)`` bins, then B3),
    (indices [B, k] int64, scores [B, k] f32, embeddings [B, k, DI]).  The
    rows are scored in f32; an f32 or bf16 corpus goes to the kernel as it
    is (its tensor-core route reads bf16 rows, exact in TF32, without a
    widened copy), any other dtype is widened first."""
    rows = corpus if corpus.dtype in (torch.float32, torch.bfloat16) else corpus.float()
    scores, idx = approx_max_k(query, rows, min(k, corpus.shape[0]), recall_target)
    return idx, scores, corpus[idx]


def chunked_mips_topk(
    corpus: torch.Tensor,  # [C, DI]
    query: torch.Tensor,  # [B, DI]
    k: int,
    chunk_size: int = 65536,
):
    """Exact top-k keeping a running (scores, indices) of k per query over
    corpus chunks of ``chunk_size`` rows, so the scores held are [B, chunk]:
    each chunk's top k merged with the running set, the running set first,
    so ties keep the lowest index."""
    c = corpus.shape[0]
    b = query.shape[0]
    if c <= chunk_size:
        return mips_topk(corpus, query, k)
    k = min(k, c)
    best_s = torch.full((b, k), float("-inf"), device=query.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=query.device)
    n_chunks = -(-c // chunk_size)
    for n in range(n_chunks):
        base = n * chunk_size
        s = _scores(corpus[base : base + chunk_size], query)
        # the last chunk is padded with -inf rows, as the JAX scan's is
        s = torch.nn.functional.pad(s, (0, chunk_size - s.shape[1]), value=float("-inf"))
        local_s, local_i = topk_ordered(s, min(k, chunk_size))
        new_s, sel = topk_ordered(torch.cat([best_s, local_s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, local_i + base], dim=1), 1, sel)
        best_s = new_s
    return best_i, best_s, corpus[best_i]


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
