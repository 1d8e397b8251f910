"""int8-quantized MIPS corpus: the serving scan at a quarter of the f32 bytes.

Port of ``two_tower_models_tpu/retrieval/quant.py``.  Symmetric per-row
quantization:

  q[c] = round(corpus[c] / scale[c]),  scale[c] = max|corpus[c]| / 127

  scores[b, c] ~ scale[c] * <query_b, q_c>

Two serving modes (``mips_topk_quantized``): pure, the top k of the
quantized scores with dequantized rows for embeddings; and rescore, an
``oversample * k`` pool on the quantized scores rescored against the
full-precision rows (``raw``), the exact top k of the pool.

With a ``recall_target`` the pre-selection is the approximate top-k
(``ops/approx_topk.py``: the bin-max kernel N1 on the int8 rows, then B3),
so no [B, C] score matrix exists; without one it is the exact top-k of the
dense quantized scores, a query chunk at a time.  Tie order is lax.top_k's
(``retrieval/mips.py:topk_ordered``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from two_tower_models_tpu_torch.ops.approx_topk import approx_max_k
from two_tower_models_tpu_torch.retrieval.mips import _CHUNK_ELEMS, topk_ordered


class QuantizedCorpus(NamedTuple):
    """Symmetric per-row int8 corpus.  ``raw`` holds the full-precision rows
    when the rescore mode is wanted; None keeps only the int8 rows."""

    q: torch.Tensor  # [C, D] int8
    scale: torch.Tensor  # [C] f32, never 0
    raw: Optional[torch.Tensor] = None  # [C, D], kept only for rescoring

    @property
    def shape(self):  # the raw corpus's [C, D], where callers need only that
        return self.q.shape


def quantize_corpus(corpus: torch.Tensor, keep_raw: bool = False) -> QuantizedCorpus:
    """[C, D] float -> per-row symmetric int8 and f32 scales, on the
    corpus's device.  In JAX's order: f32 ``amax / 127``, scale 1 for zero
    rows (so they dequantize to zeros), ``round(c / scale)`` half to even,
    clipped to +-127."""
    c32 = corpus.float()
    amax = c32.abs().amax(dim=-1)  # [C]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(c32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantizedCorpus(q=q, scale=scale, raw=corpus if keep_raw else None)


def dequantize(qc: QuantizedCorpus, dtype=torch.bfloat16) -> torch.Tensor:
    """The [C, D] rows the int8 corpus stands for, in ``dtype``."""
    return (qc.q.float() * qc.scale[:, None]).to(dtype)


def quantized_scores(query: torch.Tensor, qc: QuantizedCorpus) -> torch.Tensor:
    """[B, C] f32 approximate inner products: the f32 dot with the int8 rows
    (exact in f32), then times each row's scale."""
    return (query.float() @ qc.q.float().T) * qc.scale[None, :]


def _exact_preselect(qc: QuantizedCorpus, query: torch.Tensor, m: int, lim: int):
    """Top m of the dense quantized scores, a query chunk at a time."""
    c = qc.q.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(c, 1))
    vals, idxs = [], []
    for b0 in range(0, query.shape[0], rows):
        s = quantized_scores(query[b0 : b0 + rows], qc)
        s[:, lim:] = float("-inf")
        v, i = topk_ordered(s, m)
        vals.append(v)
        idxs.append(i)
    if not vals:
        return (torch.empty((0, m), device=query.device),
                torch.empty((0, m), dtype=torch.int64, device=query.device))
    return torch.cat(vals), torch.cat(idxs)


def quantized_shard_topk(
    qc: QuantizedCorpus,
    query: torch.Tensor,  # [B, D]
    k: int,
    recall_target: Optional[float] = 0.95,  # None = exact top-k of the quantized scores
    oversample: int = 4,
    row_offset: int = 0,  # global index of this corpus's row 0
    valid_count: Optional[int] = None,  # GLOBAL rows < this are real; the rest pad
):
    """(scores [B, k] f32, local indices [B, k] int64, embeddings [B, k, D])
    of one quantized corpus: the quantized pre-selection (rows at or past
    ``valid_count - row_offset`` at -inf), then either those (pure mode:
    embeddings dequantized in the query's dtype) or an ``oversample * k``
    pool rescored against ``qc.raw`` (rescore mode), whose -inf rows stay
    -inf, and the pool's exact top k."""
    n_local = qc.q.shape[0]
    k = min(k, n_local)
    m = min(oversample * k, n_local) if qc.raw is not None else k
    lim = n_local if valid_count is None else max(0, min(int(valid_count) - row_offset, n_local))
    if recall_target is None:
        pre_s, pre_i = _exact_preselect(qc, query, m, lim)
    else:
        pre_s, pre_i = approx_max_k(query, qc.q, m, recall_target, valid_count=lim,
                                    scale=qc.scale)
    if qc.raw is None:
        # dequantize only the selected rows, never the whole corpus
        emb = (qc.q[pre_i].float() * qc.scale[pre_i][..., None]).to(query.dtype)
        return pre_s, pre_i, emb

    cand = qc.raw[pre_i]  # [B, m, D]
    exact = torch.einsum("bmd,bd->bm", cand.to(query.dtype).float(), query.float())
    # padded rows entered the pool at -inf; they stay there after the rescore
    exact = exact.masked_fill(torch.isneginf(pre_s), float("-inf"))
    top_s, sel = topk_ordered(exact, k)  # [B, k] over the pool
    top_i = torch.gather(pre_i, 1, sel)
    top_e = torch.gather(cand, 1, sel[:, :, None].expand(-1, -1, cand.shape[-1]))
    return top_s, top_i, top_e


def mips_topk_quantized(
    qc: QuantizedCorpus,
    query: torch.Tensor,  # [B, D]
    k: int,
    recall_target: Optional[float] = 0.95,  # None = exact top-k of the quantized scores
    rescore_corpus: Optional[torch.Tensor] = None,  # [C, D] full precision
    oversample: int = 4,
):
    """(indices [B, k] int64, scores [B, k] f32, embeddings [B, k, D]): the
    ``mips_topk`` contract over an int8 corpus.  Full-precision rows
    (``rescore_corpus`` or ``qc.raw``) select the rescore mode."""
    if rescore_corpus is not None:
        qc = qc._replace(raw=rescore_corpus)
    s, i, e = quantized_shard_topk(qc, query, k, recall_target=recall_target,
                                   oversample=oversample)
    return i, s, e
