"""Exact tile-max MIPS top-k: three kernels and the pipeline around them.

Port of ``two_tower_models_tpu/ops/pallas/mips_topk.py``:

  1. ``tile_max_scores``  (csrc/tile_max.cu): per query, the max score of
     every 128-row corpus tile; the [B, C] score matrix never exists.
  2. ``select_rows``      (csrc/select_topk.cu): the k best tiles per query,
     in lax.top_k's total order; a radix select for k <= ``K_MAX``
     (launch counter ``select_topk_radix``), the tournament above it
     (``select_topk``), as ``_select_route`` decides.
  3. ``gather_rescore``   (csrc/gather_rescore.cu): every row of the k
     selected tiles scored against its query; ``invert_selection`` first
     turns the [B, k] selection into per-tile lists of (query, slot) pairs
     (launch counter ``gather_rescore_invert``), so each selected tile is
     read once and scored against every query that picked it.
  4. ``select_rows`` again over the k*128 candidates.

Each kernel's source note says what bounds it on the H100 and what its
design does about that.  Beside each wrapper is its plain PyTorch version:
a CPU tensor takes it, a CUDA tensor launches the kernel.

Exactness (``retrieval/mips.py`` of the JAX package): a top-k row's tile
has max >= the k-th score, at most k tiles can, and ties resolve to the
lowest index in both selections; sorting the selected tiles ascending makes
pass 4's positional tie-break the dense lowest-global-index rule.  On the
card this needs a row's tile-max score to equal its rescore score bit for
bit, which holds because both kernels compute each score as one fmaf chain
in d order (csrc/common.cuh).  The plain versions score with ``torch.matmul``.

Layouts: the pipeline keeps scores as [B, N] rows; ``select_topk_t``
keeps the JAX package's transposed [N, B] signature for callers of it.
"""

from __future__ import annotations

import functools

import torch

from two_tower_models_tpu_torch.ops import _lib

TILE = 128  # corpus rows per tile: the only tile size the CUDA kernels take
_INT_MIN = -(1 << 31)
# Longest row the select kernels hold in shared memory (int32 keys); longer
# rows are selected hierarchically (select_rows).
SELECT_MAX_ROWS = 56 * 1024
# The radix select's largest k (csrc/select_topk.cu K_MAX: its survivors'
# rank sort); larger k take the tournament kernel.
K_MAX = 1024
_SMEM_OPTIN = 232_448  # an H100 block's shared memory, opted in
_SMEM_SM = 233_472  # an H100 SM's shared memory (228 KB)
_SMEM_BLOCK_RESERVED = 1024  # the shared memory the card reserves a resident block
_TM_QUERIES = 128  # queries a tile-max block holds (csrc/tile_max.cu TQ)
_TM_DK = 64  # floats of a corpus row a tile-max ring stage holds (DK)
_RS_QW = 32  # pairs a gather-rescore work item at most (csrc/gather_rescore.cu QW)
_RADIX_STATIC = 1024  # headroom for the radix kernel's static shared memory
# Plain versions score at most this many (query, row) pairs at once.
_PLAIN_CHUNK_ELEMS = 1 << 26


def f32_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 key of f32 (``_f32_keys``): the float total order
    (-0.0 below +0.0, NaN above +inf) becomes int32 order.  Invertible by
    ``keys_f32``."""
    b = x.float().contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def keys_f32(k: torch.Tensor) -> torch.Tensor:
    b = torch.where(k < 0, k ^ 0x7FFFFFFF, k)
    return b.contiguous().view(torch.float32)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")


# ---------------------------------------------------------------------------
# Pass 1: tile maxes
# ---------------------------------------------------------------------------


def tile_max_scores_plain(query, corpus, tile, valid_count) -> torch.Tensor:
    """m[b, t] = max over tile t's rows r < min(valid_count, C) of
    <query_b, corpus_r> (-inf where none), [B, ceil(C / tile)] f32.  The max
    is taken in the select's total order (``f32_keys``: -NaN below -inf,
    +NaN above +inf), so a tile's key is at least each of its rows' keys
    whatever the scores hold, and the pipeline stays exact."""
    b, c = query.shape[0], corpus.shape[0]
    n_tiles = -(-c // tile)
    q = query.float()
    rows = max(tile, _PLAIN_CHUNK_ELEMS // max(b, 1) // tile * tile)
    out = []
    for r0 in range(0, n_tiles * tile, rows):
        s = q @ corpus[r0 : r0 + rows].float().T  # [B, <= rows]
        nr = min(rows, n_tiles * tile - r0)
        row = torch.arange(r0, r0 + nr, device=q.device)
        s = torch.nn.functional.pad(s, (0, nr - s.shape[1]))
        s = s.masked_fill((row >= min(valid_count, c))[None, :], float("-inf"))
        out.append(f32_keys(s).reshape(b, nr // tile, tile).amax(dim=-1))
    return keys_f32(torch.cat(out, dim=1))


def _padded(w: int) -> int:
    """Row stride in floats of rows of ``w`` floats in the kernels' shared
    memory (csrc/tile_max.cu, gather_rescore.cu ``padded``): an odd number
    of float4s, so eight consecutive rows start in distinct bank groups."""
    return w if (w // 4) % 2 else w + 4


def _tile_max_smem_bytes(d: int) -> int:
    """Dynamic shared memory of ``tile_max_kernel`` (csrc/tile_max.cu
    smem_bytes): 128 queries of D floats and a two-stage ring of 128 rows
    of min(D, 64) floats."""
    return 4 * (_TM_QUERIES * d + 2 * TILE * _padded(min(d, _TM_DK)))


@functools.lru_cache(maxsize=64)
def _tile_max_plan(b: int, c: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """(query blocks, corpus runs, blocks an SM, dynamic shared memory
    bytes) of a tile-max launch: a persistent grid of runs x query blocks
    of 128, as many as the card holds at once (two an SM, the kernel's
    launch bounds, where their shared memory fits: D <= 88), every query
    block of a run launched together so that they read the run's tiles
    from L2 in step.  Each run takes a contiguous share of the
    ceil(C / 128) tiles, none empty."""
    smem = _tile_max_smem_bytes(d)
    per_sm = max(1, min(2, _SMEM_SM // (smem + _SMEM_BLOCK_RESERVED)))
    n_tiles = -(-c // TILE)
    qblocks = -(-b // _TM_QUERIES)
    runs = max(1, min(n_tiles, per_sm * sms // qblocks))
    return qblocks, runs, per_sm, smem


def tile_max_scores(
    query: torch.Tensor,  # [B, D] f32
    corpus: torch.Tensor,  # [C, D] f32
    tile: int,
    valid_count: int,  # rows >= this are padding (-inf)
) -> torch.Tensor:
    """[B, NT] tile maxes (``tile_max_scores_plain``)."""
    if query.device.type == "cpu":
        return tile_max_scores_plain(query, corpus, tile, int(valid_count))
    _check_cuda("tile_max_scores", query, corpus)
    if query.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError("tile_max_scores takes f32 query and corpus")
    b, d = query.shape
    c = corpus.shape[0]
    if tile != TILE or corpus.shape[1] != d or d % 4 or not 0 < d <= 200:
        raise ValueError(f"tile_max_scores takes tile={TILE}, D % 4 == 0, D <= 200")
    q, cc = _lib.aligned(query), _lib.aligned(corpus)
    m = torch.empty((b, -(-c // tile)), dtype=torch.float32, device=q.device)
    if b and c:
        _, runs, _, _ = _tile_max_plan(b, c, d, _lib.sm_count(q.device.index))
        err = _lib.library().tt_tile_max_scores(
            q.data_ptr(), cc.data_ptr(), m.data_ptr(), b, c, d,
            min(int(valid_count), c), tile, runs, _lib.stream_ptr(q),
        )
        _lib.check(err, "tile_max_scores")
        _lib.launches["tile_max_scores"] += 1
    return m


# ---------------------------------------------------------------------------
# Passes 2 and 4: radix select (tournament for large k)
# ---------------------------------------------------------------------------


def select_keys_plain(keys: torch.Tensor, k: int):
    """Per-row top-k of int32 keys: (keys [R, k], positions [R, k] int32),
    descending, ties to the lowest position.  One ``torch.topk`` over int64
    (key << 32 | ~position) values, which are all distinct, so no tie order
    is left to the library."""
    n = keys.shape[1]
    pos = torch.arange(n, device=keys.device, dtype=torch.int64)
    comp = keys.long() * (1 << 32) + ((1 << 32) - 1 - pos)
    top = torch.topk(comp, k, dim=1, sorted=True).values
    return (top >> 32).int(), ((1 << 32) - 1 - (top & 0xFFFFFFFF)).int()


def _select_route(n: int, k: int) -> str:
    """The select kernel a row of n keys takes for its top k: "radix" when
    k <= K_MAX and the row plus the larger of one 1 KB histogram and the k
    8-byte survivors fit a block's shared memory (csrc/select_topk.cu
    tt_select_topk_radix), else "tournament"."""
    radix_smem = 4 * (n + (n & 1)) + max(1024, 8 * k)
    return "radix" if k <= K_MAX and radix_smem <= _SMEM_OPTIN - _RADIX_STATIC else "tournament"


def _select_leaf(x: torch.Tensor, k: int, is_f32: bool):
    if x.device.type == "cpu":
        keys = f32_keys(x).clamp_min(_INT_MIN + 1) if is_f32 else x
        return select_keys_plain(keys, k)
    return _launch_select(x, k, is_f32, _select_route(x.shape[1], k))


def _launch_select(x: torch.Tensor, k: int, is_f32: bool, route: str):
    """One launch of the ``route`` kernel over the rows of CUDA ``x``."""
    _check_cuda("select_rows", x)
    if x.dtype != (torch.float32 if is_f32 else torch.int32):
        raise TypeError(f"select_rows takes f32 scores or int32 keys, got {x.dtype}")
    rows, n = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"select_rows needs 1 <= k <= {n}, got {k}")
    xc = x.contiguous()
    out_key = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    out_idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows:
        lib = _lib.library()
        launch = lib.tt_select_topk_radix if route == "radix" else lib.tt_select_topk_rows
        name = "select_topk_radix" if route == "radix" else "select_topk"
        err = launch(xc.data_ptr(), out_key.data_ptr(), out_idx.data_ptr(),
                     rows, n, k, int(is_f32), _lib.stream_ptr(xc))
        _lib.check(err, name)
        _lib.launches[name] += 1
    return out_key, out_idx


def select_rows(x: torch.Tensor, k: int, is_f32: bool = True):
    """Per-row top-k of f32 scores (``is_f32``; mapped to keys clamped to
    INT32_MIN + 1) or of int32 keys: (keys [R, k] int32, positions [R, k]
    int32) in lax.top_k's total order.

    Rows longer than ``SELECT_MAX_ROWS`` run hierarchically, as the JAX
    package's ``_select_keys_t`` does: the top-k of each chunk, chunks
    concatenated in ascending position order, a final select over the
    survivors.  Bit-exact: for equal keys the lowest position in the
    concatenation is the lowest global position."""
    n = x.shape[1]
    if n <= SELECT_MAX_ROWS:
        return _select_leaf(x, k, is_f32)
    keys = f32_keys(x).clamp_min(_INT_MIN + 1) if is_f32 else x
    ch = SELECT_MAX_ROWS
    n_chunks = -(-n // ch)
    if n_chunks * k >= n:
        raise ValueError(f"k={k} is too large for a hierarchical select over {n}")
    vals, idxs = [], []
    for c0 in range(0, n, ch):
        part = keys[:, c0 : c0 + ch]
        kk = min(k, part.shape[1])
        v, i = select_rows(part, kk, is_f32=False)
        if kk < k:  # short tail chunk: pad its survivor list
            v = torch.nn.functional.pad(v, (0, k - kk), value=_INT_MIN)
            i = torch.nn.functional.pad(i, (0, k - kk))
        vals.append(v)
        idxs.append(i + c0)
    cat_i = torch.cat(idxs, dim=1)
    fv, fp = select_rows(torch.cat(vals, dim=1), k, is_f32=False)
    return fv, torch.gather(cat_i, 1, fp.long())


def select_topk_t(scores_t: torch.Tensor, k: int):
    """(values [k, B] f32, indices [k, B] int32) of the per-column top-k of
    transposed scores [NT, B]: the JAX package's ``select_topk_t``."""
    keys, idx = select_rows(scores_t.T.contiguous(), k)
    return keys_f32(keys).T, idx.T


# ---------------------------------------------------------------------------
# Pass 3: gather selected tiles + rescore
# ---------------------------------------------------------------------------


def gather_rescore_plain(query, corpus, tile_idx, tile) -> torch.Tensor:
    """cand[b, j*tile + r] = <query_b, corpus[tile_idx[b, j]*tile + r]>,
    rows past the corpus end (and every row of a negative tile index)
    scoring as zero rows.  [B, k*tile] f32."""
    b, k = tile_idx.shape
    c = corpus.shape[0]
    rows = tile_idx.long()[:, :, None] * tile + torch.arange(tile, device=tile_idx.device)
    rows = rows.reshape(b, k * tile)
    qb = max(1, _PLAIN_CHUNK_ELEMS // max(1, k * tile * corpus.shape[1]))
    out = []
    for b0 in range(0, b, qb):
        r = rows[b0 : b0 + qb]
        cand = corpus[r.clamp(0, c - 1)].float()  # [qb, k*tile, D]
        s = (cand @ query[b0 : b0 + qb].float()[:, :, None])[:, :, 0]
        out.append(torch.where((r >= 0) & (r < c), s, torch.zeros_like(s)))
    return torch.cat(out, dim=0) if out else rows.float()


def _rescore_smem_bytes(d: int) -> int:
    """Dynamic shared memory of ``rescore_kernel`` (csrc/gather_rescore.cu
    rescore_smem_bytes): a tile of 128 rows and QW queries of D floats, and
    the QW pairs' flat indices."""
    return 4 * (TILE + _RS_QW) * _padded(d) + 4 * _RS_QW


def _rescore_plan(b: int, k: int, n_tiles: int) -> tuple[int, int]:
    """(upper bound on work items, int32 scratch elements) of an inverted
    selection of b * k (query, slot) pairs over ``n_tiles`` tiles and the
    bucket of indices outside them (csrc/gather_rescore.cu).  Each non-empty
    bucket of n pairs gives ceil(n / QW) items, so with m <= min(buckets,
    b * k) non-empty buckets there are at most (b * k + m * (QW - 1)) // QW.
    The scratch holds the items (four int32 each), their count (padded to
    four), the counts and offsets of the buckets, and the pairs."""
    n, buckets = b * k, n_tiles + 1
    bound = (n + min(buckets, n) * (_RS_QW - 1)) // _RS_QW
    return bound, 4 * bound + 4 + buckets + (buckets + 1) + n


def rescore_scratch_views(scratch: torch.Tensor, b: int, k: int, n_tiles: int) -> dict:
    """The named parts of an inverted selection's scratch (``_rescore_plan``'s
    layout): items [bound, 4] (tile, first pair, pairs), n_items [1],
    counts [NT + 1], offsets [NT + 2], pairs [B * k] (flat b * k + j)."""
    bound, _ = _rescore_plan(b, k, n_tiles)
    sizes = (4 * bound, 4, n_tiles + 1, n_tiles + 2, b * k)
    items, n_items, counts, offsets, pairs = torch.split(scratch, sizes)
    return {"items": items.view(bound, 4), "n_items": n_items[:1], "counts": counts,
            "offsets": offsets, "pairs": pairs}


def invert_selection_plain(tile_idx: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """The inverted selection of ``tile_idx`` [B, k] as the kernels lay it
    out (``rescore_scratch_views``): per bucket (a tile, or ``n_tiles`` for
    an index outside [0, n_tiles)) its pairs' flat indices b * k + j in
    ascending order, and its work items of at most QW pairs.  Items past
    the count are zero."""
    b, k = tile_idx.shape
    bound, _ = _rescore_plan(b, k, n_tiles)
    dev = tile_idx.device
    t = tile_idx.reshape(-1).long()
    bucket = torch.where((t >= 0) & (t < n_tiles), t, n_tiles)
    counts = torch.bincount(bucket, minlength=n_tiles + 1)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    offsets = torch.cat([zero, counts.cumsum(0)])
    per = -(-counts // _RS_QW)
    item_off = torch.cat([zero, per.cumsum(0)])
    n_items = int(item_off[-1])
    tile_of = torch.repeat_interleave(torch.arange(n_tiles + 1, device=dev), per)
    first = offsets[tile_of] + (torch.arange(n_items, device=dev) - item_off[tile_of]) * _RS_QW
    items = torch.zeros((bound, 4), dtype=torch.long, device=dev)
    items[:n_items, 0] = tile_of
    items[:n_items, 1] = first
    items[:n_items, 2] = torch.minimum(offsets[tile_of + 1] - first,
                                       torch.full_like(first, _RS_QW))
    pairs = torch.sort(bucket * max(b * k, 1) + torch.arange(b * k, device=dev)).indices
    head = torch.tensor([n_items, 0, 0, 0], dtype=torch.long, device=dev)
    return torch.cat([items.reshape(-1), head, counts, offsets, pairs]).int()


def invert_selection(tile_idx: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Pass 3's first half: ``tile_idx`` [B, k] int32 inverted into per-tile
    lists of pairs cut into work items (``invert_selection_plain``; on the
    card the order inside a list is the atomics', which changes no score)."""
    if tile_idx.device.type == "cpu":
        return invert_selection_plain(tile_idx, n_tiles)
    _check_cuda("invert_selection", tile_idx)
    b, k = tile_idx.shape
    bound, size = _rescore_plan(b, k, n_tiles)
    tidx = tile_idx.to(torch.int32).contiguous()
    scratch = torch.empty(size, dtype=torch.int32, device=tidx.device)
    err = _lib.library().tt_gather_rescore_invert(
        tidx.data_ptr(), scratch.data_ptr(), b * k, n_tiles, bound, _lib.stream_ptr(tidx),
    )
    _lib.check(err, "gather_rescore_invert")
    _lib.launches["gather_rescore_invert"] += 1
    return scratch


def gather_rescore(
    query: torch.Tensor,  # [B, D] f32
    corpus: torch.Tensor,  # [C, D] f32
    tile_idx: torch.Tensor,  # [B, k] selected tile per query
    tile: int,
) -> torch.Tensor:
    """[B, k*tile] candidate scores (``gather_rescore_plain``): on the card,
    ``invert_selection`` and then one scoring launch over its work items."""
    if query.device.type == "cpu":
        return gather_rescore_plain(query, corpus, tile_idx, tile)
    _check_cuda("gather_rescore", query, corpus, tile_idx)
    if query.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError("gather_rescore takes f32 query and corpus")
    b, d = query.shape
    k = tile_idx.shape[1]
    if tile != TILE or corpus.shape[1] != d or d % 4 or not 0 < d <= 200 or tile_idx.shape[0] != b:
        raise ValueError(f"gather_rescore takes tile={TILE}, D % 4 == 0, D <= 200")
    q, cc = _lib.aligned(query), _lib.aligned(corpus)
    out = torch.empty((b, k * tile), dtype=torch.float32, device=q.device)
    if b and k:
        n_tiles = max(1, -(-cc.shape[0] // tile))
        scratch = invert_selection(tile_idx, n_tiles)
        err = _lib.library().tt_gather_rescore(
            q.data_ptr(), cc.data_ptr(), scratch.data_ptr(), out.data_ptr(), cc.shape[0], d, k,
            n_tiles, _rescore_plan(b, k, n_tiles)[0], tile, _lib.stream_ptr(q),
        )
        _lib.check(err, "gather_rescore")
        _lib.launches["gather_rescore"] += 1
    return out


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def mips_topk_exact_tiled(
    corpus: torch.Tensor,  # [C, D]
    query: torch.Tensor,  # [B, D]
    k: int,
    tile: int = TILE,
    valid_count: int | None = None,  # rows >= this are padding
):
    """Exact MIPS top-k through passes 1-4 (the JAX package's
    ``mips_topk_exact_pallas``): (indices [B, k] int64, scores [B, k] f32,
    embeddings [B, k, D] in the corpus dtype), equal to the dense
    ``retrieval.mips.mips_topk`` including its tie order.  Corpora too
    small for tile pruning take the dense scan."""
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk

    c, _ = corpus.shape
    b = query.shape[0]
    k = min(k, c)
    n_tiles = -(-c // tile)
    if k * tile >= c or n_tiles < k:
        return mips_topk(corpus, query, k, valid_count=valid_count)
    valid = c if valid_count is None else int(valid_count)
    q = query.float()
    cf = corpus.float()  # f32 on the path: no copy

    m = tile_max_scores(q, cf, tile, valid)  # [B, NT]
    _, tile_idx = select_rows(m, k)  # [B, k]
    # ascending tiles: the candidate pool is in global index order, so
    # pass 4's lowest-position tie-break is the dense lowest-index rule
    tile_idx = torch.sort(tile_idx, dim=1).values
    cand = gather_rescore(q, cf, tile_idx, tile)  # [B, k*tile]
    cand_gidx = (
        tile_idx.long()[:, :, None] * tile + torch.arange(tile, device=q.device)
    ).reshape(b, k * tile)
    cand = cand.masked_fill(cand_gidx >= valid, float("-inf"))
    top_keys, sel = select_rows(cand, k)
    top_idx = torch.gather(cand_gidx, 1, sel.long())
    return top_idx, keys_f32(top_keys), corpus[top_idx]
