"""Sparse cross-rank embedding-table gradients.

Port of ``two_tower_models_tpu/parallel/sparse_grads.py``.  A batch touches
O(B (1 + H) + B') rows of a V-row id table, so the dense [V_shard, D]
all-reduce of a table's gradient over ``data`` is mostly zeros at large V.
The exchange instead:

  1. lists the table ids the rank's own batch rows touched (user_id for
     the user table; item_id, the history and the mixed negatives for the
     item table);
  2. sorts them, keeps the first of each distinct id that this ``model``
     rank owns, and extracts those rows from its local dense gradient (the
     dedup comes first: the dense row already sums a repeated id's
     contributions, so taking it once per occurrence would count it again);
  3. all-gathers (ids, rows) over ``data``: (n_d - 1) U (D + 1) 4 wire
     bytes a rank, against the dense all-reduce's 2 (n_d - 1) / n_d
     V_shard D 4;
  4. scatter-adds every rank's rows into one [V_shard, D] gradient through
     ``nn.layers.scatter_add_rows`` in its fixed order (B18 on the card),
     so every ``data`` rank sums the gathered rows alike and the replicas
     of a shard keep the same bits; packed shards through the logical view
     (``nn.packed_table.packed_rows_scatter_add``'s function).

The result equals the dense all-reduce up to the order of f32 sums.  The
decision is per table and a function of shapes only
(``sparse_exchange_wins``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.config import ModelConfig
from two_tower_models_tpu_torch.nn.layers import scatter_add_rows
from two_tower_models_tpu_torch.parallel.collectives import all_gather_into


def table_touched_ids(model_cfg: ModelConfig, batch) -> Dict[str, torch.Tensor]:
    """Per table, the global ids this rank's batch rows touch (duplicates
    kept: the exchange dedups).  Every id whose lookup feeds the loss is
    listed: the table gradient is the sum of the lookups' scatter rows."""
    item_ids = [batch.item_id.reshape(-1)]
    if model_cfg.history_encoder is not None:
        item_ids.append(batch.user_history.reshape(-1))
    if batch.neg_item_id is not None:
        item_ids.append(batch.neg_item_id.reshape(-1))
    return {
        "user_id_table": batch.user_id.reshape(-1),
        "item_id_table": torch.cat(item_ids),
    }


def touched_id_counts(model_cfg: ModelConfig, b_local: int) -> Dict[str, int]:
    """``table_touched_ids``' lengths from the shapes alone."""
    h = model_cfg.history_len if model_cfg.history_encoder is not None else 0
    return {
        "user_id_table": b_local,
        "item_id_table": b_local * (1 + h) + int(model_cfg.mixed_negatives),
    }


def sparse_exchange_wins(u_ids: int, v_shard: int, dim: int, n_data: int) -> bool:
    """Does the sparse exchange move fewer wire bytes than the dense
    all-reduce?  Ring costs a rank:

      dense:  all_reduce([V_shard, D] f32)        = 2 (n - 1) / n V_shard D 4
      sparse: all_gather([U] ids) + ([U, D] f32)  = (n - 1) U (D + 1) 4

    so sparse wins iff U (D + 1) n < 2 V_shard D."""
    return u_ids * (dim + 1) * n_data < 2 * v_shard * dim


def sparse_table_grad_names(model_cfg: ModelConfig, mesh_cfg, batch, params) -> set:
    """The tables whose ``data`` reduction runs sparse, by
    ``MeshConfig.sparse_table_grads`` ("auto", "on", "off"), from the
    rank's batch and its own shards (packed ones by logical rows)."""
    mode = mesh_cfg.sparse_table_grads
    if mode == "off" or mesh_cfg.data <= 1:
        return set()
    if mode not in ("auto", "on"):
        raise ValueError(f"sparse_table_grads must be auto|on|off, got {mode!r}")
    dims = {
        "user_id_table": model_cfg.user_id_embedding_dim,
        "item_id_table": model_cfg.item_id_embedding_dim,
    }
    out = set()
    for name, ids in table_touched_ids(model_cfg, batch).items():
        table, dim = getattr(params, name), dims[name]
        pack = table.shape[-1] // dim
        if mode == "on" or sparse_exchange_wins(ids.numel(), table.shape[0] * pack, dim,
                                                mesh_cfg.data):
            out.add(name)
    return out


def sparse_grad_exchange(g_dense: torch.Tensor, ids: torch.Tensor, data_group, model_group,
                         dim: int | None = None) -> torch.Tensor:
    """The sum of ``g_dense`` over ``data_group`` for a row-sharded table
    whose rank gradient lives on the rows of ``ids`` (global ids, [U]).
    Packed shards ([V_s / P, P D]) exchange logical [U, D] rows."""
    dim = dim or g_dense.shape[-1]
    rows_p, width = g_dense.shape
    pack = width // dim
    v_shard = rows_p * pack  # logical rows this shard owns
    offset = dist.get_rank(model_group) * v_shard

    s = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]  # the first of each distinct id
    local = s - offset
    keep = first & (local >= 0) & (local < v_shard)
    safe = torch.where(keep, local, 0)
    rows = g_dense.reshape(-1, dim)[safe] * keep[:, None].to(g_dense.dtype)
    # a dropped slot sends a zero row and an id out of range (dropped again)
    ex_ids = torch.where(keep, safe, v_shard).to(torch.int32)

    n = dist.get_world_size(data_group)
    gids = ex_ids.new_empty(n * ex_ids.shape[0])
    grows = rows.new_empty((n * rows.shape[0], dim))
    all_gather_into(gids, ex_ids, group=data_group)
    all_gather_into(grows, rows.contiguous(), group=data_group)
    out = scatter_add_rows(gids, grows, v_shard, capped=False, fixed_order=True)
    return out.view(rows_p, width).to(g_dense.dtype)
