"""Row-sparse (lazy-Adam) embedding-table updates.

Port of ``two_tower_models_tpu/training/sparse_tables.py``.  Dense training
differentiates through the table lookup, which materialises a [V, D]
gradient and a full Adam pass over every table each step.  This path makes
the table update cost follow the touched rows:

  1. ``build_minibatch``: sort each table's batch ids, gather the touched
     rows into a MINITABLE [N, D] (N lookups, duplicates included), and
     remap the batch's id fields to minitable slots, every duplicate to its
     id's FIRST slot, so the whole gradient of an id lands there and
     duplicate slots get exactly zero.
  2. The model's loss runs on a view of the model whose two tables are the
     minitables (``MiniTables``); nothing of either table is copied.
  3. ``apply_sparse_adam``: Adam on the touched rows only, with the bias
     correction of the global step, written back in place: packed tables
     through ``ops.rows_write.rows_write_many`` (kernel B19 on the card,
     one launch for a table and its two moments), plain ones by an
     indexed copy of every slot, each duplicate carrying its id's first
     slot's values (no kernel in the JAX package either).

This is LAZY Adam (torch's SparseAdam, TF's lazy_adam): the moments of
untouched rows do not decay between the steps that touch them.  Off by
default (``TrainConfig.lazy_table_adam``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from two_tower_models_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_models_tpu_torch.models.two_tower import Batch, TwoTowerModel
from two_tower_models_tpu_torch.nn.packed_table import _packed_gather, is_packed
from two_tower_models_tpu_torch.ops.rows_write import lane_block_plan, merge_rows, rows_write_many

SPARSE_TABLE_KEYS = ("user_id_table", "item_id_table")


def split_params(params: TwoTowerModel) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """({name: param} of the dense leaves, {name: param} of the id tables)."""
    named = dict(params.named_parameters())
    dense = {k: v for k, v in named.items() if k not in SPARSE_TABLE_KEYS}
    tables = {k: named[k] for k in SPARSE_TABLE_KEYS if k in named}
    return dense, tables


def init_table_moments(params: TwoTowerModel) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero f32 Adam moments for the tables, in each table's storage shape."""
    _, tables = split_params(params)
    zeros = lambda: {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for k, t in tables.items()}
    return {"mu": zeros(), "nu": zeros()}


class MiniTables:
    """The model with its id tables replaced by per-batch minitables:
    attribute reads fall through to the model, except the two tables.  No
    parameter is copied, and the minitables are not registered on the
    model."""

    def __init__(self, model: TwoTowerModel, tables: Dict[str, torch.Tensor]):
        self._model = model
        self._tables = tables

    def __getattr__(self, name):
        tables = self.__dict__["_tables"]
        return tables[name] if name in tables else getattr(self.__dict__["_model"], name)


@torch.no_grad()
def build_minibatch(model_cfg: ModelConfig, params: TwoTowerModel, batch: Batch):
    """(params2, batch2, meta): ``params2`` is ``MiniTables`` over minitables
    [N, D] (detached: the step makes them require grad), ``batch2`` the
    batch with its ids remapped to minitable slots, and ``meta[name]`` =
    (sorted_ids [N], dup_mask [N]), dup_mask marking slots whose id repeats
    the previous slot's."""
    user_ids = batch.user_id.reshape(-1)
    item_parts = [batch.item_id.reshape(-1)]
    if model_cfg.history_encoder is not None:
        item_parts.append(batch.user_history.reshape(-1))  # history embeds through the item table
    if batch.neg_item_id is not None:
        item_parts.append(batch.neg_item_id.reshape(-1))
    item_ids = torch.cat(item_parts)
    dims = {"user_id_table": model_cfg.user_id_embedding_dim,
            "item_id_table": model_cfg.item_id_embedding_dim}
    tables, meta = {}, {}

    def prep(name, ids):
        """Sort, gather the minitable, and remap every occurrence to the
        first sorted slot of its id (the sort's inverse permutation, pushed
        to each run's first slot by one cummax)."""
        n = ids.shape[0]
        order = torch.argsort(ids, stable=True)
        s = ids[order]
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=s.device), s[1:] == s[:-1]])
        iota = torch.arange(n, device=s.device)
        first_sorted = torch.cummax(torch.where(dup, -1, iota), 0).values
        inv = torch.empty_like(order)
        inv[order] = iota
        table = getattr(params, name)
        if is_packed(table, dims[name]):
            tables[name] = _packed_gather(table, s, dims[name])
        else:
            tables[name] = table[s]
        meta[name] = (s, dup)
        return first_sorted[inv]

    remap_user = prep("user_id_table", user_ids)
    remap_item = prep("item_id_table", item_ids)
    b = batch.item_id.shape[0]
    batch2 = batch._replace(user_id=remap_user.reshape(batch.user_id.shape),
                            item_id=remap_item[:b])
    off = b
    if model_cfg.history_encoder is not None:
        h = batch.user_history.numel()
        batch2 = batch2._replace(
            user_history=remap_item[off:off + h].reshape(batch.user_history.shape))
        off += h
    if batch.neg_item_id is not None:
        batch2 = batch2._replace(neg_item_id=remap_item[off:].reshape(batch.neg_item_id.shape))
    return MiniTables(params, tables), batch2, meta


@torch.no_grad()
def apply_sparse_adam(
    table: torch.Tensor,  # [V, D] or packed
    mu: torch.Tensor,  # f32, the table's shape
    nu: torch.Tensor,
    mini_rows: torch.Tensor,  # [N, D]: rows gathered by build_minibatch
    g_mini: torch.Tensor,  # [N, D]: gradient wrt the minitable
    sorted_ids: torch.Tensor,  # [N]
    dup_mask: torch.Tensor,  # [N] bool
    t: torch.Tensor,  # scalar: the global step after this update
    train_cfg: TrainConfig,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """One lazy-Adam update of the touched rows, in place on ``table``,
    ``mu`` and ``nu`` (returned): optax.adam's arithmetic per touched row,
    bias-corrected by the global step; duplicate slots (zero gradient) write
    their first slot's values, which hold the id's whole gradient."""
    d = g_mini.shape[-1]
    g = g_mini.float()
    packed = is_packed(table, d)
    if packed:
        rows_mu = _packed_gather(mu, sorted_ids, d)
        rows_nu = _packed_gather(nu, sorted_ids, d)
    else:
        rows_mu, rows_nu = mu[sorted_ids], nu[sorted_ids]
    mu2 = b1 * rows_mu + (1.0 - b1) * g
    nu2 = b2 * rows_nu + (1.0 - b2) * (g * g)
    t = t.float()
    mu_hat = mu2 / (1.0 - b1 ** t)
    nu_hat = nu2 / (1.0 - b2 ** t)
    upd = train_cfg.learning_rate * mu_hat / (torch.sqrt(nu_hat) + eps)
    new_rows = mini_rows.float() - upd

    if packed:
        # one plan serves the three row arrays: it depends on the ids only
        plan = lane_block_plan(sorted_ids, dup_mask, table.shape[-1] // d)
        vals = [merge_rows(plan, sorted_ids, r) for r in (new_rows.to(table.dtype), mu2, nu2)]
        rows_write_many((table, mu, nu), plan[0], plan[1], vals, block_dim=d)
        return table, mu, nu
    # every slot writes its run's first slot's values, so a duplicate id is
    # written the same bits whichever write lands last, and no boolean mask
    # (whose size the host would wait for) is needed
    iota = torch.arange(dup_mask.shape[0], device=dup_mask.device)
    head = torch.cummax(torch.where(dup_mask, -1, iota), 0).values
    ids = sorted_ids.long()
    table.index_copy_(0, ids, new_rows[head].to(table.dtype))
    mu.index_copy_(0, ids, mu2[head])
    nu.index_copy_(0, ids, nu2[head])
    return table, mu, nu
