"""The towers on a mesh, with explicit collectives (forward only).

Port of the tower part of ``two_tower_models_tpu/parallel/train_step.py``
(``:55-148``).  ``params`` is this rank's block of the model
(``parallel.sharding.shard_params``): table lookups go through the
``model``-axis exchange (``parallel.embedding``), and with ``tp`` the
feature MLPs run Megatron-split with one all-reduce over ``model``.  The
rest of that file (the sharded training step) waits for A13b.

As in JAX, ``_user_tower`` takes the user-id embedding straight from the
table; a registered user-embedding arm does not run on a mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.config import ModelConfig, resolve_kernel_flags
from two_tower_models_tpu_torch.models.history_encoder import history_encoder_apply
from two_tower_models_tpu_torch.nn.layers import linear_apply, mlp_apply, round_to
from two_tower_models_tpu_torch.parallel.embedding import sharded_embedding_lookup
from two_tower_models_tpu_torch.parallel.mesh import MODEL_AXIS

_SHARDED_TABLES = ("user_id_table", "item_id_table")


def _table_dims(cfg: ModelConfig):
    return {
        "user_id_table": cfg.user_id_embedding_dim,
        "item_id_table": cfg.item_id_embedding_dim,
    }


def check_mesh_tables(params, cfg: ModelConfig, n_model: int) -> None:
    """Each table (plain [V, D] or 128-lane-packed [Vp/P, P*D]) must split
    evenly over the model axis."""
    for name in _table_dims(cfg):
        t = getattr(params, name, None)
        if t is None:
            continue
        if t.shape[0] % n_model:
            raise ValueError(
                f"{name} has {t.shape[0]} physical rows, not divisible by the model axis "
                f"({n_model}); pad the table or change the mesh"
            )


def _lookup(params, name, ids, strategy, mesh, dim=None):
    """Embedding lookup routed through the model-axis exchange for sharded
    tables (plain or packed), a local gather for replicated ones."""
    table = getattr(params, name)
    if name in _SHARDED_TABLES:
        flat = ids.reshape(-1)
        out = sharded_embedding_lookup(table, flat, mesh.get_group(MODEL_AXIS), strategy, dim)
        return out.reshape(*ids.shape, out.shape[-1])
    return table[ids]


def _tp_mlp_apply(params, x, cd, mesh):
    """Tensor-parallel 2-layer MLP: layer 0 holds this rank's output
    columns (the activation stays local), layer 1 this rank's input rows;
    one all-reduce over ``model`` recovers the full output, the bias added
    after."""
    h = torch.relu(linear_apply(params[0], x, cd))  # [B, hidden/n] local
    y = round_to(h, cd) @ round_to(params[1].w, cd)
    dist.all_reduce(y, group=mesh.get_group(MODEL_AXIS))
    return y + params[1].b.float()


def _mlp(params, x, cd, tp: bool, mesh):
    return _tp_mlp_apply(params, x, cd, mesh) if tp else mlp_apply(params, x, cd)


def _user_tower(params, cfg: ModelConfig, mesh, user_id, user_features, user_history,
                strategy, tp=False, hist_len=None):
    """(user_emb [B, DI], ranker_embs [B, NU, DI] | None): the single-device
    ``compute_user_embedding`` over the sharded lookups."""
    cfg = resolve_kernel_flags(cfg, params.item_id_table.device)
    cd = cfg.cdtype
    uid = _lookup(params, "user_id_table", user_id, strategy, mesh, cfg.user_id_embedding_dim)
    ufeat = _mlp(params.user_features_mlp, user_features, cd, tp, mesh)
    parts = [uid, ufeat]
    if cfg.history_encoder is not None:
        hist = _lookup(params, "item_id_table", user_history, strategy, mesh,
                       cfg.item_id_embedding_dim)
        summary = history_encoder_apply(
            params.history_encoder, hist, cfg.history_encoder, cd, lengths=hist_len,
        )
        parts.append(summary.reshape(summary.shape[0], -1))
    x = torch.cat([p.float() for p in parts], dim=-1)
    user_emb = linear_apply(params.user_tower_head, x, cd)
    ranker_embs = None
    if cfg.light_ranker is not None:
        nu = cfg.light_ranker.num_ranker_user_embeddings
        flat = linear_apply(params.ranker_user_tower, x, cd)  # [B, NU*DI]
        ranker_embs = flat.reshape(flat.shape[0], nu, cfg.item_id_embedding_dim)
    return user_emb, ranker_embs


def _item_tower(params, cfg: ModelConfig, mesh, item_id, item_features, strategy, tp=False):
    cd = cfg.cdtype
    iid = _lookup(params, "item_id_table", item_id, strategy, mesh, cfg.item_id_embedding_dim)
    ifeat = _mlp(params.item_features_mlp, item_features, cd, tp, mesh)
    x = torch.cat([iid.float(), ifeat], dim=-1)
    return linear_apply(params.item_tower_head, x, cd)
