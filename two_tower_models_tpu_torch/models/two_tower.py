"""Two-tower retrieval model: parameters, towers and inference.

Port of the serving half of ``two_tower_models_tpu/models/two_tower.py``.
``TwoTowerModel`` holds every parameter leaf of the JAX params pytree for
any of the 8 presets, under the pytree's own path names
(``history_encoder.attn_layers.0.in_proj.w``), so the weight bridge
(``bridge.py``) is a mechanical flatten.  The towers are plain functions of
(model, cfg, inputs), like their JAX counterparts.

Not in this slice, and raising ``NotImplementedError`` rather than taking
another path: the light-ranker rerank, ``approx_mips``, a quantized corpus,
user-embedding arms other than the id table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from two_tower_models_tpu_torch.config import (
    Debias,
    ModelConfig,
    resolve_device,
    resolve_kernel_flags,
)
from two_tower_models_tpu_torch.models.history_encoder import (
    HistoryEncoder,
    history_encoder_apply,
)
from two_tower_models_tpu_torch.nn.layers import (
    MLP,
    Linear,
    embedding_init,
    linear_apply,
    mlp_apply,
    table_lookup,
)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue A, '{item}')"
    )


class TwoTowerModel(nn.Module):
    """All parameters of one config point, named as in the JAX pytree.
    Built empty; ``init_params`` draws the weights, ``bridge.params_from_jax``
    copies them in."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        if cfg.user_embedding_arm != "table":
            raise _not_ported(
                f"user_embedding_arm {cfg.user_embedding_arm!r}", "Other zoo variants"
            )
        dt = cfg.pdtype
        du, di = cfg.user_id_embedding_dim, cfg.item_id_embedding_dim
        kw = dict(dtype=dt, device=device)
        self.user_id_table = nn.Parameter(torch.empty(cfg.user_id_hash_size, du, **kw))
        self.user_features_mlp = MLP(
            (cfg.user_features_size, cfg.feature_hidden_dim, du), dt, device
        )
        self.user_tower_head = Linear(cfg.user_tower_input_dim, di, dt, device)
        self.item_id_table = nn.Parameter(torch.empty(cfg.item_id_hash_size, di, **kw))
        self.item_features_mlp = MLP(
            (cfg.item_features_size, cfg.feature_hidden_dim, di), dt, device
        )
        self.item_tower_head = Linear(2 * di, di, dt, device)
        if cfg.history_encoder is not None:
            self.history_encoder = HistoryEncoder(di, cfg.history_encoder, dt, device)
        if cfg.debias in (Debias.POSITION, Debias.BOTH):
            self.position_bias_table = nn.Parameter(
                torch.empty(cfg.position_table_size, 1, **kw)
            )
        if cfg.debias == Debias.USER:
            self.user_debias_head = Linear(di, 1, dt, device)
        if cfg.debias == Debias.BOTH:
            self.user_debias_head = Linear(di + 1, 1, dt, device)
        if cfg.light_ranker is not None:
            nu = cfg.light_ranker.num_ranker_user_embeddings
            t_out = cfg.num_tasks * (2 if cfg.kd else 1)
            self.ranker_user_tower = Linear(cfg.user_tower_input_dim, nu * di, dt, device)
            self.light_ranker_head = Linear(2 * di + nu + 1, t_out, dt, device)
        if cfg.reward_model:
            self.proxy_ranker = Linear(2 * di + 1, cfg.num_tasks, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: tables N(0, 1), linear layers
        U(+-1/sqrt(fan_in)), attention Xavier-uniform with zero biases."""
        for child in self.children():
            child.reset_parameters(generator)
        for p in self.parameters(recurse=False):
            embedding_init(p, generator)


def init_params(seed, cfg: ModelConfig, device="cuda") -> TwoTowerModel:
    """Build and initialise the model for ``cfg`` on ``device`` from a seed
    (int) or a ``torch.Generator`` on that device."""
    dev = resolve_device(device)
    model = TwoTowerModel(cfg, dev)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    model.reset_parameters(gen)
    return model


def get_user_embedding(params: TwoTowerModel, cfg: ModelConfig, user_id) -> torch.Tensor:
    """User-ID memorization arm [B, DU]: the id-table lookup."""
    return table_lookup(params.user_id_table, user_id, cfg.user_id_embedding_dim)


def user_tower_input(
    params: TwoTowerModel, cfg: ModelConfig, user_id, user_features, user_history,
    history_len=None,
) -> torch.Tensor:
    """[B, 2*DU] (id embedding ++ feature MLP), widened to [B, 2*DU + 2*DI]
    by the history summary when the encoder is on."""
    cfg = resolve_kernel_flags(cfg, params.item_id_table.device)
    cd = cfg.cdtype
    parts = [
        get_user_embedding(params, cfg, user_id),
        mlp_apply(params.user_features_mlp, user_features, cd),
    ]
    if cfg.history_encoder is not None:
        # history ids embed through the item table
        hist_emb = table_lookup(
            params.item_id_table, user_history, cfg.item_id_embedding_dim
        )  # [B, H, DI]
        summary = history_encoder_apply(
            params.history_encoder, hist_emb, cfg.history_encoder, cd,
            lengths=history_len,
        )  # [B, 2, DI]
        parts.append(summary.reshape(summary.shape[0], -1))
    return torch.cat([p.float() for p in parts], dim=-1)


def compute_user_embedding(
    params: TwoTowerModel, cfg: ModelConfig, user_id, user_features, user_history,
    history_len=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MIPS query [B, DI]; plus the light ranker's [B, NU, DI] user
    embeddings when that head is on."""
    x = user_tower_input(params, cfg, user_id, user_features, user_history, history_len)
    user_emb = linear_apply(params.user_tower_head, x, cfg.cdtype)
    ranker_embs = None
    if cfg.light_ranker is not None:
        nu = cfg.light_ranker.num_ranker_user_embeddings
        flat = linear_apply(params.ranker_user_tower, x, cfg.cdtype)
        ranker_embs = flat.reshape(flat.shape[0], nu, cfg.item_id_embedding_dim)
    return user_emb, ranker_embs


def compute_item_embeddings(
    params: TwoTowerModel, cfg: ModelConfig, item_id, item_features
) -> torch.Tensor:
    """Item tower [B, DI] f32."""
    cd = cfg.cdtype
    iid_emb = table_lookup(params.item_id_table, item_id, cfg.item_id_embedding_dim)
    ifeat_emb = mlp_apply(params.item_features_mlp, item_features, cd)
    x = torch.cat([iid_emb.float(), ifeat_emb], dim=-1)
    return linear_apply(params.item_tower_head, x, cd)


def retrieve_from_embeddings(
    params: TwoTowerModel,
    cfg: ModelConfig,
    user_emb: torch.Tensor,  # [B, DI]
    ranker_embs: Optional[torch.Tensor],
    topk_fn,  # (query [B, DI], k) -> (indices, scores, embeddings)
) -> torch.Tensor:
    """Top ``cfg.num_items`` indices [B, num_items] from user embeddings."""
    if cfg.light_ranker is not None:
        raise _not_ported("the light-ranker rerank", "Other zoo variants")
    indices, _, _ = topk_fn(user_emb, cfg.num_items)
    return indices


def _on(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def retrieve(
    params: TwoTowerModel,
    cfg: ModelConfig,
    corpus: torch.Tensor,  # [C, DI]
    user_id,
    user_features,
    user_history,
    history_len=None,
    device="cuda",
) -> torch.Tensor:
    """Inference: top ``cfg.num_items`` corpus indices per user
    [B, num_items] (int64), by the exact tile-max MIPS pipeline.  The model
    and corpus must already be on ``device``; the inputs are moved there."""
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact

    dev = resolve_device(device)
    if not isinstance(corpus, torch.Tensor):
        raise _not_ported(f"a {type(corpus).__name__} corpus (int8)", "Approximate and int8 MIPS")
    if cfg.approx_mips:
        raise _not_ported("approx_mips", "Approximate and int8 MIPS")
    for name, t in (("model", params.item_id_table), ("corpus", corpus)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    cfg = resolve_kernel_flags(cfg, dev)
    with torch.inference_mode():
        user_emb, ranker_embs = compute_user_embedding(
            params, cfg, _on(user_id, dev), _on(user_features, dev).float(),
            _on(user_history, dev),
            None if history_len is None else _on(history_len, dev),
        )
        return retrieve_from_embeddings(
            params, cfg, user_emb, ranker_embs,
            lambda q, k: mips_topk_exact(corpus, q, k),
        )
