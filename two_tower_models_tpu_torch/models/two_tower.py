"""Two-tower retrieval model: parameters, towers, training loss, inference.

Port of ``two_tower_models_tpu/models/two_tower.py``.
``TwoTowerModel`` holds every parameter leaf of the JAX params pytree for
any of the 8 presets, under the pytree's own path names
(``history_encoder.attn_layers.0.in_proj.w``), so the weight bridge
(``bridge.py``) is a mechanical flatten.  The towers are plain functions of
(model, cfg, inputs), like their JAX counterparts, and cover all eight
presets: the light ranker's train terms and rerank, KD, the reward model
and registered user-embedding arms included.  ``retrieve`` serves from an
f32 corpus (the exact tile-max pipeline, or ``approx_mips``'s approximate
top-k) or from an int8 ``QuantizedCorpus`` (``retrieval/quant.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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
    embedding_lookup,
    linear_apply,
    mlp_apply,
)
from two_tower_models_tpu_torch.nn.packed_table import table_lookup
from two_tower_models_tpu_torch.ops.fused_softmax import fused_in_batch_ce, fused_lse


class Batch(NamedTuple):
    """One training or inference batch (the JAX package's ``Batch``)."""

    user_id: torch.Tensor  # [B] int
    user_features: torch.Tensor  # [B, IU]
    user_history: torch.Tensor  # [B, H] int, newest first
    item_id: Optional[torch.Tensor] = None  # [B] (training only)
    item_features: Optional[torch.Tensor] = None  # [B, II] (training only)
    position: Optional[torch.Tensor] = None  # [B] (training only)
    labels: Optional[torch.Tensor] = None  # [B, T]
    history_len: Optional[torch.Tensor] = None  # [B] valid history lengths
    # mixed negatives and the logQ correction (training.data.extend_batch)
    neg_item_id: Optional[torch.Tensor] = None  # [B'] extra catalog negatives
    neg_item_features: Optional[torch.Tensor] = None  # [B', II]
    item_logq: Optional[torch.Tensor] = None  # [B] log proposal probability
    neg_logq: Optional[torch.Tensor] = None  # [B']


# The mixed negatives' [B'] fields: candidates every rank of a mesh scores
# alike, not rows of the batch, so they replicate over ``data``.
REPLICATED_BATCH_FIELDS = frozenset({"neg_item_id", "neg_item_features", "neg_logq"})


class TwoTowerModel(nn.Module):
    """All parameters of one config point, named as in the JAX pytree.
    Built empty; ``init_params`` draws the weights, ``bridge.params_from_jax``
    copies them in.  A registered user-embedding arm's module sits at
    ``user_embedding_ext``, where the JAX package keeps its subtree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
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
        _, ext_init = _USER_EMBEDDING_ARMS[cfg.user_embedding_arm]
        self._ext = None
        if ext_init is not None:
            self._ext = (ext_init, cfg)
            self.user_embedding_ext = ext_init(_seeded(device, 0), cfg, device)
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
        U(+-1/sqrt(fan_in)), attention Xavier-uniform with zero biases; a
        user-embedding arm's module takes the values its ``init_fn`` draws
        from ``generator``."""
        for name, child in self.named_children():
            if name == "user_embedding_ext":
                ext_init, cfg = self._ext
                drawn = dict(ext_init(generator, cfg, generator.device).named_parameters())
                with torch.no_grad():
                    for n, p in child.named_parameters():
                        p.copy_(drawn[n])
            else:
                child.reset_parameters(generator)
        for p in self.parameters(recurse=False):
            embedding_init(p, generator)


def _seeded(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    return gen


def init_params(seed, cfg: ModelConfig, device="cuda") -> TwoTowerModel:
    """Build and initialise the model for ``cfg`` on ``device`` from a seed
    (int) or a ``torch.Generator`` on that device."""
    dev = resolve_device(device)
    model = TwoTowerModel(cfg, dev)
    gen = seed if isinstance(seed, torch.Generator) else _seeded(dev, int(seed))
    model.reset_parameters(gen)
    return model


# The user-ID memorization arm is an extension point, as in the JAX package
# (``register_user_embedding_arm`` there): register a named arm and select
# it with ``ModelConfig.user_embedding_arm``.
#
#     def my_init(generator, cfg, device) -> nn.Module   # -> model.user_embedding_ext
#     def my_apply(model, cfg, user_id) -> [B, DU]        # the whole model in
#     register_user_embedding_arm("mine", my_apply, my_init)
#
# ``my_init`` builds the module on ``device`` and draws its weights from
# ``generator``; its parameter names follow the JAX subtree's paths, so
# ``user_embedding_ext.proj.w`` crosses the weight bridge like any leaf.  An
# arm trains end to end through autograd.  The default arm is the id-table
# lookup.
_USER_EMBEDDING_ARMS: Dict[str, tuple] = {}


def register_user_embedding_arm(name: str, apply_fn, init_fn=None) -> None:
    """apply_fn(model, cfg, user_id) -> [B, DU]; optional init_fn(generator,
    cfg, device) returns the ``nn.Module`` held at
    ``model.user_embedding_ext``."""
    _USER_EMBEDDING_ARMS[name] = (apply_fn, init_fn)


def _default_user_embedding(params: TwoTowerModel, cfg: ModelConfig, user_id) -> torch.Tensor:
    return table_lookup(params.user_id_table, user_id, cfg.user_id_embedding_dim)


register_user_embedding_arm("table", _default_user_embedding)


def get_user_embedding(params: TwoTowerModel, cfg: ModelConfig, user_id) -> torch.Tensor:
    """User-ID memorization arm [B, DU]; dispatches on
    ``cfg.user_embedding_arm``."""
    apply_fn, _ = _USER_EMBEDDING_ARMS[cfg.user_embedding_arm]
    return apply_fn(params, cfg, user_id)


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


def _clip_min(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.clip(x, min=lo)`` with JAX's gradient: half to each side at a
    tie (``torch.clamp_min`` would pass all of it to ``x``).  The bound is
    filled on the device: a tensor copied from the host would synchronise
    the stream."""
    return torch.maximum(x, x.new_full((), lo))


def debias_net_user_value(
    params: TwoTowerModel,
    cfg: ModelConfig,
    net_user_value: torch.Tensor,  # [B]
    position: torch.Tensor,  # [B]
    user_embedding: torch.Tensor,  # [B, DI]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re-weighted nuv, aux loss), with the three heads' different clamp
    and MSE orders: POSITION takes the MSE of the raw estimate, then clamps;
    USER clamps first and takes the MSE of the clamped estimate; BOTH takes
    both raw MSEs and divides by the clamped user estimate.  The position
    table's gradient sums in a fixed order (B18 on the card), so a step is
    bit-equal on repeat with the default algorithms."""
    zero = net_user_value.new_zeros((), dtype=torch.float32)
    if cfg.debias == Debias.NONE:
        return net_user_value, zero
    if cfg.debias == Debias.POSITION:
        est = embedding_lookup(params.position_bias_table, position, fixed_order=True)[:, 0]
        aux = torch.sum((est - net_user_value) ** 2)
        return net_user_value / _clip_min(est, cfg.position_debias_min), aux
    if cfg.debias == Debias.USER:
        est = _clip_min(linear_apply(params.user_debias_head, user_embedding)[:, 0],
                        cfg.user_debias_min)
        aux = torch.sum((est - net_user_value) ** 2)
        return net_user_value / est, aux
    e_pos = embedding_lookup(params.position_bias_table, position, fixed_order=True)  # [B, 1]
    e_user = linear_apply(
        params.user_debias_head,
        torch.cat([user_embedding, e_pos.to(user_embedding.dtype)], dim=-1),
    )[:, 0]
    aux_pos = torch.sum((e_pos[:, 0] - net_user_value) ** 2)
    aux_user = torch.sum((e_user - net_user_value) ** 2)
    e_user = _clip_min(e_user, cfg.combined_debias_min)
    return net_user_value / e_user, aux_user + aux_pos


def _in_batch_ce(scores: torch.Tensor) -> torch.Tensor:
    """Per-row CE of the [B, B] logits against the diagonal."""
    scores = scores.float()
    return torch.logsumexp(scores, dim=-1) - torch.diagonal(scores)


def _extended_pool(
    item_embeddings: torch.Tensor,  # [B, DI]
    neg_item_embeddings: Optional[torch.Tensor],  # [B', DI]
    item_logq: Optional[torch.Tensor],  # [B]
    neg_logq: Optional[torch.Tensor],  # [B']
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate pool [B + B', DI] (in-batch items, then the mixed
    negatives) and its corrections [B + B'], f32, zero where a field is
    absent.  The corrections are rounded to the pool's dtype and back, as
    the fused route's appended column must be, so every route applies the
    same values (a no-op for the towers' f32 embeddings)."""
    b = item_embeddings.shape[0]
    pool = item_embeddings
    corr = item_embeddings.new_zeros(b, dtype=torch.float32) if item_logq is None else item_logq
    corr = corr.float()
    if neg_item_embeddings is not None:
        pool = torch.cat([pool, neg_item_embeddings.to(pool.dtype)])
        n_neg = neg_item_embeddings.shape[0]
        corr = torch.cat([corr, corr.new_zeros(n_neg) if neg_logq is None else neg_logq.float()])
    return pool, corr.to(pool.dtype).float()


def logq_operands(user_embedding: torch.Tensor, pool: torch.Tensor,
                  corr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused route's operands of ``fused_lse``, f32: [u, 1] [B, DI + 1]
    and [pool, -corr] [C, DI + 1], whose products are s_bj - corr_j."""
    ones = user_embedding.new_ones(user_embedding.shape[0], 1)
    aug_u = torch.cat([user_embedding, ones], dim=1)
    aug_pool = torch.cat([pool, (-corr)[:, None].to(pool.dtype)], dim=1)
    return aug_u.float(), aug_pool.float()


def _extended_ce(
    cfg: ModelConfig,
    user_embedding: torch.Tensor,  # [B, DI]
    item_embeddings: torch.Tensor,  # [B, DI]
    scores: Optional[torch.Tensor],  # [B, B] precomputed logits, or None
    neg_item_embeddings: Optional[torch.Tensor],  # [B', DI] mixed negatives
    item_logq: Optional[torch.Tensor],  # [B]
    neg_logq: Optional[torch.Tensor],  # [B']
) -> torch.Tensor:
    """Per-row CE [B] over the extended candidate pool [in-batch items; mixed
    negatives] with the optional logQ correction: ce_b = lse_j(s_bj -
    logq_j) - (s_bb - logq_b).

    ``cfg.fused_loss`` folds -logq into one extra feature column
    (``logq_operands``), [u, 1] . [pool_j, -logq_j] = s_bj - logq_j, so
    ``fused_lse`` (B10, then B11 + B12 without the diagonal, at C = B + B'
    and D = DI + 1 on the card) runs unchanged and the [B, C] scores never
    reach memory; otherwise the logits materialise.  Precomputed ``scores``
    (the reward model's, which already holds the [B, B] logits) take the
    diagonal as the positive and get the mixed negatives' logits appended,
    whatever ``cfg.fused_loss`` says."""
    b = user_embedding.shape[0]
    pool, corr = _extended_pool(item_embeddings, neg_item_embeddings, item_logq, neg_logq)
    if scores is not None:
        full = scores.float()
        pos = torch.diagonal(full) - corr[:b]
        if neg_item_embeddings is not None:
            full = torch.cat([full, user_embedding.float() @ neg_item_embeddings.float().T], dim=1)
        return torch.logsumexp(full - corr[None, :], dim=-1) - pos
    pos = (user_embedding.float() * item_embeddings.float()).sum(-1) - corr[:b]
    if cfg.fused_loss:
        return fused_lse(*logq_operands(user_embedding, pool, corr)) - pos
    full = user_embedding.float() @ pool.float().T - corr[None, :]
    return torch.logsumexp(full, dim=-1) - pos


def _value_weights(cfg: ModelConfig, device) -> torch.Tensor:
    """``user_value_weights`` [T] f32 on ``device``, copied without waiting
    for the device."""
    return torch.tensor(cfg.user_value_weights, dtype=torch.float32).to(device, non_blocking=True)


def _net_user_value(cfg: ModelConfig, labels: torch.Tensor) -> torch.Tensor:
    """nuv = labels @ user_value_weights over the first T tasks, [B]."""
    return labels[:, : cfg.num_tasks].float() @ _value_weights(cfg, labels.device)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy with logits, the JAX package's formula
    with its gradients at a logit of 0: ``jnp.maximum`` splits its gradient
    at the tie (so does ``torch.maximum``), and ``jnp.abs``'s gradient there
    is 1 (``torch.abs``'s is 0, so |x| is a ``where``).
    ``F.binary_cross_entropy_with_logits`` rounds otherwise."""
    logits, targets = logits.float(), targets.float()
    abs_logits = torch.where(logits >= 0, logits, -logits)
    per = _clip_min(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-abs_logits))
    return torch.mean(per)


def example_weights(
    params: TwoTowerModel, cfg: ModelConfig, user_embedding, position, labels,
    max_normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-example CE weights [B], debias aux loss): nuv, the debias hook,
    the clamp at ``nuv_min`` and the normalisation by the batch max (``amax``
    splits its gradient among tied maxima, as ``jnp.max`` does)."""
    nuv = _net_user_value(cfg, labels)
    nuv, aux_loss = debias_net_user_value(params, cfg, nuv, position, user_embedding)
    aux_loss = aux_loss * cfg.debias_aux_weight
    nuv = _clip_min(nuv, cfg.nuv_min)
    if max_normalize:
        nuv = nuv / torch.amax(nuv)
    return nuv, aux_loss


def retrieval_ce(
    cfg: ModelConfig,
    user_embedding: torch.Tensor,  # [B, DI]
    item_embeddings: torch.Tensor,  # [B, DI]
    scores: Optional[torch.Tensor] = None,  # [B, B] precomputed logits
    neg_item_embeddings: Optional[torch.Tensor] = None,  # [B', DI]
    item_logq: Optional[torch.Tensor] = None,  # [B]
    neg_logq: Optional[torch.Tensor] = None,  # [B']
) -> torch.Tensor:
    """Per-row in-batch softmax CE [B] against the diagonal: over the
    extended pool (``_extended_ce``) with mixed negatives or logQ, on
    precomputed ``scores``, through ``fused_in_batch_ce`` (B10-B12 on the
    card) with ``cfg.fused_loss``, else on materialised [B, B] logits."""
    if neg_item_embeddings is not None or item_logq is not None:
        return _extended_ce(cfg, user_embedding, item_embeddings, scores,
                            neg_item_embeddings, item_logq, neg_logq)
    if scores is not None:
        return _in_batch_ce(scores)
    if cfg.fused_loss:
        return fused_in_batch_ce(user_embedding, item_embeddings)[0]
    return _in_batch_ce(user_embedding.float() @ item_embeddings.float().T)


def softmax_retrieval_loss(
    params: TwoTowerModel,
    cfg: ModelConfig,
    user_embedding: torch.Tensor,  # [B, DI]
    item_embeddings: torch.Tensor,  # [B, DI]
    position: torch.Tensor,  # [B]
    labels: torch.Tensor,  # [B, T]
    *,
    max_normalize: bool = True,
    scores: Optional[torch.Tensor] = None,
    neg_item_embeddings: Optional[torch.Tensor] = None,
    item_logq: Optional[torch.Tensor] = None,
    neg_logq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled-softmax loss weighted by the (debiased) net user
    value, plus the debias aux loss.  Precomputed [B, B] ``scores`` are used
    as they are; otherwise ``cfg.fused_loss`` takes ``fused_in_batch_ce``
    (kernels B10-B12 on the card), or the [B, B] logits materialise.
    ``max_normalize=False`` (the light ranker's retrieval term) skips the
    division by the batch max.  ``neg_item_embeddings`` appends B' mixed negatives
    to every row's candidates and ``item_logq``/``neg_logq`` subtract each
    candidate's log proposal probability from its logit, positives included
    (``_extended_ce``).  On a mesh the loss is
    ``parallel.train_step.sharded_loss_fn``'s."""
    ce = retrieval_ce(cfg, user_embedding, item_embeddings, scores, neg_item_embeddings,
                      item_logq, neg_logq)
    nuv, aux_loss = example_weights(params, cfg, user_embedding, position, labels, max_normalize)
    loss = torch.mean(ce * nuv) + aux_loss
    metrics = {
        "softmax_ce": torch.mean(ce),
        "debias_aux_loss": aux_loss,
        "nuv_mean": torch.mean(nuv),
    }
    return loss, metrics


def _light_ranker_train_terms(
    params: TwoTowerModel,
    cfg: ModelConfig,
    ranker_user_embs: torch.Tensor,  # [B, NU, DI]
    item_embeddings: torch.Tensor,  # [B, DI]
    mips_scores_diag: torch.Tensor,  # [B]: the diagonal of the retrieval logits
    labels: torch.Tensor,  # [B, T], [B, 2T] under KD
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pointwise light-ranker loss on the impressed item: target-aware
    attention of the item over the NU ranker embeddings, the features
    [item, attended user, NU scores, MIPS score] [B, 2*DI + NU + 1], the
    head's T task logits and their BCE against the hard labels; under KD,
    ``kd_loss_weight`` times the BCE of the T aux logits against the soft
    labels ``labels[:, T:2T]``.  Every product is f32 on f32 operands (the
    towers' outputs are f32, so JAX's cast of the probabilities to the
    ranker embeddings' dtype is a no-op)."""
    t = cfg.num_tasks
    r = ranker_user_embs.float()
    items = item_embeddings.float()
    ranker_scores = torch.einsum("bnd,bd->bn", r, items)  # [B, NU]
    probs = torch.softmax(ranker_scores, dim=-1)
    ta_user = torch.einsum("bn,bnd->bd", probs, r)  # [B, DI]
    feat = torch.cat([items, ta_user, ranker_scores, mips_scores_diag[:, None].float()], dim=-1)
    task_logits = linear_apply(params.light_ranker_head, feat)  # [B, T or 2T]
    bce = _bce_with_logits(task_logits[:, :t], labels[:, :t])
    metrics = {"light_ranker_bce": bce}
    loss = bce
    if cfg.kd:
        kd_loss = _bce_with_logits(task_logits[:, t : 2 * t], labels[:, t : 2 * t])
        loss = loss + cfg.kd_loss_weight * kd_loss
        metrics["kd_loss"] = kd_loss
    return loss, metrics


def _reward_model_terms(
    params: TwoTowerModel,
    cfg: ModelConfig,
    user_embedding: torch.Tensor,  # [B, DI]
    item_embeddings: torch.Tensor,  # [B, DI]
    scores: torch.Tensor,  # [B, C] retrieval logits
    labels: torch.Tensor,  # [B, T]
    candidates: Optional[torch.Tensor] = None,  # [C, DI]: the items of scores' columns
    pos: Optional[torch.Tensor] = None,  # [B]: each row's impressed pair's score
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ranker-as-reward-model alignment: ``reward_model_loss_weight`` times
    KL(ranker top probs || softmax(retrieval logits)), plus the proxy
    ranker's BCE on the impressed (diagonal) pairs.  The columns default to
    the batch's own items and the impressed scores to the diagonal; on a
    mesh they are the global batch's items and the rank's own pairs
    (``parallel.train_step._sharded_reward_model_terms``).

    The proxy's pairwise linear over [u_b, i_j, s_bj] is decomposed over
    its weight's segments [Wu; Wi; ws], and the task axis collapses into the
    value weights first:

        vm[b, j] = u_b @ (Wu @ uvw) + i_j @ (Wi @ uvw) + s_bj (ws . uvw) + b . uvw

    so no [B, B, T] tensor exists.  The ranker's probabilities take no
    gradient (JAX's ``stop_gradient``), so they are computed without
    autograd and keep no [B, B] tensor for the backward."""
    w_full = params.proxy_ranker.w.float()  # [2*DI + 1, T]
    b_full = params.proxy_ranker.b.float()  # [T]
    di = cfg.item_id_embedding_dim
    wu, wi, ws = w_full[:di], w_full[di : 2 * di], w_full[2 * di]
    u32, i32, s32 = user_embedding.float(), item_embeddings.float(), scores.float()
    c32 = i32 if candidates is None else candidates.float()
    uvw = _value_weights(cfg, s32.device)
    with torch.no_grad():
        ranker_vm = ((u32 @ (wu @ uvw))[:, None] + (c32 @ (wi @ uvw))[None, :]
                     + s32 * torch.dot(ws, uvw) + torch.dot(b_full, uvw))  # [B, C]
        ranker_top_probs = torch.softmax(ranker_vm, dim=-1)
        log_p = torch.log(ranker_top_probs.clamp_min(1e-30))
        del ranker_vm
    log_q = torch.log_softmax(s32, dim=-1)  # the retrieval distribution
    kl = torch.mean(torch.sum(ranker_top_probs * (log_p - log_q), dim=-1))
    pos = torch.diagonal(s32) if pos is None else pos
    diag_logits = u32 @ wu + i32 @ wi + pos[:, None] * ws[None, :] + b_full
    proxy_bce = _bce_with_logits(diag_logits, labels[:, : cfg.num_tasks])
    loss = cfg.reward_model_loss_weight * kl + proxy_bce
    return loss, {"reward_kl": kl, "proxy_ranker_bce": proxy_bce}


def train_loss(
    params: TwoTowerModel, cfg: ModelConfig, batch: Batch
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss and metrics for any of the eight presets, with
    the batch's mixed negatives (embedded by the item tower, as any item)
    and logQ fields when ``training.data.extend_batch`` filled them: the
    retrieval term (without the max normalisation under the light ranker)
    plus the light ranker's BCE and KD terms, or the reward model's KL and
    proxy BCE.  The [B, B] f32 logits materialise only for the reward
    model, whose loss takes them precomputed.  AUTO kernel flags resolve on
    the device of the params."""
    cfg = resolve_kernel_flags(cfg, params.item_id_table.device)
    user_emb, ranker_embs = compute_user_embedding(
        params, cfg, batch.user_id, batch.user_features, batch.user_history,
        batch.history_len,
    )
    item_embs = compute_item_embeddings(params, cfg, batch.item_id, batch.item_features)
    scores = user_emb.float() @ item_embs.float().T if cfg.reward_model else None
    neg_embs = (
        compute_item_embeddings(params, cfg, batch.neg_item_id, batch.neg_item_features)
        if batch.neg_item_id is not None
        else None
    )
    sampling_kw = dict(neg_item_embeddings=neg_embs, item_logq=batch.item_logq,
                       neg_logq=batch.neg_logq)
    if cfg.light_ranker is not None:
        loss, metrics = softmax_retrieval_loss(
            params, cfg, user_emb, item_embs, batch.position, batch.labels,
            max_normalize=False, scores=scores, **sampling_kw,
        )
        diag = (torch.diagonal(scores) if scores is not None
                else (user_emb.float() * item_embs.float()).sum(-1))
        lr_loss, lr_metrics = _light_ranker_train_terms(
            params, cfg, ranker_embs, item_embs, diag, batch.labels
        )
        loss = loss + lr_loss
        metrics.update(lr_metrics)
    else:
        loss, metrics = softmax_retrieval_loss(
            params, cfg, user_emb, item_embs, batch.position, batch.labels,
            scores=scores, **sampling_kw,
        )
    if cfg.reward_model:
        rm_loss, rm_metrics = _reward_model_terms(
            params, cfg, user_emb, item_embs, scores, batch.labels
        )
        loss = loss + rm_loss
        metrics.update(rm_metrics)
    metrics["loss"] = loss
    return loss, metrics


# train_loss gradients that are zero in exact arithmetic under the softmax
# terms alone: the item-tower head bias and the item feature MLP's last bias
# each add one vector to every item embedding, which shifts all logits of a
# row's softmax alike, so their gradients cancel and hold only rounding
# noise.  A comparison of gradients holds them relative to ZERO_GRAD_FLOOR
# times the largest magnitude over all leaves instead of their own scale.
ZERO_GRAD_LEAVES = ("item_tower_head.b", "item_features_mlp.1.b")
ZERO_GRAD_FLOOR = 1e-2


def zero_grad_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """The leaves a gradient comparison holds to ``ZERO_GRAD_FLOOR`` times
    the top leaf for ``cfg``: none under the reward model, whose proxy
    scores the item embedding and gives them a real gradient well above the
    softmax's rounding noise.  The light ranker's head gives them a real
    gradient too, but its retrieval term is not max-normalised: the
    cancelling softmax part carries weights up to ``1 /
    combined_debias_min``, and its f32 rounding noise (about 4e-8 of the
    top leaf) reaches 1e-3 of their own scale, so they stay on the floor."""
    return () if cfg.reward_model else ZERO_GRAD_LEAVES


def rerank_values(
    params: TwoTowerModel,
    cfg: ModelConfig,
    ranker_embs: torch.Tensor,  # [B, NU, DI]
    mips_scores: torch.Tensor,  # [B, NI]
    mips_item_emb: torch.Tensor,  # [B, NI, DI]
) -> torch.Tensor:
    """The light ranker's value [B, NI] of each MIPS candidate: target-aware
    attention of the candidate over the NU ranker embeddings, the head's T
    task logits (KD's aux logits are train-only) and their sum weighted by
    ``user_value_weights``.  Every product is f32 on f32 operands."""
    r = ranker_embs.float()
    cand = mips_item_emb.float()
    scores = torch.einsum("bnd,bkd->bkn", r, cand)  # [B, NI, NU]
    probs = torch.softmax(scores, dim=-1)
    ta_user = torch.einsum("bkn,bnd->bkd", probs, r)
    feat = torch.cat([cand, ta_user, scores, mips_scores[:, :, None].float()], dim=-1)
    task_logits = linear_apply(params.light_ranker_head, feat)[..., : cfg.num_tasks]
    return torch.einsum("bkt,t->bk", task_logits, _value_weights(cfg, task_logits.device))


def retrieve_from_embeddings(
    params: TwoTowerModel,
    cfg: ModelConfig,
    user_emb: torch.Tensor,  # [B, DI]
    ranker_embs: Optional[torch.Tensor],
    topk_fn,  # (query [B, DI], k) -> (indices, scores, embeddings)
) -> torch.Tensor:
    """Top ``cfg.num_items`` indices [B, num_items] from user embeddings.
    Under the light ranker: the top ``num_mips_items`` by MIPS, reranked by
    ``rerank_values`` in lax.top_k's order (``topk_ordered``)."""
    from two_tower_models_tpu_torch.retrieval.mips import topk_ordered

    if cfg.light_ranker is None:
        indices, _, _ = topk_fn(user_emb, cfg.num_items)
        return indices
    mips_items, mips_scores, mips_item_emb = topk_fn(user_emb, cfg.light_ranker.num_mips_items)
    value = rerank_values(params, cfg, ranker_embs, mips_scores, mips_item_emb)
    _, top_idx = topk_ordered(value, cfg.num_items)  # [B, num_items]
    return torch.gather(mips_items, 1, top_idx)


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
    [B, num_items] (int64), and under the light ranker its rerank of the
    MIPS top ``num_mips_items``.  The MIPS is the JAX package's dispatch: a
    ``QuantizedCorpus`` takes ``mips_topk_quantized`` (approximate at
    ``mips_recall_target`` under ``approx_mips``, else exact over the
    quantized scores), ``approx_mips`` ``mips_topk_approx``, anything else
    the exact tile-max pipeline.  The model and corpus must already be on
    ``device``; the inputs are moved there."""
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_approx, mips_topk_exact
    from two_tower_models_tpu_torch.retrieval.quant import QuantizedCorpus, mips_topk_quantized

    dev = resolve_device(device)
    if isinstance(corpus, QuantizedCorpus):
        target = cfg.mips_recall_target if cfg.approx_mips else None
        topk_fn = lambda q, k: mips_topk_quantized(corpus, q, k, recall_target=target)
        rows = corpus.q
    elif isinstance(corpus, torch.Tensor):
        if cfg.approx_mips:
            topk_fn = lambda q, k: mips_topk_approx(corpus, q, k, cfg.mips_recall_target)
        else:
            topk_fn = lambda q, k: mips_topk_exact(corpus, q, k)
        rows = corpus
    else:
        raise TypeError(f"retrieve takes a tensor or a QuantizedCorpus, not {type(corpus).__name__}")
    for name, t in (("model", params.item_id_table), ("corpus", rows)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    cfg = resolve_kernel_flags(cfg, dev)
    with torch.inference_mode():
        user_emb, ranker_embs = compute_user_embedding(
            params, cfg, _on(user_id, dev), _on(user_features, dev).float(),
            _on(user_history, dev),
            None if history_len is None else _on(history_len, dev),
        )
        return retrieve_from_embeddings(params, cfg, user_emb, ranker_embs, topk_fn)
