"""The towers and the explicit training step on a mesh.

Port of ``two_tower_models_tpu/parallel/train_step.py`` without its GSPMD
step (``make_gspmd_train_step``: ROADMAP.md A13b, part 2).  One process a
rank: ``params`` is this rank's block of the model
(``parallel.sharding.shard_params``, or ``shard_state`` for training).
Table lookups go through the ``model``-axis exchange
(``parallel.embedding``), and with ``tp`` the feature MLPs run
Megatron-split with one all-reduce over ``model``.

Training (``make_sharded_train_step``): the batch splits over ``data``,
the tables over ``model``, everything else replicates.  Each rank scores
its own users against the items of the global batch (all-gathered over
``data``; the positive sits at column data_rank * B_local + row), takes
the nuv max over the global batch, and differentiates only its own share
of the global loss.  The collectives carry the adjoints
``parallel.collectives`` sets out, so the gradients, once reduced, are the
single-device step's on the global batch: JAX's explicit step, whose
``psum`` adjoints repeat the reduction, scales them by the mesh instead
(ROADMAP.md C).

As in JAX, ``_user_tower`` takes the user-id embedding straight from the
table; a registered user-embedding arm does not run on a mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
    resolve_kernel_flags,
)
from two_tower_models_tpu_torch.models.history_encoder import history_encoder_apply
from two_tower_models_tpu_torch.models.two_tower import (
    REPLICATED_BATCH_FIELDS,
    Batch,
    _clip_min,
    _light_ranker_train_terms,
    _net_user_value,
    _reward_model_terms,
    debias_net_user_value,
    logq_operands,
    retrieval_ce,
)
from two_tower_models_tpu_torch.nn.layers import linear_apply, mlp_apply, round_to
from two_tower_models_tpu_torch.nn.packed_table import is_packed, packed_shape
from two_tower_models_tpu_torch.ops.fused_softmax import fused_lse
from two_tower_models_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_replicated
from two_tower_models_tpu_torch.parallel.embedding import sharded_embedding_lookup
from two_tower_models_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_shape
from two_tower_models_tpu_torch.parallel.sparse_grads import (
    sparse_grad_exchange,
    sparse_table_grad_names,
    table_touched_ids,
)
from two_tower_models_tpu_torch.training.state import global_norm, make_optimizer
from two_tower_models_tpu_torch.training.step import _grads

_SHARDED_TABLES = ("user_id_table", "item_id_table")


def _table_dims(cfg: ModelConfig):
    return {
        "user_id_table": cfg.user_id_embedding_dim,
        "item_id_table": cfg.item_id_embedding_dim,
    }


def check_mesh_tables(params, cfg: ModelConfig, n_model: int, local: bool = False) -> None:
    """Each table (plain [V, D] or 128-lane-packed [Vp/P, P*D]) must split
    evenly over the model axis.  With ``local``, ``params`` is one rank's
    block, which must hold 1/n_model of each table's physical rows."""
    for name, dim in _table_dims(cfg).items():
        t = getattr(params, name, None)
        if t is None:
            continue
        if local:
            vocab = cfg.user_id_hash_size if name == "user_id_table" else cfg.item_id_hash_size
            full = packed_shape(vocab, dim)[0] if is_packed(t, dim) else vocab
            if t.shape[0] * n_model != full:
                raise ValueError(
                    f"{name}'s block has {t.shape[0]} physical rows, not 1/{n_model} of "
                    f"{full}: shard the state for this mesh (parallel.sharding.shard_state)"
                )
        elif t.shape[0] % n_model:
            raise ValueError(
                f"{name} has {t.shape[0]} physical rows, not divisible by the model axis "
                f"({n_model}); pad the table or change the mesh "
                "(create_train_state(..., model_shards=...) keeps such a table unpacked)"
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
    after.  The all-reduce's gradient is the identity: the input features
    take none, and each rank's columns and rows take its own cotangent,
    the same on every rank."""
    h = torch.relu(linear_apply(params[0], x, cd))  # [B, hidden/n] local
    y = round_to(h, cd) @ round_to(params[1].w, cd)
    y = all_reduce_replicated(y, mesh.get_group(MODEL_AXIS))
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


def _sharded_reward_model_terms(params, cfg: ModelConfig, user_emb, item_emb, negatives,
                                scores, pos, labels, n_data: int):
    """The reward model's KL and proxy BCE with the item axis spanning the
    global batch: ``negatives`` [B_global, DI], ``scores`` [B_local,
    B_global], ``pos`` [B_local] the rank's own pairs' scores.  (this
    rank's share of the loss, the rank's metrics): the KL's row mean and the
    BCE's mean are means over the global batch, so a rank's share is its
    local loss over ``n_data``."""
    loss, metrics = _reward_model_terms(params, cfg, user_emb, item_emb, scores, labels,
                                        negatives, pos)
    return loss / n_data, metrics


def _gathered_ce(cfg: ModelConfig, user_emb, item_emb, negatives, scores, pos, neg_emb,
                 batch: Batch, data_group):
    """Per-row CE [B_local] over the global pool: the all-gathered in-batch
    items, then the mixed negatives, each column corrected by its -log q
    (the in-batch corrections all-gathered beside the items)."""
    b_local = user_emb.shape[0]
    corr = None
    if batch.item_logq is not None or batch.neg_logq is not None:
        ilq = (user_emb.new_zeros(b_local) if batch.item_logq is None
               else batch.item_logq.float())
        gcorr = all_gather_rows(ilq, data_group)
        if neg_emb is not None:
            nlq = (user_emb.new_zeros(neg_emb.shape[0]) if batch.neg_logq is None
                   else batch.neg_logq.float())
            gcorr = torch.cat([gcorr, nlq])
        # rounded to the pool's dtype, as the fused route's column is
        corr = gcorr.to(item_emb.dtype).float()
    pool = negatives if neg_emb is None else torch.cat([negatives, neg_emb.to(negatives.dtype)])
    pos_ce = pos if batch.item_logq is None else pos - batch.item_logq.to(item_emb.dtype).float()
    if scores is not None:
        full = scores
        if neg_emb is not None:
            full = torch.cat([full, user_emb.float() @ neg_emb.float().T], dim=1)
        lse = torch.logsumexp(full if corr is None else full - corr[None, :], dim=-1)
    elif cfg.fused_loss:
        # B10-B12 on the rectangular [B_local, B_global + B'] (D + 1 with logQ)
        lse = fused_lse(*logq_operands(user_emb, pool, corr)) if corr is not None \
            else fused_lse(user_emb, pool)
    else:
        full = user_emb.float() @ pool.float().T
        lse = torch.logsumexp(full if corr is None else full - corr[None, :], dim=-1)
    return lse - pos_ce


# metrics reduced over ``data`` by a sum; every other one is a mean
_SUMMED_METRICS = ("loss", "debias_aux_loss")


def _reduce_metrics(metrics: Dict[str, torch.Tensor], data_group, n_data: int):
    """The rank's metrics detached, summed or averaged over ``data`` in one
    all-reduce."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if n_data == 1:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=data_group)
    return {k: (flat[i] if k in _SUMMED_METRICS else flat[i] / n_data) for i, k in enumerate(keys)}


def sharded_loss_fn(params, cfg: ModelConfig, mesh_cfg: MeshConfig, mesh, batch: Batch,
                    lookup_strategy: str = "psum"):
    """(this rank's share of the global loss, the metrics) on the rank's
    own rows ``batch`` of the global batch, for every preset (base,
    history, debias, light ranker, KD, reward model; mixed negatives and
    logQ).  The shares of all ranks of a ``model`` index sum to
    ``models.two_tower.train_loss`` on the global batch:
    sum(ce * nuv) / B_global, the rank's own debias aux sum, and the light
    ranker's and reward model's batch means over ``n_data``.  The metrics
    are reduced over ``data`` as JAX's are, ``loss`` the global loss.  Over
    a ``data`` axis of one, or with ``global_negatives`` off, the CE is the
    single-device one on the rank's rows, op for op."""
    cfg = resolve_kernel_flags(cfg, params.item_id_table.device)
    tp = mesh_cfg.tower_tp
    n_data = mesh.size(0)
    data_group = mesh.get_group(DATA_AXIS)
    user_emb, ranker_embs = _user_tower(
        params, cfg, mesh, batch.user_id, batch.user_features, batch.user_history,
        lookup_strategy, tp, batch.history_len,
    )  # [B_local, DI]
    item_emb = _item_tower(params, cfg, mesh, batch.item_id, batch.item_features,
                           lookup_strategy, tp)
    b_local = user_emb.shape[0]
    gathered = mesh_cfg.global_negatives and n_data > 1
    negatives = all_gather_rows(item_emb, data_group) if gathered else item_emb
    neg_emb = None
    if batch.neg_item_id is not None:  # [B'] replicated: every rank scores them alike
        neg_emb = _item_tower(params, cfg, mesh, batch.neg_item_id, batch.neg_item_features,
                              lookup_strategy, tp)
    # the reward model scores the whole [B_local, B_global] matrix, its
    # columns uncorrected: the CE reuses it
    scores = user_emb.float() @ negatives.float().T if cfg.reward_model else None
    off = mesh.get_local_rank(DATA_AXIS) * b_local if gathered else 0
    pos = (scores[:, off : off + b_local].diagonal() if scores is not None
           else (user_emb.float() * item_emb.float()).sum(-1))
    if gathered:
        ce = _gathered_ce(cfg, user_emb, item_emb, negatives, scores, pos, neg_emb, batch,
                          data_group)
    else:
        ce = retrieval_ce(cfg, user_emb, item_emb, scores, neg_emb, batch.item_logq,
                          batch.neg_logq)

    nuv = _net_user_value(cfg, batch.labels)
    nuv, aux_loss = debias_net_user_value(params, cfg, nuv, batch.position, user_emb)
    aux_loss = aux_loss * cfg.debias_aux_weight
    nuv = _clip_min(nuv, cfg.nuv_min)
    if cfg.light_ranker is None:
        # the max over the global batch; its gradient reduce-scatters home
        nuv = nuv / torch.amax(all_gather_rows(nuv, data_group))
    share = torch.mean(ce * nuv) / n_data + aux_loss
    metrics = {"softmax_ce": torch.mean(ce), "debias_aux_loss": aux_loss,
               "nuv_mean": torch.mean(nuv)}
    if cfg.light_ranker is not None:
        lr_loss, lr_metrics = _light_ranker_train_terms(params, cfg, ranker_embs, item_emb, pos,
                                                        batch.labels)
        share = share + lr_loss / n_data
        metrics.update(lr_metrics)
    if cfg.reward_model:
        rm_share, rm_metrics = _sharded_reward_model_terms(
            params, cfg, user_emb, item_emb, negatives, scores, pos, batch.labels, n_data)
        share = share + rm_share
        metrics.update(rm_metrics)
    metrics["loss"] = share
    return share, _reduce_metrics(metrics, data_group, n_data)


_RING = ("ring_negatives (the ppermute ring loss) is not ported yet "
         "(ROADMAP.md, queue A, A13c of A13 'Multi-device')")


def local_batch(batch: Batch, d: int, n_data: int) -> Batch:
    """Rank ``d``'s rows of the global ``batch`` along the leading axis (the
    [B'] mixed-negative fields whole)."""
    b = batch.user_id.shape[0]
    if b % n_data:
        raise ValueError(f"a global batch of {b} rows does not split over {n_data} data ranks")
    b_local = b // n_data
    return Batch(**{
        name: (None if t is None else t if name in REPLICATED_BATCH_FIELDS
               else t.narrow(0, d * b_local, b_local))
        for name, t in batch._asdict().items()
    })


def _reduce_grads(names, grads, specs, sparse, ids_map, dims, mesh, n_data, n_model):
    """The gradients of the global loss from each rank's share's: tables
    through the sparse exchange or an all-reduce over ``data``; the rest
    all-reduced over ``data`` (one flat buffer), then the replicated leaves
    averaged over ``model`` (identical there, and then bit-equal on every
    rank); the ``tower_tp`` leaves split over ``model`` stay local.
    (gradients, indices of the replicated leaves)."""
    data_group, model_group = mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS)
    out = list(grads)
    dense, rep = [], []
    for i, name in enumerate(names):
        top = name.split(".")[0]
        if top in sparse:
            out[i] = sparse_grad_exchange(out[i], ids_map[top], data_group, model_group, dims[top])
        else:
            dense.append(i)
        if MODEL_AXIS not in specs[name]:
            rep.append(i)

    def reduce(idx, group, div):
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if div > 1:
            flat.div_(div)
        for i, part in zip(idx, torch.split(flat, [out[i].numel() for i in idx])):
            out[i] = part.view(out[i].shape)

    if n_data > 1 and dense:
        reduce(dense, data_group, 1)
    if n_model > 1 and rep:
        reduce(rep, model_group, n_model)
    return out, rep


def _grad_norm(grads, rep, mesh, n_model):
    """The global norm of the gradients of the whole model: the replicated
    leaves' squares once, the split leaves' summed over ``model``."""
    if n_model == 1:
        return global_norm(grads)
    rep_set = set(rep)
    sq = lambda ts: torch.stack(torch._foreach_norm(ts)).square().sum().reshape(1)
    split = sq([g for i, g in enumerate(grads) if i not in rep_set])
    dist.all_reduce(split, group=mesh.get_group(MODEL_AXIS))
    return (sq([grads[i] for i in rep]) + split).sqrt()[0]


def sharded_grads(params, model_cfg: ModelConfig, mesh_cfg: MeshConfig, mesh, batch: Batch,
                  lookup_strategy: str = "psum"):
    """(names, gradients, metrics) of the step on the global ``batch``: the
    gradients of the global loss for this rank's leaves, in the order of
    ``params.named_parameters()`` (``_reduce_grads``), and the metrics with
    ``grad_norm``, the gradients' global norm."""
    from two_tower_models_tpu_torch.parallel.sharding import param_pspecs  # it imports this module

    n_data, n_model = mesh_shape(mesh)
    local = local_batch(batch, mesh.get_local_rank(DATA_AXIS), n_data)
    share, metrics = sharded_loss_fn(params, model_cfg, mesh_cfg, mesh, local, lookup_strategy)
    names, ps = zip(*params.named_parameters())
    grads = _grads(share, ps)
    sparse = sparse_table_grad_names(model_cfg, mesh_cfg, local, params)
    ids_map = table_touched_ids(model_cfg, local) if sparse else {}
    grads, rep = _reduce_grads(names, grads, param_pspecs(params, mesh_cfg.tower_tp), sparse,
                               ids_map, _table_dims(model_cfg), mesh, n_data, n_model)
    metrics["grad_norm"] = _grad_norm(grads, rep, mesh, n_model)
    return names, grads, metrics


def make_sharded_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh,
    mesh_cfg: MeshConfig,
    lookup_strategy: str = "psum",
) -> Callable[[object, Batch], Tuple[object, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``: one Adam step of this
    rank's block ``state`` (``parallel.sharding.shard_state``) on the
    global ``batch`` (every rank passes the same; each takes its own
    ``data`` rows, the [B'] mixed-negative fields whole), in place on the
    block.  The gradients are the single-device step's on the global batch
    (``_reduce_grads``), ``grad_norm`` their global norm, the metrics
    ``make_train_step``'s.  Over a world of one the step is
    ``training.step.make_train_step``'s, bit for bit.

    Adam is ``make_optimizer(train_cfg)``'s on the rank's leaves (B20 with
    ``fused_adam``); as in JAX, the step is dense whatever
    ``lazy_table_adam`` says.  With ``steps_per_dispatch = K > 1`` the
    batch's fields are [K, B, ...]: K steps, the metrics averaged.  The
    batch is extended (mixed negatives, logQ) by the caller
    (``training.data.extend_batch_for_idx``).  Nothing waits for the
    device but the collectives."""
    n_data, n_model = mesh_shape(mesh)
    if (mesh_cfg.data, mesh_cfg.model) != (n_data, n_model):
        raise ValueError(f"mesh_cfg is {mesh_cfg.data}x{mesh_cfg.model}, the mesh {n_data}x{n_model}")
    if model_cfg.user_embedding_arm != "table":
        raise NotImplementedError(
            "custom user_embedding_arm is not plumbed through the explicit sharded tower; "
            "the GSPMD path (ROADMAP.md A13b, part 2) would partition the full model"
        )
    if mesh_cfg.tower_tp and model_cfg.feature_hidden_dim % n_model:
        raise ValueError(
            f"tower_tp needs feature_hidden_dim ({model_cfg.feature_hidden_dim}) divisible "
            f"by the model axis ({n_model})"
        )
    if mesh_cfg.ring_negatives and model_cfg.reward_model:
        raise ValueError(
            "ring_negatives is incompatible with reward_model: the reward KL consumes the "
            "full [B_local, B_global] score matrix — use the all_gather path "
            "(ring_negatives=False)"
        )
    if mesh_cfg.ring_negatives and not mesh_cfg.global_negatives:
        raise ValueError(
            "ring_negatives shares negatives across the data axis; it requires "
            "global_negatives=True"
        )
    if train_cfg.grad_clip_norm:
        raise NotImplementedError(
            "grad_clip_norm is not taken by the explicit mesh step (the JAX package's "
            "refuses it there too)"
        )
    if mesh_cfg.ring_negatives:
        raise NotImplementedError(_RING)
    tx = make_optimizer(train_cfg)
    checked = []

    def one(state, batch: Batch):
        params = state.params
        if not checked:
            check_mesh_tables(params, model_cfg, n_model, local=True)
            checked.append(True)
        names, grads, metrics = sharded_grads(params, model_cfg, mesh_cfg, mesh, batch,
                                              lookup_strategy)
        opt_state = tx.update(params, dict(zip(names, grads)), state.opt_state)
        return state._replace(step=state.step + 1, opt_state=opt_state), metrics

    if train_cfg.steps_per_dispatch <= 1:
        return one

    def multi(state, batches: Batch):
        stacked = []
        for k in range(batches.user_id.shape[0]):
            state, metrics = one(state, Batch(*(None if t is None else t[k] for t in batches)))
            stacked.append(metrics)
        return state, {key: torch.stack([m[key] for m in stacked]).mean(0) for key in stacked[0]}

    return multi
