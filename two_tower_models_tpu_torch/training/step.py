"""The train step: gather the batch, loss, gradients, Adam; and the
recall@k eval.

Port of ``_extend_and_track``, ``make_train_step``, ``_make_lazy_table_step``
and ``make_eval_recall_fn`` of ``two_tower_models_tpu/training/step.py``.
PyTorch runs eagerly, so the step is a plain function.  Its metrics stay
device tensors: nothing in a step waits for the device, and the caller
reads them when it logs.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from two_tower_models_tpu_torch.config import ModelConfig, TrainConfig, resolve_kernel_flags
from two_tower_models_tpu_torch.models.two_tower import Batch, compute_user_embedding, train_loss
from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact
from two_tower_models_tpu_torch.training.data import (
    SyntheticRecData,
    catalog_positions,
    extend_batch,
    gather_batch,
)
from two_tower_models_tpu_torch.training.freq_estimator import freq_log_prob, freq_update
from two_tower_models_tpu_torch.training.sparse_tables import (
    SPARSE_TABLE_KEYS,
    apply_sparse_adam,
    build_minibatch,
)
from two_tower_models_tpu_torch.training.state import (
    LazyAdamState,
    TrainState,
    global_norm,
    make_optimizer,
)

Step = Callable[[TrainState, SyntheticRecData, torch.Tensor], Tuple[TrainState, Dict[str, torch.Tensor]]]


def _grads(loss, leaves):
    """d loss / d leaf for each leaf, zeros for the leaves it does not reach."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _extend_and_track(model_cfg: ModelConfig, train_cfg: TrainConfig, state: TrainState,
                      data: SyntheticRecData, batch):
    """Mixed negatives and logQ for one step, and the streaming estimator's
    advance: (batch, logq_state).  With ``streaming_logq`` the corrections
    use the estimator's current estimate (no lookahead), then the batch's
    items fold in.  With both features off the batch, ``state.rng`` and
    the estimator are untouched, so the plain path draws nothing."""
    if not (model_cfg.mixed_negatives or model_cfg.logq_correction):
        return batch, state.logq_state
    if state.rng is None:
        raise ValueError("mixed negatives and logQ draw from TrainState.rng, which is None")
    override, est = None, state.logq_state
    if train_cfg.streaming_logq:
        override = freq_log_prob(est)
        est = freq_update(est, catalog_positions(data.catalog_ids, batch.item_id),
                          train_cfg.logq_decay)
    return extend_batch(model_cfg, data, batch, state.rng, override), est


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Step:
    """``step(state, data, idx) -> (state, metrics)``: one Adam step on the
    batch of rows ``idx`` [B], in place on ``state.params`` and its moments.
    Metrics: ``loss``, ``softmax_ce``, ``debias_aux_loss``, ``nuv_mean`` and
    ``grad_norm`` (of the gradients before clipping).  With
    ``lazy_table_adam`` the tables take lazy Adam on their touched rows
    (``_make_lazy_table_step``).  With ``steps_per_dispatch = K > 1``,
    ``idx`` is [K, B]: K steps in a row, metrics averaged over them.  With
    ``mixed_negatives`` or ``logq_correction`` each step extends its batch
    first (``_extend_and_track``), drawing from ``state.rng``."""
    if train_cfg.lazy_table_adam:
        if train_cfg.fused_adam:
            raise ValueError("lazy_table_adam and fused_adam are exclusive")
        if model_cfg.user_embedding_arm != "table":
            raise NotImplementedError(
                "lazy_table_adam swaps the id tables for per-batch minitables; "
                "custom user_embedding_arm implementations cannot assume that — "
                "use the dense path"
            )
    tx = make_optimizer(train_cfg)
    if train_cfg.lazy_table_adam:
        step = _make_lazy_table_step(model_cfg, tx, train_cfg)
    else:
        step = _make_dense_step(model_cfg, tx, train_cfg)

    if train_cfg.steps_per_dispatch <= 1:
        return step

    def multi_step(state: TrainState, data: SyntheticRecData, idx2d: torch.Tensor):
        stacked = []
        for idx in idx2d:
            state, metrics = step(state, data, idx)
            stacked.append(metrics)
        return state, {k: torch.stack([m[k] for m in stacked]).mean(0) for k in stacked[0]}

    return multi_step


def _make_dense_step(model_cfg: ModelConfig, tx, train_cfg: TrainConfig) -> Step:
    def step(state: TrainState, data: SyntheticRecData, idx: torch.Tensor):
        params = state.params
        cfg = resolve_kernel_flags(model_cfg, params.item_id_table.device)
        batch, logq_state = _extend_and_track(model_cfg, train_cfg, state, data,
                                              gather_batch(data, idx))
        loss, metrics = train_loss(params, cfg, batch)
        names, ps = zip(*params.named_parameters())
        grads = _grads(loss, ps)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        opt_state = tx.update(params, dict(zip(names, grads)), state.opt_state)
        return state._replace(step=state.step + 1, opt_state=opt_state,
                              logq_state=logq_state), metrics

    return step


def _make_lazy_table_step(model_cfg: ModelConfig, tx, train_cfg: TrainConfig) -> Step:
    """Row-sparse table step (``training.sparse_tables``): the loss is
    differentiated against per-batch minitables of the touched rows, Adam
    updates the dense leaves, and lazy Adam writes the touched table rows in
    place, so the table update costs O(touched rows) whatever the table
    size."""

    def step(state: TrainState, data: SyntheticRecData, idx: torch.Tensor):
        params = state.params
        cfg = resolve_kernel_flags(model_cfg, params.item_id_table.device)
        batch, logq_state = _extend_and_track(model_cfg, train_cfg, state, data,
                                              gather_batch(data, idx))
        params2, batch2, meta = build_minibatch(cfg, params, batch)
        minis = [params2._tables[n].requires_grad_() for n in SPARSE_TABLE_KEYS]
        loss, metrics = train_loss(params2, cfg, batch2)
        names, ps = zip(*((n, p) for n, p in params.named_parameters()
                          if n not in SPARSE_TABLE_KEYS))
        grads = _grads(loss, [*ps, *minis])
        g_dense, g_minis = grads[:len(ps)], grads[len(ps):]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        dense = tx.update(params, dict(zip(names, g_dense)), state.opt_state.dense)
        t = state.step + 1
        moments = state.opt_state.tables
        for name, mini, g in zip(SPARSE_TABLE_KEYS, minis, g_minis):
            s, dup = meta[name]
            apply_sparse_adam(getattr(params, name), moments["mu"][name], moments["nu"][name],
                              mini.detach(), g, s, dup, t, train_cfg)
        return state._replace(step=t, opt_state=LazyAdamState(dense, moments),
                              logq_state=logq_state), metrics

    return step


def make_eval_recall_fn(model_cfg: ModelConfig, top_k: int = 100):
    """``recall_at_k(params, corpus, batch) -> 0-d tensor``: the share of the
    batch's positive examples (any label fired) whose engaged item is among
    the user's top-``top_k`` corpus rows by exact MIPS (the tile-max
    kernels on CUDA).  Forward only; the result stays on the device."""

    @torch.no_grad()
    def recall_at_k(params, corpus: torch.Tensor, batch: Batch) -> torch.Tensor:
        cfg = resolve_kernel_flags(model_cfg, corpus.device)
        user_emb, _ = compute_user_embedding(
            params, cfg, batch.user_id, batch.user_features,
            batch.user_history, batch.history_len,
        )
        k = min(top_k, corpus.shape[0])
        indices, _, _ = mips_topk_exact(corpus, user_emb, k)  # [B, k]
        hit = (indices == batch.item_id[:, None]).any(dim=1)
        positive = (batch.labels[:, : model_cfg.num_tasks] > 0).any(dim=1)
        hits = (hit & positive).sum()
        return hits / positive.sum().clamp_min(1)

    return recall_at_k
