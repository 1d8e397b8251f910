"""The train step: gather the batch, loss, gradients, Adam.

Port of ``make_train_step`` of ``two_tower_models_tpu/training/step.py``
(the dense path).  PyTorch runs eagerly, so the step is a plain function.
Its metrics stay device tensors: nothing in a step waits for the device,
and the caller reads them when it logs.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from two_tower_models_tpu_torch.config import ModelConfig, TrainConfig, resolve_kernel_flags
from two_tower_models_tpu_torch.models.two_tower import train_loss
from two_tower_models_tpu_torch.training.data import SyntheticRecData, gather_batch
from two_tower_models_tpu_torch.training.state import (
    TrainState,
    _not_ported,
    global_norm,
    make_optimizer,
)

Step = Callable[[TrainState, SyntheticRecData, torch.Tensor], Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig) -> Step:
    """``step(state, data, idx) -> (state, metrics)``: one Adam step on the
    batch of rows ``idx`` [B], in place on ``state.params`` and its moments.
    Metrics: ``loss``, ``softmax_ce``, ``debias_aux_loss``, ``nuv_mean`` and
    ``grad_norm`` (of the gradients before clipping).  With
    ``steps_per_dispatch = K > 1``, ``idx`` is [K, B]: K steps in a row,
    metrics averaged over them."""
    if model_cfg.mixed_negatives or model_cfg.logq_correction:
        raise _not_ported("mixed negatives and the logQ correction",
                          "queue A, Mixed negatives and logQ")
    tx = make_optimizer(train_cfg)

    def step(state: TrainState, data: SyntheticRecData, idx: torch.Tensor):
        params = state.params
        cfg = resolve_kernel_flags(model_cfg, params.item_id_table.device)
        loss, metrics = train_loss(params, cfg, gather_batch(data, idx))
        names, ps = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        opt_state = tx.update(params, dict(zip(names, grads)), state.opt_state)
        return state._replace(step=state.step + 1, opt_state=opt_state), metrics

    if train_cfg.steps_per_dispatch <= 1:
        return step

    def multi_step(state: TrainState, data: SyntheticRecData, idx2d: torch.Tensor):
        stacked = []
        for idx in idx2d:
            state, metrics = step(state, data, idx)
            stacked.append(metrics)
        return state, {k: torch.stack([m[k] for m in stacked]).mean(0) for k in stacked[0]}

    return multi_step
