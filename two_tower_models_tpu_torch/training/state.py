"""Train state and the optimizer.

Port of ``two_tower_models_tpu/training/state.py``.  ``Adam`` is
``optax.adam`` (``scale_by_adam`` then the learning rate), written in plain
torch in optax's order, with ``optax.clip_by_global_norm`` ahead of it when
``TrainConfig.grad_clip_norm`` is set; ``torch.optim.Adam`` folds the bias
corrections in elsewhere.  The update is in place on the parameters and
the moments: the port keeps one copy of each, where JAX returns new arrays.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from two_tower_models_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, init_params

_LANES = 128  # the JAX package packs tables of dim | 128 into 128-lane rows


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, '{item}')")


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments, keyed
    by parameter name."""

    count: torch.Tensor  # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """The JAX package's ``TrainState`` without its RNG key and logQ
    estimator, which only the unported mixed-negative paths use."""

    step: torch.Tensor  # int32 scalar
    params: TwoTowerModel
    opt_state: AdamState


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.stack(torch._foreach_norm(tensors)).square().sum().sqrt()


class Adam:
    """``optax.adam(learning_rate)`` with b1 0.9, b2 0.999, eps 1e-8 and
    eps_root 0, after ``optax.clip_by_global_norm(clip_norm)`` when given:

        g <- g if |g| < clip_norm else g * clip_norm / |g|
        mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  t <- t + 1
        p <- p - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float, clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm

    def init(self, params: TwoTowerModel) -> AdamState:
        named = dict(params.named_parameters())
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for n, p in named.items()}
        dev = params.item_id_table.device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())

    @torch.no_grad()
    def update(self, params: TwoTowerModel, grads: Dict[str, torch.Tensor],
               state: AdamState) -> AdamState:
        """One step, in place on ``params`` and the moments of ``state``."""
        names = list(state.mu)
        ps = [dict(params.named_parameters())[n] for n in names]
        g = [grads[n] for n in names]
        if self.clip_norm:
            norm = global_norm(g)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            g = torch._foreach_mul(g, scale)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = state.count + 1
        t = count.float()
        bc1 = 1 - torch.tensor(self.b1, device=t.device) ** t
        bc2 = 1 - torch.tensor(self.b2, device=t.device) ** t
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(ps, upd, alpha=-self.learning_rate)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(train_cfg: TrainConfig) -> Adam:
    """Adam, with global-norm clipping ahead of it when configured."""
    if train_cfg.fused_adam:
        raise _not_ported("fused_adam (the one-pass Adam kernel, B20)", "queue B, B20")
    if train_cfg.lazy_table_adam:
        raise _not_ported("lazy_table_adam", "queue A, Large tables")
    return Adam(train_cfg.learning_rate, train_cfg.grad_clip_norm or None)


def _check_unpacked(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    if not train_cfg.pack_tables:
        return
    for vocab, dim in ((model_cfg.user_id_hash_size, model_cfg.user_id_embedding_dim),
                       (model_cfg.item_id_hash_size, model_cfg.item_id_embedding_dim)):
        if vocab >= train_cfg.pack_tables_min_rows and dim < _LANES and _LANES % dim == 0:
            raise _not_ported(f"packed storage of a {vocab}-row table", "queue A, Large tables")


def create_train_state(seed, model_cfg: ModelConfig, train_cfg: TrainConfig,
                       device="cuda") -> TrainState:
    """Fresh params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``) and a zero Adam state."""
    if train_cfg.streaming_logq:
        raise _not_ported("streaming_logq", "queue A, Mixed negatives and logQ")
    _check_unpacked(model_cfg, train_cfg)
    tx = make_optimizer(train_cfg)
    params = init_params(seed, model_cfg, device=device)
    step = torch.zeros((), dtype=torch.int32, device=params.item_id_table.device)
    return TrainState(step=step, params=params, opt_state=tx.init(params))
