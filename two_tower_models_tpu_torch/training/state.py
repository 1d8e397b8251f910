"""Train state and the optimizer.

Port of ``two_tower_models_tpu/training/state.py``.  ``Adam`` is
``optax.adam`` (``scale_by_adam`` then the learning rate), written in plain
torch in optax's order, with ``optax.clip_by_global_norm`` ahead of it when
``TrainConfig.grad_clip_norm`` is set; ``torch.optim.Adam`` folds the bias
corrections in elsewhere.  With ``TrainConfig.fused_adam`` the same
update runs one pass per leaf (``FusedAdam``, ``ops.fused_adam``).  The
update is in place on the parameters and the moments: the port keeps one
copy of each, where JAX returns new arrays.
Large id tables are stored 128-lane packed (``maybe_pack_tables``,
``nn.packed_table``); with ``TrainConfig.lazy_table_adam`` the tables keep
their moments outside ``Adam`` (``LazyAdamState``, ``training.sparse_tables``).
The state's ``rng`` draws the mixed negatives and its ``logq_state`` is the
streaming frequency estimator (``training.freq_estimator``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import torch
from torch import nn

from two_tower_models_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, init_params
from two_tower_models_tpu_torch.nn.packed_table import pack_factor, pack_table, packed_shape
from two_tower_models_tpu_torch.ops.fused_adam import fused_adam_step
from two_tower_models_tpu_torch.training.freq_estimator import (
    FreqEstimatorState,
    init_freq_estimator,
)
from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS, init_table_moments


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments, keyed
    by parameter name."""

    count: torch.Tensor  # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class LazyAdamState(NamedTuple):
    """The lazy-Adam opt state, the JAX package's ``{"dense": ...,
    "tables": ...}``: Adam over the dense leaves, and f32 ``mu``/``nu`` of
    each id table in its storage shape (``tables["mu"][name]``)."""

    dense: AdamState
    tables: Dict[str, Dict[str, torch.Tensor]]


class TrainState(NamedTuple):
    """The JAX package's ``TrainState``.  ``rng`` is a ``torch.Generator``
    on the state's device, drawn from in place by the mixed-negative steps
    only (its ``get_state()`` is what a checkpoint keeps); ``logq_state``
    is present only with ``TrainConfig.streaming_logq``."""

    step: torch.Tensor  # int32 scalar
    params: TwoTowerModel
    opt_state: Union[AdamState, LazyAdamState]
    rng: Optional[torch.Generator] = None
    logq_state: Optional[FreqEstimatorState] = None


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

    def init(self, params: TwoTowerModel, exclude=()) -> AdamState:
        """Zero moments for every parameter but those named in ``exclude``."""
        named = {n: p for n, p in params.named_parameters() if n not in exclude}
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for n, p in named.items()}
        dev = params.item_id_table.device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())

    @torch.no_grad()
    def update(self, params: TwoTowerModel, grads: Dict[str, torch.Tensor],
               state: AdamState) -> AdamState:
        """One step over the parameters ``state`` holds moments for, in place
        on ``params`` and the moments of ``state``."""
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
        bc1 = 1 - self.b1 ** t  # a host scalar: a host tensor would sync the stream
        bc2 = 1 - self.b2 ** t
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(ps, upd, alpha=-self.learning_rate)
        return AdamState(count, state.mu, state.nu)


class FusedAdam(Adam):
    """``TrainConfig(fused_adam=True)``: the same Adam and the same
    ``AdamState``, each leaf updated in one pass (``ops.fused_adam``, B20 for
    leaves of 2^16 elements or more), with the bias corrections multiplied
    in as reciprocals, as the JAX package's ``fused_adam_step`` does.  No
    clipping: ``make_optimizer`` refuses it with ``grad_clip_norm``."""

    def update(self, params: TwoTowerModel, grads: Dict[str, torch.Tensor],
               state: AdamState) -> AdamState:
        return fused_adam_step(dict(params.named_parameters()), grads, state, self.learning_rate)


def make_optimizer(train_cfg: TrainConfig) -> Adam:
    """Adam, with global-norm clipping ahead of it when configured, or
    ``FusedAdam`` with ``fused_adam``; raises where the JAX package does."""
    clip = train_cfg.grad_clip_norm
    if clip and train_cfg.fused_adam:
        raise ValueError(
            "grad_clip_norm is incompatible with fused_adam (the kernel "
            "hardcodes plain-Adam semantics)"
        )
    if clip and train_cfg.lazy_table_adam:
        raise NotImplementedError(
            "grad_clip_norm with lazy_table_adam would clip on the dense "
            "subtree's norm only (table grads live outside the optimizer) — "
            "use the dense path"
        )
    if train_cfg.fused_adam:
        return FusedAdam(train_cfg.learning_rate)
    return Adam(train_cfg.learning_rate, clip or None)


def maybe_pack_tables(params: TwoTowerModel, model_cfg: ModelConfig,
                      train_cfg: TrainConfig, model_shards: int = 1) -> TwoTowerModel:
    """Swap each id table of at least ``pack_tables_min_rows`` rows whose
    dim divides 128 to 128-lane-packed storage (``nn.packed_table``), in
    place on the model: the parameter is replaced, under the same name.
    Numerics-neutral; the model dispatches on the table's shape.  A table
    packs only if its physical rows split evenly over ``model_shards``
    (the mesh's model axis), so each shard's physical range stays a
    contiguous range of logical rows (``parallel.embedding``)."""
    if not train_cfg.pack_tables:
        return params
    for name, vocab, dim in (
        ("user_id_table", model_cfg.user_id_hash_size, model_cfg.user_id_embedding_dim),
        ("item_id_table", model_cfg.item_id_hash_size, model_cfg.item_id_embedding_dim),
    ):
        if vocab >= train_cfg.pack_tables_min_rows and pack_factor(dim) > 1:
            if packed_shape(vocab, dim)[0] % model_shards:
                continue  # would not row-shard evenly; keep plain storage
            table = getattr(params, name)
            setattr(params, name, nn.Parameter(pack_table(table.detach()),
                                               requires_grad=table.requires_grad))
    return params


# Mixes the params' seed into the seed of ``TrainState.rng``, so the two
# generators of one state draw unrelated streams.
_RNG_SALT = 0x5DEECE66D


def create_train_state(seed, model_cfg: ModelConfig, train_cfg: TrainConfig,
                       device="cuda", catalog_size: Optional[int] = None,
                       model_shards: int = 1) -> TrainState:
    """Fresh params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``), packed where ``maybe_pack_tables`` says
    (``TrainConfig.pack_tables=False`` keeps plain [V, D] tables), a zero
    optimizer state (``AdamState``, or with ``lazy_table_adam`` a
    ``LazyAdamState`` whose table moments take the tables' storage shape),
    ``rng`` seeded from ``seed`` and, with ``streaming_logq``, an empty
    estimator over ``catalog_size`` items.  For a mesh, pass its model axis
    as ``model_shards``: a table whose packed rows would not split evenly
    over it stays plain (``maybe_pack_tables``)."""
    if train_cfg.streaming_logq:
        if not model_cfg.logq_correction:
            raise ValueError(
                "streaming_logq estimates frequencies FOR the logQ "
                "correction — set ModelConfig.logq_correction too"
            )
        if catalog_size is None:
            raise ValueError(
                "streaming_logq needs catalog_size (the number of catalog "
                "items the estimator tracks)"
            )
    tx = make_optimizer(train_cfg)
    params = maybe_pack_tables(init_params(seed, model_cfg, device=device), model_cfg, train_cfg,
                               model_shards)
    if train_cfg.lazy_table_adam:
        opt_state = LazyAdamState(tx.init(params, exclude=SPARSE_TABLE_KEYS),
                                  init_table_moments(params))
    else:
        opt_state = tx.init(params)
    dev = params.item_id_table.device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    rng = torch.Generator(device=dev)
    base = seed.initial_seed() if isinstance(seed, torch.Generator) else int(seed)
    rng.manual_seed((base + _RNG_SALT) % (1 << 63))
    logq_state = init_freq_estimator(catalog_size, dev) if train_cfg.streaming_logq else None
    return TrainState(step=step, params=params, opt_state=opt_state, rng=rng,
                      logq_state=logq_state)
