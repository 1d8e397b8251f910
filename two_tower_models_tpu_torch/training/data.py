"""Training data held on the device, made from a seed, and batches
gathered by index.

Port of ``SyntheticRecData``, ``make_synthetic_data``, ``gather_batch`` and
``epoch_batches`` of ``two_tower_models_tpu/training/data.py``.  The whole
dataset lives on the device; a step gathers its batch with index tensors,
so no per-step host copy.  Random draws come from ``torch.Generator``s on
the data's device, so the numbers differ from the JAX package's for the
same seed; the distributions are the same.  ``extend_batch`` is not ported
yet (ROADMAP.md, queue A, 'Mixed negatives and logQ').
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import torch

from two_tower_models_tpu_torch.config import DataConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import Batch


class SyntheticRecData(NamedTuple):
    user_ids: torch.Tensor  # [N]
    user_features: torch.Tensor  # [N, F]
    user_history: torch.Tensor  # [N, H]
    item_ids: torch.Tensor  # [N]
    item_features: torch.Tensor  # [N, F]
    positions: torch.Tensor  # [N]
    labels: torch.Tensor  # [N, T]
    catalog_ids: torch.Tensor  # [C]
    catalog_features: torch.Tensor  # [C, F]
    history_lens: Optional[torch.Tensor] = None  # [N] in [1, H], or None
    catalog_logq: Optional[torch.Tensor] = None  # [C], or None

    @property
    def num_samples(self) -> int:
        return self.user_ids.shape[0]


def gather_batch(data: SyntheticRecData, idx: torch.Tensor) -> Batch:
    """The batch of rows ``idx`` [B], gathered on the data's device."""
    return Batch(
        user_id=data.user_ids[idx],
        user_features=data.user_features[idx],
        user_history=data.user_history[idx],
        item_id=data.item_ids[idx],
        item_features=data.item_features[idx],
        position=data.positions[idx],
        labels=data.labels[idx],
        history_len=None if data.history_lens is None else data.history_lens[idx],
    )


def make_synthetic_data(
    cfg: DataConfig, *, structured: bool = True, label_cols: int | None = None,
    device="cuda",
) -> SyntheticRecData:
    """The full dataset, made on ``device`` from ``cfg.seed``.

    ``structured`` plants learnable signal: P(engage) is 0.8 when
    ``user_id % 8 == item_id % 8`` and 0.1 otherwise; without it labels are
    fair coins.  ``popularity_skew > 0`` draws item ids by rank from a Zipf
    law through the inverse CDF (a search of the [C] cdf per sample: a
    categorical draw would hold [n, C] noise, 512 GiB at n = 2.1M, C =
    65,536).  ``variable_history`` draws lengths in [1, H] and sets the
    history to id 0 past each length.  Item features are the catalog's
    feature row of the item plus 0.1 noise; ``catalog_logq`` is the
    add-one smoothed log item frequency."""
    dev = resolve_device(device)
    t = label_cols or cfg.num_tasks
    n, c, h, f = cfg.num_samples, cfg.num_items, cfg.history_len, cfg.feature_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    randint = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=gen, device=dev)
    randn = lambda g, *shape: torch.randn(shape, generator=g, device=dev)

    user_ids = randint(0, cfg.num_users, n)
    if cfg.popularity_skew > 0:
        logits = -cfg.popularity_skew * torch.log(
            torch.arange(1, c + 1, dtype=torch.float32, device=dev)
        )
        cdf = torch.cumsum(torch.softmax(logits, dim=0), dim=0)
        u = torch.rand(n, generator=gen, device=dev)
        item_ids = torch.searchsorted(cdf, u, right=True).clamp_max(c - 1)
    else:
        item_ids = randint(0, c, n)
    user_features = randn(gen, n, f)
    item_features_noise = randn(gen, n, f)
    user_history = randint(0, c, n, h)
    positions = randint(0, cfg.max_position, n)

    history_lens = None
    if cfg.variable_history:
        history_lens = randint(1, h + 1, n)
        valid = torch.arange(h, device=dev)[None, :] < history_lens[:, None]
        user_history = torch.where(valid, user_history, 0)

    catalog_ids = torch.arange(c, device=dev)
    cat_gen = torch.Generator(device=dev)
    cat_gen.manual_seed(cfg.seed + 1)
    catalog_features = randn(cat_gen, c, f)
    item_features = catalog_features[item_ids] + 0.1 * item_features_noise

    if structured:
        affinity = (user_ids % 8 == item_ids % 8).float()
        p = (0.1 + 0.7 * affinity)[:, None].expand(n, t)
    else:
        p = torch.full((n, t), 0.5, device=dev)
    labels = torch.bernoulli(p, generator=gen)

    counts = torch.bincount(item_ids, minlength=c).float()
    catalog_logq = torch.log((counts + 1.0) / (n + c))

    return SyntheticRecData(
        user_ids=user_ids,
        user_features=user_features,
        user_history=user_history,
        item_ids=item_ids,
        item_features=item_features,
        positions=positions,
        labels=labels,
        catalog_ids=catalog_ids,
        catalog_features=catalog_features,
        history_lens=history_lens,
        catalog_logq=catalog_logq,
    )


def epoch_batches(
    generator: torch.Generator, num_samples: int, batch_size: int
) -> Iterator[torch.Tensor]:
    """Shuffled index vectors [batch_size] of one epoch, on the generator's
    device; the last partial batch is dropped."""
    perm = torch.randperm(num_samples, generator=generator, device=generator.device)
    for i in range(num_samples // batch_size):
        yield perm[i * batch_size : (i + 1) * batch_size]
