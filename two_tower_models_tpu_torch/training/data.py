"""Training data held on the device, made from a seed, and batches
gathered by index.

Port of ``SyntheticRecData``, ``make_synthetic_data``, ``gather_batch``,
``epoch_batches`` and the mixed-negative and logQ batch extension
(``extend_batch``, ``extend_batch_for_idx``, ``attach_streaming_logq``,
``stream_extend_for_idx``) of ``two_tower_models_tpu/training/data.py``.
The whole dataset lives on the device; a step gathers its batch with index
tensors, so no per-step host copy.  Random draws come from
``torch.Generator``s on the data's device, so the numbers differ from the
JAX package's for the same seed; the distributions are the same.  The
extension's draw (``draw_negative_slots``) is apart from its fill
(``fill_extended_batch``), so a caller can hand the fill slots drawn
elsewhere.
"""

from __future__ import annotations

import dataclasses
import math
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


def draw_negative_slots(model_cfg, data: SyntheticRecData, batch: Batch,
                        generator: torch.Generator) -> Optional[torch.Tensor]:
    """The catalog slots of the mixed negatives, int64 [*lead, B'] uniform in
    [0, C) from ``generator`` (on the data's device: the draw advances it on
    the host and does not wait for the device); ``lead`` is () for a [B]
    batch and (K,) for a stacked [K, B] one, whose rows get independent
    draws.  None without ``mixed_negatives``."""
    b_extra = int(model_cfg.mixed_negatives)
    if b_extra == 0:
        return None
    shape = (*batch.item_id.shape[:-1], b_extra)
    return torch.randint(0, data.catalog_ids.shape[0], shape, generator=generator,
                         device=data.catalog_ids.device)


def _mixed_logq(catalog_logq: torch.Tensor, b: int, b_extra: int) -> torch.Tensor:
    """log(B p(j) + B'/C) per catalog item, in log space: the log proposal
    probability of the mixed pool up to its 1/(B + B') normaliser, a
    constant logit shift the softmax ignores."""
    c = catalog_logq.shape[0]
    uniform = math.log(b_extra / c) if b_extra else -math.inf
    return torch.logaddexp(catalog_logq + math.log(b), torch.full_like(catalog_logq, uniform))


def catalog_positions(catalog_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each id's position in the sorted ``catalog_ids`` (``searchsorted``)."""
    return torch.searchsorted(catalog_ids, ids.to(catalog_ids.dtype).contiguous())


def fill_extended_batch(model_cfg, data: SyntheticRecData, batch: Batch,
                        slots: Optional[torch.Tensor],
                        catalog_logq: Optional[torch.Tensor] = None) -> Batch:
    """The mixed-negative and logQ fields of ``batch`` from drawn catalog
    ``slots`` (``draw_negative_slots``): the slots' catalog ids and features
    as ``neg_item_id``/``neg_item_features`` and, with ``logq_correction``,
    each candidate's log proposal probability under the MIXED distribution
    the pool was drawn from (Yang et al. 2020), log(B p(j) + B'/C), as
    ``item_logq``/``neg_logq``; p is ``catalog_logq`` (default
    ``data.catalog_logq``, aligned with the sorted ``catalog_ids``)."""
    if catalog_logq is None:
        catalog_logq = data.catalog_logq
    if model_cfg.logq_correction and catalog_logq is None:
        raise ValueError(
            "logq_correction needs data.catalog_logq (log sampling "
            "probability per catalog item, aligned with catalog_ids)"
        )
    b_extra = int(model_cfg.mixed_negatives)
    b = batch.item_id.shape[-1]
    upd = {}
    if model_cfg.logq_correction:
        mix_logq = _mixed_logq(catalog_logq, b, b_extra)
    if b_extra > 0:
        upd["neg_item_id"] = data.catalog_ids[slots].to(batch.item_id.dtype)
        upd["neg_item_features"] = data.catalog_features[slots]
        if model_cfg.logq_correction:
            upd["neg_logq"] = mix_logq[slots]
    if model_cfg.logq_correction:
        upd["item_logq"] = mix_logq[catalog_positions(data.catalog_ids, batch.item_id)]
    return batch._replace(**upd)


def extend_batch(model_cfg, data: SyntheticRecData, batch: Batch,
                 generator: torch.Generator,
                 catalog_logq: Optional[torch.Tensor] = None) -> Batch:
    """Fill the mixed-negative and logQ fields of a batch: B' =
    ``model_cfg.mixed_negatives`` catalog rows drawn uniformly from
    ``generator`` as extra softmax negatives and, with ``logq_correction``,
    the corrections (``fill_extended_batch``).  With both features off the
    batch comes back untouched and the generator is not drawn from.
    ``catalog_logq`` overrides ``data.catalog_logq``: the hook of the
    streaming estimator (``training.freq_estimator``)."""
    if int(model_cfg.mixed_negatives) == 0 and not model_cfg.logq_correction:
        return batch
    slots = draw_negative_slots(model_cfg, data, batch, generator)
    return fill_extended_batch(model_cfg, data, batch, slots, catalog_logq)


def _idx_generator(base_seed: int, idx: torch.Tensor, device) -> torch.Generator:
    """A generator seeded from (``base_seed``, the batch's first sample
    index): the JAX package's ``fold_in(base_key, idx[0])``.  Reads that
    index back to the host (one sync)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((base_seed * 1_000_003 + int(idx.reshape(-1)[0])) % (1 << 63))
    return gen


def extend_batch_for_idx(model_cfg, data: SyntheticRecData, batch: Batch, base_seed: int,
                         idx: torch.Tensor) -> Batch:
    """``extend_batch`` keyed by the batch's own sample indices, so the
    negatives are a pure function of (seed, batch schedule): the same on
    every host and across a resume.  The single-device step draws from
    ``TrainState.rng`` instead; this is the mesh paths' form."""
    if not (model_cfg.mixed_negatives or model_cfg.logq_correction):
        return batch
    gen = _idx_generator(base_seed, idx, data.catalog_ids.device)
    return extend_batch(model_cfg, data, batch, gen)


def attach_streaming_logq(model_cfg, train_cfg, batch: Batch, est,
                          catalog_ids: torch.Tensor):
    """Fill ``item_logq``/``neg_logq`` from the STREAMING estimator and
    advance it (``training.freq_estimator``): the corrections use its
    current estimate (cold start: the uniform prior, a constant logit shift
    the softmax ignores), then the batch's items fold in.  The same
    mixed-proposal formula as ``extend_batch``, log(B p(j) + B'/C), with p
    from the decayed counts.  Returns (batch, new estimator state)."""
    from two_tower_models_tpu_torch.training.freq_estimator import freq_log_prob, freq_update

    b_extra = int(model_cfg.mixed_negatives)
    b = batch.item_id.shape[-1]
    mix_logq = _mixed_logq(freq_log_prob(est), b, b_extra)
    pos = catalog_positions(catalog_ids, batch.item_id)
    upd = {"item_logq": mix_logq[pos]}
    if b_extra:
        upd["neg_logq"] = mix_logq[catalog_positions(catalog_ids, batch.neg_item_id)]
    est = freq_update(est, pos, train_cfg.logq_decay)
    return batch._replace(**upd), est


def stream_extend_for_idx(model_cfg, train_cfg, data: SyntheticRecData, batch: Batch,
                          base_seed: int, idx: torch.Tensor, est):
    """``extend_batch_for_idx`` with the streaming estimator supplying the
    corrections: the negatives are drawn without them, then
    ``attach_streaming_logq`` fills them and advances the estimator.  A
    stacked [K, B] batch's rows share one estimate and fold in together.
    Returns (batch, new estimator state)."""
    no_logq = dataclasses.replace(model_cfg, logq_correction=False)
    batch = extend_batch_for_idx(no_logq, data, batch, base_seed, idx)
    return attach_streaming_logq(model_cfg, train_cfg, batch, est, data.catalog_ids)


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
        # The [C] cdf is summed on the host, in order: a CUDA cumsum's scan
        # may combine its partial sums in another order call to call, and
        # an item id at a boundary would then differ between two runs.
        logits = -cfg.popularity_skew * torch.log(torch.arange(1, c + 1, dtype=torch.float32))
        cdf = torch.cumsum(torch.softmax(logits, dim=0), dim=0).to(dev)
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
