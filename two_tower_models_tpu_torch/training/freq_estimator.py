"""Streaming item-frequency estimator for the logQ correction.

Port of ``two_tower_models_tpu/training/freq_estimator.py``: a small state
on the device, per catalog slot j

  counts[j]  the exponentially decayed occurrence count
  total      the equally decayed sample count

advanced once a training batch, ``counts <- decay * counts + bincount(batch)``
and ``total <- decay * total + B``, with the add-one smoothed estimate
``p(j) = (counts[j] + 1) / (total + C)``, the same formula family as the
synthetic data's oracle ``catalog_logq``.  The state rides in
``TrainState.logq_state`` and is checkpointed with the rest of the state,
so a resumed run continues the exact counts.

Rounding: the JAX package adds 1.0 once per occurrence
(``(counts * decay).at[pos].add(1.0)``), which rounds at each add; here a
slot's occurrences are counted first, as integers, and added once, which
rounds once.  The two differ only where a sum crosses a power of two within
one batch, by at most one unit in the last place per batch; over 50 Zipf
batches the counts stay within 1e-6 relative of the JAX package's
(tests/test_torch_freq_estimator.py).  The integer count is a scatter-add
of int32 ones, exact and so deterministic in any order: no float atomics,
no host sync (``torch.bincount`` reads the largest id back to the host).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FreqEstimatorState(NamedTuple):
    counts: torch.Tensor  # [C] f32 decayed occurrence counts per catalog slot
    total: torch.Tensor  # [] f32 decayed total sample count


def init_freq_estimator(num_items: int, device="cpu") -> FreqEstimatorState:
    return FreqEstimatorState(
        counts=torch.zeros(num_items, dtype=torch.float32, device=device),
        total=torch.zeros((), dtype=torch.float32, device=device),
    )


def freq_update(est: FreqEstimatorState, item_pos: torch.Tensor, decay: float) -> FreqEstimatorState:
    """Fold one batch of catalog POSITIONS (not raw ids: map them with
    ``searchsorted(catalog_ids, item_id)`` first) into the decayed counts;
    returns a new state."""
    pos = item_pos.reshape(-1).long()
    hits = torch.zeros(est.counts.shape, dtype=torch.int32, device=pos.device)
    hits.scatter_add_(0, pos, torch.ones_like(pos, dtype=torch.int32))
    return FreqEstimatorState(
        counts=est.counts * decay + hits.float(),
        total=est.total * decay + pos.numel(),
    )


def freq_log_prob(est: FreqEstimatorState) -> torch.Tensor:
    """[C] log p(j) with add-one smoothing, interchangeable with the oracle
    ``catalog_logq = log((count + 1) / (N + C))``."""
    c = est.counts.shape[0]
    return torch.log((est.counts + 1.0) / (est.total + c))
