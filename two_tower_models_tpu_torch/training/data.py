"""Training data held on the device and batches gathered by index.

Port of ``SyntheticRecData`` and ``gather_batch`` of
``two_tower_models_tpu/training/data.py``.  The whole dataset lives on the
device; a step gathers its batch with index tensors, so no per-step host
copy.  ``make_synthetic_data`` and ``extend_batch`` are not ported yet
(ROADMAP.md, queue A, 'Training loop' and 'Mixed negatives and logQ').
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
