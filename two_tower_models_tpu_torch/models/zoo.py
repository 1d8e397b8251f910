"""Model-zoo builder API.

Port of ``two_tower_models_tpu/models/zoo.py``.  For users coming from the
reference's class-per-variant surface (TwoTowerBaseRetrieval and its
subclasses), each builder here makes the matching ``ModelConfig`` and
returns a small stateless handle bundling the config with the functional
entry points of ``models.two_tower``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from two_tower_models_tpu_torch.config import (
    Debias,
    HistoryEncoderConfig,
    LightRankerConfig,
    ModelConfig,
    preset,
    resolve_kernel_flags,
)
from two_tower_models_tpu_torch.models import two_tower


@dataclass(frozen=True)
class TwoTowerModel:
    """Stateless handle: a config, the device it runs on, and the entry
    points.  It holds no tensors: ``init(seed_or_generator)`` returns the
    parameter module, a ``models.two_tower.TwoTowerModel``, which the other
    entry points take as ``params``.

    AUTO (None) kernel flags resolve against ``device`` at construction
    (``config.resolve_kernel_flags``): the CUDA kernels on the card, the
    plain PyTorch path on the CPU.

    Usage:
        model = zoo.two_tower_base_retrieval(num_items=10, ...)
        params = model.init(0)
        loss, metrics = model.train_forward(params, batch)
        top_items = model.forward(params, corpus, user_id, user_features, user_history)
    """

    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "cfg", resolve_kernel_flags(self.cfg, self.device))

    def init(self, seed_or_generator) -> two_tower.TwoTowerModel:
        return two_tower.init_params(seed_or_generator, self.cfg, device=self.device)

    def train_forward(self, params: two_tower.TwoTowerModel, batch: two_tower.Batch):
        """Scalar loss and metrics (``two_tower.train_loss``)."""
        return two_tower.train_loss(params, self.cfg, batch)

    def forward(self, params: two_tower.TwoTowerModel, corpus: torch.Tensor, user_id,
                user_features, user_history) -> torch.Tensor:
        """Top ``num_items`` corpus indices [B, num_items] (``two_tower.retrieve``)."""
        return two_tower.retrieve(params, self.cfg, corpus, user_id, user_features,
                                  user_history, device=self.device)

    def compute_user_embedding(self, params, user_id, user_features, user_history):
        return two_tower.compute_user_embedding(
            params, self.cfg, user_id, user_features, user_history
        )

    def compute_item_embeddings(self, params, item_id, item_features):
        return two_tower.compute_item_embeddings(params, self.cfg, item_id, item_features)


def two_tower_base_retrieval(*, device="cuda", **kwargs) -> TwoTowerModel:
    """Reference: TwoTowerBaseRetrieval."""
    return TwoTowerModel(ModelConfig(**kwargs).validate(), device)


def two_tower_with_user_history_encoder(
    *, user_history_seqlen: int, history_encoder: HistoryEncoderConfig | None = None,
    device="cuda", **kwargs
) -> TwoTowerModel:
    """Reference: TwoTowerWithUserHistoryEncoder (4 heads, 3 layers and the
    positional encoding by default, the reference's choices)."""
    cfg = ModelConfig(
        history_len=user_history_seqlen,
        history_encoder=history_encoder or HistoryEncoderConfig(),
        **kwargs,
    )
    return TwoTowerModel(cfg.validate(), device)


def _debiased(debias: str, user_history_seqlen: int, device, **kwargs) -> TwoTowerModel:
    cfg = ModelConfig(
        history_len=user_history_seqlen,
        history_encoder=HistoryEncoderConfig(),
        debias=debias,
        **kwargs,
    )
    return TwoTowerModel(cfg.validate(), device)


def two_tower_with_position_debiased_weights(*, user_history_seqlen: int, device="cuda",
                                             **kwargs) -> TwoTowerModel:
    """Reference: TwoTowerWithPositionDebiasedWeights."""
    return _debiased(Debias.POSITION, user_history_seqlen, device, **kwargs)


def two_tower_with_user_debiased_weights(*, user_history_seqlen: int, device="cuda",
                                         **kwargs) -> TwoTowerModel:
    """Reference: TwoTowerWithUserDebiasedWeights."""
    return _debiased(Debias.USER, user_history_seqlen, device, **kwargs)


def two_tower_with_debiasing(*, user_history_seqlen: int, device="cuda",
                             **kwargs) -> TwoTowerModel:
    """Reference: TwoTowerWithDebiasing."""
    return _debiased(Debias.BOTH, user_history_seqlen, device, **kwargs)


def two_tower_plus_light_ranker(
    *, user_history_seqlen: int, num_mips_items: int, num_ranker_user_embeddings: int,
    device="cuda", **kwargs
) -> TwoTowerModel:
    """Reference: TwoTowerPlusLightRanker: MIPS top ``num_mips_items``
    reranked by a pointwise head over ``num_ranker_user_embeddings`` user
    embeddings."""
    light_ranker = LightRankerConfig(
        num_mips_items=num_mips_items, num_ranker_user_embeddings=num_ranker_user_embeddings
    )
    return _debiased(Debias.BOTH, user_history_seqlen, device, light_ranker=light_ranker,
                     **kwargs)


def two_tower_plus_light_ranker_with_kd(
    *, user_history_seqlen: int, num_mips_items: int, num_ranker_user_embeddings: int,
    device="cuda", **kwargs
) -> TwoTowerModel:
    """Reference: TwoTowerPlusLightRankerWithKD: labels widen to [B, 2T] and
    the head's T aux logits distill against the soft labels."""
    base = two_tower_plus_light_ranker(
        user_history_seqlen=user_history_seqlen,
        num_mips_items=num_mips_items,
        num_ranker_user_embeddings=num_ranker_user_embeddings,
        device=device,
        **kwargs,
    )
    return TwoTowerModel(replace(base.cfg, kd=True).validate(), device)


def two_tower_with_main_ranker_reward(*, user_history_seqlen: int, device="cuda",
                                      **kwargs) -> TwoTowerModel:
    """Reference: TwoTowerWithMainRankerReward: the KL alignment of the
    retrieval softmax with a proxy ranker's top probabilities."""
    return _debiased(Debias.BOTH, user_history_seqlen, device, reward_model=True, **kwargs)


def from_preset(name: str, device="cuda", **overrides) -> TwoTowerModel:
    return TwoTowerModel(preset(name, **overrides), device)
