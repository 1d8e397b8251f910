"""Configuration of the PyTorch port: the model-space dataclasses of
``two_tower_models_tpu.config``, copied field for field so the port imports
nothing of the JAX package, plus the device rules of the port's entry points.

``pdtype``/``cdtype`` return torch dtypes.  AUTO (``None``) kernel flags
resolve against the device a call runs on (``resolve_kernel_flags``), at
apply time, never when a config or a model is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


class Debias:
    """Which example-weight debiasing head is active (NONE / POSITION / USER /
    BOTH, the reference's ``debias_net_user_value`` hook family)."""

    NONE = "none"
    POSITION = "position"
    USER = "user"
    BOTH = "both"

    ALL = (NONE, POSITION, USER, BOTH)


@dataclass(frozen=True)
class HistoryEncoderConfig:
    """User-history encoder: ``num_layers`` self-attention layers of
    ``num_heads`` heads over the embedded history, plus a mean-pool."""

    num_heads: int = 4
    num_layers: int = 3
    use_positional_encoding: bool = True
    # Per-layer and blockwise attention kernels of the JAX package; not
    # ported yet (ROADMAP.md, queue B).  The port raises when either is set.
    blockwise_kernel: bool = False
    fused_kernel: bool = False
    # Whole-encoder kernel (ops.fused_encoder).  None = AUTO: on iff the
    # call runs on a CUDA device (resolve_kernel_flags).
    fused_encoder: bool | None = None


@dataclass(frozen=True)
class LightRankerConfig:
    """Two-stage retrieval: ``num_mips_items`` MIPS candidates reranked by a
    pointwise head fed by ``num_ranker_user_embeddings`` user embeddings."""

    num_mips_items: int = 50
    num_ranker_user_embeddings: int = 4


@dataclass(frozen=True)
class ModelConfig:
    """Full model-space configuration (glossary: B batch, T tasks, DU/DI
    user/item id-embedding dims, IU/II dense-feature sizes, H history
    length, C corpus size)."""

    user_id_hash_size: int = 1024
    user_id_embedding_dim: int = 32  # DU
    item_id_hash_size: int = 1024
    item_id_embedding_dim: int = 32  # DI (== tower output dim == MIPS dim)

    user_features_size: int = 8  # IU
    item_features_size: int = 8  # II
    feature_hidden_dim: int = 256

    user_value_weights: Tuple[float, ...] = (1.0,)  # [T]

    num_items: int = 10  # items returned per query at inference
    approx_mips: bool = False
    mips_recall_target: float = 0.95

    user_embedding_arm: str = "table"

    history_len: int = 10  # H
    history_encoder: Optional[HistoryEncoderConfig] = None

    debias: str = Debias.NONE
    position_table_size: int = 100
    position_debias_min: float = 1e-3
    user_debias_min: float = 1e-1
    combined_debias_min: float = 1e-3
    nuv_min: float = 1e-6
    debias_aux_weight: float = 1.0

    mixed_negatives: int = 0
    logq_correction: bool = False

    light_ranker: Optional[LightRankerConfig] = None
    kd: bool = False
    kd_loss_weight: float = 1.0
    reward_model: bool = False
    reward_model_loss_weight: float = 1.0

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # In-batch softmax-CE kernel (training; not in the serving slice).
    # None = AUTO: on iff the call runs on a CUDA device.
    fused_loss: bool | None = None

    @property
    def num_tasks(self) -> int:
        return len(self.user_value_weights)

    @property
    def user_tower_input_dim(self) -> int:
        base = 2 * self.user_id_embedding_dim
        if self.history_encoder is not None:
            base += 2 * self.item_id_embedding_dim
        return base

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def validate(self) -> "ModelConfig":
        if self.debias not in Debias.ALL:
            raise ValueError(f"debias must be one of {Debias.ALL}, got {self.debias!r}")
        if self.kd and self.light_ranker is None:
            raise ValueError("kd=True requires a light_ranker config")
        if self.light_ranker is not None and self.history_encoder is None:
            raise ValueError("light_ranker requires history_encoder")
        if self.history_encoder is not None:
            if self.item_id_embedding_dim % self.history_encoder.num_heads != 0:
                raise ValueError("item_id_embedding_dim must divide evenly by num_heads")
        if (
            self.light_ranker is not None
            and self.light_ranker.num_mips_items < self.num_items
        ):
            raise ValueError(
                f"light_ranker.num_mips_items ({self.light_ranker.num_mips_items}) "
                f"must be >= num_items ({self.num_items})"
            )
        return self


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; without a
    GPU the caller must ask for the CPU explicitly, so a run that meant to
    measure the card never silently measures the host.  On CUDA, TF32 is
    switched off: it keeps ~3 decimal digits and would change f32 results
    (the JAX reference runs f32 matmuls at full precision)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_kernel_flags(cfg: ModelConfig, device) -> ModelConfig:
    """Resolve AUTO (None) kernel flags: enabled iff ``device`` is CUDA.
    Explicit True/False pass through untouched."""
    on_gpu = torch.device(device).type == "cuda"
    out = cfg
    if cfg.fused_loss is None:
        out = dataclasses.replace(out, fused_loss=on_gpu)
    he = cfg.history_encoder
    if he is not None and he.fused_encoder is None:
        auto = on_gpu and not (he.fused_kernel or he.blockwise_kernel)
        out = dataclasses.replace(
            out, history_encoder=dataclasses.replace(he, fused_encoder=auto)
        )
    return out


def _hist() -> HistoryEncoderConfig:
    return HistoryEncoderConfig()


def preset(name: str, **overrides) -> ModelConfig:
    """Named presets mirroring the reference model zoo (PRESET_NAMES)."""
    presets = {
        "two_tower_base_retrieval": dict(),
        "two_tower_with_user_history_encoder": dict(history_encoder=_hist()),
        "two_tower_with_position_debiased_weights": dict(
            history_encoder=_hist(), debias=Debias.POSITION
        ),
        "two_tower_with_user_debiased_weights": dict(
            history_encoder=_hist(), debias=Debias.USER
        ),
        "two_tower_with_debiasing": dict(history_encoder=_hist(), debias=Debias.BOTH),
        "two_tower_plus_light_ranker": dict(
            history_encoder=_hist(), debias=Debias.BOTH, light_ranker=LightRankerConfig()
        ),
        "two_tower_plus_light_ranker_kd": dict(
            history_encoder=_hist(),
            debias=Debias.BOTH,
            light_ranker=LightRankerConfig(),
            kd=True,
        ),
        "two_tower_with_main_ranker_reward": dict(
            history_encoder=_hist(), debias=Debias.BOTH, reward_model=True
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(presets)}")
    kwargs = dict(presets[name])
    kwargs.update(overrides)
    return ModelConfig(**kwargs).validate()


PRESET_NAMES = (
    "two_tower_base_retrieval",
    "two_tower_with_user_history_encoder",
    "two_tower_with_position_debiased_weights",
    "two_tower_with_user_debiased_weights",
    "two_tower_with_debiasing",
    "two_tower_plus_light_ranker",
    "two_tower_plus_light_ranker_kd",
    "two_tower_with_main_ranker_reward",
)
