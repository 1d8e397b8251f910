"""Configuration of the PyTorch port: the model-space dataclasses,
``MeshConfig``, ``DataConfig``, ``TrainConfig`` and ``ExperimentConfig`` of
``two_tower_models_tpu.config``, copied field for field so the port imports
nothing of the JAX package, plus the device rules of the port's entry
points.

``pdtype``/``cdtype`` return torch dtypes.  AUTO (``None``) kernel flags
resolve against the device a call runs on (``resolve_kernel_flags``), at
apply time, never when a config or a model is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
    # Per-layer attention tiers, read when fused_encoder is off: each layer
    # in one kernel (fused_kernel, ops.fused_mha), or its attention
    # blockwise, O(H) memory in both directions (blockwise_kernel,
    # ops.history_attention: for histories whose [H, H] probabilities do
    # not fit).  fused_kernel wins when both are set.  Either turns the
    # AUTO fused_encoder off.
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


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout, field for field the JAX package's ``MeshConfig``
    (its comments say what each field does there).  Serving takes a mesh
    (``parallel.mesh.make_mesh``, ``RetrievalEngine(mesh=...)``), and so
    does the explicit training step
    (``parallel.train_step.make_sharded_train_step``); the training loop on
    a mesh waits for A13b, part 2, and A13d: ``training.loop.train`` raises
    when ``data * model > 1`` (``check_single_device``)."""

    data: int = 1
    model: int = 1
    explicit_collectives: bool = True
    global_negatives: bool = True
    tower_tp: bool = False
    ring_negatives: bool = False
    sparse_table_grads: str = "auto"


def check_single_device(mesh: MeshConfig) -> None:
    """Raise unless ``mesh`` is one device: the training loop on a mesh is
    not ported (serving is, ``RetrievalEngine(mesh=...)``, and the step,
    ``parallel.train_step.make_sharded_train_step``)."""
    if mesh.data * mesh.model > 1:
        raise NotImplementedError(
            f"the training loop on a {mesh.data} x {mesh.model} mesh is not ported yet "
            "(ROADMAP.md, queue A, A13b, part 2, and A13d of A13 'Multi-device')"
        )


@dataclass(frozen=True)
class DataConfig:
    """Synthetic dataset, field for field the JAX package's ``DataConfig``
    (``training.data.make_synthetic_data``; its comments say what each
    field does there)."""

    num_samples: int = 1000
    num_users: int = 100
    num_items: int = 200  # corpus size C
    feature_dim: int = 8
    history_len: int = 10
    num_tasks: int = 1
    max_position: int = 10
    seed: int = 0
    structured: bool = True  # plant the 8-group user-item affinity
    variable_history: bool = False  # per-example lengths in [1, H], id 0 past them
    popularity_skew: float = 0.0  # Zipf exponent of item engagement (0: uniform)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration, field for field the JAX package's
    ``TrainConfig`` (its comments say what each knob does there).  The port
    trains through ``training.step.make_train_step``, packed tables
    (``pack_tables``, ``pack_tables_min_rows``), ``lazy_table_adam``,
    ``fused_adam`` and ``streaming_logq`` included, and loops through
    ``training.loop.train``."""

    batch_size: int = 32
    num_epochs: int = 2
    learning_rate: float = 1e-3
    grad_clip_norm: Optional[float] = None  # global-norm clip before Adam
    seed: int = 42
    log_every: int = 10
    eval_every: int = 0
    eval_top_k: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    profile_dir: Optional[str] = None
    donate_state: bool = True
    steps_per_dispatch: int = 1  # K > 1: K steps per call, metrics averaged
    debug_nans: bool = False
    lazy_table_adam: bool = False
    pack_tables: bool = True
    pack_tables_min_rows: int = 1 << 22
    streaming_logq: bool = False
    logq_decay: float = 0.999
    fused_adam: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


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
