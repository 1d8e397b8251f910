"""Weight interop with the torch reference (gauravchak/two_tower_models).

The port's counterpart of the JAX package's ``interop.py``, name for name:
a reference user loads an existing ``state_dict`` into a ``TwoTowerModel``
without retraining, and exports back:

    sd = torch.load("ref.pt")          # or ref_model.state_dict()
    model = params_from_reference_state_dict(sd, cfg)

The port names its parameters by the JAX pytree's flattened paths
(``bridge.flatten``: ``history_encoder.attn_layers.0.in_proj.w``), so the
map below is the JAX package's, leaf for leaf:

    reference module (file:line)                     -> port parameter
    ----------------------------------------------------------------------
    user_id_embedding_arch  (two_tower_base_retrieval.py:70)   user_id_table
    user_features_arch.{0,2} (.py:76-80, Sequential)   user_features_mlp.{i}
    user_tower_arch          (.py:90)                  user_tower_head
    item_id_embedding_arch   (.py:97)                  item_id_table
    item_features_arch.{0,2} (.py:101-105)             item_features_mlp.{i}
    item_tower_arch          (.py:107)                 item_tower_head
    user_history_encoder.multihead_attn_layers.{i}
        (user_history_encoder.py:60-67)   history_encoder.attn_layers.{i}
    position_bias_net_user_value
        (two_tower_with_position_debiased_weights.py:72)  position_bias_table
    user_debias_net_user_value.0
        (two_tower_with_user_debiased_weights.py:96-98,
         two_tower_with_debiasing.py:73-75)             user_debias_head
    ranker_user_tower        (two_tower_plus_light_ranker.py:79)
                                                        ranker_user_tower
    light_ranker             (.py:85)                   light_ranker_head

Layouts: torch ``nn.Linear`` stores weights ``[out, in]``; the port keeps the
JAX package's ``[in, out]`` (``x @ w + b``), so every linear transposes on
the way through, ``nn.MultiheadAttention``'s ``in_proj_weight`` ``[3D, D]``
to the port's ``in_proj.w`` ``[D, 3D]`` included.  Every entry is read as
f32 and then cast to the parameter's dtype, as the JAX package does.

What cannot come from a reference checkpoint, and does not need to: the
MIPS corpus, the positional-encoding table and ``user_value_weights`` are
plain tensors in the reference, outside its ``state_dict``; here the PE is
recomputed, the corpus refreshed from the item tower and the value weights
live in ``ModelConfig``.  Parameters with no reference counterpart
(``proxy_ranker``: the reference's is never assigned to ``self``; the KD
head's aux columns: the reference KD ``train_forward`` is ``pass``; a
user-embedding arm's module) keep the fresh ``init_params(seed, ...)``;
``strict`` only polices reference-side keys.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from two_tower_models_tpu_torch.config import Debias, ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel, init_params

KD_HEAD = ("light_ranker.weight", "light_ranker.bias")


def _f32(x) -> np.ndarray:
    """A torch tensor (any dtype, any device) or an array-like as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _linear(prefix: str, leaf: str) -> Iterator[Tuple[str, str, bool]]:
    yield f"{prefix}.weight", f"{leaf}.w", True
    yield f"{prefix}.bias", f"{leaf}.b", False


def _mapped(cfg: ModelConfig, names) -> Iterator[Tuple[str, str, bool]]:
    """(reference key, port parameter, transpose) for every mapped entry of
    ``cfg``, in the order the JAX package takes them (it raises on the
    first bad one); the KD head's hard columns are apart (``KD_HEAD``)."""
    yield "user_id_embedding_arch.weight", "user_id_table", False
    yield "item_id_embedding_arch.weight", "item_id_table", False
    for side in ("user", "item"):
        n_layers = sum(1 for n in names if n.startswith(f"{side}_features_mlp.") and n.endswith(".w"))
        for i in range(n_layers):  # Sequential(Linear, ReLU, Linear): indices 0, 2
            yield from _linear(f"{side}_features_arch.{2 * i}", f"{side}_features_mlp.{i}")
    yield from _linear("user_tower_arch", "user_tower_head")
    yield from _linear("item_tower_arch", "item_tower_head")
    if cfg.history_encoder is not None:
        for i in range(cfg.history_encoder.num_layers):
            ref, own = f"user_history_encoder.multihead_attn_layers.{i}", f"history_encoder.attn_layers.{i}"
            yield f"{ref}.in_proj_weight", f"{own}.in_proj.w", True
            yield f"{ref}.in_proj_bias", f"{own}.in_proj.b", False
            yield from _linear(f"{ref}.out_proj", f"{own}.out_proj")
    if cfg.debias in (Debias.POSITION, Debias.BOTH):
        yield "position_bias_net_user_value.weight", "position_bias_table", False
    if cfg.debias in (Debias.USER, Debias.BOTH):
        # the reference wraps the single Linear in an nn.Sequential: index 0
        yield from _linear("user_debias_net_user_value.0", "user_debias_head")
    if cfg.light_ranker is not None:
        yield from _linear("ranker_user_tower", "ranker_user_tower")
        if not cfg.kd:
            yield from _linear("light_ranker", "light_ranker_head")


def params_from_reference_state_dict(
    state_dict: Mapping[str, object],
    cfg: ModelConfig,
    seed=0,
    strict: bool = True,
    device="cuda",
) -> TwoTowerModel:
    """A ``TwoTowerModel`` on ``device`` from a reference ``state_dict``
    (torch tensors or numpy arrays).

    Every mappable entry overwrites its parameter of a fresh
    ``init_params(seed, cfg, device)``, which the parameters with no
    reference counterpart keep.  With ``strict`` (default) raises
    ``KeyError`` on a reference key that maps to nothing in this config, or
    on a mappable entry missing from the state_dict: both signal a
    config/checkpoint mismatch.  A shape mismatch always raises
    ``ValueError``."""
    dev = resolve_device(device)
    model = init_params(seed, cfg, device=dev)
    own = dict(model.named_parameters())
    sd = dict(state_dict)
    new: Dict[str, torch.Tensor] = {}

    def take(ref: str, leaf: str, transpose: bool) -> None:
        if ref not in sd:
            if strict:
                raise KeyError(
                    f"reference state_dict is missing '{ref}' (required by this ModelConfig; "
                    f"pass strict=False to keep the fresh init for absent entries)"
                )
            return
        arr = _f32(sd[ref])
        if transpose:
            arr = arr.T
        if arr.shape != tuple(own[leaf].shape):
            raise ValueError(
                f"'{ref}' has shape {arr.shape}" + (" (after transpose)" if transpose else "")
                + f"; this config expects {tuple(own[leaf].shape)}"
            )
        new[leaf] = torch.from_numpy(np.ascontiguousarray(arr)).to(own[leaf].dtype)

    mapped = list(_mapped(cfg, own))
    for ref, leaf, transpose in mapped:
        take(ref, leaf, transpose)
    consumed = {ref for ref, _, _ in mapped if ref in sd}

    if cfg.light_ranker is not None and cfg.kd and (KD_HEAD[0] in sd or strict):
        # KD widens the head to 2T (T hard + T aux columns,
        # two_tower_plus_light_ranker_plus_main_ranker_kd.py:10-19); a
        # reference checkpoint carries only the T hard columns (its KD
        # train_forward is `pass`).  Import them; the aux columns keep init.
        missing = [k for k in KD_HEAD if k not in sd]
        if missing:
            raise KeyError(f"reference state_dict is missing {missing} (the KD head's hard columns)")
        t = cfg.num_tasks
        w = own["light_ranker_head.w"].detach().to("cpu", torch.float32).numpy().copy()
        b = own["light_ranker_head.b"].detach().to("cpu", torch.float32).numpy().copy()
        hard_w, hard_b = _f32(sd[KD_HEAD[0]]).T, _f32(sd[KD_HEAD[1]])
        if hard_w.shape != w[:, :t].shape or hard_b.shape != b[:t].shape:
            raise ValueError(
                f"'light_ranker' has shapes {hard_w.shape} (after transpose), {hard_b.shape}; "
                f"this config expects {w[:, :t].shape}, {b[:t].shape}"
            )
        w[:, :t], b[:t] = hard_w, hard_b
        for leaf, arr in (("light_ranker_head.w", w), ("light_ranker_head.b", b)):
            new[leaf] = torch.from_numpy(arr).to(own[leaf].dtype)
        consumed.update(KD_HEAD)

    if strict:
        unused = sorted(set(sd) - consumed)
        if unused:
            raise KeyError(
                f"reference state_dict entries with no counterpart in this ModelConfig: {unused} "
                f"(wrong config/preset for this checkpoint? pass strict=False to ignore)"
            )
    with torch.no_grad():
        for leaf, t in new.items():
            own[leaf].copy_(t.to(dev))
    return model


def reference_state_dict_from_params(model: TwoTowerModel, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference's state_dict names, as f32
    CPU tensors in torch's layouts: the exact inverse of
    ``params_from_reference_state_dict`` for every mappable entry.  Load
    with ``ref_model.load_state_dict(sd, strict=False)`` (the reference's
    non-persistent tensors appear in neither direction)."""
    own = dict(model.named_parameters())
    cpu = lambda leaf: own[leaf].detach().to("cpu", torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    for ref, leaf, transpose in _mapped(cfg, own):
        t = cpu(leaf)
        sd[ref] = (t.T if transpose else t).contiguous().clone()
    if cfg.light_ranker is not None and cfg.kd:  # only the T hard-label columns the reference knows
        t = cfg.num_tasks
        sd[KD_HEAD[0]] = cpu("light_ranker_head.w").T[:t].contiguous().clone()
        sd[KD_HEAD[1]] = cpu("light_ranker_head.b")[:t].clone()
    return sd
