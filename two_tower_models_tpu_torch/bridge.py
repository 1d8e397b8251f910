"""Weight bridge between the JAX package's params pytree and the port.

The port names every parameter by its JAX pytree path (dict keys and list
indices joined by dots: ``history_encoder.attn_layers.0.in_proj.w``) and
keeps JAX's [in, out] weight layout, so the bridge is a flatten on one
side and an unflatten on the other.  The pytree travels as numpy arrays in
nested dicts and lists, exactly as ``init_params`` builds it; nothing here
imports JAX.  optax's Adam moments have the params' structure and cross
the same way (``adam_state_from_jax`` / ``adam_state_to_jax``), and so do the
lazy-Adam state (``lazy_state_from_jax`` / ``lazy_state_to_jax``) and the
streaming logQ estimator (``freq_state_from_jax`` / ``freq_state_to_jax``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel
from two_tower_models_tpu_torch.nn.packed_table import packed_shape
from two_tower_models_tpu_torch.training.freq_estimator import FreqEstimatorState
from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS
from two_tower_models_tpu_torch.training.state import AdamState, LazyAdamState


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def flatten(tree) -> Dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {dotted pytree path: array}: the
    parameter names of the port's modules."""
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, "", out)
    return out


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> TwoTowerModel:
    """JAX params pytree (numpy leaves) -> a ``TwoTowerModel`` on
    ``device`` holding the same values.  An id table may come in its
    128-lane-packed shape (``packed_shape(vocab, dim)``, as
    ``maybe_pack_tables`` leaves it) and stays packed.  Raises on any
    missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    flat = flatten(np_tree)
    model = TwoTowerModel(cfg, dev)
    own = dict(model.named_parameters())
    missing, extra = set(own) - set(flat), set(flat) - set(own)
    if missing or extra:
        raise KeyError(
            f"params do not match the config: missing {sorted(missing)}, "
            f"unexpected {sorted(extra)}"
        )
    for name, vocab, dim in (
        ("user_id_table", cfg.user_id_hash_size, cfg.user_id_embedding_dim),
        ("item_id_table", cfg.item_id_hash_size, cfg.item_id_embedding_dim),
    ):
        shape = packed_shape(vocab, dim)
        if tuple(flat[name].shape) == shape != (vocab, dim):
            setattr(model, name, nn.Parameter(own[name].new_empty(shape)))
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in own.items():
            src = flat[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {src.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src, copy=True)).to(p.dtype))
    return model


def _moments(tree, own: Dict[str, torch.Tensor], dtype=None) -> Dict[str, torch.Tensor]:
    flat = flatten(tree)
    if set(flat) != set(own):
        raise KeyError(f"moments do not match the params: {sorted(set(flat) ^ set(own))}")
    out = {}
    for n, p in own.items():
        if tuple(flat[n].shape) != tuple(p.shape):
            raise ValueError(f"moment {n}: shape {flat[n].shape}, expected {tuple(p.shape)}")
        out[n] = torch.from_numpy(np.array(flat[n], copy=True)).to(device=p.device, dtype=dtype or p.dtype)
    return out


def adam_state_from_jax(count, mu_tree, nu_tree, model: TwoTowerModel, exclude=()) -> AdamState:
    """optax's Adam state (``count`` and the ``mu`` and ``nu`` pytrees, as
    numpy) -> the port's ``AdamState`` for ``model``'s parameters but those
    named in ``exclude``, on its device."""
    own = {n: p for n, p in model.named_parameters() if n not in exclude}
    count_t = torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=model.item_id_table.device)
    return AdamState(count_t, _moments(mu_tree, own), _moments(nu_tree, own))


def _tree(tensors: Dict[str, torch.Tensor]):
    return _unflatten({n: t.detach().cpu().numpy().copy() for n, t in tensors.items()})


def adam_state_to_jax(state: AdamState):
    """The inverse: (count, mu pytree, nu pytree) as numpy."""
    return np.asarray(state.count.item(), np.int32), _tree(state.mu), _tree(state.nu)


def lazy_state_from_jax(np_state, model: TwoTowerModel) -> LazyAdamState:
    """The JAX package's lazy-Adam opt state as numpy, ``{"dense": (count,
    mu pytree, nu pytree) of optax's Adam over the dense subtree, "tables":
    {"mu": {table: array}, "nu": {table: array}}}``, -> the port's
    ``LazyAdamState`` for ``model``; table moments keep the tables' storage
    shape (packed or plain) and are f32."""
    dense = adam_state_from_jax(*np_state["dense"], model, exclude=SPARSE_TABLE_KEYS)
    tables = {n: p for n, p in model.named_parameters() if n in SPARSE_TABLE_KEYS}
    return LazyAdamState(dense, {k: _moments(np_state["tables"][k], tables, torch.float32)
                                 for k in ("mu", "nu")})


def lazy_state_to_jax(state: LazyAdamState):
    """The inverse of ``lazy_state_from_jax``."""
    return {"dense": adam_state_to_jax(state.dense),
            "tables": {k: _tree(state.tables[k]) for k in ("mu", "nu")}}


def freq_state_from_jax(counts, total, device="cuda") -> FreqEstimatorState:
    """The JAX package's ``FreqEstimatorState`` fields as numpy (``counts``
    [C], ``total`` []) -> the port's, f32 on ``device``."""
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)
    return FreqEstimatorState(counts=as_t(counts).reshape(-1), total=as_t(total).reshape(()))


def freq_state_to_jax(state: FreqEstimatorState):
    """The inverse: (counts [C], total []) as f32 numpy."""
    return (state.counts.detach().cpu().numpy().copy(),
            np.asarray(state.total.detach().cpu().numpy(), np.float32))


def _unflatten(flat: Dict[str, np.ndarray]):
    """{dotted path: array} -> nested dicts and lists (a node whose keys are
    all indices is a list)."""
    root: dict = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def params_to_jax(model: TwoTowerModel):
    """The inverse: nested dicts and lists of numpy arrays in the JAX
    pytree's structure."""
    return _unflatten({n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()})
