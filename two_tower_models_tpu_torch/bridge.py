"""Weight bridge between the JAX package's params pytree and the port.

The port names every parameter by its JAX pytree path (dict keys and list
indices joined by dots: ``history_encoder.attn_layers.0.in_proj.w``) and
keeps JAX's [in, out] weight layout, so the bridge is a flatten on one
side and an unflatten on the other.  The pytree travels as numpy arrays in
nested dicts and lists, exactly as ``init_params`` builds it; nothing here
imports JAX.  optax's Adam moments have the params' structure and cross
the same way (``adam_state_from_jax`` / ``adam_state_to_jax``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel
from two_tower_models_tpu_torch.training.state import AdamState


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
    ``device`` holding the same values.  Raises on any missing, extra or
    misshapen leaf."""
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
    with torch.no_grad():
        for name, p in own.items():
            src = flat[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {src.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src, copy=True)).to(p.dtype))
    return model


def adam_state_from_jax(count, mu_tree, nu_tree, model: TwoTowerModel) -> AdamState:
    """optax's Adam state (``count`` and the ``mu`` and ``nu`` pytrees, as
    numpy) -> the port's ``AdamState`` for ``model``, on its device."""
    own = dict(model.named_parameters())
    dev = model.item_id_table.device
    moments = []
    for tree in (mu_tree, nu_tree):
        flat = flatten(tree)
        if set(flat) != set(own):
            raise KeyError(f"moments do not match the params: {sorted(set(flat) ^ set(own))}")
        moments.append({n: torch.from_numpy(np.array(flat[n], copy=True)).to(
            device=dev, dtype=p.dtype) for n, p in own.items()})
    count_t = torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev)
    return AdamState(count_t, *moments)


def adam_state_to_jax(state: AdamState):
    """The inverse: (count, mu pytree, nu pytree) as numpy."""
    return (
        np.asarray(state.count.item(), np.int32),
        _unflatten({n: t.detach().cpu().numpy().copy() for n, t in state.mu.items()}),
        _unflatten({n: t.detach().cpu().numpy().copy() for n, t in state.nu.items()}),
    )


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
