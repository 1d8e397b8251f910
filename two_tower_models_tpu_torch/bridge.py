"""Weight bridge between the JAX package's params pytree and the port.

The port names every parameter by its JAX pytree path (dict keys and list
indices joined by dots: ``history_encoder.attn_layers.0.in_proj.w``) and
keeps JAX's [in, out] weight layout, so the bridge is a flatten on one
side and an unflatten on the other.  The pytree travels as numpy arrays in
nested dicts and lists, exactly as ``init_params`` builds it; nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from two_tower_models_tpu_torch.config import ModelConfig, resolve_device
from two_tower_models_tpu_torch.models.two_tower import TwoTowerModel


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


def params_to_jax(model: TwoTowerModel):
    """The inverse: nested dicts and lists of numpy arrays in the JAX
    pytree's structure (a node whose keys are all indices is a list)."""
    root: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().cpu().numpy().copy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)
