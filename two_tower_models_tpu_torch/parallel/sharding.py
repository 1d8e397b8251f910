"""Sharding layout of the parameters, and a rank's own cut of them.

Port of ``two_tower_models_tpu/parallel/sharding.py:25-78``.  Placement:

  * Embedding tables (``user_id_table``, ``item_id_table``) -- row-sharded
    over the ``model`` axis, ``("model", None)``: each rank owns V/n rows
    (physical rows of a 128-lane-packed table, ``nn/packed_table.py``).
  * With ``tower_tp`` the feature MLPs split Megatron-style: layer 0 by
    columns, layer 1 by rows (``_tp_mlp_spec``).
  * Everything else replicates, ``()``.

A spec is a tuple with one entry a dim, the axis that dim is split over
or None, as a JAX ``PartitionSpec`` reads.  JAX's ``shard_map`` cuts each
device's block from the global array by those specs; the port, one process
a rank, cuts the rank's own ``TwoTowerModel`` once (``shard_params``).
``state_pspecs`` and ``shard_state`` wait for A13b.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn

from two_tower_models_tpu_torch.parallel.mesh import MODEL_AXIS, mesh_shape
from two_tower_models_tpu_torch.parallel.train_step import check_mesh_tables

# Row-sharded over `model`; everything else replicates.  (The position-bias
# table is not here: 100 x 1 -- sharding it would cost a collective per
# lookup to save 400 bytes.)
_TABLE_KEYS = ("user_id_table", "item_id_table")
# Feature-MLP keys eligible for tensor parallelism (tower_tp): layer 0
# column-split, layer 1 row-split (one all-reduce after layer 1).
_TP_MLP_KEYS = ("user_features_mlp", "item_features_mlp")


def _tp_mlp_spec(parts):
    """TP spec for an (mlp-name, layer-index, 'w'|'b') path suffix, else None."""
    for i, n in enumerate(parts):
        if n in _TP_MLP_KEYS:
            if i + 2 >= len(parts):
                return None
            layer, leafn = parts[i + 1], parts[i + 2]
            if layer == "0":  # column-parallel: out features split
                return (None, MODEL_AXIS) if leafn == "w" else (MODEL_AXIS,)
            if layer == "1":  # row-parallel: in features split, bias replicated
                return (MODEL_AXIS, None) if leafn == "w" else ()
            return ()
    return None


def param_pspecs(params: nn.Module, tower_tp: bool = False) -> Dict[str, tuple]:
    """{parameter name: spec} for every leaf of ``params``."""

    def spec_for(name):
        parts = name.split(".")
        if parts[0] in _TABLE_KEYS:
            return (MODEL_AXIS, None)
        if tower_tp:
            tp = _tp_mlp_spec(parts)
            if tp is not None:
                return tp
        return ()  # replicated

    return {name: spec_for(name) for name, _ in params.named_parameters()}


def shard_params(params: nn.Module, cfg, mesh, tower_tp: bool = False, device=None) -> nn.Module:
    """This rank's block of the full model ``params`` on ``device``: every
    dim a spec splits over ``model`` cut to this rank's 1/n_model of it
    (rank m of the model axis takes block m), the rest copied whole.  The
    copy is frozen (``requires_grad`` off), for serving; ``params`` is left
    as it is."""
    n_model = mesh_shape(mesh)[1]
    m = mesh.get_local_rank(MODEL_AXIS)
    check_mesh_tables(params, cfg, n_model)
    specs = param_pspecs(params, tower_tp)
    memo = {}
    for name, p in params.named_parameters():
        t = p.detach()
        for dim, axis in enumerate(specs[name]):
            if axis == MODEL_AXIS:
                if t.shape[dim] % n_model:
                    raise ValueError(f"{name} has {t.shape[dim]} entries on dim {dim}, not "
                                     f"divisible by the model axis ({n_model})")
                size = t.shape[dim] // n_model
                t = t.narrow(dim, m * size, size)
        own = torch.empty(t.shape, dtype=t.dtype, device=device or t.device).copy_(t)
        memo[id(p)] = nn.Parameter(own, requires_grad=False)
    # deepcopy takes every parameter from the memo, so the full tables are
    # never copied; the modules around them are
    return copy.deepcopy(params, memo).eval()
