"""Sharding layout of the parameters, and a rank's own cut of them.

Port of ``two_tower_models_tpu/parallel/sharding.py``.  Placement:

  * Embedding tables (``user_id_table``, ``item_id_table``) -- row-sharded
    over the ``model`` axis, ``("model", None)``: each rank owns V/n rows
    (physical rows of a 128-lane-packed table, ``nn/packed_table.py``).
  * With ``tower_tp`` the feature MLPs split Megatron-style: layer 0 by
    columns, layer 1 by rows (``_tp_mlp_spec``).
  * Everything else replicates, ``()``.

A spec is a tuple with one entry a dim, the axis that dim is split over
or None, as a JAX ``PartitionSpec`` reads.  JAX's ``shard_map`` cuts each
device's block from the global array by those specs; the port, one process
a rank, cuts the rank's own ``TwoTowerModel`` once: frozen for serving
(``shard_params``), or with its optimizer state for training
(``shard_state``, the explicit step ``parallel.train_step``).
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn

from two_tower_models_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_shape
from two_tower_models_tpu_torch.parallel.train_step import check_mesh_tables
from two_tower_models_tpu_torch.training.state import AdamState, TrainState

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


def state_pspecs(state: TrainState, tower_tp: bool = False) -> TrainState:
    """The spec of every leaf of a ``TrainState`` (JAX's ``state_pspecs``):
    Adam's moments take their parameter's, ``step``, ``count``, ``rng``
    and the streaming estimator replicate."""
    pspecs = param_pspecs(state.params, tower_tp)
    opt = state.opt_state
    if not isinstance(opt, AdamState):
        raise ValueError(
            "the explicit mesh step keeps dense Adam (as the JAX package's does); "
            "make the state with lazy_table_adam=False"
        )
    moments = lambda tree: {name: pspecs[name] for name in tree}
    logq = None if state.logq_state is None else type(state.logq_state)(*(() for _ in state.logq_state))
    return TrainState(step=(), params=pspecs,
                      opt_state=AdamState((), moments(opt.mu), moments(opt.nu)),
                      rng=(), logq_state=logq)


def _cut(t: torch.Tensor, spec: tuple, n_model: int, m: int, name: str) -> torch.Tensor:
    """Block ``m`` of ``t`` on every dim ``spec`` splits over ``model``."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            if t.shape[dim] % n_model:
                raise ValueError(f"{name} has {t.shape[dim]} entries on dim {dim}, not "
                                 f"divisible by the model axis ({n_model})")
            size = t.shape[dim] // n_model
            t = t.narrow(dim, m * size, size)
    return t


def _own(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device or t.device).copy_(t)


def _model_block(params: nn.Module, cfg, mesh, tower_tp: bool, device, trainable: bool):
    n_model = mesh_shape(mesh)[1]
    m = mesh.get_local_rank(MODEL_AXIS)
    check_mesh_tables(params, cfg, n_model)
    specs = param_pspecs(params, tower_tp)
    memo = {}
    for name, p in params.named_parameters():
        own = _own(_cut(p.detach(), specs[name], n_model, m, name), device)
        memo[id(p)] = nn.Parameter(own, requires_grad=trainable)
    # deepcopy takes every parameter from the memo, so the full tables are
    # never copied; the modules around them are
    return copy.deepcopy(params, memo)


def shard_params(params: nn.Module, cfg, mesh, tower_tp: bool = False, device=None) -> nn.Module:
    """This rank's block of the full model ``params`` on ``device``: every
    dim a spec splits over ``model`` cut to this rank's 1/n_model of it
    (rank m of the model axis takes block m), the rest copied whole.  The
    copy is frozen (``requires_grad`` off), for serving; ``params`` is left
    as it is."""
    return _model_block(params, cfg, mesh, tower_tp, device, trainable=False).eval()


def shard_state(state: TrainState, cfg, mesh, tower_tp: bool = False, device=None) -> TrainState:
    """This rank's block of the full ``state`` on ``device``, for
    ``make_sharded_train_step``: the parameters cut as ``shard_params``
    cuts them but trainable, Adam's ``mu`` and ``nu`` on the same specs,
    and copies of ``step``, ``count``, ``logq_state`` and ``rng`` (a
    generator on ``device`` with the state's, which must live on a device of
    the same type).  ``state`` is left as it is."""
    specs = state_pspecs(state, tower_tp)
    n_model = mesh_shape(mesh)[1]
    m = mesh.get_local_rank(MODEL_AXIS)
    params = _model_block(state.params, cfg, mesh, tower_tp, device, trainable=True)
    dev = params.item_id_table.device
    opt = state.opt_state
    cut = lambda tree, spec: {name: _own(_cut(t, spec[name], n_model, m, name), dev)
                              for name, t in tree.items()}
    opt_state = AdamState(_own(opt.count, dev), cut(opt.mu, specs.opt_state.mu),
                          cut(opt.nu, specs.opt_state.nu))
    rng = None
    if state.rng is not None:
        if state.rng.device.type != dev.type:
            raise ValueError(f"the state's rng lives on {state.rng.device}, the block on {dev}")
        rng = torch.Generator(device=dev)
        rng.set_state(state.rng.get_state())
    logq = None if state.logq_state is None else type(state.logq_state)(
        *(_own(t, dev) for t in state.logq_state))
    return TrainState(step=_own(state.step, dev), params=params, opt_state=opt_state,
                      rng=rng, logq_state=logq)


def batch_pspec() -> tuple:
    """The [B]-leading batch fields split over ``data``; the mixed
    negatives' [B'] fields (``models.two_tower.REPLICATED_BATCH_FIELDS``)
    replicate."""
    return (DATA_AXIS,)


def data_pspecs(data) -> object:
    """A ``SyntheticRecData`` replicates: every rank holds the dataset and
    the step takes its own rows of each global batch."""
    return type(data)(*(None if t is None else () for t in data))
