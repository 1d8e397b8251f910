"""Device mesh construction.

Port of ``two_tower_models_tpu/parallel/mesh.py``.  Axes:
  ``data``  -- batch sharding (DP);
  ``model`` -- embedding-table row sharding (and optional tower TP).

JAX runs a mesh as one process over many devices; the port runs it the way
PyTorch does, one process per device (SPMD): every rank calls the same entry
point with the same arguments.  ``make_mesh`` lays a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")``
over the default process group, whose world must be exactly
``data * model``.  The mesh is row-major, so rank ``r`` sits at
``(r // model, r % model)``: the order of JAX's ``P(("data", "model"))``,
which the corpus shards and the candidate all-gather of
``retrieval.mips.sharded_mips_topk`` follow.

The backend follows the device: NCCL for CUDA, one card a rank
(``cuda:<rank>``: one host), gloo for the CPU.  A mesh whose backend does
not match the device raises; nothing falls back to gloo or to one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from two_tower_models_tpu_torch.config import MeshConfig, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _backend_for(device: torch.device) -> str:
    if device.type not in _BACKEND:
        raise ValueError(f"a mesh runs on cuda (NCCL) or cpu (gloo), not {device.type}")
    return _BACKEND[device.type]


def init_process_group(rank: int, world: int, init_method: str, device="cuda") -> torch.device:
    """Join a one-host world of ``world`` processes as ``rank``: NCCL bound to
    card ``rank`` for ``device="cuda"``, gloo for ``"cpu"``.  ``init_method``
    is the store, e.g. ``file:///tmp/store`` or ``tcp://localhost:29500``.
    Returns the rank's device."""
    dev = resolve_device(device)
    backend = _backend_for(dev)
    kw = {}
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs card {rank}; "
                             f"this host has {torch.cuda.device_count()}")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
    return dev


def make_mesh(cfg: MeshConfig, device="cuda"):
    """The ``(data, model)`` DeviceMesh over the default process group, whose
    world must be ``cfg.data * cfg.model`` and whose backend must match
    ``device`` (NCCL for cuda, gloo for cpu)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    n = cfg.data * cfg.model
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {cfg.data}x{cfg.model} needs a process group of {n} ranks: call "
            "parallel.mesh.init_process_group on every rank first"
        )
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {cfg.data}x{cfg.model} needs {n} ranks, the world has {dist.get_world_size()}"
        )
    want, have = _backend_for(dev), dist.get_backend()
    if have != want:
        raise ValueError(f"a {dev.type} mesh runs over {want}, the process group is {have}")
    return init_device_mesh(dev.type, (cfg.data, cfg.model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh(device="cuda"):
    return make_mesh(MeshConfig(data=1, model=1), device)


def mesh_device(mesh, device="cuda") -> torch.device:
    """This rank's device on ``mesh``: ``cuda:<rank>`` (one host) or the CPU.
    Raises when ``device`` is not of the mesh's type, or the process group
    runs another backend than that type's."""
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is a {mesh.device_type} mesh, the device {dev}")
    want, have = _backend_for(dev), dist.get_backend()
    if have != want:
        raise ValueError(f"a {dev.type} mesh runs over {want}, the process group is {have}")
    if dev.type == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def mesh_shape(mesh) -> tuple[int, int]:
    """(n_data, n_model)."""
    return mesh.size(0), mesh.size(1)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None) -> None:
    """Multi-host bring-up is not ported yet."""
    raise NotImplementedError(
        "multi-host meshes are not ported yet (ROADMAP.md, queue A, A13d of A13 'Multi-device')"
    )
