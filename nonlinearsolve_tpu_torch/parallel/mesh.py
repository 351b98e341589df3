"""Device meshes for the distributed layer (the port of ``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and places
arrays with ``NamedSharding``.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised default process group (one device a rank: the card under NCCL,
the CPU under gloo), and a sharding is the list of DTensor placements, one
per mesh dimension: ``row_sharding`` gives ``Shard(shard_dim)`` on the named
axis, ``replicated`` gives ``Replicate()`` on every axis.

The caller initialises the process group itself (``init_process_group``
with its address, world size and rank); nothing here reads a cluster's
environment.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


def mesh_device_type() -> str:
    """Where the default group's tensors live: ``cuda`` under NCCL, else
    ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the distributed layer needs an initialised default process "
            "group: call torch.distributed.init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("x",),
                devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` — the ranks of the default group
    (all of them by default), one device each.  Every rank of the default
    group must call it, members of the mesh or not."""
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    kind = mesh_device_type()
    if shape is None:
        shape = (len(ranks),)
    arr = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(kind, arr, mesh_dim_names=tuple(axis_names))


def row_sharding(mesh: DeviceMesh, axis: str = "x", ndim: int = 1,
                 shard_dim: int = 0) -> list:
    """Placements that shard dimension ``shard_dim`` of an ``ndim``-array
    over ``axis`` and replicate it over the mesh's other axes — the
    row/block partitioning of the state vector."""
    if not 0 <= shard_dim < ndim:
        raise ValueError(f"shard_dim={shard_dim} is not a dimension of an "
                         f"array of {ndim} dimensions")
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return [Shard(shard_dim) if name == axis else Replicate()
            for name in names]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim
