"""Device mesh for the port's SPMD training steps. Counterpart of
``tpushare/parallel/mesh.py``.

The JAX package names six canonical axes, outer to inner: ``pp``
(pipeline), ``dp`` (data), ``fsdp`` (sharded params and optimizer
state), ``ep`` (experts), ``sp`` (sequence, ridden by ring attention)
and ``tp`` (tensor). The port's training runs over ``pp``, ``dp``,
``fsdp`` and ``sp``; ``make_mesh`` builds a ``torch.distributed``
DeviceMesh of those over the default process group, which the caller
initializes itself (``torch.distributed.init_process_group`` with its
address, world size and rank: nothing on a machine tells a program of
its cluster). Ranks are laid out as the JAX mesh lays out devices: the
axes in ``MESH_AXES`` order, outer to inner. The mesh always carries
``dp`` and ``sp`` (size 1 or more); ``pp`` and ``fsdp`` are dimensions
of it only above 1. ``axis_size`` / ``axis_group`` / ``axis_rank`` read
any canonical axis, an absent one as size 1, no group, rank 0.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# ROADMAP items that port the axes the training path leaves out.
TODO_AXES = {"tp": "ROADMAP A10 (multi-GPU: tp/ep splits)",
             "ep": "ROADMAP A10 (multi-GPU: tp/ep splits)"}

_ALWAYS = ("dp", "sp")


def make_mesh(axis_sizes: Mapping[str, int]) -> DeviceMesh:
    """A DeviceMesh spanning the whole default process group: NCCL
    groups give a ``cuda`` mesh, gloo groups a ``cpu`` one. Its
    dimensions are ``dp`` and ``sp``, and ``pp`` and ``fsdp`` where
    their sizes are above 1, in canonical order. ``axis_sizes`` maps
    canonical axis names to sizes (absent axes are 1); their product
    must equal the world size. ``tp`` or ``ep`` above 1 raises
    ``NotImplementedError`` naming its ROADMAP item."""
    unknown = set(axis_sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                         f"canonical axes are {MESH_AXES}")
    sizes = {ax: int(axis_sizes.get(ax, 1)) for ax in MESH_AXES}
    for ax, item in TODO_AXES.items():
        if sizes[ax] > 1:
            raise NotImplementedError(f"mesh axis {ax}={sizes[ax]}: {item}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_process_group with an address, world "
                           "size and rank)")
    names = tuple(ax for ax in MESH_AXES
                  if ax in _ALWAYS or sizes[ax] > 1)
    shape = tuple(sizes[ax] for ax in names)
    need = math.prod(shape)
    world = dist.get_world_size()
    if need != world:
        desc = " x ".join(f"{ax}={sizes[ax]}" for ax in names)
        raise ValueError(f"mesh {desc} needs {need} ranks, the process "
                         f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of canonical ``axis`` on ``mesh``: 1 where it is not a
    dimension."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of ``axis`` on ``mesh``, or None where it is
    not a dimension (size 1)."""
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) \
        else None


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 where it is not a
    dimension)."""
    return mesh.get_local_rank(axis) \
        if axis in (mesh.mesh_dim_names or ()) else 0
