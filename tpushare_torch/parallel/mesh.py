"""Device mesh for the port's SPMD training steps. Counterpart of
``tpushare/parallel/mesh.py``.

The JAX package names six canonical axes, outer to inner: ``pp``
(pipeline), ``dp`` (data), ``fsdp`` (sharded params and optimizer
state), ``ep`` (experts), ``sp`` (sequence, ridden by ring attention)
and ``tp`` (tensor). The port's dense-LM training runs over ``dp`` and
``sp``; ``make_mesh`` builds a ``torch.distributed`` DeviceMesh of those
two over the default process group, which the caller initializes itself
(``torch.distributed.init_process_group`` with its address, world size
and rank: nothing on a machine tells a program of its cluster). Ranks
are laid out as the JAX mesh lays out devices: dp outer, sp inner.
"""

from __future__ import annotations

from typing import Mapping

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# ROADMAP items that port the axes the training path leaves out.
TODO_AXES = {"tp": "ROADMAP A10 (multi-GPU: tp/ep splits)",
             "ep": "ROADMAP A10 (multi-GPU: tp/ep splits)",
             "fsdp": "ROADMAP A12 (fsdp training steps)",
             "pp": "ROADMAP A12 (pipeline)"}


def make_mesh(axis_sizes: Mapping[str, int]) -> DeviceMesh:
    """A DeviceMesh over ``("dp", "sp")`` spanning the whole default
    process group: NCCL groups give a ``cuda`` mesh, gloo groups a
    ``cpu`` one. ``axis_sizes`` maps canonical axis names to sizes
    (absent axes are 1); dp * sp must equal the world size. Any other
    axis above 1 raises ``NotImplementedError`` naming its ROADMAP
    item."""
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
    world = dist.get_world_size()
    if sizes["dp"] * sizes["sp"] != world:
        raise ValueError(f"mesh dp={sizes['dp']} x sp={sizes['sp']} needs "
                         f"{sizes['dp'] * sizes['sp']} ranks, the process "
                         f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (sizes["dp"], sizes["sp"]),
                            mesh_dim_names=("dp", "sp"))
