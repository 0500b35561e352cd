"""The process axis of sharded serving: the gang env contract and how a
mesh's ranks fall into hosts. Counterpart of
``tpushare/parallel/multihost.py``.

Env contract (set by the plugin's multi-host Allocate path or by the
operator's Job spec; ``plugin/const.py`` spells it):
  TPUSHARE_COORDINATOR   host:port of process 0
  TPUSHARE_NUM_PROCESSES total processes in the tenant
  TPUSHARE_PROCESS_ID    this process's rank

In the port every rank of a serving mesh is a process of its own, so
the contract maps onto the mesh's rendezvous: ``initialize`` turns it
into the ``--dist-init`` address and ``--rank`` of
``ServingMesh.bind``, and the gang liaison listens one port above.
A "host" of the process view is a contiguous run of mesh.size //
num_processes ranks (``ProcessTopology``): losing a host loses its
whole rank range.

Differences by design from the reference (ROADMAP C):
``addressable_fetch`` keeps its name and means what it can in torch —
this rank's tensors fetched to the host (each process reads its own;
the per-tick fetch stays one per process); ``host_scalar`` returns a
host scalar of this rank's value; ``hybrid_mesh`` and
``process_tenant_mesh`` build the ``make_mesh`` layout of dp across
hosts and tp within each, over an initialized default group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch

from tpushare_torch.parallel.mesh import MESH_AXES
# Single source of truth for the gang env spellings: the plugin's
# Allocate injects these names from const.py.
from tpushare_torch.plugin.const import (ENV_COORDINATOR, ENV_NUM_PROCESSES,
                                         ENV_PROCESS_ID)


def gang_contract() -> Optional[dict]:
    """Read the plugin-injected gang env contract, or None when absent
    (``TPUSHARE_COORDINATOR`` unset)."""
    coordinator = os.environ.get(ENV_COORDINATOR)
    if coordinator is None:
        return None
    return {
        "coordinator": coordinator,
        "num_processes": int(os.environ.get(ENV_NUM_PROCESSES, "1")),
        "process_id": int(os.environ.get(ENV_PROCESS_ID, "0")),
    }


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Optional[dict]:
    """The gang contract (from the arguments, else the env) as the
    serving mesh's rendezvous: ``{"init_method": "tcp://<coordinator>",
    "process_id", "num_processes", "coordinator"}`` for
    ``ServingMesh.bind(rank=process_id, init_method=...)``; None for
    the single-process case (no coordinator, or one process), so
    callers keep one code path."""
    contract = gang_contract() or {}
    coordinator = coordinator or contract.get("coordinator")
    if coordinator is None:
        return None
    n = int(num_processes if num_processes is not None
            else contract.get("num_processes", 1))
    if n < 2:
        return None
    pid = int(process_id if process_id is not None
              else contract.get("process_id", 0))
    return {"coordinator": coordinator, "init_method": f"tcp://{coordinator}",
            "num_processes": n, "process_id": pid}


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """How a serving mesh's ranks map onto hosts: num_processes hosts,
    each owning local_device_count contiguous ranks (positions of the
    configured mesh)."""

    num_processes: int
    process_index: int
    local_device_count: int

    def __post_init__(self) -> None:
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not (0 <= self.process_index < self.num_processes):
            raise ValueError(
                f"process_index {self.process_index} out of range for "
                f"{self.num_processes} processes")
        if self.local_device_count < 1:
            raise ValueError("local_device_count must be >= 1")

    @classmethod
    def forced_view(cls, num_processes: int,
                    mesh_size: int) -> "ProcessTopology":
        """Partition a ``mesh_size``-rank mesh into ``num_processes``
        hosts of contiguous ranks (rank 0's host is host 0)."""
        if mesh_size % num_processes != 0:
            raise ValueError(
                f"mesh of {mesh_size} devices does not divide into "
                f"{num_processes} processes")
        return cls(num_processes=int(num_processes), process_index=0,
                   local_device_count=mesh_size // int(num_processes))

    @property
    def total_devices(self) -> int:
        return self.num_processes * self.local_device_count

    def process_of(self, flat_idx: int) -> int:
        """Which host owns mesh position ``flat_idx``."""
        if not (0 <= flat_idx < self.total_devices):
            raise ValueError(f"device index {flat_idx} out of range")
        return flat_idx // self.local_device_count

    def device_range(self, rank: int) -> range:
        """Mesh positions owned by host ``rank``."""
        if not (0 <= rank < self.num_processes):
            raise ValueError(f"rank {rank} out of range")
        lo = rank * self.local_device_count
        return range(lo, lo + self.local_device_count)


def addressable_fetch(x):
    """The one per-tick fetch, one per process: this rank's tensors
    (through lists, tuples and dicts) copied to the host; other values
    pass through. Every rank of a sharded server holds the replicated
    outputs itself, so no collective is needed."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(addressable_fetch(v) for v in x)
    if isinstance(x, dict):
        return {k: addressable_fetch(v) for k, v in x.items()}
    return x


def host_scalar(x):
    """A scalar the caller is about to ``int()``: a one-element tensor
    is read to the host, anything else passes through."""
    if isinstance(x, torch.Tensor) and x.numel() == 1:
        return x.item()
    return x


def hybrid_mesh(dcn_axis_sizes: Mapping[str, int],
                ici_axis_sizes: Mapping[str, int]):
    """A DeviceMesh whose ``dcn_axis_sizes`` axes cross hosts and
    ``ici_axis_sizes`` axes stay within a host (``make_mesh`` lays
    ranks out outer to inner, so a host's ranks stay contiguous along
    the inner axes). An axis may appear in only one group."""
    overlap = set(dcn_axis_sizes) & set(ici_axis_sizes)
    if overlap:
        raise ValueError(f"axes {sorted(overlap)} appear in both groups")
    unknown = (set(dcn_axis_sizes) | set(ici_axis_sizes)) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                         f"canonical axes are {MESH_AXES}")
    from tpushare_torch.parallel.mesh import make_mesh
    return make_mesh({**dict(dcn_axis_sizes), **dict(ici_axis_sizes)})


def process_tenant_mesh(num_hosts: int):
    """Default multi-host tenant layout over the default group: dp
    across ``num_hosts`` hosts, tp within each."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if world % num_hosts:
        raise ValueError(f"{world} ranks do not divide into {num_hosts} "
                         f"hosts")
    return hybrid_mesh({"dp": num_hosts}, {"tp": world // num_hosts})
