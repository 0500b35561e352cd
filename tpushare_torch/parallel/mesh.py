"""Device meshes for the port's SPMD training steps and its sharded
serving. Counterpart of ``tpushare/parallel/mesh.py``.

The JAX package names six canonical axes, outer to inner: ``pp``
(pipeline), ``dp`` (data), ``fsdp`` (sharded params and optimizer
state), ``ep`` (experts), ``sp`` (sequence, ridden by ring attention)
and ``tp`` (tensor).

Training: ``make_mesh`` builds a ``torch.distributed`` DeviceMesh over
the default process group, which the caller initializes itself
(``torch.distributed.init_process_group`` with its address, world size
and rank: nothing on a machine tells a program of its cluster). Ranks
are laid out as the JAX mesh lays out devices: the axes in
``MESH_AXES`` order, outer to inner. The mesh always carries ``dp`` and
``sp`` (size 1 or more); ``pp``, ``fsdp``, ``ep`` and ``tp`` are
dimensions of it only above 1. ``axis_size`` / ``axis_group`` /
``axis_rank`` read any canonical axis, an absent one as size 1, no
group, rank 0. The training steps refuse ``tp`` and ``ep`` above 1
(training under tp is its own ROADMAP item).

Serving: ``serving_mesh`` meshes over the cards the plugin granted and
returns a ``ServingMesh``: the axis sizes, the card each rank runs on,
and the transport of its collectives. One process per rank; ``bind``
joins this process to the group (or adopts one already initialized) and
builds one process group per axis above 1, plus a gloo group for host
objects (``parallel/control.py``). The transport follows from the card
count alone: NCCL where every rank has a card of its own, gloo over
CUDA tensors where ranks outnumber the cards (they then share cards,
rank r on card r mod n, and every collective stages through the host:
such a run's times are not tensor-parallel measurements), and gloo on
the CPU.
"""

from __future__ import annotations

import datetime
import math
import os
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# What the training steps do not carry yet.
TODO_TRAIN_AXES = "ROADMAP A10c (training under tp / ep)"

_ALWAYS = ("dp", "sp")


def make_mesh(axis_sizes: Mapping[str, int]) -> DeviceMesh:
    """A DeviceMesh spanning the whole default process group: NCCL
    groups give a ``cuda`` mesh, gloo groups a ``cpu`` one. Its
    dimensions are ``dp`` and ``sp``, and every other canonical axis
    whose size is above 1, in canonical order. ``axis_sizes`` maps
    canonical axis names to sizes (absent axes are 1); their product
    must equal the world size."""
    unknown = set(axis_sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                         f"canonical axes are {MESH_AXES}")
    sizes = {ax: int(axis_sizes.get(ax, 1)) for ax in MESH_AXES}
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


def refuse_serving_axes(mesh) -> None:
    """The training steps' guard: a mesh with ``tp`` or ``ep`` above 1
    raises, naming the ROADMAP item (they would silently replicate)."""
    for ax in ("tp", "ep"):
        if mesh is not None and axis_size(mesh, ax) > 1:
            raise NotImplementedError(
                f"training over mesh axis {ax}={axis_size(mesh, ax)}: "
                f"{TODO_TRAIN_AXES}")


def axis_size(mesh, axis: str) -> int:
    """The size of canonical ``axis`` on ``mesh`` (a DeviceMesh or a
    ServingMesh): 1 where it is not a dimension."""
    if isinstance(mesh, ServingMesh):
        return mesh.sizes[axis]
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh, axis: str):
    """The process group of ``axis`` on ``mesh``, or None where it is
    not a dimension (size 1)."""
    if isinstance(mesh, ServingMesh):
        return mesh.axis_group(axis)
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) \
        else None


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 where it is not a
    dimension)."""
    if isinstance(mesh, ServingMesh):
        return mesh.axis_rank(axis)
    return mesh.get_local_rank(axis) \
        if axis in (mesh.mesh_dim_names or ()) else 0


def parse_mesh_spec(spec: str) -> dict:
    """Parse a ``tp=2,ep=2`` CLI mesh spec into {axis: size}: comma-
    separated ``axis=size`` pairs over the canonical axis names; a size
    may be -1 (absorb the remaining cards). Unknown axes and malformed
    pairs fail loudly — a typo'd axis silently replicating everything
    would serve at 1/N of the grant."""
    sizes: dict = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        axis, eq, val = part.partition("=")
        axis = axis.strip()
        try:
            size = int(val.strip())
        except ValueError:
            size = 0
        if not eq or axis not in MESH_AXES or (size < 1 and size != -1):
            raise ValueError(
                f"bad mesh spec segment {part!r}: want axis=size with "
                f"axis in {MESH_AXES} and size >= 1 (or -1 wildcard)")
        if axis in sizes:
            raise ValueError(f"mesh axis {axis!r} given twice in {spec!r}")
        sizes[axis] = size
    if not sizes:
        raise ValueError(f"empty mesh spec {spec!r} (e.g. 'tp=2,ep=2')")
    return sizes


def transport_for(cards: Sequence[torch.device]) -> str:
    """The collectives' transport, from the rank -> card map alone:
    "nccl" where every rank has a CUDA card of its own, else "gloo"
    (ranks sharing cards, or the CPU)."""
    cards = [torch.device(c) for c in cards]
    if all(c.type == "cuda" for c in cards) and \
            len({(c.type, c.index) for c in cards}) == len(cards):
        return "nccl"
    return "gloo"


class ServingMesh:
    """A serving mesh: the canonical axis sizes, the card each rank runs
    on, the transport, and (after ``bind``) this process's rank, its
    per-axis process groups and the gloo control group.

    Rank r's coordinate along each axis follows ``MESH_AXES`` order,
    outer to inner, as ``make_mesh`` lays out ranks (ep x tp: rank =
    ep_index * tp + tp_index). A mesh of one rank needs no process
    group: ``bind`` then leaves torch.distributed alone."""

    def __init__(self, axis_sizes: Mapping[str, int],
                 cards: Sequence[Any]):
        unknown = set(axis_sizes) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"canonical axes are {MESH_AXES}")
        self.sizes = {ax: int(axis_sizes.get(ax, 1)) for ax in MESH_AXES}
        self.size = math.prod(self.sizes.values())
        self.cards = [torch.device(c) for c in cards]
        if len(self.cards) != self.size:
            raise ValueError(f"mesh {self.shape_str()} has {self.size} "
                             f"ranks but {len(self.cards)} cards were "
                             f"mapped")
        self.transport = transport_for(self.cards)
        self.rank: Optional[int] = None
        self._groups: Dict[str, Any] = {}
        self.control = None

    @property
    def shape(self) -> Dict[str, int]:
        """Every canonical axis and its size (as ``jax.sharding.Mesh
        .shape`` reads)."""
        return dict(self.sizes)

    def shape_str(self) -> str:
        return ",".join(f"{ax}={s}" for ax, s in self.sizes.items()
                        if s > 1) or "1"

    @property
    def n_cards(self) -> int:
        """Distinct cards the ranks run on."""
        return len({(c.type, c.index) for c in self.cards})

    @property
    def device(self) -> torch.device:
        """This rank's card (rank 0's before ``bind``)."""
        return self.cards[self.rank or 0]

    def coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for ax in reversed(MESH_AXES):
            out[ax] = rank % self.sizes[ax]
            rank //= self.sizes[ax]
        return {ax: out[ax] for ax in MESH_AXES}

    def axis_rank(self, axis: str) -> int:
        return self.coords(self.rank or 0)[axis]

    def axis_group(self, axis: str):
        """This rank's process group along ``axis``; None at size 1."""
        return self._groups.get(axis)

    def _axis_ranks(self, axis: str) -> List[List[int]]:
        """Every group of ranks that differ only along ``axis``."""
        groups: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(v for ax, v in c.items() if ax != axis)
            groups.setdefault(key, []).append(r)
        return list(groups.values())

    def bind(self, rank: Optional[int] = None,
             init_method: Optional[str] = None,
             timeout_s: float = 300.0) -> "ServingMesh":
        """Join this process to the mesh's group as ``rank``: initialize
        torch.distributed with the mesh's transport at ``init_method``
        (``tcp://localhost:<port>``), or adopt the default group when it
        is already initialized (its world size must be the mesh's). Then
        build the per-axis groups and the gloo control group; every rank
        makes the same calls in the same order. Prints the transport on
        a line of its own. Every collective waits at most ``timeout_s``."""
        if self.size == 1:
            self.rank = 0
            return self
        timeout = datetime.timedelta(seconds=timeout_s)
        if dist.is_initialized():
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"mesh {self.shape_str()} needs {self.size} ranks, "
                    f"the process group has {dist.get_world_size()}")
            self.rank = dist.get_rank()
        else:
            if rank is None or init_method is None:
                raise ValueError("bind needs rank and init_method when "
                                 "torch.distributed is not initialized")
            self.rank = int(rank)
            if self.cards[self.rank].type == "cuda":
                torch.cuda.set_device(self.cards[self.rank])
            dist.init_process_group(
                self.transport, init_method=init_method,
                world_size=self.size, rank=self.rank, timeout=timeout)
        for ax in MESH_AXES:
            if self.sizes[ax] == 1:
                continue
            for ranks in self._axis_ranks(ax):
                g = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[ax] = g
        self.control = dist.new_group(list(range(self.size)),
                                      backend="gloo", timeout=timeout)
        if self.rank == 0:
            print(f"mesh {self.shape_str()}: {self.size} ranks on "
                  f"{self.n_cards} card(s), transport {self.describe()}",
                  flush=True)
        return self

    def describe(self) -> str:
        """The transport as ``/stats`` names it."""
        if self.transport == "nccl":
            return "nccl"
        if self.cards[0].type == "cuda":
            return ("gloo (ranks share cards; collectives staged "
                    "through the host)")
        return "gloo"


def visible_cards() -> List[torch.device]:
    """The CUDA cards this process sees (empty without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def serving_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
                 devices: Optional[Sequence[Any]] = None) -> ServingMesh:
    """The serving engine's mesh over the cards this tenant was granted
    (reference ``serving_mesh``): ``devices`` (default: the visible
    cards) in order.

    - A poisoned grant raises ``AllocationError`` (``read_tenant_env``);
      on CUDA a grant that lists cards must match the visible count.
    - ``axis_sizes`` default ``{"tp": -1}``; one axis may be -1 to
      absorb the cards the others leave.
    - A spec smaller than the grant warns on stderr and uses a prefix of
      the cards.
    - A spec larger than the grant maps rank r to card r mod n, warns,
      and runs its collectives over gloo (the one-card stand-in)."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_cards())]
    if not devices:
        raise RuntimeError("serving_mesh found no card; pass devices= "
                           "(e.g. ['cpu'] * n) to mesh on the CPU")
    from tpushare_torch.utils import tenant
    if os.environ.get(tenant.ENV_NVIDIA_VISIBLE_DEVICES) or \
            os.environ.get(tenant.ENV_TPU_VISIBLE_CHIPS) or \
            os.environ.get(tenant.ENV_TPU_VISIBLE_DEVICES):
        spec = tenant.read_tenant_env()     # AllocationError on poison
        granted = len(spec.chips)
        if devices[0].type == "cuda" and granted and \
                granted != len(devices):
            raise ValueError(
                f"the plugin granted {granted} cards but torch sees "
                f"{len(devices)}: the engine refuses to mesh over a "
                f"partial grant")
    sizes = dict(axis_sizes or {"tp": -1})
    unknown = set(sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                         f"canonical axes are {MESH_AXES}")
    wild = [ax for ax, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    if wild:
        rest = math.prod(s for ax, s in sizes.items() if ax != wild[0])
        if rest == 0 or len(devices) % rest:
            raise ValueError(f"cannot infer {wild[0]}: {len(devices)} "
                             f"cards not divisible by {rest}")
        sizes[wild[0]] = len(devices) // rest
    total = math.prod(sizes.values())
    if 0 < total < len(devices):
        print(f"WARNING: --mesh {sizes} uses {total} of {len(devices)} "
              f"visible cards; the rest idle (use -1 on one axis to "
              f"absorb them)", file=sys.stderr, flush=True)
        devices = devices[:total]
    elif total > len(devices):
        print(f"WARNING: --mesh {sizes} puts {total} ranks on "
              f"{len(devices)} card(s): ranks share cards and their "
              f"collectives run over gloo through the host",
              file=sys.stderr, flush=True)
    return ServingMesh(sizes, [devices[r % len(devices)]
                               for r in range(total)])
