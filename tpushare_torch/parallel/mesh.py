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
builds one process group per axis above 1, plus the control channel of
``parallel/control.py`` over the group's store. The transport follows
from the card count alone: NCCL where every rank has a card of its own,
gloo over CUDA tensors where ranks outnumber the cards (they then share
cards, rank r on card r mod n, and every collective stages through the
host: such a run's times are not tensor-parallel measurements), and
gloo on the CPU.

Generations. A reshard (``models/reshard.py``) ends the mesh's
generation g; the ranks that go on serve generation g+1 on a mesh of
its own (``successor``): a fresh default process group on the store
prefix ``mesh/g<g+1>/`` with the survivors re-ranked 0..n-1, new axis
groups and a new control channel. Every process keeps its *process id*,
its rank in the configured mesh (``--rank``), for good; the process of
id 0 leads every generation (it takes the requests), and the others
take the configured positions the plan carved, in order. Rank 0
publishes each plan on the store (``publish``) before any rank leaves
the old generation, so a rank that waits on a dead peer's group, or on
the old control channel, learns of it without a collective. A process
no generation names stands by (``wait_plan``) and rejoins when a plan
names it again: a process restarted after a crash finds the mesh past
generation 0 at ``bind`` and stands by from the start.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import sys
import time
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
        # Generations: this mesh's number, the process id of each of its
        # ranks, this process's id, and the store every generation meets
        # on (None for a one-rank configured mesh, which never reshards).
        self.generation = 0
        self.members: List[int] = list(range(self.size))
        self.process_id: Optional[int] = None
        self.store = None
        self.timeout_s = 300.0
        self.release_ids: List[int] = []
        self.stop_posted = False

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
        torch.distributed with the mesh's transport over a TCP store at
        ``init_method`` (``tcp://localhost:<port>``; rank 0 serves the
        store), or adopt the default group when it is already
        initialized (its world size must be the mesh's). Then build the
        per-axis groups and the control channel; every rank makes the
        same calls in the same order. Prints the transport on a line of
        its own. Every collective waits at most ``timeout_s``.

        A process whose rank finds the mesh already formed (restarted
        after a crash) joins no group: it is left standing by
        (``rank`` None, ``standby`` True) until a plan names it."""
        self.timeout_s = float(timeout_s)
        if self.size == 1:
            self.rank = 0
            self.process_id = 0
            return self
        if dist.is_initialized():
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"mesh {self.shape_str()} needs {self.size} ranks, "
                    f"the process group has {dist.get_world_size()}")
            self.rank = self.process_id = dist.get_rank()
            from torch.distributed import distributed_c10d
            self.store = distributed_c10d._get_default_store()
            if self.rank == 0:
                self.store.set(_GEN_KEY, "0")
        else:
            if rank is None or init_method is None:
                raise ValueError("bind needs rank and init_method when "
                                 "torch.distributed is not initialized")
            self.process_id = int(rank)
            self.store = _tcp_store(init_method, self.process_id == 0,
                                    self.timeout_s)
            if self.process_id == 0:
                self.store.set(_GEN_KEY, "0")
            else:
                gen = int(self.store.get(_GEN_KEY))
                if gen > 0 or self.store.check([_formed_key(0)]):
                    self.generation = gen
                    self.rank = None
                    return self
            self.rank = self.process_id
            self._init_group()
        self._bind_groups()
        if self.rank == 0:
            self.store.set(_formed_key(0), "1")
            print(f"mesh {self.shape_str()}: {self.size} ranks on "
                  f"{self.n_cards} card(s), transport {self.describe()}",
                  flush=True)
        return self

    @property
    def standby(self) -> bool:
        """True where this process serves no rank of this generation."""
        return self.rank is None

    def _init_group(self) -> None:
        if self.cards[self.rank].type == "cuda":
            torch.cuda.set_device(self.cards[self.rank])
        dist.init_process_group(
            self.transport,
            store=dist.PrefixStore(f"mesh/g{self.generation}/pg",
                                   self.store),
            world_size=self.size, rank=self.rank,
            timeout=datetime.timedelta(seconds=self.timeout_s))

    def _bind_groups(self) -> None:
        timeout = datetime.timedelta(seconds=self.timeout_s)
        for ax in MESH_AXES:
            if self.sizes[ax] == 1:
                continue
            for ranks in self._axis_ranks(ax):
                g = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[ax] = g
        from tpushare_torch.parallel.control import StoreChannel
        self.control = StoreChannel(
            dist.PrefixStore(f"mesh/g{self.generation}/ctl", self.store),
            self.timeout_s, self.next_plan_ready)

    # -- generations -----------------------------------------------------
    def successor(self, sizes: Mapping[str, int], positions: Sequence[int],
                  configured: "ServingMesh") -> "ServingMesh":
        """The mesh of the next generation, unbound: ``sizes`` over the
        ``configured`` mesh's positions ``positions`` (the plan's carve,
        in rank order). Process 0 takes the first position, and the
        process of each other position its own."""
        return self._next(sizes, [configured.cards[p] for p in positions],
                          [0] + [int(p) for p in positions[1:]])

    def _next(self, sizes, cards, members, release=()) -> "ServingMesh":
        """The next generation's mesh, unbound, with this process's rank
        in it (None where it stands by)."""
        nxt = ServingMesh(sizes, cards)
        nxt.generation = self.generation + 1
        nxt.members = [int(m) for m in members]
        nxt.release_ids = [int(r) for r in release]
        nxt.process_id, nxt.store = self.process_id, self.store
        nxt.timeout_s = self.timeout_s
        if self.process_id in nxt.members:
            nxt.rank = nxt.members.index(self.process_id)
        return nxt

    def publish(self, release: Sequence[int]) -> None:
        """Rank 0: post this (unbound) generation's plan on the store,
        naming the processes whose memory must be freed before any rank
        builds (``release``), then make it the current generation."""
        self.release_ids = sorted(int(r) for r in release)
        plan = {"sizes": self.sizes, "members": self.members,
                "cards": [str(c) for c in self.cards],
                "release": self.release_ids}
        self.store.set(_plan_key(self.generation), json.dumps(plan))
        self.store.set(_GEN_KEY, str(self.generation))

    def publish_stop(self) -> None:
        """Rank 0 at shutdown: post a plan that names no process past
        rank 0, so processes standing by leave (``wait_plan`` returns
        it with ``stop`` set)."""
        self.store.set(_plan_key(self.generation + 1),
                       json.dumps({"stop": True}))

    def next_plan_ready(self) -> bool:
        """Has rank 0 posted the next generation's plan?"""
        return self.store is not None and self.store.check(
            [_plan_key(self.generation + 1)])

    def wait_plan(self, timeout_s: Optional[float] = None,
                  stop=None) -> Optional["ServingMesh"]:
        """A follower: block until rank 0 posts the next generation's
        plan (``stop()`` true, ``timeout_s`` past, or rank 0 posted its
        stop: None, ``stop_posted`` set for the last) and return
        that generation's mesh, unbound, with this process's rank in it
        (None where it stands by). Marks this process ready for it."""
        key = _plan_key(self.generation + 1)
        self.store.set(_ready_key(self.process_id),
                       str(self.generation + 1))
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.timeout_s)
        delay = 0.001
        while not self.store.check([key]):
            if (stop is not None and stop()) or \
                    time.monotonic() > deadline:
                return None
            time.sleep(delay)
            delay = min(0.05, delay * 2)
        plan = json.loads(self.store.get(key))
        if plan.get("stop"):
            self.stop_posted = True
            return None
        return self._next(plan["sizes"], plan["cards"], plan["members"],
                          plan["release"])

    def ready_ids(self, n_processes: int) -> List[int]:
        """Rank 0: the processes of ids 1..n_processes-1 standing by for
        the next generation (``wait_plan`` marks them)."""
        want = str(self.generation + 1)
        return [pid for pid in range(1, n_processes)
                if self.store.check([_ready_key(pid)])
                and self.store.get(_ready_key(pid)).decode() == want]

    def abort(self) -> None:
        """Abort this generation's process groups (NCCL: its
        communicators are aborted, not waited on), unblocking a
        collective that waits on a dead peer with an error."""
        if self.size == 1 or self.rank is None or \
                not dist.is_initialized():
            return
        if self.transport == "nccl":
            from torch.distributed import distributed_c10d
            abort = getattr(distributed_c10d, "_abort_process_group",
                            None)
            if abort is not None:
                try:
                    abort()
                except Exception:       # noqa: BLE001 — already torn
                    pass

    def release(self) -> None:
        """End this generation on this process: abort (NCCL) and
        destroy its process groups, then mark this process's memory
        freed for the next generation (the caller drops its server and
        empties the CUDA cache first)."""
        if self.size > 1 and self.rank is not None and \
                dist.is_initialized():
            self.abort()
            try:
                dist.destroy_process_group()
            except Exception:           # noqa: BLE001 — aborted above
                pass
        self._groups = {}
        self.control = None
        if self.store is not None:
            self.store.set(_freed_key(self.generation + 1,
                                      self.process_id), "1")

    def missing_frees(self) -> List[int]:
        """The processes of this (published) generation's release list
        that have not freed their memory yet."""
        return [pid for pid in self.release_ids
                if not self.store.check([_freed_key(self.generation,
                                                    pid)])]

    def join(self) -> "ServingMesh":
        """A member of this (published) generation: form its group,
        axis groups and control channel (on this rank's card). The
        caller waits for ``missing_frees`` to empty first."""
        if self.size == 1:
            if self.cards[0].type == "cuda":
                torch.cuda.set_device(self.cards[0])
            return self
        self._init_group()
        self._bind_groups()
        return self

    def describe(self) -> str:
        """The transport as ``/stats`` names it."""
        if self.transport == "nccl":
            return "nccl"
        if self.cards[0].type == "cuda":
            return ("gloo (ranks share cards; collectives staged "
                    "through the host)")
        return "gloo"


_GEN_KEY = "mesh/gen"


def _plan_key(gen: int) -> str:
    return f"mesh/g{gen}/plan"


def _formed_key(gen: int) -> str:
    """Set once generation 0's group formed: a process binding later was
    restarted, and stands by."""
    return f"mesh/g{gen}/formed"


def _freed_key(gen: int, pid: int) -> str:
    return f"mesh/g{gen}/freed/{pid}"


def _ready_key(pid: int) -> str:
    return f"mesh/ready/{pid}"


def _tcp_store(init_method: str, is_master: bool, timeout_s: float):
    """The TCP store at ``tcp://host:port`` (served by the master)."""
    if not init_method.startswith("tcp://"):
        raise ValueError(f"--dist-init {init_method!r}: want "
                         f"tcp://host:port")
    host, _, port = init_method[len("tcp://"):].rpartition(":")
    return dist.TCPStore(host or "localhost", int(port), None, is_master,
                         datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


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
