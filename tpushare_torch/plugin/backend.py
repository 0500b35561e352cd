"""Card discovery backends: the port's counterpart of
``tpushare/plugin/backend.py``.

The reference plugin's L1 is NVML (nvidia.go:44-86, cgo with no testing
seam). Here discovery sits behind the same ``Backend`` interface as the
JAX package's, with three implementations:

- ``FakeBackend``  — env/arg-configured, the JAX package's fake unchanged
                     (same env keys, same topology), so both plugins'
                     tests drive the same fake node.
- ``NvmlBackend``  — ``libnvidia-ml.so.1`` through ctypes
                     (``plugin/nvmldisc.py``); makes no CUDA context, so
                     the daemon may run it beside its tenants.
- ``TorchBackend`` — asks ``torch.cuda`` (claims the card: it makes a
                     CUDA context), for benchmarks and diagnostics only,
                     never the daemon; ``auto_backend`` chains it after
                     NVML only when asked by name, as a cross-check.

Kept from the original: ``Chip``, ``HostTopology``, ``Backend``,
``FakeBackend``, ``ChainBackend`` with its cross-check,
``auto_backend`` and ``topology_to_json``. The TPU-only discovery
(sysfs accel nodes, the GCE metadata server, their static tables) has no
counterpart: nothing falls back to a table when NVML is missing.

A card is one ``Chip``: ``index`` is the NVML index, ``uuid`` NVML's
``GPU-...`` string, ``hbm_bytes`` NVML's total, ``cores`` 1 (the unit a
tenant process owns; no grant divides the SMs), ``coords`` ``(i, 0, 0)``
in a ``(n, 1, 1)`` mesh (NVSwitch joins every pair of cards, so the mesh
only orders ``choose_submesh``'s preference), ``device_path``
``/dev/nvidia<minor>``.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

log = logging.getLogger("tpushare.backend")

_GIB = 1 << 30
# The fake's per-generation core counts: the JAX package's table, so the
# two fakes advertise the same node.
_DEFAULT_CORES = {"v5e": 1, "v5p": 2, "v4": 2, "v6e": 1}
# Host device nodes every CUDA tenant opens whichever card it got.
NVIDIA_SHARED_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
# NVML's total less the CUDA runtime's (memory the card reserves): the
# cross-check's allowance between the two backends' memory figures.
TOTAL_MEMORY_SLACK = _GIB


@dataclass(frozen=True)
class Chip:
    """One physical card (or TPU chip, for the fake) on this host."""

    index: int                 # host-local index (what NVIDIA_VISIBLE_DEVICES names)
    uuid: str                  # stable id used in fake-device IDs
    hbm_bytes: int
    cores: int
    coords: tuple              # (x, y, z) position in the host mesh
    numa_node: int = 0
    healthy: bool = True
    # Host device node a tenant must open to reach this card; Allocate
    # returns DeviceSpec entries built from it for non-privileged pods.
    device_path: str = ""


@dataclass(frozen=True)
class HostTopology:
    """Card inventory + mesh of one host."""

    generation: str            # "h100", ...
    mesh: tuple                # host mesh (x, y, z)
    chips: tuple = field(default_factory=tuple)
    # Device nodes every tenant on this host needs regardless of which
    # card it got (/dev/nvidiactl, /dev/nvidia-uvm, ...).
    shared_device_paths: tuple = ()

    @property
    def chip_count(self) -> int:
        return len(self.chips)

    @property
    def total_hbm_bytes(self) -> int:
        return sum(c.hbm_bytes for c in self.chips)

    @property
    def total_cores(self) -> int:
        return sum(c.cores for c in self.chips)

    def chip_by_index(self, index: int) -> Chip:
        for c in self.chips:
            if c.index == index:
                return c
        raise KeyError(f"no chip with index {index}")

    def chip_by_uuid(self, uuid: str) -> Chip:
        for c in self.chips:
            if c.uuid == uuid:
                return c
        raise KeyError(f"no chip with uuid {uuid}")


def _mesh_coords(mesh: tuple) -> list:
    """Chip index -> mesh coordinate, row-major over (x, y, z)."""
    x, y, z = mesh
    return [(i % x, (i // x) % y, i // (x * y)) for i in range(x * y * z)]


def _build_topology(generation: str, count: int, mesh: tuple, hbm: int,
                    cores: int, uuid_prefix: str, numa_nodes: Optional[Sequence[int]] = None,
                    hbm_per_chip: Optional[Sequence[int]] = None,
                    indices: Optional[Sequence[int]] = None,
                    device_paths: Optional[Sequence[str]] = None,
                    shared_device_paths: Sequence[str] = (),
                    uuids: Optional[Sequence[str]] = None) -> HostTopology:
    """``indices`` carries the real device numbers when they are sparse;
    numa/hbm/device-path/uuid lists are positional alongside it. Without
    ``uuids`` a chip's uuid is ``<uuid_prefix>-<index>``; without
    ``device_paths`` the fake's ``/dev/accel<index>`` is assumed."""
    coords = _mesh_coords(mesh)
    idxs = list(indices) if indices is not None else list(range(count))
    chips = tuple(
        Chip(
            index=idxs[i],
            uuid=(uuids[i] if uuids else f"{uuid_prefix}-{idxs[i]}"),
            hbm_bytes=(hbm_per_chip[i] if hbm_per_chip else hbm),
            cores=cores,
            coords=coords[i] if i < len(coords) else (i, 0, 0),
            numa_node=(numa_nodes[i] if numa_nodes else 0),
            device_path=(device_paths[i] if device_paths
                         else f"/dev/accel{idxs[i]}"),
        )
        for i in range(count)
    )
    return HostTopology(generation=generation, mesh=mesh, chips=chips,
                        shared_device_paths=tuple(shared_device_paths))


class Backend:
    """Discovery seam. ``probe()`` returns the host topology or raises;
    ``available()`` is a cheap pre-check used by auto_backend()."""

    name = "abstract"

    def available(self) -> bool:
        raise NotImplementedError

    def probe(self) -> HostTopology:
        raise NotImplementedError

    def health_probe(self) -> HostTopology:
        """Periodic-poll variant of probe(). Default: a full re-probe."""
        return self.probe()


class FakeBackend(Backend):
    """Configurable fake: the JAX package's, unchanged.

    Env config: TPUSHARE_FAKE_CHIPS, TPUSHARE_FAKE_HBM_GIB,
    TPUSHARE_FAKE_MESH ("2x2"), TPUSHARE_FAKE_GENERATION,
    TPUSHARE_FAKE_UNHEALTHY (comma-separated chip indices).
    """

    name = "fake"

    def __init__(self, chips: Optional[int] = None, hbm_gib: Optional[float] = None,
                 mesh: Optional[tuple] = None, generation: Optional[str] = None,
                 cores: Optional[int] = None,
                 unhealthy: Optional[Sequence[int]] = None):
        env = os.environ
        self._chips = chips if chips is not None else int(env.get("TPUSHARE_FAKE_CHIPS", "0") or 0)
        self._hbm = int(float(hbm_gib if hbm_gib is not None
                              else env.get("TPUSHARE_FAKE_HBM_GIB", "16")) * _GIB)
        self._generation = generation or env.get("TPUSHARE_FAKE_GENERATION", "v5e")
        self._cores = cores if cores is not None else int(
            env.get("TPUSHARE_FAKE_CORES", str(_DEFAULT_CORES.get(self._generation, 1))))
        mesh_s = env.get("TPUSHARE_FAKE_MESH", "")
        if mesh is None and mesh_s:
            parts = [int(p) for p in re.split("[x,]", mesh_s)]
            mesh = tuple(parts + [1] * (3 - len(parts)))
        self._mesh = mesh
        self._unhealthy = set(unhealthy) if unhealthy is not None else {
            int(i) for i in env.get("TPUSHARE_FAKE_UNHEALTHY", "").split(",") if i.strip()
        }

    def available(self) -> bool:
        return self._chips > 0

    def probe(self) -> HostTopology:
        if self._chips <= 0:
            raise RuntimeError("FakeBackend not configured (set TPUSHARE_FAKE_CHIPS)")
        mesh = self._mesh or _default_mesh(self._chips)
        topo = _build_topology(self._generation, self._chips, mesh, self._hbm,
                               self._cores, uuid_prefix=f"faketpu-{self._generation}")
        if self._unhealthy:
            chips = tuple(
                Chip(**{**c.__dict__, "healthy": c.index not in self._unhealthy})
                for c in topo.chips
            )
            topo = HostTopology(topo.generation, topo.mesh, chips,
                                topo.shared_device_paths)
        return topo


def _default_mesh(count: int) -> tuple:
    return {1: (1, 1, 1), 2: (2, 1, 1), 4: (2, 2, 1), 8: (2, 4, 1), 16: (4, 4, 1)}.get(
        count, (count, 1, 1))


def generation_from_name(name: str) -> str:
    """Card generation from its marketing name: ``"NVIDIA H100 80GB
    HBM3"`` -> ``"h100"``, ``"NVIDIA A100-SXM4-80GB"`` -> ``"a100"``;
    a name with no model token gives its lower-cased alphanumerics."""
    m = re.search(r"\b([A-Z]{1,3}\d{1,4}[A-Z]?)\b", name)
    if m:
        return m.group(1).lower()
    return re.sub(r"[^a-z0-9]+", "", name.lower()) or "gpu"


def build_topology_from_facts(indices: Sequence[int],
                              numa_nodes: Sequence[int],
                              hbm_per_chip: Sequence[int],
                              uuids: Sequence[str],
                              generation: str,
                              device_paths: Optional[Sequence[str]] = None,
                              shared_device_paths: Sequence[str] = ()) -> HostTopology:
    """One assembly path for discovered card facts (the NVML and torch
    probes both end here): one core per card, a ``(n, 1, 1)`` mesh, each
    card's own memory and uuid; device paths default to
    ``/dev/nvidia<index>``."""
    count = len(indices)
    return _build_topology(generation, count, (count, 1, 1), 0, 1,
                           uuid_prefix="", numa_nodes=list(numa_nodes),
                           hbm_per_chip=list(hbm_per_chip),
                           indices=list(indices),
                           device_paths=(list(device_paths) if device_paths
                                         else [f"/dev/nvidia{i}"
                                               for i in indices]),
                           shared_device_paths=shared_device_paths,
                           uuids=list(uuids))


def _read_int(path: str, default: int = 0) -> int:
    try:
        with open(path) as f:
            v = int(f.read().strip())
            return max(v, 0)  # sysfs numa_node is -1 when unknown
    except (OSError, ValueError):
        return default


class TorchBackend(Backend):
    """Probe through ``torch.cuda``. Claims the card (it makes a CUDA
    context), so it must never run inside the daemon — bench/diagnostic
    use only, and as ``ChainBackend``'s cross-check of NVML. It knows no
    minor number or NUMA node: device paths stay empty, NUMA 0."""

    name = "torch"

    def available(self) -> bool:
        try:
            import torch
        except ImportError:
            return False
        return torch.cuda.is_available()

    def probe(self) -> HostTopology:
        import torch
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible to torch")
        props = [torch.cuda.get_device_properties(i) for i in range(n)]
        return build_topology_from_facts(
            list(range(n)), [0] * n, [p.total_memory for p in props],
            [f"GPU-{p.uuid}" for p in props],
            generation_from_name(props[0].name), device_paths=[""] * n)


class ChainBackend(Backend):
    """Probe backends in order, first success wins. When NVML won and a
    ``TorchBackend`` is in the chain, the two are compared (card count,
    uuids, generation, memory): ``disagreement`` holds what differed,
    ``checked_against`` the backend the check read (None when it did not
    run)."""

    name = "chain"

    def __init__(self, backends: Sequence[Backend]):
        self.backends = list(backends)
        self._active: Optional[Backend] = None

    def available(self) -> bool:
        return any(b.available() for b in self.backends)

    def probe(self) -> HostTopology:
        errors = []
        for b in self.backends:
            if not b.available():
                continue
            try:
                topo = b.probe()
                self._active = b
                self._cross_check(topo)
                return topo
            except Exception as e:
                log.warning("backend %s probe failed: %s", b.name, e)
                errors.append(f"{b.name}: {e}")
        raise RuntimeError("all discovery backends failed: "
                           + "; ".join(errors or ["none available"]))

    disagreement: Optional[str] = None
    checked_against: Optional[str] = None

    def _cross_check(self, topo: HostTopology) -> None:
        self.disagreement = None           # never report a stale mismatch
        self.checked_against = None
        try:
            self._cross_check_inner(topo)
        except Exception as e:             # a failed *check* must never
            log.debug("discovery cross-check skipped: %s", e)   # fail the probe

    def _cross_check_inner(self, topo: HostTopology) -> None:
        if self._active is None or self._active.name != "nvml":
            return
        other = next((b for b in self.backends if b.name == "torch"), None)
        if other is None or not other.available():
            return
        tt = other.probe()
        self.checked_against = other.name
        mismatches = []
        if tt.generation != topo.generation:
            mismatches.append(f"generation {topo.generation!r} (nvml) "
                              f"vs {tt.generation!r} (torch)")
        if tt.chip_count != topo.chip_count:
            mismatches.append(f"chip_count {topo.chip_count} vs "
                              f"{tt.chip_count}")
        if [c.uuid for c in tt.chips] != [c.uuid for c in topo.chips]:
            mismatches.append(f"uuids {[c.uuid for c in topo.chips]} vs "
                              f"{[c.uuid for c in tt.chips]}")
        for a, b in zip(topo.chips, tt.chips):
            # The CUDA runtime reports NVML's total less what the card
            # reserves (~480 MiB on an H100 80GB); more than the slack
            # apart, or above NVML's, is a misread card.
            if not 0 <= a.hbm_bytes - b.hbm_bytes < TOTAL_MEMORY_SLACK:
                mismatches.append(f"card {a.index} memory {a.hbm_bytes} "
                                  f"(nvml) vs {b.hbm_bytes} (torch)")
        if mismatches:
            self.disagreement = "; ".join(mismatches)
            log.error("DISCOVERY MISMATCH (nvml vs torch): %s — advertised "
                      "memory may be wrong on this node", self.disagreement)

    def health_probe(self) -> HostTopology:
        # Poll through whichever backend won the startup probe; fall
        # back to a full chain probe before first use.
        if self._active is not None:
            return self._active.health_probe()
        return self.probe()


def auto_backend(prefer: Optional[str] = None) -> Backend:
    """Pick a backend: explicit name > fake-if-configured > NVML.

    ``"torch"`` by name is NVML chained with torch (NVML answers, torch
    cross-checks; torch answers alone only where NVML is absent). Raises
    when nothing is available — no table stands in for a missing NVML;
    the reference blocks forever when no GPU exists (gpumanager.go:39,46)
    and callers get the same behavior by looping on this raising."""
    from tpushare_torch.plugin.nvmldisc import NvmlBackend
    by_name = {b.name: b for b in (FakeBackend(), NvmlBackend(),
                                   TorchBackend())}
    prefer = prefer or os.environ.get("TPUSHARE_BACKEND", "")
    if prefer:
        if prefer not in by_name:
            raise ValueError(f"unknown backend {prefer!r}; one of {sorted(by_name)}")
        if prefer == "torch":
            return ChainBackend([by_name["nvml"], by_name["torch"]])
        return by_name[prefer]
    if by_name["fake"].available():
        return by_name["fake"]
    if by_name["nvml"].available():
        return by_name["nvml"]
    raise RuntimeError("no GPU discovery backend available "
                       "(no TPUSHARE_FAKE_CHIPS, no libnvidia-ml.so.1)")


def topology_to_json(topo: HostTopology) -> str:
    return json.dumps({
        "generation": topo.generation,
        "mesh": list(topo.mesh),
        "shared_device_paths": list(topo.shared_device_paths),
        "chips": [{"index": c.index, "uuid": c.uuid, "hbm_bytes": c.hbm_bytes,
                   "cores": c.cores, "coords": list(c.coords),
                   "numa_node": c.numa_node, "healthy": c.healthy,
                   "device_path": c.device_path}
                  for c in topo.chips],
    })
