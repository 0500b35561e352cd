"""Mesh-aware card selection and the selection env: the port's copy of
``tpushare/plugin/topology.py``.

Kept as they are: ``choose_submesh``, ``contiguous_submeshes``,
``submesh_dims``, ``topology_annotation``, ``topology_from_annotation``,
``default_mesh`` and ``synthesize_topology`` (the extender's placement
fallback for a node without the topology annotation), and
``preferred_fake_devices`` (GetPreferredAllocation).
Over a host of cards the mesh is ``(n, 1, 1)`` (plugin/backend.py):
NVSwitch joins every pair, so the mesh only orders preference.

The env half differs: ``gpu_env_for_cards`` writes the reference
plugin's one selector, ``NVIDIA_VISIBLE_DEVICES`` (allocate.go:114-128),
in place of ``tpu_env_for_chips``' TPU_VISIBLE_CHIPS and process bounds:
a CUDA process has no bound env to set.
"""

from __future__ import annotations

import itertools
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from tpushare_torch.plugin import const
from tpushare_torch.plugin.backend import Chip, HostTopology
from tpushare_torch.plugin.devices import FAKE_ID_SEP, DeviceMap, extract_real_device_id


def _rect_dims(k: int) -> List[Tuple[int, int]]:
    """All (w, h) factorizations of k, squarest first (squarer sub-meshes
    have shorter ICI diameter)."""
    dims = [(w, k // w) for w in range(1, k + 1) if k % w == 0]
    return sorted(dims, key=lambda wh: abs(wh[0] - wh[1]))


def contiguous_submeshes(mesh: Tuple[int, int, int], k: int) -> List[Tuple[Tuple[int, int, int], ...]]:
    """Every axis-aligned contiguous w x h rectangle of k chips in the
    host mesh (z handled as extra rows; single-host TPUs are 2D)."""
    x, y, z = mesh
    out = []
    for (w, h) in _rect_dims(k):
        for zz in range(z):
            for ox in range(x - w + 1):
                for oy in range(y - h + 1):
                    rect = tuple((ox + dx, oy + dy, zz)
                                 for dy in range(h) for dx in range(w))
                    out.append(rect)
    return out


def _coord_to_index(topo: HostTopology) -> Dict[Tuple[int, int, int], int]:
    return {c.coords: c.index for c in topo.chips}


def choose_submesh(topo: HostTopology, k: int,
                   available: Optional[Iterable[int]] = None) -> Optional[List[int]]:
    """Pick chip indices for a k-chip allocation: a contiguous sub-mesh
    drawn from ``available`` (default: all healthy chips). Returns None
    when no valid sub-mesh exists. Preference order: squarest rectangle,
    then lowest chip indices (deterministic)."""
    avail = set(available) if available is not None else {
        c.index for c in topo.chips if c.healthy}
    if k <= 0 or k > len(avail):
        return None
    if k == 1:
        return [min(avail)]
    c2i = _coord_to_index(topo)
    for rect in contiguous_submeshes(topo.mesh, k):
        idxs = [c2i.get(p) for p in rect]
        if None not in idxs and all(i in avail for i in idxs):
            return sorted(idxs)
    return None


def submesh_dims(topo: HostTopology, chip_indices: Sequence[int]) -> Tuple[int, int, int]:
    """Bounding-box dims of the chosen chips inside the host mesh."""
    coords = [topo.chip_by_index(i).coords for i in chip_indices]
    spans = []
    for axis in range(3):
        vals = [c[axis] for c in coords]
        spans.append(max(vals) - min(vals) + 1)
    return tuple(spans)


def gpu_env_for_cards(topo: HostTopology, indices: Sequence[int]) -> Dict[str, str]:
    """Container env selecting a card set: ``{NVIDIA_VISIBLE_DEVICES:
    "0,2"}``, indices sorted and joined by commas as the reference
    writes them (allocate.go:118). Raises KeyError for an index the
    topology does not hold."""
    idxs = sorted(indices)
    for i in idxs:
        topo.chip_by_index(i)
    return {const.ENV_NVIDIA_VISIBLE_DEVICES: ",".join(str(i) for i in idxs)}


def topology_annotation(topo: HostTopology) -> str:
    """Serialize the host mesh for the node annotation the extender
    reads (const.ANN_NODE_TOPOLOGY): generation, mesh dims, and chip
    index -> ICI coords. Only placement knowledge — HBM/core figures
    stay in node capacity where the reference puts them."""
    return json.dumps({
        "generation": topo.generation,
        "mesh": list(topo.mesh),
        "chips": {str(c.index): list(c.coords) for c in topo.chips},
    }, sort_keys=True)


def topology_from_annotation(value: str) -> Optional[HostTopology]:
    """Parse ANN_NODE_TOPOLOGY back into a placement-only HostTopology
    (synthetic uuids, zero HBM — enough for choose_submesh)."""
    try:
        obj = json.loads(value)
        mesh = tuple(int(v) for v in obj["mesh"])
        chips = tuple(
            Chip(index=int(i), uuid=f"ann-{i}", hbm_bytes=0, cores=1,
                 coords=tuple(int(v) for v in xyz))
            for i, xyz in sorted(obj["chips"].items(), key=lambda kv: int(kv[0])))
        if len(mesh) != 3 or not chips:
            return None
        return HostTopology(generation=str(obj.get("generation", "")),
                            mesh=mesh, chips=chips)
    except (ValueError, KeyError, TypeError):
        return None


def default_mesh(count: int) -> Tuple[int, int, int]:
    """Standard single-host mesh shape for a chip count: the squarest
    (w, h, 1) factorization (the JAX package's TPU host shapes, 4 -> 2x2,
    8 -> 2x4; over cards it only orders the extender's preference)."""
    w = 1
    for cand in range(1, int(count ** 0.5) + 1):
        if count % cand == 0:
            w = cand
    return (w, count // w, 1)


def synthesize_topology(count: int) -> HostTopology:
    """Placement-only fallback topology for nodes that predate the
    topology annotation: default mesh, row-major chip coords."""
    w, h, d = default_mesh(max(count, 1))
    chips = tuple(
        Chip(index=i, uuid=f"syn-{i}", hbm_bytes=0, cores=1,
             coords=(i % w, (i // w) % h, i // (w * h)))
        for i in range(max(count, 1)))
    return HostTopology(generation="", mesh=(w, h, d), chips=chips)


def preferred_fake_devices(devmap: DeviceMap, topo: HostTopology,
                           available_ids: Sequence[str],
                           must_include_ids: Sequence[str],
                           allocation_size: int) -> List[str]:
    """GetPreferredAllocation policy (reference: panic, server.go:38-39).

    Pack the requested fake devices onto as few chips as possible; when
    several chips can hold the whole request, best-fit — the chip with
    the *fewest* free units that still fits — so big free chunks stay
    intact for future large pods; for multi-chip spans prefer
    ICI-contiguous sub-meshes via choose_submesh.
    """
    must = list(must_include_ids)
    need = allocation_size - len(must)
    if need <= 0:
        return must[:allocation_size]
    taken = set(must)
    by_chip: Dict[int, List[str]] = defaultdict(list)
    for fid in available_ids:
        if fid in taken:
            continue
        uuid = extract_real_device_id(fid)
        idx = devmap.uuid_to_index.get(uuid)
        if idx is not None:
            by_chip[idx].append(fid)
    for idx in by_chip:
        by_chip[idx].sort(key=lambda f: int(f.split(FAKE_ID_SEP)[-1]))

    # Chips that can satisfy the remainder alone: best fit (fewest free
    # units that still fit), lowest index as tiebreak.
    single = [i for i, ids in by_chip.items() if len(ids) >= need]
    if single:
        best = min(single, key=lambda i: (len(by_chip[i]), i))
        return must + by_chip[best][:need]

    # Otherwise span chips: try contiguous sub-meshes of growing size.
    order = sorted(by_chip, key=lambda i: -len(by_chip[i]))
    for k in range(2, len(order) + 1):
        for combo in itertools.combinations(order, k):
            if sum(len(by_chip[i]) for i in combo) < need:
                continue
            sub = choose_submesh(topo, k, available=combo)
            if sub is None or set(sub) != set(combo):
                continue
            picked: List[str] = []
            for i in sub:
                picked.extend(by_chip[i])
            return must + picked[:need]
    # No contiguous option: greedy fill (kubelet may still use it).
    picked = []
    for i in order:
        picked.extend(by_chip[i])
    return must + picked[:need]
