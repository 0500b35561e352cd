"""Elastic mesh failure domains: degrade-and-replay resharding.
Counterpart of ``tpushare/models/reshard.py``: the same pure policy,
copied (the port imports nothing of the JAX package), over the port's
``ServingMesh``.

A sharded replica that loses a card shrinks instead of dying. This
module owns the policy half:

- ``degraded_spec``: the largest tp/ep sub-spec of the configured mesh
  that fits the surviving cards AND satisfies the MeshPlacement
  divisibility contract (tp | n_kv_heads for target and draft, ep |
  n_experts). Ties keep ``ep`` first, then ``tp``. Axes only ever
  shrink.
- ``carve_devices``: a contiguous run of healthy positions in the
  configured mesh's order, falling back to the first-N healthy.
- ``plan_reshard``: health mask in, ``ReshardPlan`` out.
- ``ParamStore``: the weight source a rebuild reads, off the mesh: a
  host copy of the unplaced tree, or a safetensors checkpoint written
  once at build (with an atomic ``.meta.json`` marker) whose leaves
  each rank reads by offset, only its own slice.

A "device" here is a mesh position: rank r of the configured mesh, in
``ServingMesh.cards`` order (the reference's flattened
``mesh.devices.flat``). The plan's ``positions`` name the configured
positions the new mesh runs on, in its rank order; which process takes
which position is the mesh generation's business
(``parallel/mesh.py`` ``MeshGenerations``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the serving axes (MeshPlacement.check: everything else must be 1)
SERVING_AXES = ("ep", "tp")


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _axis_candidates(configured: int, *must_divide: Optional[int]
                     ) -> List[int]:
    """Sizes an axis may shrink to: divisors of every constraint,
    never larger than the configured size."""
    cands = _divisors(configured)
    for n in must_divide:
        if n is not None:
            cands = [d for d in cands if n % d == 0]
    return cands


def mesh_spec_of(mesh) -> Dict[str, int]:
    """The tp/ep sizes of a mesh (1 for absent axes): the configured
    shape the degrade policy shrinks from."""
    return {ax: int(mesh.shape.get(ax, 1)) for ax in SERVING_AXES}


def degraded_spec(configured: Dict[str, int], n_devices: int, cfg,
                  draft_cfg=None) -> Optional[Dict[str, int]]:
    """The largest valid {ep, tp} sub-spec of ``configured`` that fits
    on ``n_devices`` surviving cards: tp divides every family's
    n_kv_heads, ep divides n_experts (dense families pin ep == 1).
    Maximizes total cards; ties keep ``ep`` first, then ``tp``. None
    when no card survives."""
    if n_devices <= 0:
        return None
    kv_constraints = [getattr(cfg, "n_kv_heads", None)]
    if draft_cfg is not None:
        kv_constraints.append(getattr(draft_cfg, "n_kv_heads", None))
    tp_cands = _axis_candidates(configured.get("tp", 1), *kv_constraints)
    n_experts = getattr(cfg, "n_experts", None)
    if n_experts is None:
        ep_cands = [1]
    else:
        ep_cands = _axis_candidates(configured.get("ep", 1), n_experts)
    best: Optional[Tuple[int, int, int, Dict[str, int]]] = None
    for ep in ep_cands:
        for tp in tp_cands:
            if ep * tp > n_devices:
                continue
            key = (ep * tp, ep, tp)
            if best is None or key > best[:3]:
                best = (*key, {"ep": ep, "tp": tp})
    return best[3] if best else None


def carve_devices(devices: Sequence, healthy: np.ndarray,
                  need: int) -> Optional[List]:
    """Pick ``need`` of ``devices`` (the configured mesh's order)
    restricted to the healthy mask: a contiguous healthy window first
    (the order the plugin's contiguous grant arrived in), else the
    first ``need`` healthy. None when fewer than ``need`` survive."""
    healthy = np.asarray(healthy, bool)
    idx = np.nonzero(healthy)[0]
    if len(idx) < need:
        return None
    for start in range(len(devices) - need + 1):
        if healthy[start:start + need].all():
            return list(devices[start:start + need])
    return [devices[i] for i in idx[:need]]


@dataclasses.dataclass
class ReshardPlan:
    """Outcome of plan_reshard: the mesh to rebuild on (an unbound
    ``ServingMesh``; None = no surviving shape, the replica must
    drain), its spec, whether it is a degraded sub-shape of the
    configured mesh, the healthy count, and the configured positions
    it runs on, in its rank order."""
    mesh: Optional[Any]
    spec: Optional[Dict[str, int]]
    degraded: bool
    n_healthy: int
    positions: Optional[List[int]] = None


def plan_reshard(configured_mesh, healthy: np.ndarray, cfg,
                 draft_cfg=None) -> ReshardPlan:
    """Re-carve a serving mesh from the configured mesh's surviving
    positions. All-healthy returns the configured shape over every
    position (the grow-back path); otherwise the largest
    ``degraded_spec`` over a ``carve_devices`` window."""
    from tpushare_torch.parallel.mesh import ServingMesh
    healthy = np.asarray(healthy, bool)
    n_healthy = int(healthy.sum())
    configured = mesh_spec_of(configured_mesh)
    n = configured_mesh.size
    if healthy.all():
        return ReshardPlan(
            mesh=ServingMesh(configured_mesh.sizes, configured_mesh.cards),
            spec=configured, degraded=False, n_healthy=n_healthy,
            positions=list(range(n)))
    spec = degraded_spec(configured, n_healthy, cfg, draft_cfg)
    if spec is None:
        return ReshardPlan(mesh=None, spec=None, degraded=True,
                           n_healthy=n_healthy)
    picked = carve_devices(list(range(n)), healthy,
                           spec["ep"] * spec["tp"])
    if picked is None:          # pragma: no cover - spec fits by
        return ReshardPlan(mesh=None, spec=None, degraded=True,
                           n_healthy=n_healthy)
    mesh = ServingMesh(spec, [configured_mesh.cards[p] for p in picked])
    return ReshardPlan(mesh=mesh, spec=spec, degraded=True,
                       n_healthy=n_healthy, positions=picked)


def host_mem_available() -> Optional[int]:
    """``MemAvailable`` of ``/proc/meminfo`` in bytes (None where the
    file is absent): what a host copy of the weights may take."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


class ParamStore:
    """The weight source a reshard rebuilds from: off the mesh by
    construction, so no card loss can take it down.

    - in-memory (default): a host copy of the unplaced trees (CPU
      tensors; a tree already on the host is kept by reference, since
      the servers never write their weights).
    - checkpoint (``path=``): the host trees written once at build as
      one safetensors file (``utils/checkpoint.save``), and the
      ``.meta.json`` marker written after it through the atomic
      helper. ``load()`` then returns lazy leaves
      (``checkpoint.LazyLeaf``): the placement of each rebuilt server
      reads only its rank's slice of each leaf, by offset.

    ``load()`` returns ``(params, draft_params)`` for
    ``MeshPlacement.place_params`` under whatever mesh the plan
    carved."""

    def __init__(self, params, draft_params=None,
                 path: Optional[str] = None):
        self.path = path
        if path is None:
            self._host = _to_host(params)
            self._dhost = (_to_host(draft_params)
                           if draft_params is not None else None)
            return
        from tpushare_torch.utils import atomicio, checkpoint
        tree = {"params": params}
        if draft_params is not None:
            tree["draft"] = draft_params
        checkpoint.save(path, tree, overwrite=True)
        # The marker rides beside the file through the atomic write
        # helper: every load() checks it, so a checkpoint a crash left
        # half-written is detected instead of half-restored.
        atomicio.write_json(self._meta_path(path),
                            {"complete": True,
                             "has_draft": draft_params is not None})
        self._host = self._dhost = None

    @staticmethod
    def _meta_path(path: str) -> str:
        return os.path.abspath(path).rstrip("/") + ".meta.json"

    def load(self) -> Tuple[Any, Optional[Any]]:
        if self.path is None:
            return self._host, self._dhost
        from tpushare_torch.utils import checkpoint
        try:
            with open(self._meta_path(self.path)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise RuntimeError(
                f"reshard checkpoint at {self.path} has no complete "
                f"metadata marker ({e}): the checkpoint write never "
                f"finished — rebuild from a healthy boot") from e
        if not meta.get("complete"):
            raise RuntimeError(
                f"reshard checkpoint at {self.path} is marked "
                f"incomplete — rebuild from a healthy boot")
        tree = checkpoint.lazy_tree(self.path)
        return tree["params"], tree.get("draft")
