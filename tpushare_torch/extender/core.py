"""Scheduler-extender brain, fit, score, card choice, assume: the port's
copy of ``tpushare/extender/core.py``.

The reference plugin depends on an out-of-tree gpushare scheduler
extender to pick the device and write the assumed-pod annotations its
Allocate reads back (allocate.go:79-107); the JAX package ships one, and
this is its copy. Every definition is the original's except the three
capacity functions, ``node_chip_count``, ``node_total_mem`` and
``chip_free``, which come from ``plugin/capacity.py`` (with
``pod_device_usage`` and ``is_active_pod``): the plugin's stale-assume
check, this extender and ``cli/inspect.py`` share one meaning of free.

Semantics:
- *fit*: a pod requesting R units fits a node if some single card has
  R units free, or, when R exceeds one card, ceil(R/per_card) cards are
  completely free (the extender works from node capacity and pod
  annotations only, no daemon RPC).
- *score*: bin-pack: prefer nodes already in use, so small tenants
  consolidate and whole hosts stay free for multi-card tenants.
- *choose*: best-fit within a node, the fullest card that still fits;
  multi-card takes a contiguous sub-mesh of fully free cards from the
  topology annotation the plugin publishes (over cards the mesh is
  ``(n, 1, 1)``: it only orders the preference), falling back to the
  standard mesh for the card count.
- *assume*: write the annotations the plugin's Allocate reads (IDX,
  assume-time ns, assigned="false", per-card allocation JSON), then bind
  the pod to the node.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional, Tuple

from tpushare_torch.k8s.types import Node, Pod
from tpushare_torch.plugin import const, podutils
from tpushare_torch.plugin.capacity import (chip_free, is_active_pod,
                                            node_chip_count, node_total_mem)
from tpushare_torch.plugin.topology import (choose_submesh,
                                            synthesize_topology,
                                            topology_from_annotation)


def node_topology(node: Node):
    """Host ICI mesh for multi-chip placement: the plugin-published
    annotation when present, else the standard mesh for the chip count
    (nodes running a pre-annotation daemon)."""
    ann = node.annotations.get(const.ANN_NODE_TOPOLOGY)
    if ann:
        topo = topology_from_annotation(ann)
        if topo is not None:
            return topo
    return synthesize_topology(node_chip_count(node))


def fits(node: Node, pods: List[Pod], request: int,
         now_ns: Optional[int] = None) -> bool:
    return choose_chips(node, pods, request, now_ns=now_ns) is not None


def score(node: Node, pods: List[Pod], *, max_score: int = 10) -> int:
    """Bin-pack priority: utilization fraction scaled to [0, max].

    Per-chip free is clamped at 0 first: exclusive multi-chip
    accounting can drive a chip negative on nodes with legacy
    co-located pods, and the scheduler contract is scores in
    [0, max_score]."""
    total = node_total_mem(node)
    if total <= 0:
        return 0
    free = sum(max(f, 0) for f in chip_free(node, pods).values())
    return int(round(max_score * (total - free) / total))


def pod_placement_policy(pod: Pod) -> str:
    """binpack (default) or spread, from the pod annotation."""
    val = pod.annotations.get(const.ANN_PLACEMENT_POLICY,
                              const.PLACEMENT_BINPACK)
    return (const.PLACEMENT_SPREAD if val == const.PLACEMENT_SPREAD
            else const.PLACEMENT_BINPACK)


def choose_chips(node: Node, pods: List[Pod], request: int,
                 policy: str = const.PLACEMENT_BINPACK,
                 now_ns: Optional[int] = None) -> Optional[List[int]]:
    """Best-fit chip selection; None when the pod no longer fits.

    ``policy``: "binpack" picks the fullest chip that fits (default —
    consolidates, keeping whole chips free); "spread" picks the
    emptiest (saturation workloads wanting one pod per chip)."""
    free = chip_free(node, pods, now_ns=now_ns)
    if not free or request <= 0:
        return None
    per_chip = node_total_mem(node) // node_chip_count(node)
    if request <= per_chip:
        candidates = [(f, i) for i, f in free.items() if f >= request]
        if not candidates:
            return None
        if policy == const.PLACEMENT_SPREAD:
            # Emptiest-that-fits, ties to the lowest index.
            _, idx = max(candidates, key=lambda t: (t[0], -t[1]))
        else:
            # Fullest-that-fits, ties to the lowest index.
            _, idx = min(candidates, key=lambda t: (t[0], t[1]))
        return [idx]
    # Multi-chip: an ICI-contiguous sub-mesh of fully-free chips, or
    # nothing — a non-rectangular grant (e.g. a diagonal pair) cannot
    # get TPU_PROCESS_BOUNDS and the tenant's mesh init would fail.
    need = math.ceil(request / per_chip)
    empty = sorted(i for i, f in free.items() if f == per_chip)
    if len(empty) < need:
        return None
    return choose_submesh(node_topology(node), need, available=empty)


def allocation_json(pod: Pod, chips: List[int], request: int) -> str:
    """The per-container allocation annotation the plugin/inspect parse:
    ``{container: {chip_idx: mem}}`` (podutils.get_allocation). Each
    container's request is laid onto the chip list in order, splitting
    across chips when one fills up."""
    chips = sorted(chips)
    share, rem = divmod(request, len(chips))
    capacity = {c: share + (1 if i < rem else 0)
                for i, c in enumerate(chips)}
    result: Dict[str, Dict[str, int]] = {}
    it = iter(chips)
    cur = next(it)
    left = capacity[cur]
    for container in pod.spec.get("containers", []):
        limits = (container.get("resources") or {}).get("limits") or {}
        need = int(limits.get(const.RESOURCE_NAME,
                              limits.get(const.LEGACY_RESOURCE_NAME, 0)) or 0)
        alloc: Dict[str, int] = {}
        while need > 0:
            if left == 0:
                cur = next(it)
                left = capacity[cur]
            take = min(need, left)
            alloc[str(cur)] = alloc.get(str(cur), 0) + take
            need -= take
            left -= take
        if alloc:
            result[container.get("name", "")] = alloc
    return json.dumps(result)


def gang_annotations(kube, pod: Pod, node: Node,
                     all_pods: Optional[List[Pod]] = None) -> Dict[str, str]:
    """Rank + coordinator for a gang member being bound to ``node``.

    Rank = the smallest rank not held by an *active* peer (the bind
    verb is serialized by the extender lock / leader lease, so the scan
    is race-free). Bind order therefore ranks a fresh gang 0,1,2,...,
    and a member whose pod failed and was recreated by its controller
    gets its old rank back instead of a duplicate. The rank-0 member's
    node address becomes the gang coordinator, copied onto every later
    member so each node's plugin can inject the contract without a
    cross-pod search at Allocate time.

    A rank-0 replacement re-derives the coordinator from its own
    (possibly different) node — surviving peers then hold a stale
    coordinator annotation, which is inherent to the contract:
    jax.distributed cannot hot-swap members, so losing any member means
    the operator's controller restarts the whole gang anyway (each pod
    re-binds, re-ranks, and re-reads the fresh coordinator).

    Raises ValueError when a non-rank-0 member binds but no rank-0 peer
    exists: without a coordinator the gang cannot form, and failing the
    bind lets kube-scheduler retry after rank 0 is recreated.
    """
    gang = pod.annotations.get(const.ANN_GANG_NAME)
    if not gang:
        return {}
    try:
        port = int(pod.annotations.get(const.ANN_GANG_PORT,
                                       const.DEFAULT_GANG_PORT))
    except ValueError:
        port = const.DEFAULT_GANG_PORT
    # Idempotent on scheduler bind retries: keep an already-assigned
    # rank. But a retry may land on a DIFFERENT node (first bind failed
    # after the annotation patch), so rank 0 must re-derive the
    # coordinator from the node it is actually binding to — a stale
    # node-1 address would hang every member's jax.distributed init.
    if const.ANN_GANG_RANK in pod.annotations:
        if pod.annotations[const.ANN_GANG_RANK] == "0":
            return {const.ANN_GANG_COORDINATOR: f"{node.address()}:{port}"}
        return {}
    try:
        size = int(pod.annotations.get(const.ANN_GANG_SIZE, "0"))
    except ValueError:
        size = 0
    if size <= 0:
        raise ValueError(
            f"gang pod {pod.namespace}/{pod.name} has missing or invalid "
            f"{const.ANN_GANG_SIZE} annotation")
    pods = all_pods if all_pods is not None else kube.list_pods()
    peers = [p for p in pods
             if p.namespace == pod.namespace
             and p.annotations.get(const.ANN_GANG_NAME) == gang
             and const.ANN_GANG_RANK in p.annotations
             and is_active_pod(p)]
    held = set()
    for p in peers:
        try:
            held.add(int(p.annotations[const.ANN_GANG_RANK]))
        except ValueError:
            pass
    rank = next(r for r in range(len(held) + 1) if r not in held)
    if rank >= size:
        raise ValueError(
            f"gang {pod.namespace}/{gang} already has {len(held)} members "
            f"of declared size {size}")
    if rank == 0:
        coordinator = f"{node.address()}:{port}"
    else:
        rank0 = next((p for p in peers
                      if p.annotations.get(const.ANN_GANG_RANK) == "0"), None)
        if rank0 is None or const.ANN_GANG_COORDINATOR not in rank0.annotations:
            raise ValueError(
                f"gang {pod.namespace}/{gang}: rank-0 member not found; "
                f"cannot determine coordinator")
        coordinator = rank0.annotations[const.ANN_GANG_COORDINATOR]
    return {const.ANN_GANG_RANK: str(rank),
            const.ANN_GANG_COORDINATOR: coordinator}


def assume_pod(kube, pod: Pod, node_name: str, chips: List[int],
               request: int, *, bind: bool = True,
               now_ns: Optional[int] = None,
               node: Optional[Node] = None,
               all_pods: Optional[List[Pod]] = None) -> None:
    """Annotate (assumed, unassigned) + bind — the extender's bind verb.

    The annotations are exactly what the plugin's Allocate matches on
    (quantity + FIFO assume-time) and resolves (IDX -> chips); gang
    members additionally get rank/coordinator (gang_annotations).
    ``node``/``all_pods`` let the bind handler reuse objects it already
    fetched under its lock; the node is only needed for gang pods.
    """
    now = time.time_ns() if now_ns is None else now_ns
    ann = {
        const.ANN_RESOURCE_INDEX: ",".join(str(c) for c in sorted(chips)),
        const.ANN_ASSUME_TIME: str(now),
        const.ANN_ASSIGNED_FLAG: "false",
        const.ANN_ALLOCATION_JSON: allocation_json(pod, chips, request),
    }
    if pod.annotations.get(const.ANN_GANG_NAME):
        if node is None:
            node = kube.get_node(node_name)
        ann.update(gang_annotations(kube, pod, node, all_pods))
    kube.patch_pod(pod.namespace, pod.name,
                   {"metadata": {"annotations": ann}})
    if bind:
        kube.bind_pod(pod.namespace, pod.name, node_name, uid=pod.uid)


def filter_nodes(pod: Pod, nodes: List[Node],
                 pods: List[Pod]) -> Tuple[List[Node], Dict[str, str]]:
    """ExtenderFilter: (fitting nodes, failed node -> reason)."""
    request = podutils.pod_requested_mem(pod)
    good, failed = [], {}
    for node in nodes:
        if node_total_mem(node) <= 0:
            failed[node.name] = "no shareable TPU memory advertised"
        elif not fits(node, pods, request):
            failed[node.name] = (
                f"no chip with {request} free units "
                f"(request {request}, per-chip capacity "
                f"{node_total_mem(node) // max(node_chip_count(node), 1)})")
        else:
            good.append(node)
    return good, failed


# Re-exported so the HTTP layer needs only `core`.
pod_requested_mem = podutils.pod_requested_mem
