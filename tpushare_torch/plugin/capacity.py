"""The extender's capacity accounting, as the plugin's stale-assume
check reads it: the port's copies of ``node_chip_count``,
``node_total_mem`` and ``chip_free`` (``tpushare/extender/core.py``) and
of ``pod_device_usage`` and ``is_active_pod``
(``tpushare/cli/inspect.py``). The plugin, the extender
(``extender/core.py``) and ``cli/inspect.py`` must agree on what free
means, so this is their one implementation; a test holds these copies to
the originals.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpushare_torch.k8s.types import Node, Pod
from tpushare_torch.plugin import const, podutils


def pod_device_usage(pod: Pod) -> Dict[int, int]:
    """Which chips a pod occupies and how much on each (reference:
    getDeivceInfo, nodeinfo.go:169-197 + the TPU multi-chip extension:
    an IDX list "0,1" splits the pod total evenly)."""
    allocation = podutils.get_allocation(pod)
    if allocation:
        return allocation
    mem = podutils.pod_requested_mem(pod)
    ids = podutils.get_chip_ids_from_annotation(pod)
    if not ids:
        return {-1: mem}  # unknown -> pending bucket
    share, rem = divmod(mem, len(ids))
    return {chip: share + (1 if i < rem else 0)
            for i, chip in enumerate(sorted(ids))}


def is_active_pod(pod: Pod) -> bool:
    """Drop Succeeded/Failed (reference: podinfo.go:96-107)."""
    return pod.phase not in ("Succeeded", "Failed")


def node_chip_count(node: Node) -> int:
    return int(node.allocatable.get(const.RESOURCE_COUNT, 0) or 0)


def node_total_mem(node: Node) -> int:
    return int(node.allocatable.get(const.RESOURCE_NAME, 0) or 0)


def chip_free(node: Node, pods: List[Pod],
              now_ns: Optional[int] = None) -> Dict[int, int]:
    """Free units per chip from node capacity minus annotation usage.

    A MULTI-chip grant owns its chips exclusively: the tenant runs a
    JAX mesh over them (TPU_CHIPS_PER_PROCESS_BOUNDS), so the split
    remainder on each chip is internal fragmentation, not shareable
    capacity — co-locating a small pod onto a mesh tenant's chip
    would hand two processes conflicting views of the same chip.
    (Caught by the scheduling fuzz exclusivity invariant.)

    Assumed-pod TTL GC: a pod assumed but never ASSIGNED within
    TPUSHARE_ASSUME_TTL_SECONDS stops counting against capacity — the
    reference predicate has no expiry (podutils.go:78-119), so a pod
    deleted mid-schedule would reserve its chip forever. The plugin's
    Allocate still honors a late-arriving stale pod (kubelet may just
    be slow); this only lets the extender place new work again."""
    count = node_chip_count(node)
    total = node_total_mem(node)
    if count <= 0 or total <= 0:
        return {}
    ttl = podutils.assume_ttl_ns()
    per_chip = total // count
    free = {i: per_chip for i in range(count)}
    for pod in pods:
        if pod.node_name != node.name or not is_active_pod(pod):
            continue
        if podutils.pod_requested_mem(pod) <= 0:
            continue
        if podutils.is_stale_assumed(pod, ttl, now_ns=now_ns):
            continue
        usage = pod_device_usage(pod)
        exclusive = len(usage) > 1
        for chip, used in usage.items():
            if chip in free:
                free[chip] -= per_chip if exclusive else used
    return free
