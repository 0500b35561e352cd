"""Pod predicates and the scheduler-extender annotation codec: the port's
copy of ``tpushare/plugin/podutils.py`` (TPU-spelled keys first, the
legacy GPU-spelled keys as fallbacks, so one extender drives both
plugins).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional

from tpushare_torch.k8s.types import Pod
from tpushare_torch.plugin import const

log = logging.getLogger("tpushare.podutils")

TPU_DIALECT = "tpu"
GPU_DIALECT = "gpu"


def annotation_dialect(pod: Pod) -> str:
    """Which key family did the extender write on this pod?"""
    ann = pod.annotations
    if const.ANN_ASSUME_TIME in ann or const.ANN_ASSIGNED_FLAG in ann:
        return TPU_DIALECT
    if const.LEGACY_ANN_ASSUME_TIME in ann or const.LEGACY_ANN_ASSIGNED_FLAG in ann:
        return GPU_DIALECT
    return TPU_DIALECT


def _ann(pod: Pod, tpu_key: str, gpu_key: str) -> Optional[str]:
    ann = pod.annotations
    if tpu_key in ann:
        return ann[tpu_key]
    return ann.get(gpu_key)


def get_chip_ids_from_annotation(pod: Pod) -> List[int]:
    """Chip index(es) the extender chose. The reference parses a single
    int and returns -1 on failure (podutils.go:37-61); the TPU dialect
    additionally allows a comma list ("0,1,2,3") for multi-chip pods.
    Returns [] when absent/unparseable (the -1 analog)."""
    value = _ann(pod, const.ANN_RESOURCE_INDEX, const.LEGACY_ANN_RESOURCE_INDEX)
    if value is None:
        log.warning("no device index annotation for pod %s in ns %s",
                    pod.name, pod.namespace)
        return []
    try:
        ids = [int(p) for p in str(value).split(",") if p.strip() != ""]
    except ValueError:
        log.warning("failed to parse dev id %r for pod %s in ns %s",
                    value, pod.name, pod.namespace)
        return []
    if any(i < 0 for i in ids):
        return []
    return ids


def get_assume_time(pod: Pod) -> int:
    """Extender's assume timestamp in ns; 0 when absent/unparseable
    (podutils.go:64-75)."""
    value = _ann(pod, const.ANN_ASSUME_TIME, const.LEGACY_ANN_ASSUME_TIME)
    if value is None:
        return 0
    try:
        t = int(value)
        return t if t >= 0 else 0
    except ValueError:
        log.warning("failed to parse assume timestamp %r", value)
        return 0


def pod_requested_mem(pod: Pod) -> int:
    """Sum of tpu-mem limits over containers (podutils.go:122-131 sums
    Limits of the extended resource); legacy gpu-mem counts too so
    GPU-era pod specs keep working."""
    return pod.limit_sum((const.RESOURCE_NAME, const.LEGACY_RESOURCE_NAME))


def is_assumed_pod(pod: Pod) -> bool:
    """The three-clause "assumed but not yet assigned" predicate
    (podutils.go:78-119): requests the shared resource, has an assume
    time, and ASSIGNED is exactly "false"."""
    if pod_requested_mem(pod) <= 0:
        return False
    if _ann(pod, const.ANN_ASSUME_TIME, const.LEGACY_ANN_ASSUME_TIME) is None:
        return False
    assigned = _ann(pod, const.ANN_ASSIGNED_FLAG, const.LEGACY_ANN_ASSIGNED_FLAG)
    if assigned is None:
        log.warning("no assigned flag for pod %s in ns %s", pod.name, pod.namespace)
        return False
    return assigned == "false"


def is_stale_assumed(pod: Pod, ttl_ns: int,
                     now_ns: Optional[int] = None) -> bool:
    """Assumed-but-never-assigned past its TTL. The reference predicate
    (podutils.go:78-119) has no expiry, so a pod the extender assumed
    that never reached kubelet Allocate (deleted mid-schedule, crashed
    node agent) holds its chip units forever; the out-of-tree gpushare
    extender expires these. ``ttl_ns <= 0`` disables (never stale).

    Only PENDING pods expire: a Running pod still carrying
    assigned="false" already received *some* kubelet device grant (the
    quantity-match protocol cannot prove whose — allocate.go:55-89's
    same-size ambiguity), so expiring it would hide a live hardware
    tenant from capacity accounting and re-create the double-grant the
    TTL exists to prevent."""
    if ttl_ns <= 0 or pod.phase != "Pending" or not is_assumed_pod(pod):
        return False
    t = get_assume_time(pod)
    if t <= 0:
        return False
    now = time.time_ns() if now_ns is None else now_ns
    return now - t > ttl_ns


def assume_ttl_ns() -> int:
    """Assume-reservation TTL from TPUSHARE_ASSUME_TTL_SECONDS
    (default 300 s; 0 disables expiry)."""
    import os
    try:
        return int(float(os.environ.get(
            "TPUSHARE_ASSUME_TTL_SECONDS", "300")) * 1e9)
    except ValueError:
        log.warning("bad TPUSHARE_ASSUME_TTL_SECONDS; using 300")
        return 300 * 10 ** 9


def assigned_patch(pod: Pod, now_ns: Optional[int] = None) -> Dict:
    """Strategic-merge patch body flipping ASSIGNED=true and refreshing
    the assume time — the exact fields the reference patches
    (podutils.go:27-35), in the dialect the extender used."""
    now_ns = now_ns if now_ns is not None else time.time_ns()
    if annotation_dialect(pod) == GPU_DIALECT:
        ann = {const.LEGACY_ANN_ASSIGNED_FLAG: "true",
               const.LEGACY_ANN_ASSUME_TIME: str(now_ns)}
    else:
        ann = {const.ANN_ASSIGNED_FLAG: "true",
               const.ANN_ASSUME_TIME: str(now_ns)}
    return {"metadata": {"annotations": ann}}


def unassign_patch(pod: Pod) -> Dict:
    """Inverse of assigned_patch for the stale-grant unwind: restore
    assigned="false" and the pod's ORIGINAL assume time (so the pod
    returns to its expired state instead of holding capacity for a
    fresh TTL it did not earn)."""
    original = _ann(pod, const.ANN_ASSUME_TIME,
                    const.LEGACY_ANN_ASSUME_TIME) or "0"
    if annotation_dialect(pod) == GPU_DIALECT:
        ann = {const.LEGACY_ANN_ASSIGNED_FLAG: "false",
               const.LEGACY_ANN_ASSUME_TIME: original}
    else:
        ann = {const.ANN_ASSIGNED_FLAG: "false",
               const.ANN_ASSUME_TIME: original}
    return {"metadata": {"annotations": ann}}


def get_allocation(pod: Pod) -> Dict[int, int]:
    """Per-chip memory map from the scheduler-framework extender's
    allocation JSON (reference: GetAllocation, cmd/inspect/nodeinfo.go:245-272).
    The annotation holds ``{container: {chip_idx: mem}}``; returns the
    chip->mem sum over containers, or {} when absent/malformed."""
    raw = _ann(pod, const.ANN_ALLOCATION_JSON, const.LEGACY_ANN_ALLOCATION_JSON)
    if not raw:
        return {}
    try:
        data = json.loads(raw)
        out: Dict[int, int] = {}
        for container_alloc in data.values():
            for idx_str, mem in container_alloc.items():
                out[int(idx_str)] = out.get(int(idx_str), 0) + int(mem)
        return out
    except (ValueError, TypeError, AttributeError):
        log.warning("malformed allocation annotation on pod %s/%s",
                    pod.namespace, pod.name)
        return {}


class GangContractError(ValueError):
    """A gang-annotated pod whose contract is partial or inconsistent.

    Raised (not warned past) because the failure mode of proceeding is
    split-brain: a gang member started without the multi-host env
    serves single-host inside a gang whose other ranks block in
    jax.distributed init — the worst of both. Allocate catches this
    and refuses the grant loudly (event + metric + poisoned env)."""


def gang_env(pod: Pod) -> Dict[str, str]:
    """Multi-host env contract for a gang member, or {} for non-gang
    pods. Requires the extender-written rank + coordinator *and* the
    user-set size. The warn-vs-refuse boundary: a pod with NO gang
    name is simply not a gang member ({} — the common case); a pod
    WITH a gang name but a partial/unparseable/inconsistent contract
    raises GangContractError — the extender predates gangs or the
    bind was tampered with, and starting it single-host would
    split-brain the mesh. The caller (Allocate) turns the raise into
    a refused grant."""
    ann = pod.annotations
    if const.ANN_GANG_NAME not in ann:
        return {}
    missing = [k for k in (const.ANN_GANG_SIZE, const.ANN_GANG_RANK,
                           const.ANN_GANG_COORDINATOR) if k not in ann]
    if missing:
        raise GangContractError(
            f"gang pod {pod.namespace}/{pod.name} is missing "
            f"annotations {missing}: refusing the grant (starting it "
            f"single-host would split-brain the gang)")
    try:
        size = int(ann[const.ANN_GANG_SIZE])
        rank = int(ann[const.ANN_GANG_RANK])
    except ValueError:
        raise GangContractError(
            f"gang pod {pod.namespace}/{pod.name} has unparseable "
            f"size/rank {ann[const.ANN_GANG_SIZE]!r}/"
            f"{ann[const.ANN_GANG_RANK]!r}: refusing the grant")
    if size <= 0 or not (0 <= rank < size):
        raise GangContractError(
            f"gang pod {pod.namespace}/{pod.name} has inconsistent "
            f"rank {rank} of size {size}: refusing the grant")
    return {
        const.ENV_COORDINATOR: ann[const.ANN_GANG_COORDINATOR],
        const.ENV_NUM_PROCESSES: str(size),
        const.ENV_PROCESS_ID: str(rank),
    }


# --- liveness predicates (reference podutils.go:133-182; used by the
# inspect CLI's active-pod filter) -----------------------------------------

def _condition_true_only(conditions: List[Dict], expect: str) -> bool:
    if len(conditions) != 1:
        return False
    c = conditions[0]
    return c.get("type") == expect and c.get("status") == "True"


def pod_is_not_running(pod: Pod) -> bool:
    if pod.deletion_timestamp:
        return True
    if pod.phase in ("Failed", "Succeeded"):
        return True
    if pod.phase == "Pending" and _condition_true_only(pod.conditions, "PodScheduled"):
        return True
    return False
