"""The Allocate decision path: the port's copy of
``tpushare/plugin/allocate.py`` (itself the reference plugin's
allocate.go:43-201, bit for bit where the extender can see it: pod
identity inferred by matching the summed fake-device count against
assumed pods in FIFO assume-time order; ASSIGNED flipped with one retry
on the optimistic-lock conflict; the single-card fast path; failures
answered with a successful RPC whose env poisons the container).

Three changes from the original, each to a card's terms:
- ``_container_responses`` selects cards with ``gpu_env_for_cards``
  (``NVIDIA_VISIBLE_DEVICES``) in place of the TPU_* env;
- ``_err_response`` writes the reference's poison,
  ``NVIDIA_VISIBLE_DEVICES=no-gpu-has-<n><unit>-to-run``;
- ``_device_specs`` returns the card's nodes (``/dev/nvidia<minor>``
  and the shared ``/dev/nvidiactl`` / ``nvidia-uvm`` nodes, from
  ``NvmlBackend``'s topology).
The stale-assume check reads the extender's accounting from the port's
copy (``plugin/capacity.py``).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from tpushare_torch.deviceplugin import pb
from tpushare_torch.k8s import events
from tpushare_torch.plugin.metrics import REGISTRY as METRICS, Timer
from tpushare_torch.k8s.client import ApiError, KubeClient
from tpushare_torch.k8s.types import Pod
from tpushare_torch.plugin import const, podutils
from tpushare_torch.plugin.backend import HostTopology
from tpushare_torch.plugin.devices import DeviceMap
from tpushare_torch.plugin.podmanager import PodManager
from tpushare_torch.plugin.topology import gpu_env_for_cards

log = logging.getLogger("tpushare.allocate")


class Allocator:
    def __init__(self, devmap: DeviceMap, topo: HostTopology,
                 podmgr: PodManager, kube: KubeClient,
                 disable_isolation: bool = False,
                 recorder=None,
                 device_nodes: bool = True):
        self.devmap = devmap
        self.topo = topo
        self.podmgr = podmgr
        self.kube = kube
        self.disable_isolation = disable_isolation
        # Inject /dev/accel* DeviceSpec entries so non-privileged tenant
        # pods can open their chips. The reference gets this for free
        # from the NVIDIA container runtime (allocate.go:114-128 injects
        # only NVIDIA_VISIBLE_DEVICES and the runtime mounts the nodes);
        # TPU has no runtime hook, so the plugin must do it. Off switch
        # for clusters that run tenants privileged (--device-nodes=off).
        self.device_nodes = device_nodes
        # Optional k8s EventRecorder: Allocate outcomes land on the pod
        # (the reference holds the events RBAC grant but never emits).
        self.recorder = recorder
        # One global lock fully serializing allocations (reference:
        # server.go:34 + allocate.go:60).
        self._lock = threading.Lock()

    # -- err-as-env (reference: buildErrResponse, allocate.go:25-40) -------
    def _err_response(self, reqs: pb.AllocateRequest, pod_req: int) -> pb.AllocateResponse:
        resp = pb.AllocateResponse()
        unit = self.devmap.memory_unit
        for req in reqs.container_requests:
            resp.container_responses.add(envs={
                const.ENV_NVIDIA_VISIBLE_DEVICES: f"no-gpu-has-{pod_req}{unit}-to-run",
                const.ENV_RESOURCE_INDEX: "-1",
                const.ENV_RESOURCE_BY_POD: str(pod_req),
                const.ENV_RESOURCE_BY_CONTAINER: str(len(req.devicesIDs)),
                const.ENV_RESOURCE_BY_DEV: str(self._units_per_dev()),
            })
        return resp

    def _units_per_dev(self) -> int:
        """Fake-device count of one chip for the *_DEV env. The reference
        uses a single global sampled from device 0 (nvidia.go:67-69);
        chips here may differ, so report the first chip's figure for
        parity and per-chip values elsewhere."""
        if not self.devmap.units_per_chip:
            return 0
        return self.devmap.units_per_chip[min(self.devmap.units_per_chip)]

    def _device_specs(self, chip_ids: List[int]) -> List:
        """DeviceSpec entries for a card grant: each granted card's host
        node (``/dev/nvidia<minor>``, same path inside the container)
        plus the host-wide nodes every CUDA process opens
        (``/dev/nvidiactl``, ``/dev/nvidia-uvm``, ``-tools``). The
        NVIDIA container runtime mounts them on its own where it runs;
        these entries let a pod without that runtime reach its card.
        Co-located tenants sharing one card each receive its node; memory
        partitioning is the ENV_HBM_LIMIT_BYTES contract
        (utils/tenant.py)."""
        specs = []
        for i in sorted(chip_ids):
            path = self.topo.chip_by_index(i).device_path
            if not path:
                log.warning("chip %d has no device_path; tenant pod must "
                            "run privileged to reach it", i)
                continue
            specs.append(pb.DeviceSpec(host_path=path, container_path=path,
                                       permissions="rw"))
        for path in self.topo.shared_device_paths:
            specs.append(pb.DeviceSpec(host_path=path, container_path=path,
                                       permissions="rw"))
        return specs

    def _container_responses(self, reqs: pb.AllocateRequest, pod_req: int,
                             chip_ids: List[int],
                             resp: pb.AllocateResponse,
                             pod: Optional[Pod] = None) -> None:
        """Env synthesis per container (reference: allocate.go:114-128).
        Gang members additionally get the multi-host contract the
        extender stamped on the pod (TPUSHARE_COORDINATOR /
        NUM_PROCESSES / PROCESS_ID, consumed by
        parallel/multihost.initialize). Unlike the reference, each
        response also carries the chip device nodes (_device_specs)."""
        tpu_env = gpu_env_for_cards(self.topo, chip_ids)
        if pod is not None:
            tpu_env.update(podutils.gang_env(pod))
        idx_str = ",".join(str(i) for i in sorted(chip_ids))
        units_dev = self.devmap.units_per_chip.get(min(chip_ids), self._units_per_dev())
        unit_bytes = const.MEMORY_UNIT_BYTES[self.devmap.memory_unit]
        specs = self._device_specs(chip_ids) if self.device_nodes else []
        for req in reqs.container_requests:
            req_n = len(req.devicesIDs)
            envs = dict(tpu_env)
            envs.update({
                const.ENV_RESOURCE_INDEX: idx_str,
                const.ENV_RESOURCE_BY_POD: str(pod_req),
                const.ENV_RESOURCE_BY_CONTAINER: str(req_n),
                const.ENV_RESOURCE_BY_DEV: str(units_dev),
                const.ENV_HBM_LIMIT_BYTES: str(req_n * unit_bytes),
            })
            if self.disable_isolation:
                envs[const.ENV_DISABLE_ISOLATION] = "true"
            resp.container_responses.add(envs=envs, devices=specs)

    def _patch_assigned(self, pod: Pod) -> bool:
        """Flip ASSIGNED=true with one retry on the optimistic-lock
        conflict, matched by error string (allocate.go:132-152)."""
        patch = podutils.assigned_patch(pod)
        for attempt in (0, 1):
            try:
                self.kube.patch_pod(pod.namespace, pod.name, patch)
                return True
            except ApiError as e:
                # The reference string-matches the conflict message exactly
                # (allocate.go:140); real apiservers prefix it with
                # 'Operation cannot be fulfilled on ...', so match by
                # containment / Conflict reason / 409 instead.
                conflict = (const.OPTIMISTIC_LOCK_ERROR_MSG in e.message
                            or e.reason == "Conflict" or e.status_code == 409)
                if attempt == 0 and conflict:
                    continue
                log.warning("failed to patch pod %s/%s: %s",
                            pod.namespace, pod.name, e)
                return False
        return False

    def _node_state_for_stale_check(self):
        """(node, pods-on-node) for stale-conflict verification, fetched
        at most once per Allocate (inside the global lock — one stall,
        not one per stale candidate) and only on the rare stale path.
        None means unverifiable: fail OPEN and honor the stale pod,
        matching the pre-TTL reference behavior (podutils.go:78-119
        never expires). Rationale: a conflict requires the extender to
        have re-assumed through the same apiserver we cannot reach, and
        a false grant needs that plus a quantity match, while a false
        rejection strands a merely-slow kubelet's pod forever."""
        if self.kube is None:
            return None
        try:
            node = self.kube.get_node(self.podmgr.node_name)
            pods = self.kube.list_pods(
                field_selector=f"spec.nodeName={self.podmgr.node_name}")
            return node, pods
        except Exception as e:
            log.warning("cannot verify stale assumes on %s (%s); "
                        "honoring them", self.podmgr.node_name, e)
            return None

    def _stale_assume_conflicts(self, pod: Pod, node_state) -> bool:
        """True when a stale-assumed pod's chip units are no longer
        free — i.e. honoring its late Allocate would double-grant.

        Freeness is computed by the extender's OWN accounting
        (extender/core.chip_free on the node's published capacity):
        the safety property is exactly "plugin and extender agree on
        what free means", so there must be one implementation of it.
        chip_free already encodes stale-assumed-holds-nothing and
        exclusive multi-chip ownership."""
        from tpushare_torch.plugin.capacity import (chip_free,
                                                    node_chip_count,
                                                    node_total_mem,
                                                    pod_device_usage)
        want = pod_device_usage(pod)
        if -1 in want:          # no resolvable chip annotation: the
            return False        # annotation-resolve guard handles it
        if node_state is None:
            return False
        node, others = node_state
        count, total = node_chip_count(node), node_total_mem(node)
        if count <= 0 or total <= 0:
            # Capacity never published: the extender cannot have
            # re-assumed anything either — nothing to conflict with.
            return False
        free = chip_free(node, [p for p in others if p.uid != pod.uid])
        per_chip = total // count
        want_exclusive = len(want) > 1      # mesh grants need whole chips
        for chip, units in want.items():
            if free.get(chip, 0) < (per_chip if want_exclusive else units):
                return True
        return False

    def _stale_regrant_verified(self, pod: Pod, record) -> bool:
        """Read-after-write re-verify for a stale grant: between the
        pre-grant conflict check and the ASSIGNED flip, the extender
        may have re-assumed this pod's chips (it saw the stale pod as
        holding nothing for that whole window). Once the flip is
        visible the extender counts the pod again, so a conflicting
        assume is either visible to this post-flip list or was placed
        against a view that already included the flip (and therefore
        avoided these chips). On conflict: unwind the flip (restore
        the expired state) and refuse the grant. Residual window: an
        extender read and a plugin write that are mutually invisible —
        documented in OPERATIONS.md; the annotation protocol has no
        shared object to make the pair transactional."""
        node_state = self._node_state_for_stale_check()
        if (node_state is None
                or not self._stale_assume_conflicts(pod, node_state)):
            return True
        log.warning("stale grant for %s/%s lost the re-assume race; "
                    "unwinding ASSIGNED", pod.namespace, pod.name)
        record(pod, events.REASON_ALLOCATE_FAILED,
               "stale assume: chips re-assumed concurrently with the "
               "grant; delete and reschedule", "Warning")
        METRICS.inc("tpushare_allocations_total",
                    {"outcome": "stale_regrant_unwound"})
        try:
            self.kube.patch_pod(pod.namespace, pod.name,
                                podutils.unassign_patch(pod))
        except ApiError as e:
            # Failed unwind leaves ASSIGNED=true: the pod then counts
            # against capacity (over-accounting — the safe direction)
            # until an operator deletes it.
            log.warning("failed to unwind stale grant for %s/%s: %s",
                        pod.namespace, pod.name, e)
        return False

    def allocate(self, reqs: pb.AllocateRequest) -> pb.AllocateResponse:
        log.info("----Allocating TPU for tpu mem is started----")
        pod_req = sum(len(r.devicesIDs) for r in reqs.container_requests)
        log.info("RequestPodTPUs: %d", pod_req)

        # Events are queued and emitted after the lock releases: an
        # apiserver stall on a best-effort event write must not extend
        # the global-lock hold (every Allocate serializes on it).
        pending_events = []

        def record(pod, reason, message, type_="Normal"):
            pending_events.append((pod, reason, message, type_))

        try:
            with Timer(METRICS, "tpushare_allocate_seconds"), self._lock:
                resp, assume_pod = self._allocate_locked(
                    reqs, pod_req, record)
        finally:
            if self.recorder is not None:
                for pod, reason, message, type_ in pending_events:
                    self.recorder.pod_event(pod, reason, message, type_)

        pod_name = assume_pod.name if assume_pod else ""
        log.info("----Allocating TPU for tpu mem for %s is ended----", pod_name)
        return resp

    def _allocate_locked(self, reqs: pb.AllocateRequest, pod_req: int,
                         record):
        try:
            pods = self.podmgr.get_candidate_pods()
        except Exception as e:
            log.info("invalid allocation request: failed to find "
                     "candidate pods due to %s", e)
            METRICS.inc("tpushare_allocations_total",
                        {"outcome": "candidate_list_error"})
            return self._err_response(reqs, pod_req), None

        assume_pod: Optional[Pod] = None
        assume_stale = False
        ttl = podutils.assume_ttl_ns()
        node_state = _UNFETCHED = object()   # lazy: rare stale path only
        for pod in pods:
            if podutils.pod_requested_mem(pod) != pod_req:
                continue
            # A stale-assumed pod no longer counts against extender
            # capacity (chip_free's TTL GC), so its chip units may
            # already be re-assumed to a replacement pod. Honoring its
            # late Allocate unconditionally could grant the same units
            # twice; honor it only while its chips are still free —
            # the "kubelet is just slow" case — and otherwise skip it
            # so the FIFO scan reaches the fresh replacement (which,
            # being its replacement, typically quantity-matches too).
            stale = podutils.is_stale_assumed(pod, ttl)
            if stale:
                if node_state is _UNFETCHED:
                    node_state = self._node_state_for_stale_check()
                if self._stale_assume_conflicts(pod, node_state):
                    log.warning(
                        "skipping stale assumed pod %s/%s: its chip "
                        "grant was re-assumed after the %.0fs TTL "
                        "expired", pod.namespace, pod.name, ttl / 1e9)
                    record(pod, events.REASON_ALLOCATE_FAILED,
                           "stale assume: chip units re-assumed to "
                           "another pod after TTL expiry; delete and "
                           "reschedule", "Warning")
                    METRICS.inc("tpushare_allocations_total",
                                {"outcome": "stale_conflict_skipped"})
                    continue
            log.info("found assumed TPU-share pod %s in ns %s with "
                     "tpu mem %d", pod.name, pod.namespace, pod_req)
            assume_pod = pod
            assume_stale = stale
            break

        resp = pb.AllocateResponse()
        if assume_pod is not None:
            chip_ids = podutils.get_chip_ids_from_annotation(assume_pod)
            idx2uuid = self.devmap.index_to_uuid
            valid = bool(chip_ids) and all(i in idx2uuid for i in chip_ids)
            if not valid:
                log.warning("failed to resolve device for pod %s/%s "
                            "(annotation ids %s)", assume_pod.namespace,
                            assume_pod.name, chip_ids)
                record(assume_pod, events.REASON_ALLOCATE_FAILED,
                       f"cannot resolve chip annotation {chip_ids} "
                       f"against this node's devices", "Warning")
                METRICS.inc("tpushare_allocations_total",
                            {"outcome": "annotation_resolve_error"})
                return self._err_response(reqs, pod_req), assume_pod
            log.info("chip index %s, uuids: %s", chip_ids,
                     [idx2uuid[i] for i in chip_ids])
            try:
                self._container_responses(reqs, pod_req, chip_ids, resp,
                                          pod=assume_pod)
            except podutils.GangContractError as e:
                # A partial gang contract never starts serving: a
                # member booted single-host would split-brain the
                # mesh while its siblings hang in distributed init.
                log.warning("%s", e)
                record(assume_pod, events.REASON_ALLOCATE_FAILED,
                       str(e), "Warning")
                METRICS.inc("tpushare_allocations_total",
                            {"outcome": "gang_contract_refused"})
                return self._err_response(reqs, pod_req), assume_pod
            if not self._patch_assigned(assume_pod):
                record(assume_pod, events.REASON_ALLOCATE_FAILED,
                       "failed to mark pod assigned (see plugin log "
                       "for the apiserver error)", "Warning")
                METRICS.inc("tpushare_allocations_total",
                            {"outcome": "assign_patch_error"})
                return self._err_response(reqs, pod_req), assume_pod
            if assume_stale and not self._stale_regrant_verified(
                    assume_pod, record):
                return self._err_response(reqs, pod_req), assume_pod
            unit = self.devmap.memory_unit
            record(assume_pod, events.REASON_ALLOCATED,
                   f"allocated TPU chip(s) "
                   f"{','.join(map(str, sorted(chip_ids)))} "
                   f"({pod_req} {unit} tpu-mem)")
            METRICS.inc("tpushare_allocations_total",
                        {"outcome": "assigned"})
        elif len(self.devmap.uuid_to_index) == 1:
            # Single-chip fast path: no pod search, no extender needed
            # (allocate.go:154-181). No gang env here by construction:
            # gangs require the extender (it assigns ranks), and an
            # extender-assumed pod always quantity-matches into the
            # branch above.
            only_idx = next(iter(self.devmap.uuid_to_index.values()))
            log.info("this node has only one tpu chip, skip pod search "
                     "and directly assign chip %d", only_idx)
            self._container_responses(reqs, pod_req, [only_idx], resp)
            METRICS.inc("tpushare_allocations_total",
                        {"outcome": "single_chip_fast_path"})
        else:
            log.warning("invalid allocation request: request tpu memory "
                        "%d can't be satisfied", pod_req)
            METRICS.inc("tpushare_allocations_total",
                        {"outcome": "no_matching_pod"})
            return self._err_response(reqs, pod_req), None

        return resp, assume_pod
