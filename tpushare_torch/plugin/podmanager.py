"""Cluster-state manager (pending-pod discovery, node resource patching):
the port's copy of ``tpushare/plugin/podmanager.py``.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from tpushare_torch.k8s.client import ApiError, KubeClient
from tpushare_torch.k8s.kubelet import KubeletClient
from tpushare_torch.k8s.types import Pod
from tpushare_torch.plugin import const, podutils

log = logging.getLogger("tpushare.podmanager")

KUBELET_RETRIES = 8          # podmanager.go:29 retries=8
KUBELET_RETRY_SLEEP = 0.1    # podmanager.go:215 100ms
APISERVER_RETRIES = 3        # podmanager.go:233
APISERVER_RETRY_SLEEP = 1.0  # podmanager.go:238


class PodManager:
    def __init__(self, kube: KubeClient, node_name: str,
                 kubelet: Optional[KubeletClient] = None,
                 query_kubelet: bool = False,
                 sleep=time.sleep):
        if not node_name:
            raise ValueError("NODE_NAME must be set")  # podmanager.go:55-58
        self.kube = kube
        self.node_name = node_name
        self.kubelet = kubelet
        self.query_kubelet = query_kubelet and kubelet is not None
        self._sleep = sleep

    # -- node label switch (reference: disableCGPUIsolationOrNot,
    # podmanager.go:62-75) --------------------------------------------------
    def disable_isolation_or_not(self) -> bool:
        node = self.kube.get_node(self.node_name)
        for key in (const.NODE_LABEL_DISABLE_ISOLATION,
                    const.LEGACY_NODE_LABEL_DISABLE_ISOLATION):
            if node.labels.get(key) == "true":
                log.info("isolation disabled via node label %s", key)
                return True
        return False

    # -- node capacity patch (reference: patchGPUCount, podmanager.go:160-185,
    # extended with the per-host core resource) -----------------------------
    def patch_chip_resources(self, chip_count: int, core_count: int) -> None:
        node = self.kube.get_node(self.node_name)
        want = {const.RESOURCE_COUNT: chip_count, const.RESOURCE_CORE: core_count}
        if all(node.capacity_of(k, -1) == v and node.allocatable_of(k, -1) == v
               for k, v in want.items()):
            log.info("no need to update capacity %s", sorted(want))
            return
        quantities = {k: str(v) for k, v in want.items()}
        patch = {"status": {"capacity": dict(quantities),
                            "allocatable": dict(quantities)}}
        try:
            self.kube.patch_node_status(self.node_name, patch)
            log.info("updated capacity %s successfully", sorted(want))
        except ApiError as e:
            log.warning("failed to update capacity: %s", e)
            raise

    # -- topology annotation (extender reads it for multi-chip choices) -----
    def publish_topology(self, topo) -> None:
        """Annotate the node with the host ICI mesh (ANN_NODE_TOPOLOGY)
        so the extender can pick contiguous sub-meshes. Advisory: on
        failure the extender falls back to a synthesized default mesh,
        so errors are logged, not raised."""
        from tpushare_torch.plugin.topology import topology_annotation
        value = topology_annotation(topo)
        try:
            node = self.kube.get_node(self.node_name)
            if node.annotations.get(const.ANN_NODE_TOPOLOGY) == value:
                return
            self.kube.patch_node(self.node_name, {
                "metadata": {"annotations": {const.ANN_NODE_TOPOLOGY: value}}})
            log.info("published topology annotation %s", value)
        except ApiError as e:
            log.warning("failed to publish topology annotation: %s", e)

    # -- pending pod listing ------------------------------------------------
    def _pending_from_kubelet(self) -> List[Pod]:
        """Kubelet /pods with retries, apiserver fallback
        (podmanager.go:187-225). 'No pending pods' counts as a failure
        and triggers retry/fallback, exactly like getPodList's error
        (podmanager.go:203-205)."""
        last_err: Exception = RuntimeError("kubelet query disabled")
        for attempt in range(1 + KUBELET_RETRIES):
            try:
                pods = self.kubelet.get_node_running_pods()
                pending = [p for p in pods if p.phase == "Pending"]
                if pending:
                    return pending
                last_err = RuntimeError("not found pending pod")
            except Exception as e:
                last_err = e
            if attempt < KUBELET_RETRIES:
                log.warning("failed to get pending pod list, retry: %s", last_err)
                self._sleep(KUBELET_RETRY_SLEEP)
        log.warning("not found from kubelet /pods api, start to list apiserver")
        return self._pending_from_apiserver()

    def _pending_from_apiserver(self) -> List[Pod]:
        """Field-selector list with retries (podmanager.go:227-245)."""
        selector = f"spec.nodeName={self.node_name},status.phase=Pending"
        last_err: Optional[Exception] = None
        for attempt in range(1 + APISERVER_RETRIES):
            try:
                return self.kube.list_pods(field_selector=selector)
            except Exception as e:
                last_err = e
                if attempt < APISERVER_RETRIES:
                    self._sleep(APISERVER_RETRY_SLEEP)
        raise RuntimeError(
            f"failed to get Pods assigned to node {self.node_name}: {last_err}")

    def get_pending_pods(self) -> List[Pod]:
        """Pending pods on this node, deduped by UID and filtered to our
        nodeName (podmanager.go:247-297)."""
        if self.query_kubelet:
            pod_list = self._pending_from_kubelet()
        else:
            pod_list = self._pending_from_apiserver()
        seen, pods = set(), []
        for pod in pod_list:
            if pod.node_name != self.node_name:
                log.warning("pod %s/%s is on node %s, not %s as expected",
                            pod.namespace, pod.name, pod.node_name, self.node_name)
                continue
            if pod.uid not in seen:
                seen.add(pod.uid)
                pods.append(pod)
        return pods

    def get_candidate_pods(self) -> List[Pod]:
        """Assumed-but-unassigned pods, FIFO by assume time
        (podmanager.go:300-333; stable sort preserves list order for
        equal timestamps, matching the reference's <= comparator intent)."""
        candidates = [p for p in self.get_pending_pods() if podutils.is_assumed_pod(p)]
        for p in candidates:
            log.debug("candidate pod %s in ns %s with timestamp %d",
                      p.name, p.namespace, podutils.get_assume_time(p))
        return sorted(candidates, key=podutils.get_assume_time)
