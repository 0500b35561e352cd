"""Best-effort Kubernetes Event emission: the port's copy of
``tpushare/k8s/events.py``. Allocate outcomes and health transitions
land on the pod / node; a failed write is logged, never raised.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

log = logging.getLogger("tpushare.events")

COMPONENT = "tpushare-device-plugin"

# Event reasons (the `kubectl get events` REASON column).
REASON_ALLOCATED = "TpuAllocated"
REASON_ALLOCATE_FAILED = "TpuAllocationFailed"
REASON_CHIP_UNHEALTHY = "TpuChipUnhealthy"
REASON_CHIP_RECOVERED = "TpuChipRecovered"


def _rfc3339(ts: Optional[float] = None) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(ts if ts is not None else time.time()))


class EventRecorder:
    """Writes v1 Events through a KubeClient-shaped object.

    ``kube`` may be None (tests, dry runs) — every method degrades to a
    log line. Event names get a nanosecond suffix for uniqueness, the
    same scheme client-go's event recorder uses.
    """

    def __init__(self, kube: Any, node_name: str,
                 component: str = COMPONENT):
        self.kube = kube
        self.node_name = node_name
        self.component = component
        self._node_uid: Optional[str] = None

    def _node_ref_uid(self) -> str:
        """The node's UID, fetched once: `kubectl describe node` matches
        events by involvedObject.uid, so an event without it is
        invisible there (raw `kubectl get events` still shows it)."""
        if self._node_uid is None:
            uid = ""
            try:
                node = self.kube.get_node(self.node_name)
                uid = (node.metadata or {}).get("uid", "")
            except Exception as e:
                log.debug("could not fetch node uid for events: %s", e)
            self._node_uid = uid
        return self._node_uid

    def _emit(self, namespace: str, involved: Dict[str, Any],
              reason: str, message: str, type_: str) -> None:
        if self.kube is None or not hasattr(self.kube, "create_event"):
            log.info("event (dropped, no client): %s %s: %s",
                     type_, reason, message)
            return
        now = _rfc3339()
        name = f"{involved.get('name', 'unknown')}.{time.time_ns():x}"
        event = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": dict(involved, namespace=namespace)
            if involved.get("kind") == "Pod" else involved,
            "reason": reason, "message": message, "type": type_,
            "source": {"component": self.component, "host": self.node_name},
            "firstTimestamp": now, "lastTimestamp": now, "count": 1,
        }
        try:
            self.kube.create_event(namespace, event)
        except Exception as e:
            log.warning("failed to emit %s event for %s: %s",
                        reason, involved.get("name"), e)

    # -- pod events (Allocate outcomes) ---------------------------------
    def pod_event(self, pod, reason: str, message: str,
                  type_: str = "Normal") -> None:
        involved = {"kind": "Pod", "name": pod.name,
                    **({"uid": pod.uid} if getattr(pod, "uid", None) else {})}
        self._emit(pod.namespace, involved, reason, message, type_)

    # -- node events (chip health) --------------------------------------
    def node_event(self, reason: str, message: str,
                   type_: str = "Normal") -> None:
        involved = {"kind": "Node", "name": self.node_name}
        if self.kube is not None:
            uid = self._node_ref_uid()
            if uid:
                involved["uid"] = uid
        self._emit("default", involved, reason, message, type_)
