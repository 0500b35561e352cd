"""Lightweight typed views over Kubernetes JSON objects: the port's copy
of ``tpushare/k8s/types.py`` (``Pod``, ``Node``, quantities).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+)([A-Za-z]*)$")
_SUFFIX = {
    "": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40, "Pi": 1 << 50,
    "m": 1e-3,
}


def parse_quantity(value: Any) -> int:
    """Parse a k8s resource quantity to an integer value (extended
    resources are integral; mirrors resource.Quantity.Value() which the
    reference calls at podutils.go:127)."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _QUANTITY_RE.match(str(value).strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix {value!r}")
    return int(float(num) * _SUFFIX[suffix])


class Pod:
    """Read-mostly view of a v1.Pod dict."""

    def __init__(self, obj: Dict[str, Any]):
        self.obj = obj or {}

    @property
    def metadata(self) -> Dict[str, Any]:
        return self.obj.get("metadata") or {}

    @property
    def spec(self) -> Dict[str, Any]:
        return self.obj.get("spec") or {}

    @property
    def status(self) -> Dict[str, Any]:
        return self.obj.get("status") or {}

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "default")

    @property
    def uid(self) -> str:
        return self.metadata.get("uid", "")

    @property
    def annotations(self) -> Dict[str, str]:
        return self.metadata.get("annotations") or {}

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.get("labels") or {}

    @property
    def node_name(self) -> str:
        return self.spec.get("nodeName", "")

    @property
    def phase(self) -> str:
        return self.status.get("phase", "")

    @property
    def deletion_timestamp(self) -> Optional[str]:
        return self.metadata.get("deletionTimestamp")

    @property
    def containers(self) -> List[Dict[str, Any]]:
        return self.spec.get("containers") or []

    @property
    def conditions(self) -> List[Dict[str, Any]]:
        return self.status.get("conditions") or []

    @property
    def container_statuses(self) -> List[Dict[str, Any]]:
        return self.status.get("containerStatuses") or []

    def limit_sum(self, resource_names: Iterable[str]) -> int:
        """Sum a resource over container *limits* — the reference sums
        Limits, not Requests (podutils.go:122-131). The first matching
        name wins per container so tpu-mem + legacy gpu-mem don't
        double-count."""
        total = 0
        for c in self.containers:
            limits = (c.get("resources") or {}).get("limits") or {}
            for rn in resource_names:
                if rn in limits:
                    total += parse_quantity(limits[rn])
                    break
        return total

    def __repr__(self) -> str:
        return f"Pod({self.namespace}/{self.name})"


class Node:
    """Read-mostly view of a v1.Node dict."""

    def __init__(self, obj: Dict[str, Any]):
        self.obj = obj or {}

    @property
    def metadata(self) -> Dict[str, Any]:
        return self.obj.get("metadata") or {}

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.get("labels") or {}

    @property
    def annotations(self) -> Dict[str, str]:
        return self.metadata.get("annotations") or {}

    @property
    def status(self) -> Dict[str, Any]:
        return self.obj.get("status") or {}

    @property
    def capacity(self) -> Dict[str, Any]:
        return self.status.get("capacity") or {}

    @property
    def allocatable(self) -> Dict[str, Any]:
        return self.status.get("allocatable") or {}

    @property
    def addresses(self) -> Dict[str, str]:
        """status.addresses as {type: address}."""
        return {a.get("type", ""): a.get("address", "")
                for a in self.status.get("addresses") or []}

    def address(self) -> str:
        """Best address for reaching this node: InternalIP, then
        Hostname, then the node name (resolvable in clusters whose node
        names are DNS)."""
        addrs = self.addresses
        return addrs.get("InternalIP") or addrs.get("Hostname") or self.name

    def capacity_of(self, resource: str, default: int = 0) -> int:
        v = self.capacity.get(resource)
        return parse_quantity(v) if v is not None else default

    def allocatable_of(self, resource: str, default: int = 0) -> int:
        v = self.allocatable.get(resource)
        return parse_quantity(v) if v is not None else default

    def __repr__(self) -> str:
        return f"Node({self.name})"
