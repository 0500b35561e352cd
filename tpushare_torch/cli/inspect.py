"""kubectl-inspect-tpushare, the cluster's share-utilization CLI: the
port's copy of ``tpushare/cli/inspect.py`` (the reference's
cmd/inspect/{main,nodeinfo,podinfo,display}.go). It lists the sharing
nodes (Allocatable[tpu-mem] > 0, or the legacy gpu-mem) and their active
pods, rebuilds per-card usage from pod annotations alone (allocation
JSON first, then the IDX annotation, an unknown index under -1
"pending") and renders the summary or the per-pod details with cluster
totals, byte for byte as the JAX package's CLI does.

``pod_device_usage`` and ``is_active_pod`` come from
``plugin/capacity.py``, their one home in the port, so the plugin, the
extender and this CLI read usage alike.

Usage: ``python -m tpushare_torch.cli.inspect [-d] [nodeName]`` (console
script ``kubectl-inspect_tpushare_torch``)
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpushare_torch.k8s.client import KubeClient
from tpushare_torch.k8s.types import Node, Pod
from tpushare_torch.plugin import const, podutils
from tpushare_torch.plugin.capacity import is_active_pod, pod_device_usage


@dataclass
class DeviceInfo:
    """Per-chip usage view (reference: DeviceInfo, nodeinfo.go)."""

    idx: int
    total_mem: int
    used_mem: int = 0
    pods: List[Pod] = field(default_factory=list)

    def __str__(self) -> str:  # "used/total" (display.go dev.String())
        return f"{self.used_mem}/{self.total_mem}"


@dataclass
class NodeInfo:
    node: Node
    pods: List[Pod] = field(default_factory=list)
    chip_count: int = 0
    total_mem: int = 0
    devs: Dict[int, DeviceInfo] = field(default_factory=dict)

    @property
    def has_pending(self) -> bool:
        return -1 in self.devs

    @property
    def used_mem(self) -> int:
        return sum(d.used_mem for d in self.devs.values())

    @property
    def address(self) -> str:
        for addr in (self.node.status.get("addresses") or []):
            if addr.get("type") == "InternalIP":
                return addr.get("address", "unknown")
        return "unknown"


def is_tpu_sharing_node(node: Node) -> bool:
    """Allocatable[tpu-mem] > 0 (reference: isGPUSharingNode,
    nodeinfo.go:214-222); legacy gpu-mem also counts."""
    return (node.allocatable_of(const.RESOURCE_NAME) > 0
            or node.allocatable_of(const.LEGACY_RESOURCE_NAME) > 0)


def node_total_mem(node: Node) -> int:
    return (node.allocatable_of(const.RESOURCE_NAME)
            or node.allocatable_of(const.LEGACY_RESOURCE_NAME))


def node_chip_count(node: Node) -> int:
    for res in (const.RESOURCE_COUNT, const.LEGACY_RESOURCE_COUNT):
        c = node.capacity_of(res)
        if c > 0:
            return c
    c = node.labels.get(const.LABEL_CHIP_COUNT)
    return int(c) if c and c.isdigit() else 0


def infer_memory_unit(total_mem: int, chip_count: int) -> str:
    """Per-chip size > 100 means the unit must be MiB (reference:
    setUnit, nodeinfo.go:228-244)."""
    if chip_count <= 0:
        return const.GIB
    return const.MIB if total_mem // chip_count > 100 else const.GIB


def build_node_infos(nodes: List[Node], pods: List[Pod]) -> List[NodeInfo]:
    """Reference: buildAllNodeInfos (nodeinfo.go:47-135)."""
    infos = []
    for node in nodes:
        if not is_tpu_sharing_node(node):
            continue
        info = NodeInfo(node=node, chip_count=node_chip_count(node),
                        total_mem=node_total_mem(node))
        per_chip = info.total_mem // info.chip_count if info.chip_count else 0
        for i in range(info.chip_count):
            info.devs[i] = DeviceInfo(idx=i, total_mem=per_chip)
        info.pods = [p for p in pods
                     if p.node_name == node.name and is_active_pod(p)
                     and podutils.pod_requested_mem(p) > 0]
        for pod in info.pods:
            for dev_id, used in pod_device_usage(pod).items():
                if dev_id not in info.devs:
                    info.devs[dev_id] = DeviceInfo(idx=dev_id, total_mem=per_chip)
                info.devs[dev_id].used_mem += used
                info.devs[dev_id].pods.append(pod)
        infos.append(info)
    return infos


# --- rendering (tabwriter analog) ------------------------------------------

def _table(rows: List[List[str]]) -> str:
    if not rows:
        return ""
    widths = [max(len(r[i]) for r in rows if i < len(r))
              for i in range(max(len(r) for r in rows))]
    lines = []
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i]) for i, c in enumerate(r)).rstrip())
    return "\n".join(lines)


def display_summary(infos: List[NodeInfo], out=sys.stdout) -> None:
    """Reference: displaySummary (display.go:141-245)."""
    max_chips = max((i.chip_count for i in infos), default=0)
    has_pending = any(i.has_pending for i in infos)
    unit = infer_memory_unit(infos[0].total_mem, infos[0].chip_count) if infos else const.GIB

    header = ["NAME", "IPADDRESS"]
    header += [f"TPU{i}(Allocated/Total)" for i in range(max_chips)]
    if has_pending:
        header.append("PENDING(Allocated)")
    header.append(f"TPU Memory({unit})")
    rows = [header]

    used_cluster = total_cluster = 0
    for info in infos:
        if info.total_mem <= 0:
            continue
        row = [info.node.name, info.address]
        for i in range(max_chips):
            row.append(str(info.devs[i]) if i in info.devs else "0/0")
        if has_pending:
            row.append(str(info.devs[-1].used_mem) if info.has_pending else "")
        row.append(f"{info.used_mem}/{info.total_mem}")
        rows.append(row)
        used_cluster += info.used_mem
        total_cluster += info.total_mem

    print(_table(rows), file=out)
    print("-" * 70, file=out)
    pct = int(used_cluster / total_cluster * 100) if total_cluster else 0
    print("Allocated/Total TPU Memory In Cluster:", file=out)
    print(f"{used_cluster}/{total_cluster} ({pct}%)", file=out)


def display_details(infos: List[NodeInfo], out=sys.stdout) -> None:
    """Reference: displayDetails (display.go:15-129)."""
    used_cluster = total_cluster = 0
    for info in infos:
        if info.total_mem <= 0:
            continue
        print(f"\nNAME:       {info.node.name}", file=out)
        print(f"IPADDRESS:  {info.address}\n", file=out)
        header = ["NAME", "NAMESPACE"]
        header += [f"TPU{i}(Allocated)" for i in range(info.chip_count)]
        if info.has_pending:
            header.append("Pending(Allocated)")
        # Multi-host gangs are visible state the operator needs when a
        # tenant hangs at jax.distributed init (is every rank bound?).
        has_gang = any(pod.annotations.get(const.ANN_GANG_NAME)
                       for dev in info.devs.values() for pod in dev.pods)
        if has_gang:
            header.append("GANG(rank/size)")
        rows = [header]
        seen = set()
        ttl = podutils.assume_ttl_ns()
        for dev in sorted(info.devs.values(), key=lambda d: d.idx):
            for pod in dev.pods:
                if pod.uid in seen:
                    continue
                seen.add(pod.uid)
                usage = pod_device_usage(pod)
                # Assumed past the TTL without ASSIGNED flipping: the
                # extender no longer counts it against capacity
                # (core.chip_free GC) — surface that so the operator
                # knows the reservation is expired, not live.
                stale = podutils.is_stale_assumed(pod, ttl)
                row = [pod.name + (" (STALE)" if stale else ""),
                       pod.namespace]
                for i in range(info.chip_count):
                    row.append(str(usage.get(i, 0)))
                if info.has_pending:
                    row.append(str(usage.get(-1, 0)))
                if has_gang:
                    gname = pod.annotations.get(const.ANN_GANG_NAME, "")
                    if gname:
                        rank = pod.annotations.get(const.ANN_GANG_RANK, "?")
                        size = pod.annotations.get(const.ANN_GANG_SIZE, "?")
                        row.append(f"{gname}:{rank}/{size}")
                    else:
                        row.append("")
                rows.append(row)
        print(_table(rows), file=out)
        unit = infer_memory_unit(info.total_mem, info.chip_count)
        print(f"Total({unit}): {info.total_mem}, Allocated: {info.used_mem}",
              file=out)
        used_cluster += info.used_mem
        total_cluster += info.total_mem
    print("-" * 70, file=out)
    pct = int(used_cluster / total_cluster * 100) if total_cluster else 0
    print("Allocated/Total TPU Memory In Cluster:", file=out)
    print(f"{used_cluster}/{total_cluster} ({pct}%)", file=out)


def main(argv=None, kube: Optional[KubeClient] = None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(
        prog="kubectl-inspect-tpushare",
        description="Display TPU-share utilization across the cluster")
    parser.add_argument("-d", "--details", action="store_true",
                        help="per-pod detail view")
    parser.add_argument("node", nargs="?", default="",
                        help="restrict to one node")
    args = parser.parse_args(argv)

    kube = kube or KubeClient()
    try:
        if args.node:
            nodes = [kube.get_node(args.node)]
        else:
            nodes = kube.list_nodes()
        pods = kube.list_pods()
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    infos = build_node_infos(nodes, pods)
    if not infos:
        print("No TPU-share nodes found in the cluster", file=out)
        return 0
    if args.details:
        display_details(infos, out=out)
    else:
        display_summary(infos, out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
