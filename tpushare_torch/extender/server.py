"""Scheduler-extender HTTP endpoints (k8s scheduler extender protocol):
the port's copy of ``tpushare/extender/server.py``.

Wire format follows the kube-scheduler extender convention the
reference's companion extender speaks: POST JSON ``ExtenderArgs`` to
/filter and /prioritize, ``ExtenderBindingArgs`` to /bind; capitalized
field names (Pod, Nodes, NodeNames, FailedNodes, Error). stdlib
http.server — the daemon side has no web-framework dependency either.

Deploy one replica cluster-wide (the reference's extender is also a
single deployment) and point kube-scheduler policy at it:
  {"urlPrefix": "http://tpushare-extender:39999/tpushare",
   "filterVerb": "filter", "prioritizeVerb": "prioritize",
   "bindVerb": "bind", "managedResources": [{"name": "aliyun.com/tpu-mem"}]}
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpushare_torch.extender import core
from tpushare_torch.k8s.types import Node, Pod
from tpushare_torch.plugin.metrics import Registry, Timer

log = logging.getLogger("tpushare.extender")

# Extender-side registry (separate process from the daemon's).
METRICS = Registry()
METRICS.describe("tpushare_extender_binds_total", "counter",
                 "Bind verb outcomes")
METRICS.describe("tpushare_extender_bind_seconds", "summary",
                 "Bind verb wall time (incl. the serialization lock)")
METRICS.describe("tpushare_extender_is_leader", "gauge",
                 "1 when this replica holds the bind lease (or HA off)")


class ExtenderService:
    """Protocol handlers over a KubeClient (fake-able in tests).

    ``elector`` (optional, extender/leader.py) enables HA: replicas all
    serve the read-only /filter and /prioritize, but /bind — whose chip
    choice depends on cluster state the bind mutates — is refused by
    followers with a protocol Error so kube-scheduler retries onto the
    lease holder."""

    def __init__(self, kube, elector=None, pod_cache=None):
        self.kube = kube
        self.elector = elector
        # Optional informer-style cache (k8s/watch.PodCache) backing the
        # READ-ONLY verbs: /filter and /prioritize tolerate mild
        # staleness and fire on every scheduling cycle, so serving them
        # from the watch-fed store drops a full pod LIST per call.
        # /bind keeps live reads — its chip choice must see the state
        # its own writes mutate.
        self.pod_cache = pod_cache
        # One bind at a time: chip choice depends on cluster state that
        # the bind itself mutates (same serialization the plugin's
        # Allocate uses, reference allocate.go:60).
        self._lock = threading.Lock()

    def _cached_pods(self):
        if self.pod_cache is not None:
            return self.pod_cache.list()
        return self.kube.list_pods()

    # -- verbs -------------------------------------------------------------
    def filter(self, args: dict) -> dict:
        pod = Pod(args.get("Pod") or {})
        all_pods = self._cached_pods()
        node_names: Optional[list] = args.get("NodeNames")
        if args.get("Nodes") and args["Nodes"].get("Items"):
            nodes = [Node(n) for n in args["Nodes"]["Items"]]
        elif node_names:
            nodes = [self.kube.get_node(n) for n in node_names]
        else:
            nodes = self.kube.list_nodes()
        good, failed = core.filter_nodes(pod, nodes, all_pods)
        resp = {"FailedNodes": failed, "Error": ""}
        if node_names is not None:
            resp["NodeNames"] = [n.name for n in good]
        else:
            resp["Nodes"] = {"Items": [n.obj for n in good]}
        return resp

    def prioritize(self, args: dict) -> list:
        all_pods = self._cached_pods()
        if args.get("Nodes") and args["Nodes"].get("Items"):
            nodes = [Node(n) for n in args["Nodes"]["Items"]]
        else:
            nodes = [self.kube.get_node(n)
                     for n in (args.get("NodeNames") or [])]
        return [{"Host": n.name, "Score": core.score(n, all_pods)}
                for n in nodes]

    def bind(self, args: dict) -> dict:
        ns = args.get("PodNamespace", "default")
        name = args.get("PodName", "")
        node_name = args.get("Node", "")
        if self.elector is not None and not self.elector.is_leader:
            METRICS.inc("tpushare_extender_binds_total",
                        {"outcome": "not_leader"})
            return {"Error": "not the lease holder; retry (HA follower)"}
        with Timer(METRICS, "tpushare_extender_bind_seconds"), self._lock:
            try:
                pod = self.kube.get_pod(ns, name)
                node = self.kube.get_node(node_name)
                request = core.pod_requested_mem(pod)
                all_pods = self.kube.list_pods()
                chips = core.choose_chips(node, all_pods, request,
                                          policy=core.pod_placement_policy(
                                              pod))
                if not chips:
                    METRICS.inc("tpushare_extender_binds_total",
                                {"outcome": "no_fit"})
                    return {"Error": f"pod {ns}/{name} no longer fits "
                                     f"node {node_name}"}
                # Re-check right before the mutating write: the reads
                # above can stall past the lease; a deposed leader must
                # not assume with state read while it still led. (The
                # irreducible race below this check is the lease
                # protocol's own.)
                if self.elector is not None and not self.elector.is_leader:
                    METRICS.inc("tpushare_extender_binds_total",
                                {"outcome": "lost_lease"})
                    return {"Error": "lost the lease mid-bind; retry"}
                core.assume_pod(self.kube, pod, node_name, chips, request,
                                node=node, all_pods=all_pods)
            except Exception as e:  # surface as protocol error, not 500
                log.exception("bind failed")
                METRICS.inc("tpushare_extender_binds_total",
                            {"outcome": "error"})
                return {"Error": str(e)}
        METRICS.inc("tpushare_extender_binds_total", {"outcome": "bound"})
        return {"Error": ""}


def make_server(kube, host: str = "0.0.0.0", port: int = 39999,
                prefix: str = "/tpushare",
                elector=None, pod_cache=None) -> ThreadingHTTPServer:
    svc = ExtenderService(kube, elector=elector, pod_cache=pod_cache)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # route to logging, not stderr
            log.debug(fmt, *a)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                args = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self.send_error(400, "bad json")
                return
            route = self.path.rstrip("/")
            if route == f"{prefix}/filter":
                out = svc.filter(args)
            elif route == f"{prefix}/prioritize":
                out = svc.prioritize(args)
            elif route == f"{prefix}/bind":
                out = svc.bind(args)
            else:
                self.send_error(404, f"unknown route {self.path}")
                return
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)
