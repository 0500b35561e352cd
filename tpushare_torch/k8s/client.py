"""Minimal apiserver REST client: the port's copy of
``tpushare/k8s/client.py`` ($KUBECONFIG, else in-cluster config;
get/list/patch of nodes and pods over stdlib http.client).
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import ssl
import tempfile
import urllib.parse
from typing import Any, Dict, List, Optional

from tpushare_torch.chaos import fault_point

from .types import Node, Pod

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
STRATEGIC_MERGE = "application/strategic-merge-patch+json"
MERGE_PATCH = "application/merge-patch+json"


class ApiError(Exception):
    """HTTP-level apiserver error; ``message`` carries the server's
    Status message so callers can string-match the optimistic-lock
    conflict exactly like the reference does (allocate.go:140)."""

    def __init__(self, status_code: int, message: str, reason: str = ""):
        self.status_code = status_code
        self.message = message
        self.reason = reason
        super().__init__(message)

    def __str__(self) -> str:
        return self.message


class _Config:
    def __init__(self, host: str, port: int, token: Optional[str] = None,
                 ca_file: Optional[str] = None, cert_file: Optional[str] = None,
                 key_file: Optional[str] = None, insecure: bool = False,
                 scheme: str = "https"):
        self.host, self.port, self.scheme = host, port, scheme
        self.token, self.ca_file = token, ca_file
        self.cert_file, self.key_file = cert_file, key_file
        self.insecure = insecure


def _in_cluster_config() -> _Config:
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise RuntimeError("not running in cluster (no KUBERNETES_SERVICE_HOST)")
    token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
    ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
    with open(token_path) as f:
        token = f.read().strip()
    return _Config(host=host, port=int(port), token=token,
                   ca_file=ca_path if os.path.exists(ca_path) else None,
                   insecure=not os.path.exists(ca_path))


def _materialize(data_b64: Optional[str], path: Optional[str]) -> Optional[str]:
    """kubeconfig carries certs inline (…-data) or as paths."""
    if path:
        return path
    if data_b64:
        f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
        f.write(base64.b64decode(data_b64))
        f.close()
        return f.name
    return None


def _kubeconfig_config(path: str) -> _Config:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f)
    ctx_name = cfg.get("current-context")
    ctx = next(c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name)
    cluster = next(c["cluster"] for c in cfg.get("clusters", []) if c["name"] == ctx["cluster"])
    user = next(u["user"] for u in cfg.get("users", []) if u["name"] == ctx["user"])
    u = urllib.parse.urlparse(cluster["server"])
    return _Config(
        host=u.hostname, port=u.port or (443 if u.scheme == "https" else 80),
        scheme=u.scheme,
        token=user.get("token"),
        ca_file=_materialize(cluster.get("certificate-authority-data"),
                             cluster.get("certificate-authority")),
        cert_file=_materialize(user.get("client-certificate-data"),
                               user.get("client-certificate")),
        key_file=_materialize(user.get("client-key-data"), user.get("client-key")),
        insecure=bool(cluster.get("insecure-skip-tls-verify")),
    )


def load_config(kubeconfig: Optional[str] = None) -> _Config:
    """$KUBECONFIG file if it exists, else in-cluster — the reference's
    resolution order (podmanager.go:33-48)."""
    path = kubeconfig or os.environ.get("KUBECONFIG", "")
    if path and os.path.exists(path):
        return _kubeconfig_config(path)
    return _in_cluster_config()


class KubeClient:
    """The apiserver verbs the daemon + CLIs use."""

    def __init__(self, config: Optional[_Config] = None, timeout: float = 30.0):
        self._cfg = config or load_config()
        self._timeout = timeout
        # Chaos seam (tpushare.chaos): TPUSHARE_CHAOS arming
        # k8s.apiserver makes every request raise a connection-shaped
        # InjectedUnavailable or stall — the apiserver flake the
        # watch/retry paths must converge through (the harness twin of
        # tests/test_apiserver_flake.py's stateful simulator). Unarmed
        # (the default), this is the shared no-op.
        self._fault = fault_point("k8s.apiserver")

    # -- transport ---------------------------------------------------------
    def _conn(self, timeout: Optional[float] = None) -> http.client.HTTPConnection:
        c = self._cfg
        timeout = self._timeout if timeout is None else timeout
        if c.scheme == "http":
            return http.client.HTTPConnection(c.host, c.port, timeout=timeout)
        if c.insecure and not c.ca_file:
            ctx = ssl._create_unverified_context()
        else:
            ctx = ssl.create_default_context(cafile=c.ca_file)
        if c.cert_file:
            ctx.load_cert_chain(c.cert_file, c.key_file)
        return http.client.HTTPSConnection(c.host, c.port, context=ctx,
                                           timeout=timeout)

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        headers = {"Accept": "application/json"}
        if self._cfg.token:
            headers["Authorization"] = f"Bearer {self._cfg.token}"
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    @staticmethod
    def _raise_for_status(status: int, data: bytes) -> None:
        if status < 400:
            return
        msg, reason = data.decode(errors="replace"), ""
        try:
            st = json.loads(data)
            msg, reason = st.get("message", msg), st.get("reason", "")
        except (ValueError, AttributeError):
            pass
        raise ApiError(status, msg, reason)

    def _request(self, method: str, path: str, query: Optional[Dict[str, str]] = None,
                 body: Optional[bytes] = None, content_type: Optional[str] = None) -> Any:
        if query:
            path = path + "?" + urllib.parse.urlencode(query)
        self._fault()
        conn = self._conn()
        try:
            conn.request(method, path, body=body,
                         headers=self._headers(content_type))
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        self._raise_for_status(resp.status, data)
        return json.loads(data) if data else None

    # -- nodes -------------------------------------------------------------
    def get_node(self, name: str) -> Node:
        return Node(self._request("GET", f"/api/v1/nodes/{name}"))

    def patch_node(self, name: str, patch: Dict[str, Any]) -> Node:
        """Strategic-merge patch of the node object itself (metadata —
        e.g. the topology annotation; status goes via patch_node_status)."""
        body = json.dumps(patch).encode()
        return Node(self._request("PATCH", f"/api/v1/nodes/{name}",
                                  body=body, content_type=STRATEGIC_MERGE))

    def patch_node_status(self, name: str, patch: Dict[str, Any]) -> Node:
        """Strategic-merge patch against the node's status subresource.

        The reference builds a two-way merge patch of whole node objects
        (podmanager.go:77-158) because it diffs arbitrary old/new nodes;
        tpushare only ever *adds capacity entries*, so a direct additive
        strategic-merge patch is wire-equivalent and far simpler."""
        body = json.dumps(patch).encode()
        try:
            return Node(self._request("PATCH", f"/api/v1/nodes/{name}/status",
                                      body=body, content_type=STRATEGIC_MERGE))
        except ApiError as e:
            if e.status_code in (404, 405):
                # apiservers without the status subresource path
                return Node(self._request("PATCH", f"/api/v1/nodes/{name}",
                                          body=body, content_type=STRATEGIC_MERGE))
            raise

    # -- pods --------------------------------------------------------------
    def list_pods(self, namespace: Optional[str] = None,
                  field_selector: Optional[str] = None) -> List[Pod]:
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        query = {"fieldSelector": field_selector} if field_selector else None
        out = self._request("GET", path, query=query)
        return [Pod(item) for item in out.get("items", [])]

    def list_pods_with_version(self, namespace: Optional[str] = None,
                               field_selector: Optional[str] = None
                               ) -> "tuple[List[Pod], str]":
        """list_pods plus the list's resourceVersion — the watch
        bookmark a subsequent watch_pods() resumes from."""
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        query = {"fieldSelector": field_selector} if field_selector else None
        out = self._request("GET", path, query=query)
        rv = str((out.get("metadata") or {}).get("resourceVersion", ""))
        return [Pod(item) for item in out.get("items", [])], rv

    def watch_pods(self, resource_version: str = "",
                   namespace: Optional[str] = None,
                   field_selector: Optional[str] = None,
                   timeout_s: int = 60):
        """Generator of (event_type, Pod) from a chunked watch stream —
        the watch verb the reference's client-go informers use and the
        polling client previously lacked. Yields until the server ends
        the stream (apiservers close at ~timeoutSeconds; the caller
        re-lists and re-watches, informer-style). ERROR events raise
        ApiError (410 Gone => the caller's resourceVersion expired and
        it must re-list)."""
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        query = {"watch": "true", "timeoutSeconds": str(timeout_s),
                 "allowWatchBookmarks": "true"}
        if resource_version:
            query["resourceVersion"] = resource_version
        if field_selector:
            query["fieldSelector"] = field_selector
        # Socket read timeout must outlive the requested watch window —
        # with the default 30s request timeout an idle 60s watch would
        # die on TimeoutError and degrade the cache to LIST polling.
        self._fault()           # chaos: watch opens hit the seam too
        conn = self._conn(timeout=timeout_s + 30)
        try:
            conn.request("GET", path + "?" + urllib.parse.urlencode(query),
                         headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                self._raise_for_status(resp.status, resp.read())
            while True:
                line = resp.readline()      # chunked-decoding reader
                if not line:
                    return                  # server closed the window
                line = line.strip()
                if not line:
                    continue
                evt = json.loads(line)
                etype = evt.get("type", "")
                obj = evt.get("object") or {}
                if etype == "ERROR":
                    raise ApiError(int(obj.get("code", 500)),
                                   obj.get("message", "watch error"),
                                   obj.get("reason", ""))
                yield etype, Pod(obj)
        finally:
            conn.close()

    def get_pod(self, namespace: str, name: str) -> Pod:
        return Pod(self._request("GET", f"/api/v1/namespaces/{namespace}/pods/{name}"))

    def patch_pod(self, namespace: str, name: str, patch: Dict[str, Any]) -> Pod:
        """Strategic-merge patch (the verb Allocate uses to flip
        ASSIGNED, reference allocate.go:136-137)."""
        body = json.dumps(patch).encode()
        return Pod(self._request("PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
                                 body=body, content_type=STRATEGIC_MERGE))

    def bind_pod(self, namespace: str, name: str, node: str,
                 uid: Optional[str] = None) -> None:
        """POST a v1 Binding — the scheduler-extender bind verb."""
        binding = {
            "apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace,
                         **({"uid": uid} if uid else {})},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        self._request("POST",
                      f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
                      body=json.dumps(binding).encode(),
                      content_type="application/json")

    def list_nodes(self) -> List[Node]:
        out = self._request("GET", "/api/v1/nodes")
        return [Node(item) for item in out.get("items", [])]

    # -- events ------------------------------------------------------------
    def create_event(self, namespace: str, event: Dict[str, Any]) -> None:
        """POST a core/v1 Event (the verb the reference's RBAC grants
        but never uses, device-plugin-rbac.yaml:17-23)."""
        self._request("POST", f"/api/v1/namespaces/{namespace}/events",
                      body=json.dumps(event).encode(),
                      content_type="application/json")

    # -- leases (coordination.k8s.io/v1, leader election) ------------------
    _LEASE_BASE = "/apis/coordination.k8s.io/v1/namespaces"

    def get_lease(self, namespace: str, name: str) -> Dict[str, Any]:
        return self._request(
            "GET", f"{self._LEASE_BASE}/{namespace}/leases/{name}")

    def create_lease(self, namespace: str,
                     lease: Dict[str, Any]) -> Dict[str, Any]:
        return self._request(
            "POST", f"{self._LEASE_BASE}/{namespace}/leases",
            body=json.dumps(lease).encode(),
            content_type="application/json")

    def update_lease(self, namespace: str, name: str,
                     lease: Dict[str, Any]) -> Dict[str, Any]:
        """PUT with the lease's resourceVersion — the apiserver rejects
        stale writes with 409, which is the election's mutual
        exclusion."""
        return self._request(
            "PUT", f"{self._LEASE_BASE}/{namespace}/leases/{name}",
            body=json.dumps(lease).encode(),
            content_type="application/json")
