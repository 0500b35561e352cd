"""Kubelet read-only client (``GET https://<node>:10250/pods/``): the
port's copy of ``tpushare/k8s/kubelet.py``, the node-local fast path
``PodManager`` prefers over an apiserver list.
"""

from __future__ import annotations

import http.client
import json
import ssl
from typing import List, Optional

from .types import Pod


class KubeletClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 10250,
                 token: Optional[str] = None, ca_file: Optional[str] = None,
                 cert_file: Optional[str] = None, key_file: Optional[str] = None,
                 timeout: float = 10.0, scheme: str = "https"):
        self.host, self.port, self.scheme = host, port, scheme
        self._token, self._ca = token, ca_file
        self._cert, self._key = cert_file, key_file
        self._timeout = timeout

    def _conn(self) -> http.client.HTTPConnection:
        if self.scheme == "http":  # test servers
            return http.client.HTTPConnection(self.host, self.port, timeout=self._timeout)
        if self._ca:
            ctx = ssl.create_default_context(cafile=self._ca)
        else:
            ctx = ssl._create_unverified_context()  # reference: InsecureSkipVerify (client.go:68-70)
        if self._cert:
            ctx.load_cert_chain(self._cert, self._key)
        return http.client.HTTPSConnection(self.host, self.port, context=ctx,
                                           timeout=self._timeout)

    def get_node_running_pods(self) -> List[Pod]:
        """GET /pods/ and decode the v1.PodList (client.go:119-134)."""
        headers = {"Accept": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        conn = self._conn()
        try:
            conn.request("GET", "/pods/", headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        if resp.status >= 400:
            raise RuntimeError(
                f"kubelet /pods returned {resp.status}: {data[:200].decode(errors='replace')}")
        return [Pod(item) for item in json.loads(data).get("items", [])]
