"""Prometheus-format metrics and the health endpoint: the port's copy of
``tpushare/plugin/metrics.py`` (same metric names, so one dashboard
reads both plugins).
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple


class Registry:
    """Thread-safe counters, gauges, and a summary (sum+count)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._help: Dict[str, Tuple[str, str]] = {}  # name -> (type, help)
        self.ready = False                           # /healthz state

    def describe(self, name: str, type_: str, help_: str) -> None:
        self._help[name] = (type_, help_)

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, labels: Optional[Dict[str, str]] = None,
            value: float = 1.0) -> None:
        with self._lock:
            k = self._key(name, labels)
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, seconds: float) -> None:
        """Summary family <name>: emits <name>_sum / <name>_count
        (name the family with its unit, e.g. x_seconds)."""
        self.inc(name + "_sum", value=seconds)
        self.inc(name + "_count")

    def render(self) -> str:
        with self._lock:
            lines = []
            series = [("counter", self._counters), ("gauge", self._gauges)]
            seen_help = set()
            for default_type, table in series:
                for (name, labels), value in sorted(table.items()):
                    base = name
                    for suffix in ("_sum", "_count"):
                        if name.endswith(suffix):
                            base = name[: -len(suffix)]
                    if base in self._help and base not in seen_help:
                        t, h = self._help[base]
                        lines.append(f"# HELP {base} {h}")
                        lines.append(f"# TYPE {base} {t}")
                        seen_help.add(base)
                    label_s = ",".join(f'{k}="{v}"' for k, v in labels)
                    label_s = "{" + label_s + "}" if label_s else ""
                    fv = repr(float(value)) if value != int(value) \
                        else str(int(value))
                    lines.append(f"{name}{label_s} {fv}")
            return "\n".join(lines) + "\n"


# The daemon's shared registry (import-site singleton, like logging).
REGISTRY = Registry()
REGISTRY.describe("tpushare_allocations_total", "counter",
                  "Allocate RPC outcomes by result")
REGISTRY.describe("tpushare_allocate_seconds", "summary",
                  "Allocate RPC wall time")
REGISTRY.describe("tpushare_mem_units_advertised", "gauge",
                  "Fake memory-unit devices advertised to the kubelet")
REGISTRY.describe("tpushare_chips_healthy", "gauge",
                  "Chips currently reported healthy")
REGISTRY.describe("tpushare_chips_total", "gauge",
                  "Chips discovered on this host")
REGISTRY.describe("tpushare_plugin_registrations_total", "counter",
                  "Successful kubelet registrations (first serve plus "
                  "re-registrations after kubelet restarts / SIGHUP)")


def make_metrics_server(registry: Registry = REGISTRY,
                        host: str = "0.0.0.0",
                        port: int = 9102) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            pass

        def do_GET(self):
            if self.path == "/metrics":
                body = registry.render().encode()
                ctype = "text/plain; version=0.0.4"
                code = 200
            elif self.path == "/healthz":
                body = (b"ok" if registry.ready else b"not registered")
                ctype = "text/plain"
                code = 200 if registry.ready else 503
            else:
                self.send_error(404)
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, name="metrics",
                         daemon=True)
    t.start()
    return server


class Timer:
    """with REGISTRY-observing timer: ``with Timer(reg, 'x'): ...``"""

    def __init__(self, registry: Registry, name: str):
        self.registry = registry
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.observe(self.name, time.perf_counter() - self._t0)
        return False
