"""Analyzer configuration for the port's gate.

The JAX package's gate reads ``[tool.tpushare-analysis]`` from
pyproject.toml; that section configures the JAX tree and the port adds
none of its own, so the port's defaults live here, in one dataclass:
the paths the gate sweeps, the excluded generated module, the baseline,
the const and proto modules, and the serving modules whose handlers and
clients make up the HTTP wire surface. ``load_config`` only anchors
them at the repo root.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Sequence


@dataclasses.dataclass
class AnalysisConfig:
    #: repo root (directory holding pyproject.toml); anchors relpaths
    root: str = "."
    #: default analysis targets, repo-relative
    paths: Sequence[str] = ("tpushare_torch", "chip_smoke.py")
    #: path suffixes to skip (generated code can't be held to hand-written rules)
    exclude: Sequence[str] = ("tpushare_torch/deviceplugin/api_pb2.py",)
    #: ratchet file, repo-relative
    baseline: str = "tpushare_torch/analysis/baseline.json"
    #: the one module allowed to define wire-contract literals
    const_module: str = "tpushare_torch/plugin/const.py"
    #: ...and the module defining the kubelet socket-path constants
    deviceplugin_module: str = "tpushare_torch/deviceplugin/__init__.py"
    #: proto source of truth for WC302
    proto: str = "tpushare_torch/deviceplugin/api.proto"
    #: local names the deviceplugin message module is imported under
    pb_aliases: Sequence[str] = ("pb", "api_pb2")
    #: method names treated as RPC/HTTP handler entry points (CC rules)
    handler_methods: Sequence[str] = (
        # deviceplugin/v1beta1 servicer surface
        "GetDevicePluginOptions", "ListAndWatch", "GetPreferredAllocation",
        "Allocate", "PreStartContainer", "Register",
        # stdlib http.server handlers
        "do_GET", "do_POST", "do_PUT", "do_DELETE",
        # scheduler-extender verbs
        "filter", "prioritize", "bind",
    )
    #: method names treated as thread entry points even without a
    #: visible threading.Thread(target=...) in the same class
    thread_entry_methods: Sequence[str] = ("run", "run_forever")
    #: thread entry method name -> canonical role for the ownership
    #: layer (threads.py). Unlisted targets get their own name
    #: (stripped of underscores) as an auto-role.
    thread_role_map: Sequence[Sequence[str]] = (
        ("_loop", "engine"), ("_loop_once", "engine"),
        ("_tick", "engine"),
        ("_supervise", "supervisor"),
        ("_poll_loop", "poll"),
        ("run", "thread"), ("run_forever", "thread"),
        ("serve_forever", "handler"),
    )

    #: modules whose http.server handlers define the serving wire
    #: surface (the wire layer re-parses these for nested Handler
    #: classes, which the top-level fact extraction cannot see)
    wire_server_modules: Sequence[str] = (
        "tpushare_torch/cli/serve.py", "tpushare_torch/router/daemon.py")
    #: repo-relative prefixes holding wire CLIENTS (the consumption
    #: side the WC30x rules resolve `.get()` chains in)
    wire_consumer_modules: Sequence[str] = (
        "tpushare_torch/router/", "tpushare_torch/cli/serve.py",
        "tpushare_torch/durable/smoke.py", "tpushare_torch/chaos/smoke.py")
    #: names of JSON-fetch helpers whose literal path argument roots a
    #: consumption chain; ``name:N`` marks a helper returning a tuple
    #: whose element N is the payload
    wire_fetch_helpers: Sequence[str] = ("_fetch_json", "_get_json:1")

    def resolve(self, relpath: str) -> str:
        return os.path.join(self.root, relpath)


def find_root(start: Optional[str] = None) -> str:
    """Nearest ancestor holding pyproject.toml, else ``start``."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isfile(os.path.join(cur, "pyproject.toml")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start or os.getcwd())
        cur = parent


def load_config(root: Optional[str] = None) -> AnalysisConfig:
    """The port's defaults, anchored at ``root`` (default: the nearest
    ancestor holding pyproject.toml)."""
    return AnalysisConfig(root=root or find_root())


def parse_proto_messages(proto_text: str) -> Dict[str, set]:
    """message name -> set of field names, from the .proto source.

    Line-oriented: ``message X {`` opens a scope; ``type name = N;``
    (incl. ``repeated`` and ``map<k,v>``) declares a field. Good for
    the flat v1beta1 proto this repo pins; nested messages would need a
    real parser and would fail loudly here (unknown message)."""
    messages: Dict[str, set] = {}
    current: Optional[str] = None
    field_re = re.compile(
        r"^\s*(?:repeated\s+)?(?:map\s*<[^>]+>|[\w.]+)\s+(\w+)\s*=\s*\d+\s*;")
    for raw in proto_text.splitlines():
        line = raw.split("//", 1)[0]
        m = re.match(r"^\s*message\s+(\w+)\s*\{", line)
        if m:
            current = m.group(1)
            messages[current] = set()
            continue
        if current is None:
            continue
        if re.match(r"^\s*\}", line):
            current = None
            continue
        fm = field_re.match(line)
        if fm:
            messages[current].add(fm.group(1))
    return messages
