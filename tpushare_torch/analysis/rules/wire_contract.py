"""WC: wire-contract rules (whole tree).

WC301 — a wire-contract string literal (env var, annotation key,
resource name, the card selector ``NVIDIA_VISIBLE_DEVICES`` the port's
Allocate injects) anywhere but ``plugin/const.py``. The kubelet/extender
contract lives in exactly one module so a renamed annotation can't
half-migrate; a raw ``"TPU_VISIBLE_CHIPS"`` elsewhere is drift waiting
to ship. Docstrings and comments may name the strings
freely — documentation is not wire traffic.

WC302 — a field access or constructor kwarg on a ``deviceplugin``
message that does not exist in ``api.proto``. The proto is the
bit-compatibility surface with any v1beta1 kubelet; the hand-written
rpc plumbing makes a typo'd field a silent wire bug instead of an
AttributeError, so the proto file itself is the checkable truth (the
port keeps its own copy, ``deviceplugin/api.proto``).

WC303–WC305 — the HTTP serving plane, on top of the wire index
(``analysis/wire.py``): consumed-key-never-produced, endpoint drift
(path/method/status vs the handler, incl. the 503-means-retry
contract), and null-vs-zero contract violations. All three only fire
on facts the extractor resolved to CLOSED shapes — unknowns silence
the rules, they never invent findings.
"""

from __future__ import annotations

import ast
import os
import re
import types
from typing import Dict, Iterator, Optional, Set

from tpushare_torch.analysis import wire
from tpushare_torch.analysis.config import parse_proto_messages
from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted

WIRE_PATTERNS = [re.compile(p) for p in (
    r"^NVIDIA_VISIBLE_DEVICES$",
    r"^TPU_VISIBLE_(CHIPS|DEVICES)$",
    r"^TPU_(PROCESS_BOUNDS|CHIPS_PER_PROCESS_BOUNDS)$",
    r"^ALIYUN_COM_[TG]PU_[A-Z_]+$",
    r"^aliyun\.com/[tg]pu-[a-z-]+$",
    r"^aliyun\.accelerator/[a-z_]+$",
    r"^scheduler\.framework\.[tg]pushare\.allocation$",
    r"^c[tg]pu\.disable\.isolation$",
    r"^TPUSHARE_(HBM_LIMIT_BYTES|HBM_ENFORCE|COORDINATOR|NUM_PROCESSES"
    r"|PROCESS_ID)$",
    r"^CTPU_DISABLE$",
    r"^aliyuntpushare\.sock$",
)]

#: protobuf runtime API that is legal on any message/repeated field
PROTO_RUNTIME_ATTRS = {"add", "append", "extend", "CopyFrom", "MergeFrom",
                       "SerializeToString", "ParseFromString", "HasField",
                       "ClearField", "WhichOneof", "ListFields", "Clear",
                       "items", "keys", "values", "get", "update", "sort"}


def _is_wire_literal(value: str) -> bool:
    return any(p.match(value) for p in WIRE_PATTERNS)


@register
class WireLiteralOutsideConst(Rule):
    id = "WC301"
    name = "wire-literal-outside-const"
    family = "wire-contract"
    description = ("wire-contract string literal outside plugin/const.py "
                   "(env var / annotation / resource name)")
    paths = ()  # whole tree

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        allowed = {
            getattr(ctx.config, "const_module",
                    "tpushare_torch/plugin/const.py"),
            getattr(ctx.config, "deviceplugin_module",
                    "tpushare_torch/deviceplugin/__init__.py"),
        }
        if ctx.relpath in allowed:
            return
        docstrings = ctx.docstring_nodes()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Constant):
                continue
            if not isinstance(node.value, str) or id(node) in docstrings:
                continue
            if _is_wire_literal(node.value):
                yield ctx.finding(
                    self.id, node,
                    f"wire-contract literal {node.value!r} belongs in "
                    f"plugin/const.py; import the named constant instead")


@register
class ProtoFieldDrift(Rule):
    id = "WC302"
    name = "proto-field-drift"
    family = "wire-contract"
    description = ("field access/kwarg on a deviceplugin message that "
                   "api.proto does not define")
    paths = ()  # wherever pb messages are touched

    def __init__(self):
        self._messages: Optional[Dict[str, Set[str]]] = None
        self._proto_path: Optional[str] = None

    def _load_messages(self, ctx: FileContext) -> Dict[str, Set[str]]:
        proto_rel = getattr(ctx.config, "proto",
                            "tpushare_torch/deviceplugin/api.proto")
        root = getattr(ctx.config, "root", ".")
        path = (proto_rel if os.path.isabs(proto_rel)
                else os.path.join(root, proto_rel))
        if self._messages is None or self._proto_path != path:
            try:
                with open(path, encoding="utf-8") as f:
                    self._messages = parse_proto_messages(f.read())
            except OSError:
                self._messages = {}
            self._proto_path = path
        return self._messages

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        messages = self._load_messages(ctx)
        if not messages:
            return
        aliases = self._pb_aliases(ctx)
        if not aliases:
            return
        # var name -> message type, per assignment from pb.Msg(...)
        var_types: Dict[str, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                msg = self._message_of(node.value.func, aliases)
                if msg is not None and msg in messages:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            var_types[t.id] = msg
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                msg = self._message_of(node.func, aliases)
                if msg is not None:
                    if msg not in messages:
                        if msg[:1].isupper():
                            yield ctx.finding(
                                self.id, node,
                                f"message {msg!r} does not exist in "
                                f"api.proto")
                        continue
                    for kw in node.keywords:
                        if kw.arg and kw.arg not in messages[msg]:
                            yield ctx.finding(
                                self.id, kw.value,
                                f"field {kw.arg!r} does not exist on proto "
                                f"message {msg} (api.proto)")
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id in var_types):
                msg = var_types[node.value.id]
                field = node.attr
                if (field not in messages[msg]
                        and field not in PROTO_RUNTIME_ATTRS):
                    yield ctx.finding(
                        self.id, node,
                        f"field {field!r} does not exist on proto message "
                        f"{msg} (api.proto)")

    def _pb_aliases(self, ctx: FileContext) -> Set[str]:
        configured = set(getattr(ctx.config, "pb_aliases", ("pb",)))
        found: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module and "deviceplugin" in node.module:
                    for alias in node.names:
                        if alias.name in configured or (
                                alias.asname or alias.name) in configured:
                            found.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    leaf = (alias.asname
                            or alias.name.rsplit(".", 1)[-1])
                    if ("deviceplugin" in alias.name
                            and leaf in configured):
                        found.add(leaf)
        return found

    @staticmethod
    def _message_of(func: ast.AST, aliases: Set[str]) -> Optional[str]:
        """``pb.MessageName`` -> ``MessageName`` when pb is an alias."""
        name = dotted(func)
        if not name or "." not in name:
            return None
        base, leaf = name.rsplit(".", 1)
        if base in aliases:
            return leaf
        return None


def _site(line: int, col: int):
    """A finding anchor for a wire-index site (the index stores
    line/col, not AST nodes — ``ctx.finding`` only reads these two)."""
    return types.SimpleNamespace(lineno=line, col_offset=col)


@register
class ConsumedKeyNeverProduced(Rule):
    id = "WC303"
    name = "consumed-key-never-produced"
    family = "wire-contract"
    description = ("client reads a response key no matching handler "
                   "writes (silently degrades to None downstream)")
    paths = ()  # consumption sites only exist in wire consumer modules

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        wi = wire.index_for(ctx)
        for c in wi.consumptions:
            if c.relpath != ctx.relpath:
                continue
            eps = wi.endpoints_for(c.method, c.path)
            if not eps:
                continue                 # WC304 owns missing endpoints
            if all(e.shape.closed_missing(c.keypath) for e in eps):
                keypath = ".".join(c.keypath)
                yield ctx.finding(
                    self.id, _site(c.line, c.col),
                    f"key {keypath!r} read from {c.method} {c.path} is "
                    f"never written by any matching handler — "
                    f".get() returns None and downstream logic is "
                    f"silently neutralized")


@register
class EndpointDrift(Rule):
    id = "WC304"
    name = "endpoint-drift"
    family = "wire-contract"
    description = ("client path/method/expected-status set disagrees "
                   "with every matching handler (incl. the 503-retry "
                   "contract)")
    paths = ()  # client call sites only exist in wire consumer modules

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        wi = wire.index_for(ctx)
        if not wi.endpoints:
            return                       # no servers in view: no truth
        for cl in wi.clients:
            if cl.relpath != ctx.relpath:
                continue
            any_path = wi.any_path(cl.path, cl.prefix)
            if not any_path:
                yield ctx.finding(
                    self.id, _site(cl.line, cl.col),
                    f"no handler serves {cl.path!r} (client sends "
                    f"{cl.method})")
                continue
            eps = wi.endpoints_for(cl.method, cl.path, cl.prefix)
            if not eps:
                methods = sorted({e.method for e in any_path})
                yield ctx.finding(
                    self.id, _site(cl.line, cl.col),
                    f"{cl.path!r} is served, but not for {cl.method} "
                    f"(handlers accept {', '.join(methods)})")
                continue
            if cl.status_unknown or any(e.dynamic_status for e in eps):
                continue                 # status set is a lower bound
            union: Set[int] = set()
            for e in eps:
                union |= e.statuses
            extra = sorted(cl.expected - union)
            if extra and union:
                yield ctx.finding(
                    self.id, _site(cl.line, cl.col),
                    f"client treats status(es) {extra} from {cl.method} "
                    f"{cl.path} as expected, but the handler only emits "
                    f"{sorted(union)} — dead branch or missed contract")


@register
class NullVsZeroViolation(Rule):
    id = "WC305"
    name = "null-vs-zero-violation"
    family = "wire-contract"
    description = ("producer writes constant 0/False for a /stats key "
                   "whose contract requires None when the subsystem is "
                   "absent")
    # the serving plane owns the null-not-zero contract; test payloads
    # and demos may fake zeros freely
    paths = ("tpushare_torch/",)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node, key in wire.null_zero_violations(ctx.tree):
            yield ctx.finding(
                self.id, node,
                f"{key!r} is under the null-not-zero contract "
                f"(wire.NULL_NOT_ZERO_KEYS): absence must serialize as "
                f"None, not {ast.unparse(node)} — a constant zero "
                f"reads as 'present and exhausted' to every consumer")
