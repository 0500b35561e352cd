"""Wire-contract extraction for the distributed serving plane.

The serving stack speaks JSON over HTTP between processes — engine
replicas (``cli/serve.py``), the router daemon (``router/daemon.py``),
and the harness clients — and every field crosses that boundary as a
``.get("key")`` against a dict some handler assembled many calls away.
Nothing type-checks that seam: a consumed key no producer writes
degrades to ``None`` and silently neutralizes whatever scoring read
it (an affinity salt or a shed anchor read under a key nobody
writes is exactly this class). This module makes the seam checkable:

- **producers**: walk each server module's nested
  ``BaseHTTPRequestHandler`` classes (invisible to the top-level
  callgraph extraction) — dispatch paths, methods, status codes, and
  response payloads, resolved through the callgraph's dict-shape
  summaries so multi-hop assembly lands (``/stats``'s ``host_tier``
  block is built in ``models/kvtier.py``, two calls away);
- **consumers**: resolve ``_fetch_json(rep, "/<path>")``-style roots
  and the downstream ``.get("key")``/``[...]`` chains, including
  sub-payload locals (``ht = s.get("host_tier")``), tuple-returning
  helpers, attribute re-binding (``rep.stats = stats``), and one-hop
  argument passing into same-module helpers;
- **registry**: the canonical per-endpoint schema (key, type,
  nullability, producing site, consuming sites).

The WC303/WC304/WC305 rules in ``rules/wire_contract.py`` run on top
of the index built here. Soundness stance: membership checks only
fire against CLOSED shapes (no unresolved spread, no dynamic keys) —
an unmodeled construct widens a shape to "unknown" and silences the
rules rather than inventing findings. Known limits: SSE event
payloads, unresolvable in-process receivers, non-literal URLs.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from tpushare_torch.analysis import callgraph as cg

#: ``/stats`` keys under the engine's null-not-zero contract (the
#: JAX engine's, which the port's /stats keeps): absence of the backing
#: subsystem must read as ``None``/null, never ``0``/``False`` — a
#: zero here turns "no pool exists" into "pool permanently exhausted"
#: for every consumer that scores on the value.
NULL_NOT_ZERO_KEYS = frozenset((
    "free_blocks", "reclaimable_blocks", "live_blocks",
    "pool_free_frac",
    "pipeline_flushes", "host_gap_ms", "tick_in_flight_ms",
    "degraded", "healthy_devices", "num_devices_configured",
    "mesh_shape", "reshard_ms",
    "journal", "journal_bytes", "journal_fsync_ms",
    "tenants", "tick_wedge_ms",
    "host_tier", "host_prefetch_errors",
    "num_processes", "process_index", "healthy_processes",
))

TABLE_BEGIN = ("<!-- WIRE TABLE BEGIN (generated from the wire "
               "registry; regenerate: python -m tpushare_torch.analysis "
               "--wire-table) -->")
TABLE_END = "<!-- WIRE TABLE END -->"

#: server relpath -> display name for the generated tables
_SERVER_TITLES = {
    "tpushare_torch/cli/serve.py": "Engine",
    "tpushare_torch/router/daemon.py": "Router",
}

# ---------------------------------------------------------------------------
# Resolved shapes (the post-linking view of callgraph.DictShape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResolvedKey:
    types: Set[str] = dataclasses.field(default_factory=set)
    nullable: bool = False
    conditional: bool = False
    site: Tuple[str, int] = ("", 0)        # (relpath, line)
    nested: Optional["ResolvedShape"] = None


@dataclasses.dataclass
class ResolvedShape:
    keys: Dict[str, ResolvedKey] = dataclasses.field(default_factory=dict)
    #: summary of comprehension-style dynamic entries, when present
    dynamic: Optional[ResolvedKey] = None
    #: True when some contribution could not be modeled — membership
    #: is unknown and the WC303 check must stay silent
    open: bool = False

    def closed_missing(self, keypath: Sequence[str]) -> bool:
        """True iff this CLOSED shape provably lacks ``keypath``."""
        shape: Optional[ResolvedShape] = self
        for seg in keypath:
            if shape is None:
                return False               # value shape unknown: benign
            if shape.open or shape.dynamic is not None:
                return False
            key = shape.keys.get(seg)
            if key is None:
                return True
            shape = key.nested
        return False


@dataclasses.dataclass
class Endpoint:
    server: str                  # handler module relpath
    method: str                  # "GET" / "POST"
    path: str
    prefix: bool                 # startswith dispatch
    line: int
    statuses: Set[int] = dataclasses.field(default_factory=set)
    #: some response status is a non-constant expression; when the
    #: module-level ``.status = <int>`` scan closed it, ``statuses``
    #: already holds the union and checks may proceed
    dynamic_status: bool = False
    sse: bool = False
    shape: ResolvedShape = dataclasses.field(default_factory=ResolvedShape)
    #: producer quals whose returned dicts ARE this payload (joins
    #: in-process ``engine.stats()``-style consumption back here)
    payload_quals: Set[str] = dataclasses.field(default_factory=set)

    def matches_path(self, path: str, client_prefix: bool = False) -> bool:
        if self.prefix:
            return path.startswith(self.path) or (
                client_prefix and self.path.startswith(path))
        if client_prefix:
            return self.path.startswith(path)
        return path == self.path


@dataclasses.dataclass
class ClientCall:
    relpath: str
    line: int
    col: int
    method: str
    path: str
    prefix: bool                 # only the leading literal is known
    expected: Set[int] = dataclasses.field(default_factory=set)
    #: don't check statuses (tuple-returning helper: caller branches
    #: on the status itself)
    status_unknown: bool = False


@dataclasses.dataclass
class Consumption:
    relpath: str
    line: int
    col: int
    method: str
    path: str
    keypath: Tuple[str, ...]


@dataclasses.dataclass
class WireIndex:
    endpoints: List[Endpoint] = dataclasses.field(default_factory=list)
    clients: List[ClientCall] = dataclasses.field(default_factory=list)
    consumptions: List[Consumption] = dataclasses.field(
        default_factory=list)

    def endpoints_for(self, method: str, path: str,
                      client_prefix: bool = False) -> List[Endpoint]:
        return [e for e in self.endpoints
                if e.method == method
                and e.matches_path(path, client_prefix)]

    def any_path(self, path: str, client_prefix: bool = False
                 ) -> List[Endpoint]:
        return [e for e in self.endpoints
                if e.matches_path(path, client_prefix)]


# ---------------------------------------------------------------------------
# Shape resolution through the linked project index
# ---------------------------------------------------------------------------

_TYPE_NAMES = {"int": "int", "float": "float", "bool": "bool",
               "str": "str", "number": "number", "list": "list",
               "dict": "dict", "NoneType": ""}


class _Resolver:
    def __init__(self, project: cg.ProjectIndex):
        self.project = project
        self._memo: Dict[str, Optional[ResolvedShape]] = {}

    def _class_of(self, facts: Optional[cg.FuncFacts]
                  ) -> Optional[cg.ClassFacts]:
        if facts is None or facts.class_name is None:
            return None
        return self.project.class_of(facts.relpath, facts.class_name)

    def func_shape(self, qual: str,
                   stack: Tuple[str, ...] = ()) -> Optional[ResolvedShape]:
        """The union of every dict shape ``qual`` returns, or None
        when it is not known to return a dict."""
        if qual in stack or len(stack) > 6:
            return None
        if qual in self._memo:
            return self._memo[qual]
        facts = self.project.functions.get(qual)
        if facts is None or not (facts.returned_dicts
                                 or facts.returned_self_calls):
            self._memo[qual] = None
            return None
        self._memo[qual] = None            # cycle guard during build
        cls = self._class_of(facts)
        parts = [self.shape(s, facts, cls, stack + (qual,))
                 for s in facts.returned_dicts]
        # ``return self._helper()``: the helper's shapes are this
        # method's (a locked accessor over an unlocked body)
        for call in facts.calls:
            if (call.line, call.col) in facts.returned_self_calls:
                for callee in call.resolved:
                    sub = self.func_shape(callee, stack + (qual,))
                    if sub is not None:
                        parts.append(sub)
        if not parts:
            return None
        merged = _merge_shapes(parts)
        self._memo[qual] = merged
        return merged

    def shape(self, dshape: cg.DictShape,
              facts: Optional[cg.FuncFacts],
              cls: Optional[cg.ClassFacts],
              stack: Tuple[str, ...] = ()) -> ResolvedShape:
        relpath = (facts.relpath if facts is not None
                   else (cls.relpath if cls is not None else ""))
        out = ResolvedShape(open=dshape.open)
        for kind, name in dshape.spreads:
            inner = None
            if kind == "selfattr" and cls is not None:
                src = cls.attr_dicts.get(name)
                if src is not None:
                    inner = self.shape(src, None, cls, stack)
            if inner is None:
                out.open = True
            else:
                for k, rk in inner.keys.items():
                    _merge_into(out, k, rk)
                out.open = out.open or inner.open
                if inner.dynamic is not None and out.dynamic is None:
                    out.dynamic = inner.dynamic
        for k, f in dshape.keys.items():
            _merge_into(out, k, self.fact(f, facts, cls, relpath, stack))
        if dshape.dynamic is not None:
            out.dynamic = self.fact(dshape.dynamic, facts, cls,
                                    relpath, stack)
        return out

    def fact(self, f: cg.DictKeyFact,
             facts: Optional[cg.FuncFacts],
             cls: Optional[cg.ClassFacts],
             relpath: str,
             stack: Tuple[str, ...] = ()) -> ResolvedKey:
        rk = ResolvedKey(nullable=f.nullable, conditional=f.conditional,
                         site=(relpath, f.line))
        for c in f.consts:
            tn = _TYPE_NAMES.get(type(c).__name__)
            if tn:
                rk.types.add(tn)
        if f.kind == "dict" and f.nested is not None:
            rk.types.add("dict")
            rk.nested = self.shape(f.nested, facts, cls, stack)
        elif f.kind == "call" and f.call_site is not None:
            quals: Tuple[str, ...] = ()
            if facts is not None:
                for call in facts.calls:
                    if (call.line, call.col) == f.call_site:
                        quals = call.resolved
                        break
            for qual in quals:
                callee = self.project.functions.get(qual)
                if callee is None:
                    continue
                if callee.returns_none:
                    rk.nullable = True
                sub = self.func_shape(qual, stack)
                if sub is not None:
                    rk.types.add("dict")
                    rk.nested = (sub if rk.nested is None
                                 else _merge_shapes([rk.nested, sub]))
        elif f.kind == "attr" and cls is not None:
            src = cls.attr_dicts.get(f.hint)
            if src is not None:
                rk.types.add("dict")
                rk.nested = self.shape(src, None, cls, stack)
            for tn in cls.attr_scalars.get(f.hint, ()):
                mapped = _TYPE_NAMES.get(tn)
                if mapped:
                    rk.types.add(mapped)
                elif tn == "NoneType":
                    rk.nullable = True
            if "NoneType" in cls.attr_scalars.get(f.hint, ()):
                rk.nullable = True
        elif f.kind == "other" and f.hint in _TYPE_NAMES:
            if _TYPE_NAMES[f.hint]:
                rk.types.add(_TYPE_NAMES[f.hint])
        return rk


def _merge_into(shape: ResolvedShape, key: str, rk: ResolvedKey) -> None:
    old = shape.keys.get(key)
    if old is None:
        shape.keys[key] = rk
        return
    old.types |= rk.types
    old.nullable = old.nullable or rk.nullable
    old.conditional = old.conditional and rk.conditional
    if old.nested is None:
        old.nested = rk.nested
    elif rk.nested is not None:
        old.nested = _merge_shapes([old.nested, rk.nested])


def _merge_shapes(parts: List[ResolvedShape]) -> ResolvedShape:
    """Union across alternative returns: a key absent from some
    alternative is conditional."""
    if len(parts) == 1:
        return parts[0]
    out = ResolvedShape()
    all_keys: Set[str] = set()
    for p in parts:
        all_keys |= set(p.keys)
        out.open = out.open or p.open
        if p.dynamic is not None and out.dynamic is None:
            out.dynamic = p.dynamic
    for k in all_keys:
        holders = [p.keys[k] for p in parts if k in p.keys]
        rk = holders[0]
        for h in holders[1:]:
            rk.types |= h.types
            rk.nullable = rk.nullable or h.nullable
            rk.conditional = rk.conditional and h.conditional
            if rk.nested is None:
                rk.nested = h.nested
        if len(holders) < len(parts):
            rk.conditional = True
        out.keys[k] = rk
    return out


# ---------------------------------------------------------------------------
# Producer side: nested HTTP handler extraction
# ---------------------------------------------------------------------------

_HANDLER_VERBS = {"do_GET": "GET", "do_POST": "POST",
                  "do_PUT": "PUT", "do_DELETE": "DELETE"}


def _path_test(test: ast.AST) -> Optional[Tuple[str, str]]:
    """Classify a dispatch test on ``self.path``: returns
    ``(literal, "eq"|"ne"|"prefix")`` or None."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and cg._dotted(test.left) == "self.path"
            and isinstance(test.comparators[0], ast.Constant)
            and isinstance(test.comparators[0].value, str)):
        lit = test.comparators[0].value
        if isinstance(test.ops[0], ast.Eq):
            return lit, "eq"
        if isinstance(test.ops[0], ast.NotEq):
            return lit, "ne"
        return None
    if (isinstance(test, ast.Call)
            and isinstance(test.func, ast.Attribute)
            and test.func.attr == "startswith"
            and cg._dotted(test.func.value) == "self.path"
            and test.args
            and isinstance(test.args[0], ast.Constant)
            and isinstance(test.args[0].value, str)):
        return test.args[0].value, "prefix"
    return None


def _status_consts(expr: ast.AST) -> Tuple[Set[int], bool]:
    """(constant statuses, dynamic?) of a response-status expression."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return {expr.value}, False
    if isinstance(expr, ast.IfExp):
        a, da = _status_consts(expr.body)
        b, db = _status_consts(expr.orelse)
        return a | b, da or db
    return set(), True


def _literal_path(expr: ast.AST) -> Optional[Tuple[str, bool]]:
    """(leading literal, prefix?) of a request-path expression."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        lit = expr.value.split("?", 1)[0]
        return (lit, False) if lit.startswith("/") else None
    if isinstance(expr, ast.JoinedStr) and expr.values:
        first = expr.values[0]
        if (isinstance(first, ast.Constant)
                and isinstance(first.value, str)
                and first.value.startswith("/")):
            return first.value.split("?", 1)[0], True
        return None
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _literal_path(expr.left)
        if left is not None:
            return left[0], True
        return None
    return None


class _HandlerExtractor:
    """Endpoints out of one server module: every nested class with a
    ``do_*`` verb, dispatch parsed from the if/elif chain on
    ``self.path``, payload calls resolved through the handler
    factory's parameter annotations (or a unique-method fallback over
    the classes the module defines/imports)."""

    def __init__(self, relpath: str, tree: ast.Module,
                 project: cg.ProjectIndex, resolver: _Resolver):
        self.relpath = relpath
        self.tree = tree
        self.project = project
        self.resolver = resolver
        self.mod = project.modules.get(relpath)
        self.status_pool = self._scan_status_consts(tree)

    @staticmethod
    def _scan_status_consts(tree: ast.Module) -> Set[int]:
        """Every integer constant assigned to a ``*status`` attribute
        anywhere in the module — closes dynamic response statuses
        (``self._json(req.status, ...)``) with the set of statuses the
        module can actually stamp."""
        out: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and t.attr.endswith("status")
                            and isinstance(node.value, ast.Constant)
                            and isinstance(node.value.value, int)):
                        out.add(node.value.value)
        return out

    def run(self) -> List[Endpoint]:
        out: List[Endpoint] = []
        # factory param annotations: class body -> {param: class name}
        factories: Dict[int, Dict[str, str]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                anns = {}
                for a in node.args.args:
                    if a.annotation is not None:
                        cands = cg._annotation_classes(a.annotation)
                        if len(cands) == 1:
                            anns[a.arg] = next(iter(cands))
                for child in ast.walk(node):
                    if isinstance(child, ast.ClassDef):
                        factories[id(child)] = anns
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            methods = {m.name: m for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if not any(v in methods for v in _HANDLER_VERBS):
                continue
            receivers = factories.get(id(node), {})
            for verb_meth, http_method in _HANDLER_VERBS.items():
                fn = methods.get(verb_meth)
                if fn is not None:
                    out.extend(self._dispatch(fn, http_method, methods,
                                              receivers))
        return out

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, fn: ast.AST, method: str,
                  methods: Dict[str, ast.AST],
                  receivers: Dict[str, str]) -> List[Endpoint]:
        out: List[Endpoint] = []
        self._dispatch_stmts(list(fn.body), method, methods, receivers,
                             None, out)
        return out

    def _dispatch_stmts(self, stmts: List[ast.stmt], method: str,
                        methods: Dict[str, ast.AST],
                        receivers: Dict[str, str],
                        current: Optional[Endpoint],
                        out: List[Endpoint]) -> None:
        i = 0
        while i < len(stmts):
            stmt = stmts[i]
            if isinstance(stmt, ast.If):
                pt = _path_test(stmt.test)
                if pt is not None:
                    lit, kind = pt
                    if kind == "ne":
                        # negative guard: the body is the catch-all
                        # sink; everything AFTER the If serves `lit`
                        ep = self._endpoint(method, lit, False,
                                            stmt.lineno)
                        self._responses(stmts[i + 1:], ep, methods,
                                        set(), receivers)
                        out.append(ep)
                        return
                    ep = self._endpoint(method, lit, kind == "prefix",
                                        stmt.lineno)
                    self._responses(stmt.body, ep, methods, set(),
                                    receivers)
                    out.append(ep)
                    self._dispatch_stmts(list(stmt.orelse), method,
                                         methods, receivers, current,
                                         out)
                    i += 1
                    continue
            if current is not None:
                self._responses([stmt], current, methods, set(),
                                receivers)
            i += 1

    def _endpoint(self, method: str, path: str, prefix: bool,
                  line: int) -> Endpoint:
        return Endpoint(server=self.relpath, method=method, path=path,
                        prefix=prefix, line=line)

    # -- response collection ----------------------------------------------
    def _responses(self, stmts: List[ast.stmt], ep: Endpoint,
                   methods: Dict[str, ast.AST],
                   visited: Set[str],
                   receivers: Optional[Dict[str, str]] = None,
                   env: Optional[Dict[str, ast.AST]] = None) -> None:
        if receivers is None:
            receivers = {}
        if env is None:
            env = {}
        for stmt in stmts:
            for node in self._walk_stmt(stmt):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = node.targets[0]
                    if isinstance(t, ast.Name):
                        env[t.id] = node.value
                if not isinstance(node, ast.Call):
                    continue
                fname = cg._dotted(node.func)
                if fname == "self._json" and len(node.args) >= 2:
                    sts, dyn = _status_consts(node.args[0])
                    ep.statuses |= sts
                    if dyn:
                        ep.dynamic_status = True
                        ep.statuses |= self.status_pool
                    self._payload(node.args[1], ep, receivers or {},
                                  env)
                elif (fname == "self.send_response" and node.args
                      and isinstance(node.args[0], ast.Constant)):
                    ep.statuses.add(node.args[0].value)
                    ep.sse = True
                    ep.shape.open = True
                elif (fname and fname.startswith("self._")
                      and fname.count(".") == 1):
                    meth = fname.split(".", 1)[1]
                    if meth in methods and meth not in visited:
                        if meth.lstrip("_").startswith("stream"):
                            ep.sse = True
                            ep.statuses.add(200)
                            ep.shape.open = True
                            continue
                        visited.add(meth)
                        self._responses(list(methods[meth].body), ep,
                                        methods, visited,
                                        receivers, env)

    @staticmethod
    def _walk_stmt(stmt: ast.stmt) -> Iterator[ast.AST]:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node

    def _payload(self, expr: ast.AST, ep: Endpoint,
                 receivers: Dict[str, str],
                 env: Dict[str, ast.AST]) -> None:
        if isinstance(expr, ast.Name) and expr.id in env:
            expr = env[expr.id]
        if isinstance(expr, (ast.Dict, ast.DictComp)):
            dshape = cg._shape_of(expr, {}, {})
            if dshape is not None:
                merged = _merge_shapes(
                    [ep.shape, self.resolver.shape(dshape, None, None)]
                ) if (ep.shape.keys or ep.shape.open) else \
                    self.resolver.shape(dshape, None, None)
                # literal keys land in THIS module
                for k in merged.keys.values():
                    if not k.site[0]:
                        k.site = (self.relpath, k.site[1])
                ep.shape = merged
            return
        if isinstance(expr, ast.Call):
            qual = self._resolve_payload_call(expr, receivers)
            if qual is not None:
                ep.payload_quals.add(qual)
                sub = self.resolver.func_shape(qual)
                if sub is not None:
                    ep.shape = (_merge_shapes([ep.shape, sub])
                                if (ep.shape.keys or ep.shape.open)
                                else sub)
                    return
        ep.shape.open = True

    def _resolve_payload_call(self, call: ast.Call,
                              receivers: Dict[str, str]
                              ) -> Optional[str]:
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)):
            return None
        rname, meth = func.value.id, func.attr
        cls_name = receivers.get(rname)
        cands: List[cg.ClassFacts] = []
        if cls_name is not None:
            cands = self.project._class_by_name(cls_name, self.relpath)
        elif self.mod is not None:
            # unannotated factory param: unique method name among the
            # classes this module defines or from-imports
            pool: List[cg.ClassFacts] = list(
                self.mod.classes.values())
            for local, (_, orig) in self.mod.from_imports.items():
                for c in self.project.classes_by_name.get(orig, ()):
                    pool.append(c)
            cands = [c for c in pool
                     if self.project._method_in_mro(c, meth)]
            if len(cands) != 1:
                return None
        for c in cands:
            found = self.project._method_in_mro(c, meth)
            if found:
                return found[0].qual
        return None


# ---------------------------------------------------------------------------
# Consumer side: fetch roots + .get() chains + client calls
# ---------------------------------------------------------------------------

def _parse_helpers(specs: Sequence[str]) -> Dict[str, Optional[int]]:
    """helper leaf name -> payload tuple index (None = payload is the
    return value itself)."""
    out: Dict[str, Optional[int]] = {}
    for spec in specs:
        if ":" in spec:
            name, idx = spec.split(":", 1)
            try:
                out[name] = int(idx)
            except ValueError:
                out[name] = None
        else:
            out[spec] = None
    return out


#: a consumption/client ref: (method, path, keypath prefix)
_Ref = Tuple[str, str, Tuple[str, ...]]


class _ConsumerExtractor:
    def __init__(self, relpath: str, tree: ast.Module,
                 project: cg.ProjectIndex,
                 helpers: Dict[str, Optional[int]],
                 payload_quals: Dict[str, Tuple[str, str]]):
        self.relpath = relpath
        self.tree = tree
        self.project = project
        self.helpers = helpers
        self.payload_quals = payload_quals
        self.mod = project.modules.get(relpath)
        self.consumptions: List[Consumption] = []
        self.clients: List[ClientCall] = []
        self._seen: Set[Tuple[int, int, Tuple[str, ...]]] = set()
        #: attr name -> ref, from ``X.attr = <payload local>`` stores
        self.attr_bindings: Dict[str, _Ref] = {}
        #: (qual, param) -> ref, one-hop propagation into same-module
        #: helpers
        self.param_roots: Dict[Tuple[str, str], _Ref] = {}
        #: status-predicate helpers: name -> int consts it accepts
        self.status_preds = self._scan_status_preds(tree)

    @staticmethod
    def _scan_status_preds(tree: ast.Module) -> Dict[str, Set[int]]:
        out: Dict[str, Set[int]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in node.args.args}
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Return)
                        and isinstance(sub.value, ast.Compare)
                        and len(sub.value.ops) == 1
                        and isinstance(sub.value.ops[0], ast.In)
                        and isinstance(sub.value.left, ast.Name)
                        and sub.value.left.id in params):
                    comp = sub.value.comparators[0]
                    if isinstance(comp, (ast.Tuple, ast.Set, ast.List)):
                        vals = {e.value for e in comp.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, int)}
                        if vals:
                            out[node.name] = vals
        return out

    def run(self) -> None:
        fns = self._functions()
        # two rounds: round 2 picks up attr bindings and param roots
        # discovered in round 1
        for _ in range(2):
            self.consumptions = []
            self._seen = set()
            self.clients = []
            for qual, fn in fns:
                self._function(qual, fn)

    def _functions(self) -> List[Tuple[Optional[str], ast.AST]]:
        out: List[Tuple[Optional[str], ast.AST]] = []
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((f"{self.relpath}::{node.name}", node))
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        out.append(
                            (f"{self.relpath}::{node.name}.{m.name}", m))
        return out

    # -- one function ------------------------------------------------------
    def _function(self, qual: Optional[str], fn: ast.AST) -> None:
        facts = (self.project.functions.get(qual)
                 if qual is not None else None)
        env: Dict[str, _Ref] = {}
        if facts is not None:
            for p in facts.params:
                root = self.param_roots.get((qual, p))
                if root is not None:
                    env[p] = root
        # single-request functions: a json.loads(...) local IS that
        # request's payload
        requests = self._request_calls(fn)
        single_req = requests[0] if len(requests) == 1 else None
        self._env_pass(list(fn.body), env, facts, single_req)
        self._consume_pass(fn, env)
        self._client_pass(fn, requests)
        if facts is not None:
            self._propagate_params(facts, env)

    def _request_calls(self, fn: ast.AST
                       ) -> List[Tuple[str, str, bool, ast.Call]]:
        out = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "request"
                    and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                lp = _literal_path(node.args[1])
                if lp is not None:
                    out.append((node.args[0].value.upper(), lp[0],
                                lp[1], node))
        return out

    def _root_of(self, expr: ast.AST,
                 single_req: Optional[Tuple[str, str, bool, ast.Call]]
                 ) -> Optional[Tuple[_Ref, Optional[int]]]:
        """(ref, tuple-elem) when ``expr`` is a payload root."""
        if not isinstance(expr, ast.Call):
            return None
        leaf = cg._leaf(cg._dotted(expr.func))
        if leaf in self.helpers:
            path = None
            for a in expr.args:
                if (isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        and a.value.startswith("/")):
                    path = a.value.split("?", 1)[0]
                    break
            if path is not None:
                return ("GET", path, ()), self.helpers[leaf]
        if (leaf == "loads" and single_req is not None and expr.args):
            method, path, _, _ = single_req
            return (method, path, ()), None
        # in-process: a call resolving to a known payload producer
        return None

    def _inproc_root(self, expr: ast.AST,
                     facts: Optional[cg.FuncFacts]) -> Optional[_Ref]:
        if facts is None or not isinstance(expr, ast.Call):
            return None
        for call in facts.calls:
            if (call.line, call.col) == (expr.lineno, expr.col_offset):
                for q in call.resolved:
                    ep_key = self.payload_quals.get(q)
                    if ep_key is not None:
                        return (ep_key[0], ep_key[1], ())
        return None

    def _env_pass(self, stmts: List[ast.stmt], env: Dict[str, _Ref],
                  facts: Optional[cg.FuncFacts],
                  single_req) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t = stmt.targets[0]
                rooted = self._root_of(stmt.value, single_req)
                if rooted is not None:
                    ref, elem = rooted
                    if elem is None and isinstance(t, ast.Name):
                        env[t.id] = ref
                    elif (elem is not None and isinstance(t, ast.Tuple)
                          and elem < len(t.elts)
                          and isinstance(t.elts[elem], ast.Name)):
                        env[t.elts[elem].id] = ref
                elif isinstance(t, ast.Name):
                    ref = (self._payload_ref(stmt.value, env)
                           or self._inproc_root(stmt.value, facts))
                    if ref is not None:
                        env[t.id] = ref
                    else:
                        env.pop(t.id, None)
                elif (isinstance(t, ast.Attribute)
                      and isinstance(stmt.value, ast.Name)
                      and stmt.value.id in env):
                    self.attr_bindings[t.attr] = env[stmt.value.id]
            # recurse into compound statements, order-preserving
            for body in self._sub_bodies(stmt):
                self._env_pass(body, env, facts, single_req)

    @staticmethod
    def _sub_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if (sub and isinstance(sub, list)
                    and not isinstance(stmt, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))):
                out.append(sub)
        for h in getattr(stmt, "handlers", ()) or ():
            out.append(h.body)
        return out

    def _payload_ref(self, expr: ast.AST,
                     env: Dict[str, _Ref]) -> Optional[_Ref]:
        if isinstance(expr, ast.Name):
            return env.get(expr.id)
        # inline chain: _fetch_json(rep, "/stats").get("key")
        if isinstance(expr, ast.Call):
            leaf = cg._leaf(cg._dotted(expr.func))
            if leaf in self.helpers and self.helpers[leaf] is None:
                for a in expr.args:
                    if (isinstance(a, ast.Constant)
                            and isinstance(a.value, str)
                            and a.value.startswith("/")):
                        return "GET", a.value.split("?", 1)[0], ()
        if isinstance(expr, ast.Attribute):
            return self.attr_bindings.get(expr.attr)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                ref = self._payload_ref(v, env)
                if ref is not None:
                    return ref
            return None
        if (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr == "get"
                and expr.args
                and isinstance(expr.args[0], ast.Constant)
                and isinstance(expr.args[0].value, str)):
            base = self._payload_ref(expr.func.value, env)
            if base is not None:
                m, p, kp = base
                return m, p, kp + (expr.args[0].value,)
            return None
        if (isinstance(expr, ast.Subscript)
                and isinstance(expr.slice, ast.Constant)
                and isinstance(expr.slice.value, str)):
            base = self._payload_ref(expr.value, env)
            if base is not None:
                m, p, kp = base
                return m, p, kp + (expr.slice.value,)
        return None

    def _consume_pass(self, fn: ast.AST, env: Dict[str, _Ref]) -> None:
        for node in ast.walk(fn):
            key: Optional[str] = None
            base: Optional[ast.AST] = None
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                key, base = node.args[0].value, node.func.value
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.slice.value, str)):
                key, base = node.slice.value, node.value
            if key is None or base is None:
                continue
            ref = self._payload_ref(base, env)
            if ref is None:
                continue
            m, p, kp = ref
            keypath = kp + (key,)
            dedup = (node.lineno, node.col_offset, keypath)
            if dedup in self._seen:
                continue
            self._seen.add(dedup)
            self.consumptions.append(Consumption(
                relpath=self.relpath, line=node.lineno,
                col=node.col_offset, method=m, path=p,
                keypath=keypath))

    def _client_pass(self, fn: ast.AST,
                     requests: List[Tuple[str, str, bool, ast.Call]]
                     ) -> None:
        expected, saw_status_use = self._expected_statuses(fn)
        for method, path, prefix, call in requests:
            self.clients.append(ClientCall(
                relpath=self.relpath, line=call.lineno,
                col=call.col_offset, method=method, path=path,
                prefix=prefix, expected=set(expected),
                status_unknown=not saw_status_use))
        # fetch-helper call sites are clients too
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            leaf = cg._leaf(cg._dotted(node.func))
            if leaf not in self.helpers:
                continue
            path = None
            for a in node.args:
                if (isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        and a.value.startswith("/")):
                    path = a.value.split("?", 1)[0]
                    break
            if path is None:
                continue
            codes: Set[int] = set()
            for kw in node.keywords:
                if (kw.arg == "ok_codes"
                        and isinstance(kw.value, (ast.Tuple, ast.Set,
                                                  ast.List))):
                    codes = {e.value for e in kw.value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, int)}
            unknown = self.helpers[leaf] is not None and not codes
            self.clients.append(ClientCall(
                relpath=self.relpath, line=node.lineno,
                col=node.col_offset, method="GET", path=path,
                prefix=False, expected=codes or {200},
                status_unknown=unknown))

    def _expected_statuses(self, fn: ast.AST) -> Tuple[Set[int], bool]:
        out: Set[int] = set()
        saw = False
        for node in ast.walk(fn):
            if (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.left, ast.Attribute)
                    and node.left.attr == "status"):
                saw = True
                comp = node.comparators[0]
                if (isinstance(comp, ast.Constant)
                        and isinstance(comp.value, int)):
                    out.add(comp.value)
                elif isinstance(comp, (ast.Tuple, ast.Set, ast.List)):
                    out |= {e.value for e in comp.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, int)}
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Attribute)
                  and node.args[0].attr == "status"):
                preds = self.status_preds.get(
                    cg._leaf(cg._dotted(node.func)))
                if preds:
                    saw = True
                    out |= preds
        return out, saw

    def _propagate_params(self, facts: cg.FuncFacts,
                          env: Dict[str, _Ref]) -> None:
        for call in facts.calls:
            for i, aname in call.arg_names:
                ref = env.get(aname)
                if ref is None:
                    continue
                for qual in call.resolved:
                    callee = self.project.functions.get(qual)
                    if (callee is not None
                            and callee.relpath == self.relpath
                            and i < len(callee.params)):
                        self.param_roots.setdefault(
                            (qual, callee.params[i]), ref)


# ---------------------------------------------------------------------------
# Index construction
# ---------------------------------------------------------------------------

def _module_tree(relpath: str, root: str) -> Optional[ast.Module]:
    path = relpath if os.path.isabs(relpath) else os.path.join(root,
                                                               relpath)
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, UnicodeDecodeError, SyntaxError):
        return None


def build(project: cg.ProjectIndex, config) -> WireIndex:
    """The full producer/consumer wire index over ``project``.

    Server/consumer module sets come from the config; when NONE of the
    configured servers is in view (a single-fixture index), every
    module in the project plays both roles — fixtures are their own
    self-contained wire worlds."""
    root = getattr(config, "root", ".") or "."
    server_set = set(getattr(config, "wire_server_modules", ()))
    consumer_pre = tuple(getattr(config, "wire_consumer_modules", ()))
    helpers = _parse_helpers(getattr(config, "wire_fetch_helpers",
                                     ("_fetch_json",)))
    servers = [r for r in project.modules if r in server_set]
    consumers = [r for r in project.modules
                 if any(r == c or r.startswith(c)
                        for c in consumer_pre)]
    if not servers:
        servers = sorted(project.modules)
        consumers = sorted(project.modules)
    resolver = _Resolver(project)
    wi = WireIndex()
    for rel in sorted(servers):
        tree = _module_tree(rel, root)
        if tree is None:
            continue
        wi.endpoints.extend(
            _HandlerExtractor(rel, tree, project, resolver).run())
    payload_quals: Dict[str, Tuple[str, str]] = {}
    for ep in wi.endpoints:
        for q in ep.payload_quals:
            payload_quals.setdefault(q, (ep.method, ep.path))
    for rel in sorted(set(consumers)):
        tree = _module_tree(rel, root)
        if tree is None:
            continue
        ex = _ConsumerExtractor(rel, tree, project, helpers,
                                payload_quals)
        ex.run()
        wi.consumptions.extend(ex.consumptions)
        wi.clients.extend(ex.clients)
    return wi


def index_for(ctx) -> WireIndex:
    """The per-project memoized WireIndex (built once per gate run)."""
    project = ctx.project
    wi = project.memo.get("wire.index")
    if not isinstance(wi, WireIndex):
        wi = build(project, ctx.config)
        project.memo["wire.index"] = wi
    return wi


# ---------------------------------------------------------------------------
# The canonical /stats registry + generated doc table
# ---------------------------------------------------------------------------

def _type_str(rk: ResolvedKey) -> str:
    return "/".join(sorted(rk.types)) if rk.types else "?"


def _null_str(rk: ResolvedKey) -> str:
    if rk.nullable or rk.conditional:
        return "yes"
    return "no" if rk.types else "?"


def _consumers_of(wi: WireIndex, ep: Endpoint,
                  keypath: Tuple[str, ...]) -> List[str]:
    out: Set[str] = set()
    for c in wi.consumptions:
        if c.keypath != keypath:
            continue
        for cand in wi.endpoints_for(c.method, c.path):
            if cand is ep or (cand.method == ep.method
                              and cand.path == ep.path):
                out.add(c.relpath)
                break
    return sorted(out)


def _registry_rows(wi: WireIndex, ep: Endpoint
                   ) -> List[Tuple[str, ResolvedKey]]:
    rows: List[Tuple[str, ResolvedKey]] = []

    def emit(prefix: Tuple[str, ...], shape: ResolvedShape,
             depth: int) -> None:
        for k in sorted(shape.keys):
            rk = shape.keys[k]
            rows.append((".".join(prefix + (k,)), rk))
            if rk.nested is not None and depth < 2:
                emit(prefix + (k,), rk.nested, depth + 1)
        if shape.dynamic is not None and depth < 2:
            rk = shape.dynamic
            rows.append((".".join(prefix + ("*",)), rk))
            if rk.nested is not None:
                emit(prefix + ("*",), rk.nested, depth + 1)

    emit((), ep.shape, 0)
    return rows


def table_block(wi: WireIndex) -> str:
    """The generated ``/stats`` schema tables, markers included —
    byte-identical output for identical trees (everything sorted)."""
    lines: List[str] = [TABLE_BEGIN, ""]
    stats_eps = sorted(
        (e for e in wi.endpoints
         if e.path == "/stats" and e.method == "GET"),
        key=lambda e: (e.server not in _SERVER_TITLES, e.server))
    for ep in stats_eps:
        title = _SERVER_TITLES.get(
            ep.server, os.path.splitext(os.path.basename(ep.server))[0])
        lines.append(f"**{title} `GET /stats`** — handler in "
                     f"`{ep.server}`:")
        lines.append("")
        lines.append("| field | type | null | produced at | "
                     "consumed by |")
        lines.append("|---|---|---|---|---|")
        for path, rk in _registry_rows(wi, ep):
            keypath = tuple(path.split("."))
            consumers = _consumers_of(wi, ep, keypath)
            site = (f"`{rk.site[0]}:{rk.site[1]}`"
                    if rk.site[0] else "?")
            cons = (", ".join(f"`{c}`" for c in consumers)
                    if consumers else "—")
            lines.append(f"| `{path}` | {_type_str(rk)} | "
                         f"{_null_str(rk)} | {site} | {cons} |")
        lines.append("")
    lines.append(TABLE_END)
    return "\n".join(lines) + "\n"


def extract_table(doc_text: str) -> Optional[str]:
    """The generated block out of a doc, markers included (None when
    the markers are absent/malformed)."""
    try:
        start = doc_text.index(TABLE_BEGIN)
        end = doc_text.index(TABLE_END) + len(TABLE_END)
    except ValueError:
        return None
    return doc_text[start:end] + "\n"


# ---------------------------------------------------------------------------

def _zero_nodes(expr: ast.AST) -> Iterator[ast.Constant]:
    """Constant ``0``/``0.0``/``False`` productions inside a value
    expression (the expression itself, IfExp arms, or-fallbacks).
    ``None`` never matches — it IS the contract."""
    if isinstance(expr, ast.Constant):
        v = expr.value
        if (v is False or (not isinstance(v, bool)
                           and isinstance(v, (int, float)) and v == 0)):
            yield expr
    elif isinstance(expr, ast.IfExp):
        yield from _zero_nodes(expr.body)
        yield from _zero_nodes(expr.orelse)
    elif isinstance(expr, ast.BoolOp):
        for v in expr.values:
            yield from _zero_nodes(v)


def null_zero_violations(tree: ast.Module
                         ) -> Iterator[Tuple[ast.AST, str]]:
    """(node, key) for every constant-zero production of a key the
    null-not-zero contract covers: dict-literal entries and
    ``X["key"] = 0``-style subscript stores."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for knode, vnode in zip(node.keys, node.values):
                if (isinstance(knode, ast.Constant)
                        and knode.value in NULL_NOT_ZERO_KEYS):
                    for bad in _zero_nodes(vnode):
                        yield bad, knode.value
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value in NULL_NOT_ZERO_KEYS):
                    for bad in _zero_nodes(node.value):
                        yield bad, t.slice.value
