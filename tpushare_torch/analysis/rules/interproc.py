"""Inter-procedural rule families: TS104, RL4xx, CC204.

These are the bug classes a review has to catch by hand when every
rule is intra-function:

- **TS104 transitive-host-sync** — a helper that ``.item()``s (or
  ``.tolist()``s, ``.cpu()``s, ...) reached from a ``*SlotServer``
  engine-tick method through any call chain. TS103 polices syncs
  written directly in ``step``/``_spec_step``/``admit_step``/
  ``_fused_tick``; this closes the hole where the sync hides one (or
  five) frames below, which a per-callsite baseline papers over.
- **RL401/RL402 resource-leak** — an exception edge escapes the
  region between a resource acquisition (slot activation via
  ``admit``/``admit_start`` -> RL401; pool-block allocation via
  ``alloc_blocks`` -> RL402) and its release (``evict`` /
  ``_safe_evict`` / ``release`` / ``_unref``; a ``finally`` or an
  except-handler release guards the region) or its ownership transfer
  (stored into a container/attribute, returned, or passed to a callee
  whose summary releases/stores that parameter). This is exactly the
  orphaned-ACTIVE-slot class: activate, then fail before registering,
  and the slot eats capacity forever.
- **CC204 lock-order-inversion** — a cycle in the project-wide lock
  acquisition-order graph (lock B taken while holding A in one call
  chain, A while holding B in another), including non-reentrant
  re-acquisition through a helper. The engine loop, the supervisor,
  and the HTTP handlers all share locks across files, so the graph is
  global; each cycle is reported once, at its earliest edge site.

May-raise is propagated from explicit ``raise`` statements over
*resolved* calls only; unresolved calls (builtins, third-party, duck
receivers the heuristics cannot type) are assumed silent. That is the
low-noise direction: these rules exist to catch the repo's own
helpers, whose sources are all in view.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted, last_component
from tpushare_torch.analysis.rules.tracer_safety import (STEP_LOOP_METHODS,
                                                         TRACER_PATHS,
                                                         is_tick_class)
from tpushare_torch.analysis import callgraph
from tpushare_torch.analysis.callgraph import (RESOURCE_KINDS,
                                               REENTRANT_FACTORIES)


class _Pos:
    """Anchor shim: a line/col pair quacking like an AST node for
    FileContext.finding()."""

    def __init__(self, line: int, col: int):
        self.lineno = line
        self.col_offset = col


def _short(qual: str) -> str:
    """'tpushare_torch/models/paged.py::Cls.meth' -> 'Cls.meth'."""
    return qual.rsplit("::", 1)[-1]


# ---------------------------------------------------------------------------
# TS104 — transitive host sync below the engine tick
# ---------------------------------------------------------------------------

def _is_step_loop(facts) -> bool:
    return (facts.name in STEP_LOOP_METHODS
            and facts.class_name is not None
            and is_tick_class(facts.class_name))


@register
class TransitiveHostSync(Rule):
    id = "TS104"
    name = "transitive-host-sync"
    family = "tracer-safety"
    description = ("host-device sync reached from a *SlotServer "
                   "engine-tick method through a call chain — TS103 "
                   "only sees syncs written directly in the tick body")
    paths = TRACER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        index = ctx.project
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ClassDef)
                    and is_tick_class(node.name)):
                continue
            for stmt in node.body:
                if not (isinstance(stmt, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and stmt.name in STEP_LOOP_METHODS):
                    continue
                qual = f"{ctx.relpath}::{node.name}.{stmt.name}"
                entry = index.func(qual)
                if entry is None:
                    continue
                # Other step-loop methods are TS103's jurisdiction:
                # their direct syncs carry their own (baselined or
                # flagged) TS103 findings already.
                for call, chain, sync in index.sync_chains(
                        entry, skip=_is_step_loop):
                    hops = " -> ".join(_short(q) for q in chain)
                    yield ctx.finding(
                        self.id, _Pos(call.line, call.col),
                        f"{sync.desc} reached from "
                        f"{node.name}.{stmt.name} via {hops} "
                        f"(depth {len(chain) - 1}) — the engine tick "
                        f"must stay sync-free through its whole call "
                        f"tree, not just its own body")


# ---------------------------------------------------------------------------
# RL401/RL402 — exception edge escapes an acquire..release region
# ---------------------------------------------------------------------------

# tpushare_torch/router rides the sweep: the front door holds no
# slot/block resources itself, but the region walk keeps it that way —
# a future router-side admission ticket or reserved-slot handle gets
# the leak analysis for free.
RESOURCE_PATHS = ("tpushare_torch/cli", "tpushare_torch/models", "tpushare_torch/chaos",
                  "tpushare_torch/router", "tpushare_torch/slo", "tpushare_torch/durable")


class _RegionWalker:
    """Linear-order walk of one function body tracking held resource
    handles. Branches are visited in source order (no path
    sensitivity): a release/transfer in either arm closes the region,
    which under-reports rather than spamming exclusive-branch noise."""

    def __init__(self, rule, ctx: FileContext, facts, index,
                 acquire_names: Set[str], release_names: Set[str]):
        self.rule = rule
        self.ctx = ctx
        self.facts = facts
        self.index = index
        self.acquire_names = acquire_names
        self.release_names = release_names
        #: var -> (acquire line, acquire snippet-ish)
        self.held: Dict[str, Tuple[int, int]] = {}
        self.reported: Set[str] = set()
        self.findings: List[Finding] = []
        self._callfacts = {(c.line, c.col): c for c in facts.calls}

    # -- helpers -----------------------------------------------------------
    def _calls_in(self, node: ast.AST) -> List[ast.Call]:
        out = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
        out.sort(key=lambda n: (n.lineno, n.col_offset))
        return out

    def _may_raise(self, call: ast.Call) -> bool:
        cf = self._callfacts.get((call.lineno, call.col_offset))
        if cf is None or cf.guarded:
            return False
        for qual in cf.resolved:
            f = self.index.func(qual)
            if f is not None and f.may_raise:
                return True
        return False

    def _releases(self, call: ast.Call) -> Set[str]:
        """Names this call releases or takes ownership of (NOT
        filtered to currently-held vars: the try/finally pre-scan
        needs releases of vars acquired later, inside the body)."""
        out: Set[str] = set()
        leaf = last_component(dotted(call.func))
        arg_names = [(i, a.id) for i, a in enumerate(call.args)
                     if isinstance(a, ast.Name)]
        if leaf in self.release_names:
            out.update(n for _, n in arg_names)
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in callgraph.STORE_METHODS):
            out.update(n for _, n in arg_names)
        cf = self._callfacts.get((call.lineno, call.col_offset))
        if cf is not None:
            for qual in cf.resolved:
                f = self.index.func(qual)
                if f is None:
                    continue
                for i, aname in arg_names:
                    if i >= len(f.params):
                        continue
                    p = f.params[i]
                    if p in f.param_release or p in f.param_store:
                        out.add(aname)
        return out

    def _transfer_names(self, stmt: ast.stmt) -> Set[str]:
        """Ownership leaving via stores/returns in this statement."""
        out: Set[str] = set()

        def names_of(expr: Optional[ast.expr]) -> List[str]:
            if isinstance(expr, ast.Name):
                return [expr.id]
            if isinstance(expr, ast.Tuple):
                return [e.id for e in expr.elts
                        if isinstance(e, ast.Name)]
            return []

        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = getattr(stmt, "value", None)
            for t in targets:
                if isinstance(t, ast.Subscript):
                    out.update(names_of(t.slice))
                    out.update(names_of(value))
                elif isinstance(t, ast.Attribute):
                    out.update(names_of(value))
        elif isinstance(stmt, ast.Return):
            out.update(names_of(stmt.value))
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                       (ast.Yield,)):
            out.update(names_of(stmt.value.value))
        return {n for n in out if n in self.held}

    def _flag(self, var: str, call: ast.Call) -> None:
        if var in self.reported:
            return
        self.reported.add(var)
        acq_line, _ = self.held[var]
        callee = dotted(call.func) or "<call>"
        self.findings.append(self.ctx.finding(
            self.rule.id, call,
            f"{callee}() may raise while {var!r} (acquired at line "
            f"{acq_line}) is still un-released and un-registered — an "
            f"exception here orphans the {self.rule.resource} (wrap "
            f"in try/finally with a release, or register before "
            f"fallible work)"))

    # -- the walk ----------------------------------------------------------
    def run(self, fn: ast.AST) -> List[Finding]:
        self._stmts(fn.body, protected=frozenset())
        for var in sorted(self.held):
            if var in self.reported:
                continue
            line, col = self.held[var]
            self.findings.append(self.ctx.finding(
                self.rule.id, _Pos(line, col),
                f"{var!r} acquired here is neither released nor "
                f"handed off on any path out of "
                f"{self.facts.name}() — the {self.rule.resource} "
                f"leaks even without an exception"))
        return self.findings

    def _stmts(self, stmts: List[ast.stmt],
               protected: frozenset) -> None:
        for stmt in stmts:
            self._stmt(stmt, protected)

    _COMPOUND = (ast.If, ast.For, ast.AsyncFor, ast.While,
                 ast.With, ast.AsyncWith)

    def _stmt(self, stmt: ast.stmt, protected: frozenset) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Try):
            # Vars released in a handler or the finally are protected
            # inside the body; a try with handlers is assumed to
            # handle the exception (escape ends there — the guarded
            # flag on the CallFacts enforces the same).
            rel: Set[str] = set()
            for part in ([s for h in stmt.handlers for s in h.body]
                         + stmt.finalbody):
                for call in self._calls_in(part):
                    rel |= self._releases(call)
            inner = protected | rel
            if stmt.handlers:
                inner = inner | set(self.held)
            self._stmts(stmt.body, frozenset(inner))
            for h in stmt.handlers:
                self._stmts(h.body, protected)
            self._stmts(stmt.orelse, protected)
            self._stmts(stmt.finalbody, protected)
            # A finally-release closes the region for good.
            for var in rel:
                self.held.pop(var, None)
            return
        if isinstance(stmt, self._COMPOUND):
            if isinstance(stmt, (ast.If, ast.While)):
                headers = [stmt.test]
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                headers = [stmt.iter]
            else:
                headers = [it.context_expr for it in stmt.items]
            for h in headers:
                self._exprs(h, protected)
            self._stmts(stmt.body, protected)
            self._stmts(getattr(stmt, "orelse", []), protected)
            return
        # acquire: simple-name assignment from an acquire-vocab call.
        # The acquire call itself failing is the clean path (nothing
        # held yet) — but it may escape OTHER already-held vars, so
        # the value expression is processed before the bind.
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)):
            leaf = last_component(dotted(stmt.value.func))
            if leaf in self.acquire_names:
                self._exprs(stmt.value, protected)
                self.held[stmt.targets[0].id] = (stmt.lineno,
                                                 stmt.col_offset)
                return
        # simple statement: escape/release checks in source order,
        # then the statement's own ownership transfers take effect.
        transfers = self._transfer_names(stmt)
        self._exprs(stmt, protected)
        for var in transfers:
            self.held.pop(var, None)

    def _exprs(self, node: ast.AST, protected: frozenset) -> None:
        for call in self._calls_in(node):
            released = self._releases(call)
            hit = {v for v in released if v in self.held}
            for var in hit:
                self.held.pop(var, None)
            # A call that released/stored SOME names can still raise
            # while OTHER handles are held — those vars' escape edges
            # are real; only the handles this call just disposed of
            # are exempt (they were popped above).
            self._escape_check(call, protected)

    def _escape_check(self, call: ast.Call, protected: frozenset) -> None:
        if not self.held:
            return
        if not self._may_raise(call):
            return
        for var in list(self.held):
            if var not in protected:
                self._flag(var, call)


class _ResourceLeakRule(Rule):
    paths = RESOURCE_PATHS
    resource = ""
    kind = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        index = ctx.project
        acquire, release = RESOURCE_KINDS[self.kind]
        for cls_name, fn in _functions(ctx.tree):
            qual = (f"{ctx.relpath}::{cls_name}.{fn.name}" if cls_name
                    else f"{ctx.relpath}::{fn.name}")
            facts = index.func(qual)
            if facts is None:
                continue
            # cheap gate: no acquire-vocab call, no region to track
            if not any(isinstance(n, ast.Call)
                       and last_component(dotted(n.func)) in acquire
                       for n in ast.walk(fn)):
                continue
            walker = _RegionWalker(self, ctx, facts, index,
                                   acquire, release)
            yield from walker.run(fn)


def _functions(tree: ast.Module):
    """(class_name_or_None, function_node) for module-level functions
    and class methods (nested defs excluded — their region state
    belongs to the closure's run time, not the definition site)."""
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, stmt
        elif isinstance(stmt, ast.ClassDef):
            for item in stmt.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield stmt.name, item


@register
class SlotLeak(_ResourceLeakRule):
    id = "RL401"
    name = "slot-activation-leak"
    family = "resource-leak"
    description = ("exception edge escapes between slot activation "
                   "(admit/admit_start) and its evict/registration — "
                   "an orphaned ACTIVE slot consumes engine capacity "
                   "forever")
    resource = "slot"
    kind = "slot"


@register
class BlockLeak(_ResourceLeakRule):
    id = "RL402"
    name = "block-allocation-leak"
    family = "resource-leak"
    description = ("exception edge escapes between pool-block "
                   "allocation (alloc_blocks) and its free/attach — "
                   "leaked blocks shrink every tenant's KV pool")
    resource = "block allocation"
    kind = "blocks"


# ---------------------------------------------------------------------------
# CC204 — lock-order inversion over the project lock graph
# ---------------------------------------------------------------------------

LOCK_ORDER_PATHS = ("tpushare_torch/cli", "tpushare_torch/chaos", "tpushare_torch/plugin",
                    "tpushare_torch/k8s", "tpushare_torch/extender",
                    "tpushare_torch/models", "tpushare_torch/router",
                    "tpushare_torch/slo", "tpushare_torch/durable")

_MEMO_KEY = "cc204_cycles"


def _lock_factory(index, lock_id: str) -> Optional[str]:
    """Factory name for a lock id, scanning class/module lock tables."""
    if "::" in lock_id:
        relpath, name = lock_id.rsplit("::", 1)
        mod = index.modules.get(relpath)
        return mod.module_locks.get(name) if mod else None
    cls_name, _, attr = lock_id.partition(".")
    for cls in index.classes_by_name.get(cls_name, []):
        if attr in cls.lock_attrs:
            return cls.lock_attrs[attr]
    return None


def _collect_edges(index) -> Dict[Tuple[str, str],
                                  List[Tuple[str, int, int, str]]]:
    """(held, acquired) -> [(relpath, line, col, via)] over every
    function in the index: direct nested with-blocks plus calls made
    while holding a lock, expanded through the callee's transitive
    acquisition summary."""
    edges: Dict[Tuple[str, str], List[Tuple[str, int, int, str]]] = {}

    def add(a: str, b: str, relpath: str, line: int, col: int,
            via: str) -> None:
        edges.setdefault((a, b), []).append((relpath, line, col, via))

    for f in index.functions.values():
        for a, b, line, col in f.lock_edges:
            add(a, b, f.relpath, line, col, _short(f.qual))
        for call in f.calls:
            if not call.locks_held:
                continue
            for qual in call.resolved:
                callee = index.func(qual)
                if callee is None:
                    continue
                for held in call.locks_held:
                    for acq in callee.trans_locks:
                        if acq == held and _lock_factory(
                                index, held) in REENTRANT_FACTORIES:
                            continue
                        add(held, acq, f.relpath, call.line, call.col,
                            f"{_short(f.qual)} -> {_short(qual)}")
    return edges


def _find_cycles(edges) -> List[Tuple[str, ...]]:
    """Simple cycles (canonical rotation, deduped), length-capped —
    the lock graph is a handful of nodes, so plain DFS is fine."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: Set[Tuple[str, ...]] = set()

    def canon(path: Tuple[str, ...]) -> Tuple[str, ...]:
        i = path.index(min(path))
        return path[i:] + path[:i]

    def dfs(start: str, node: str, path: Tuple[str, ...]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cycles.add(canon(path))
            elif nxt not in path and len(path) < 6:
                dfs(start, nxt, path + (nxt,))

    for n in sorted(graph):
        if n in graph.get(n, ()):
            cycles.add((n,))
        dfs(n, n, (n,))
    return sorted(cycles)


@register
class LockOrderInversion(Rule):
    id = "CC204"
    name = "lock-order-inversion"
    family = "concurrency"
    description = ("cycle in the cross-function lock acquisition-order "
                   "graph (A held while taking B on one chain, B while "
                   "taking A on another — a deadlock waiting for the "
                   "right interleaving), incl. non-reentrant re-entry")
    paths = LOCK_ORDER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        index = ctx.project
        memo = index.memo.get(_MEMO_KEY)
        if memo is None:
            edges = _collect_edges(index)
            memo = []
            for cycle in _find_cycles(edges):
                sites: List[Tuple] = []
                descs: List[str] = []
                pairs = (
                    [(cycle[0], cycle[0])] if len(cycle) == 1 else
                    [(cycle[i], cycle[(i + 1) % len(cycle)])
                     for i in range(len(cycle))])
                for a, b in pairs:
                    site = min(edges[(a, b)])
                    sites.append(site)
                    descs.append(f"{a} -> {b} at {site[0]}:{site[1]} "
                                 f"(via {site[3]})")
                # Anchor at the earliest edge site IN A POLICED FILE:
                # a cycle whose globally-earliest edge sits in an
                # out-of-scope file (the index sees the whole tree)
                # would otherwise anchor where check() never runs and
                # be silently dropped. Fixture runs (respect_scope
                # off, paths outside the policed trees) fall back to
                # the global minimum.
                in_scope = [s for s in sites if self.applies_to(s[0])]
                anchor = min(in_scope or sites)
                if len(cycle) == 1:
                    msg = (f"non-reentrant lock {cycle[0]} is "
                           f"re-acquired while already held: "
                           f"{'; '.join(descs)} — self-deadlock")
                else:
                    msg = (f"lock-order inversion "
                           f"{' / '.join(sorted(cycle))}: "
                           f"{'; '.join(descs)} — two threads taking "
                           f"these chains concurrently deadlock")
                memo.append((anchor[0], anchor[1], anchor[2], msg))
            index.memo[_MEMO_KEY] = memo
        for relpath, line, col, msg in memo:
            if relpath == ctx.relpath:
                yield ctx.finding(self.id, _Pos(line, col), msg)
