"""CC: concurrency rules (plugin/, extender/, k8s/).

CC201 — an instance attribute mutated both from a thread/watcher entry
point and from a gRPC/HTTP handler method, where at least one mutation
site is not under a ``with self.<lock>`` block. The daemon's watcher
threads (health loop, fs watcher, pod cache) and its gRPC handlers
share ``self`` state; the repo's discipline is "every cross-thread
store under the instance lock" (plugin/server.py), and this rule makes
that discipline checkable instead of conventional.

CC202 — blocking calls (``time.sleep``, sync socket/subprocess I/O)
inside ``async def`` bodies or directly inside RPC/HTTP handler
methods: a blocked handler thread is one less worker in the gRPC
thread pool serving the kubelet.

CC203 — swallowed exceptions: a BROAD handler (bare ``except``,
``except Exception``/``BaseException``) whose body only passes,
continues, or logs — no re-raise, no counter, no state change —
inside the plugin/extender/k8s trees or the serving hot classes
(``*SlotServer``/``ServeEngine*`` methods in models/ and cli/). The
engine treats "exception in a tick" as a first-class recovery path
with counters; a silent swallow anywhere on
those paths un-counts a failure the /stats surface promises to report.
Narrow handlers (``except OSError: pass``) are a deliberate judgment
call and stay legal; so does any broad handler that raises, returns,
or mutates state (a counter bump is a mutation).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted, is_self_attr, last_component

# The router is exactly the shape these rules police — a stats-poll
# thread and HTTP handler threads sharing per-replica score/breaker maps
# (fixtures/torch_analysis/cc201_router_shape.py preserves the unlocked
# variant as the rule's positive). The SLO layer's tier-counter maps are
# read by router poll threads and engine handler threads
# (fixtures/torch_analysis/cc201_tier_counters.py preserves the
# off-lock-mutation shape as a positive).
CONCURRENCY_PATHS = ("tpushare_torch/plugin", "tpushare_torch/extender",
                     "tpushare_torch/k8s", "tpushare_torch/router",
                     "tpushare_torch/slo", "tpushare_torch/durable")

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}

#: container-mutating method calls treated as stores
MUTATOR_METHODS = {"append", "appendleft", "add", "update", "pop", "popleft",
                   "extend", "remove", "discard", "clear", "insert",
                   "setdefault"}

BLOCKING_CALLS = ("time.sleep", "socket.create_connection",
                  "subprocess.run", "subprocess.check_output",
                  "subprocess.check_call", "subprocess.call",
                  "select.select", "urllib.request.urlopen",
                  "requests.get", "requests.post")
BLOCKING_ATTRS = {"recv", "recv_into", "sendall", "accept", "connect",
                  "makefile"}


class _MethodInfo:
    def __init__(self, node: ast.FunctionDef):
        self.node = node
        self.calls_self: Set[str] = set()          # self.X() method calls
        self.thread_targets: Set[str] = set()      # Thread(target=self.X)
        # attr path -> list of (node, locked?)
        self.stores: Dict[str, List[Tuple[ast.AST, bool]]] = {}
        self.lock_attrs_defined: Set[str] = set()  # self.X = threading.Lock()


def _scan_method(method: ast.FunctionDef, lock_attrs: Set[str]) -> _MethodInfo:
    info = _MethodInfo(method)

    def visit(node: ast.AST, lock_depth: int) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = lock_depth
            for item in node.items:
                expr = item.context_expr
                # ``with self._lock:`` / ``with self._cond:`` — and the
                # combined ``with Timer(...), self._lock:`` spelling.
                attr = is_self_attr(expr)
                if attr is not None and (attr in lock_attrs
                                         or _lockish_name(attr)):
                    held += 1
                visit(expr, lock_depth)
            for child in node.body:
                visit(child, held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # Nested defs (thread bodies, callbacks) keep the ambient
            # lock depth of their DEFINITION site conservatively at 0:
            # the closure runs later, when the with-block is gone.
            for child in ast.iter_child_nodes(node):
                visit(child, 0)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = getattr(node, "value", None)
            for t in targets:
                base = t
                if isinstance(t, ast.Subscript):      # self.store[k] = v
                    base = t.value
                attr = is_self_attr(base)
                if attr is not None:
                    if (isinstance(value, ast.Call)
                            and last_component(dotted(value.func))
                            in LOCK_FACTORIES):
                        info.lock_attrs_defined.add(attr)
                    info.stores.setdefault(attr, []).append(
                        (node, lock_depth > 0))
            if value is not None:
                visit(value, lock_depth)
            return
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name and last_component(name) == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        attr = is_self_attr(kw.value)
                        if attr is not None:
                            info.thread_targets.add(attr)
            if name == "signal.signal" and len(node.args) >= 2:
                attr = is_self_attr(node.args[1])
                if attr is not None:
                    info.thread_targets.add(attr)
            func = node.func
            if isinstance(func, ast.Attribute):
                attr = is_self_attr(func)
                if attr is not None:
                    parts = attr.rsplit(".", 1)
                    if len(parts) == 1:
                        info.calls_self.add(attr)
                    else:
                        base, meth = parts
                        if meth in MUTATOR_METHODS:
                            info.stores.setdefault(base, []).append(
                                (node, lock_depth > 0))
                        else:
                            info.calls_self.add(attr)
            for child in ast.iter_child_nodes(node):
                visit(child, lock_depth)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, lock_depth)

    for stmt in method.body:
        visit(stmt, 0)
    return info


def _lockish_name(attr: str) -> bool:
    leaf = attr.rsplit(".", 1)[-1].lower()
    return "lock" in leaf or "cond" in leaf or "mutex" in leaf


def _closure(seed: Set[str], infos: Dict[str, _MethodInfo]) -> Set[str]:
    """Transitive closure of ``self.X()`` calls from ``seed`` methods."""
    out = set(seed)
    frontier = list(seed)
    while frontier:
        name = frontier.pop()
        info = infos.get(name)
        if info is None:
            continue
        for callee in info.calls_self:
            base = callee.split(".", 1)[0]
            if base in infos and base not in out:
                out.add(base)
                frontier.append(base)
    return out


@register
class UnlockedSharedMutation(Rule):
    id = "CC201"
    name = "unlocked-shared-mutation"
    family = "concurrency"
    description = ("instance attribute mutated from both a thread entry "
                   "point and an RPC/HTTP handler without a held lock")
    paths = CONCURRENCY_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        handler_names = set(getattr(ctx.config, "handler_methods", ()))
        entry_defaults = set(getattr(ctx.config, "thread_entry_methods", ()))
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            infos: Dict[str, _MethodInfo] = {}
            lock_attrs: Set[str] = set()
            # Pass 1: find declared locks so pass 2 can credit them.
            for item in cls.body:
                if isinstance(item, ast.FunctionDef):
                    pre = _scan_method(item, set())
                    lock_attrs |= pre.lock_attrs_defined
                    lock_attrs |= {a for a in pre.stores if _lockish_name(a)}
            for item in cls.body:
                if isinstance(item, ast.FunctionDef):
                    infos[item.name] = _scan_method(item, lock_attrs)

            thread_entries: Set[str] = set()
            for info in infos.values():
                for target in info.thread_targets:
                    thread_entries.add(target.split(".", 1)[0])
            thread_entries |= {m for m in entry_defaults if m in infos}
            thread_entries = {m for m in thread_entries if m in infos}
            handlers = {m for m in infos if m in handler_names}
            if not thread_entries or not handlers:
                continue
            entry_reach = _closure(thread_entries, infos)
            handler_reach = _closure(handlers, infos) - entry_reach

            def mutated_attrs(methods: Set[str]) -> Set[str]:
                out: Set[str] = set()
                for m in methods:
                    out |= set(infos[m].stores)
                return out

            shared = mutated_attrs(entry_reach) & mutated_attrs(handler_reach)
            shared = {a for a in shared
                      if a not in lock_attrs and not _lockish_name(a)}
            for attr in sorted(shared):
                for m in sorted(entry_reach | handler_reach):
                    for node, locked in infos[m].stores.get(attr, []):
                        if not locked:
                            yield ctx.finding(
                                self.id, node,
                                f"self.{attr} is mutated from thread entry "
                                f"point(s) {sorted(entry_reach & thread_entries)} "
                                f"and handler(s) {sorted(handlers)} but this "
                                f"store in {cls.name}.{m}() holds no lock")


@register
class BlockingInAsync(Rule):
    id = "CC202"
    name = "blocking-call-in-async-handler"
    family = "concurrency"
    description = ("blocking call (time.sleep, sync socket/subprocess) "
                   "inside an async function or RPC/HTTP handler")
    paths = CONCURRENCY_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        handler_names = set(getattr(ctx.config, "handler_methods", ()))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                yield from self._scan(ctx, node, f"async {node.name}()",
                                      in_async=True)
            elif (isinstance(node, ast.FunctionDef)
                  and node.name in handler_names):
                yield from self._scan(ctx, node, f"handler {node.name}()",
                                      in_async=False)

    def _scan(self, ctx: FileContext, fn: ast.AST, where: str,
              in_async: bool) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            if name in BLOCKING_CALLS:
                yield ctx.finding(
                    self.id, node,
                    f"{name}() blocks the event loop/worker inside {where}")
            elif (in_async and isinstance(node.func, ast.Attribute)
                  and node.func.attr in BLOCKING_ATTRS):
                yield ctx.finding(
                    self.id, node,
                    f".{node.func.attr}() is sync socket I/O inside {where}")


#: exception names treated as "broad" for CC203
BROAD_EXC_NAMES = {"Exception", "BaseException"}

#: call roots that make an except body "logging only" (logging is not
#: handling: the failure leaves no counter and no control-flow trace)
LOGGING_ROOTS = {"log", "logging", "logger", "warnings"}
LOGGING_CALLS = {"print"}

#: serving hot classes policed outside the plugin/extender/k8s trees
SERVING_CLASS_SUFFIX = "SlotServer"
SERVING_CLASS_PREFIX = "ServeEngine"

CC203_EXTRA_PATHS = ("tpushare_torch/models", "tpushare_torch/cli")


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:                               # bare except
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        name = dotted(n)
        if name is not None and last_component(name) in BROAD_EXC_NAMES:
            return True
    return False


LOGGING_VERBS = {"debug", "info", "warning", "warn", "error",
                 "exception", "critical"}


def _is_logging_call(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func) or ""
    if name in LOGGING_CALLS:
        return True
    parts = name.split(".")
    root, leaf = parts[0], parts[-1]
    if root in LOGGING_ROOTS:
        return True
    if leaf not in LOGGING_VERBS:
        return False
    if root == "self":
        # Instance-held loggers count (self._log.warning(...) is still
        # just logging), but ONLY through a logger-ish attribute —
        # self.recorder.warning(...) or a domain method named error()
        # is real handling, not a log line.
        return any("log" in p.lower() for p in parts[1:-1])
    return True


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does NOTHING with the failure:
    every statement is a pass, a continue, or a pure logging call.
    Any raise/return/break, assignment (a counter bump is an
    AugAssign), or non-logging call counts as handling."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if (isinstance(stmt, ast.Expr)
                and (_is_logging_call(stmt.value)
                     or isinstance(stmt.value, ast.Constant))):
            continue
        return False
    return True


@register
class SwallowedException(Rule):
    id = "CC203"
    name = "swallowed-exception"
    family = "concurrency"
    description = ("broad except whose body only passes/continues/logs "
                   "— no re-raise, counter, or state change — in the "
                   "plugin/extender/k8s trees or *SlotServer/"
                   "ServeEngine methods")
    paths = CONCURRENCY_PATHS + CC203_EXTRA_PATHS

    def _roots(self, ctx: FileContext):
        """Whole file inside the daemon trees; only the serving hot
        classes (*SlotServer / ServeEngine*) elsewhere — a models/ or
        cli/ helper outside the engine may legitimately best-effort a
        broad except."""
        rp = ctx.relpath.replace("\\", "/")
        if any(rp.startswith(p) for p in CONCURRENCY_PATHS):
            yield None, ctx.tree
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and (
                    node.name.endswith(SERVING_CLASS_SUFFIX)
                    or node.name.startswith(SERVING_CLASS_PREFIX)):
                yield node.name, node

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for cls_name, root in self._roots(ctx):
            where = (f"in {cls_name}" if cls_name
                     else "in a daemon-side module")
            for node in ast.walk(root):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    if (_is_broad_handler(handler)
                            and _swallows(handler)):
                        yield ctx.finding(
                            self.id, handler,
                            f"broad except swallows the failure {where} "
                            f"(no re-raise, counter, or state change — "
                            f"count it or let the recovery path see it)")
