"""TS: host-sync rules of the PyTorch port (models/, ops/, parallel/).

TS101 — a host sync inside autograd scope. The ``forward``/``backward``
of a ``torch.autograd.Function`` run once per training step on the
device's critical path: an ``.item()`` / ``.cpu()`` / ``.tolist()``
there stalls the host until the device drains, every step, and cannot
be captured by a CUDA graph. A function handed to
``torch.utils.checkpoint.checkpoint`` runs TWICE (forward, then again
at recompute in the backward), so its host syncs are paid twice and a
``print``/``time.*`` side effect fires twice per step.

TS103 — host-device syncs in the serving engine tick. The
``step``/``_spec_step``/``admit_step`` methods of the ``*SlotServer``
families and their ``SpecDecodeMixin`` (and the overlapped pipeline's
``*_async`` halves, whose
``PendingStep`` closures carry the tick's deferred token fetch) are the
per-token hot loop. The invariant is one device->host transfer per
tick: the token fetch itself, suppressed on its line with the cause;
any OTHER sync must read the host mirrors (``PagedCache.host_lengths``,
the servers' ``active`` arrays) instead.

The sync vocabulary (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.synchronize()``, a blocking ``.to("cpu")``,
``float()``/``int()``/``bool()`` of a tensor) lives in
``callgraph.sync_desc``, shared with TS104's transitive pass.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from tpushare_torch.analysis.callgraph import sync_desc
from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted, last_component

TRACER_PATHS = ("tpushare_torch/models", "tpushare_torch/ops",
                "tpushare_torch/parallel")

#: the methods of a torch.autograd.Function the autograd engine calls
AUTOGRAD_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}


def is_function_class(cls: ast.ClassDef) -> bool:
    """A ``torch.autograd.Function`` subclass (``Function`` by any
    spelling of its base)."""
    return any(last_component(dotted(b)) == "Function" for b in cls.bases)


def _imports_checkpoint(tree: ast.Module) -> bool:
    return any(isinstance(n, ast.ImportFrom)
               and n.module == "torch.utils.checkpoint"
               and any(a.name == "checkpoint" and a.asname is None
                       for a in n.names)
               for n in ast.walk(tree))


def _is_checkpoint_call(call: ast.Call, bare_ok: bool) -> bool:
    name = dotted(call.func) or ""
    return (name.endswith("utils.checkpoint.checkpoint")
            or (bare_ok and name == "checkpoint"))


def autograd_roots(tree: ast.Module
                   ) -> List[Tuple[ast.AST, str]]:
    """(function node, label) for every body autograd runs: the
    ``forward``/``backward`` methods of Function subclasses, and the
    callables passed to ``torch.utils.checkpoint.checkpoint`` (a lambda,
    or a def resolved by name in its lexical scope)."""
    roots: List[Tuple[ast.AST, str]] = []
    seen: Set[int] = set()
    bare_ok = _imports_checkpoint(tree)

    def add(n: ast.AST, label: str) -> None:
        if id(n) not in seen:
            seen.add(id(n))
            roots.append((n, label))

    def visit_scope(body: List[ast.stmt], env: List[Dict[str, ast.AST]],
                    class_scope: bool = False) -> None:
        local: Dict[str, ast.AST] = {
            s.name: s for s in body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        chain = env + [local]
        method_env = env if class_scope else chain

        def resolve(name: str) -> Optional[ast.AST]:
            for scope in reversed(chain):
                if name in scope:
                    return scope[name]
            return None

        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit_scope(stmt.body, method_env)
                # checkpoint(f, ...) calls in this def's own statements
                # are visited by its scope walk above
                continue
            if isinstance(stmt, ast.ClassDef):
                if is_function_class(stmt):
                    for m in stmt.body:
                        if (isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                                and m.name in AUTOGRAD_METHODS):
                            add(m, f"{stmt.name}.{m.name}")
                visit_scope(stmt.body, chain, class_scope=True)
                continue
            for node in ast.walk(stmt):
                if (isinstance(node, ast.Call) and node.args
                        and _is_checkpoint_call(node, bare_ok)):
                    arg = node.args[0]
                    if isinstance(arg, ast.Lambda):
                        add(arg, "a checkpointed lambda")
                    elif isinstance(arg, ast.Name):
                        target = resolve(arg.id)
                        if target is not None:
                            add(target, f"checkpointed {arg.id}()")

    visit_scope(tree.body, [])
    return roots


@register
class HostSyncInAutograd(Rule):
    id = "TS101"
    name = "host-sync-in-autograd"
    family = "tracer-safety"
    description = ("host sync inside a torch.autograd.Function's "
                   "forward/backward or a checkpointed function (paid "
                   "every step, twice under recompute), or a print/"
                   "time.* side effect in a checkpointed function "
                   "(fires twice per step)")
    paths = TRACER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for root, label in autograd_roots(ctx.tree):
            checkpointed = not label.split(".")[-1] in AUTOGRAD_METHODS
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                desc = sync_desc(node)
                if desc is not None:
                    yield ctx.finding(
                        self.id, node,
                        f"{desc} waits on the device inside {label} — "
                        f"a host stall on every step"
                        + (" (twice: the forward reruns at recompute)"
                           if checkpointed else ""))
                    continue
                if not checkpointed:
                    continue
                name = dotted(node.func) or ""
                if name == "print" or name.startswith("time."):
                    yield ctx.finding(
                        self.id, node,
                        f"{name}() in {label} fires twice per step: "
                        f"checkpoint reruns the function at recompute")


#: the engine-tick methods TS103 polices (the per-token hot loop;
#: _fused_tick is step()'s fused-admission body and shares its budget).
#: The *_async variants are the overlapped pipeline's dispatch halves:
#: their PendingStep closures carry the tick's deferred token fetch, so
#: they own the same one-fetch budget — ast.walk descends into the
#: nested _finalize defs, keeping the fetch visible to the rule (a
#: second fetch smuggled into a closure is still a finding).
STEP_LOOP_METHODS = {"step", "_spec_step", "admit_step", "_fused_tick",
                     "step_async", "_spec_step_async",
                     "_fused_tick_async"}
#: classes whose STEP_LOOP_METHODS are the tick: the slot servers, and
#: the speculative mixin the paged and MoE servers take their
#: ``_spec_step_async`` from
TICK_CLASS_SUFFIXES = ("SlotServer", "SpecDecodeMixin")


def is_tick_class(name: str) -> bool:
    return name.endswith(TICK_CLASS_SUFFIXES)


@register
class HostSyncInStepLoop(Rule):
    id = "TS103"
    name = "host-sync-in-step-loop"
    family = "tracer-safety"
    description = ("host-device sync inside a *SlotServer engine-tick "
                   "method (step/_spec_step/admit_step and the *_async "
                   "halves) — the per-token hot loop must read host-"
                   "mirrored scheduler state; the one justified token "
                   "fetch is suppressed on its line with the cause")
    paths = TRACER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ClassDef)
                    and is_tick_class(node.name)):
                continue
            for stmt in node.body:
                if not (isinstance(stmt, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and stmt.name in STEP_LOOP_METHODS):
                    continue
                for sub in ast.walk(stmt):
                    desc = (sync_desc(sub) if isinstance(sub, ast.Call)
                            else None)
                    if desc is not None:
                        yield ctx.finding(
                            self.id, sub,
                            f"{desc} waits on the device in "
                            f"{node.name}.{stmt.name} — the engine tick "
                            f"must branch on host mirrors, not device "
                            f"reads")
