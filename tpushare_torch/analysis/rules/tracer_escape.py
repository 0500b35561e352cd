"""TE701: a tensor escaping autograd scope (models/, ops/, parallel/).

The JAX package's tracer-escape rule catches a traced value stored
where it outlives the trace. The port has no tracers, but autograd has
the same boundary: what a ``torch.autograd.Function``'s ``forward`` /
``backward`` or a checkpointed function computes belongs to the graph,
and two ways out of it are faults that no test on the CPU sees:

- a store to ``self``, a ``global`` or a captured mutable (module
  dict, closed-over list) from those bodies keeps the step's
  activations, and through their ``grad_fn`` the whole graph, alive
  past the step; in a checkpointed function the store also runs twice,
  the second time with the recomputed value;
- ``ctx.<name> = <output>`` in ``forward``: an output held on ``ctx``
  forms the cycle output -> grad_fn -> ctx -> output, which only the
  cycle collector frees, and skips the version check that catches an
  in-place write between forward and backward. Outputs (and inputs)
  are saved with ``ctx.save_for_backward``.

Stores into local containers are fine (they die with the frame), and
constants are skipped. Attributes of ``ctx`` other than outputs
(shapes, flags, non-tensor config) are the documented use of ``ctx``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from tpushare_torch.analysis.callgraph import STORE_METHODS
from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import assigned_names, dotted
from tpushare_torch.analysis.rules.tracer_safety import (TRACER_PATHS,
                                                         autograd_roots)


def _root_name(node: ast.AST) -> str:
    """Base name of an attribute/subscript chain (``a.b[0].c`` -> a)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _is_constant(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_is_constant(e) for e in expr.elts)
    if isinstance(expr, ast.UnaryOp):
        return _is_constant(expr.operand)
    return False


def _returned_names(fn: ast.AST) -> Set[str]:
    """Names ``fn`` returns, directly or as elements of a tuple."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            out.update(assigned_names(node.value))
    return out


@register
class TensorEscape(Rule):
    id = "TE701"
    name = "tensor-escape"
    description = ("tensor from an autograd.Function's forward/backward "
                   "or a checkpointed function stored to self, a global "
                   "or a captured mutable (keeps the graph alive; runs "
                   "twice under recompute), or a forward output held on "
                   "ctx instead of ctx.save_for_backward (a reference "
                   "cycle, no version check)")
    paths = TRACER_PATHS
    family = "tensor-escape"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for root, label in autograd_roots(ctx.tree):
            if isinstance(root, ast.Lambda):
                continue  # lambda bodies cannot contain statements
            yield from self._check_root(ctx, root, label)

    def _check_root(self, ctx: FileContext, fn: ast.AST, label: str
                    ) -> Iterator[Finding]:
        args = fn.args
        params = [a.arg for a in args.posonlyargs + args.args
                  + args.kwonlyargs]
        global_names: Set[str] = set()
        local_names: Set[str] = set(params)
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                local_names.add(extra.arg)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                global_names.update(node.names)
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Store):
                local_names.add(node.id)
        local_names -= global_names
        ctx_name = params[0] if (label.endswith(".forward") and params
                                 and params[0] != "self") else None
        outputs = _returned_names(fn) if ctx_name else set()

        def escape_kind(target: ast.AST) -> str:
            base = _root_name(target)
            if isinstance(target, ast.Name):
                if target.id in global_names:
                    return f"the global {target.id!r}"
                if target.id not in local_names:
                    return f"the captured mutable {target.id!r}"
                return ""
            if base == "self":
                return f"{dotted(target) or 'self.<attr>'!r} on self"
            if base and base not in local_names:
                return f"the captured mutable {base!r}"
            return ""

        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if value is None or _is_constant(value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                flat = []
                stack = list(targets)
                while stack:
                    t = stack.pop()
                    if isinstance(t, (ast.Tuple, ast.List)):
                        stack.extend(t.elts)
                    elif isinstance(t, ast.Starred):
                        stack.append(t.value)
                    else:
                        flat.append(t)
                for t in flat:
                    where = escape_kind(t)
                    if where:
                        yield ctx.finding(
                            self.id, node,
                            f"tensor stored to {where} inside {label} — "
                            f"it outlives the step and keeps its graph "
                            f"alive")
                    elif (ctx_name and isinstance(t, ast.Attribute)
                          and isinstance(t.value, ast.Name)
                          and t.value.id == ctx_name
                          and isinstance(value, ast.Name)
                          and value.id in outputs):
                        yield ctx.finding(
                            self.id, node,
                            f"forward output {value.id!r} held as "
                            f"{ctx_name}.{t.attr} in {label} — a "
                            f"reference cycle with no version check; "
                            f"use {ctx_name}.save_for_backward")
            elif isinstance(node, ast.Call):
                func = node.func
                if not (isinstance(func, ast.Attribute)
                        and func.attr in STORE_METHODS):
                    continue
                if node.args and all(_is_constant(a) for a in node.args):
                    continue
                where = escape_kind(func.value)
                if where:
                    yield ctx.finding(
                        self.id, node,
                        f".{func.attr}() onto {where} inside {label} "
                        f"keeps a tensor past the step")
