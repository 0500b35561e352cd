"""JC801: a kernel built or loaded per call (models/, ops/, parallel/).

The JAX package's recompile rule guards the most expensive host-side
event of its serving loop, a jit handle rebuilt per tick. The port's
counterpart is the kernel build: ``ops/_build.py`` compiles each
``csrc/*.cu`` with ``nvcc`` once and keeps the ``ctypes`` library in a
module-level table, so a wrapper's launch costs a dictionary lookup.
A wrapper that reaches the build itself — ``ctypes.CDLL`` of the
library, ``torch.utils.cpp_extension.load``/``load_inline``,
``triton.compile``, or a ``@triton.jit`` kernel defined inside the
launching function — re-opens, re-hashes or recompiles on every call:
milliseconds to minutes per launch, silent on the CPU where no kernel
is built.

A build site is memoized, and not a finding, when its function is
``functools.lru_cache``/``cache``-decorated, or when the function keeps
the result in a module-level table (``_libs[name] = lib``), a
``global`` or an attribute of ``self``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import (assigned_names, dotted,
                                                 last_component)
from tpushare_torch.analysis.rules.tracer_safety import TRACER_PATHS

_MEMO_DECORATORS = {"lru_cache", "cache"}


def build_call(call: ast.Call) -> Optional[str]:
    """The spelling of a kernel build/load call, else None."""
    name = dotted(call.func) or ""
    leaf = last_component(name)
    if name in ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "CDLL"):
        return name
    if leaf in ("load", "load_inline") and "cpp_extension" in name:
        return name
    if name in ("load_inline", "triton.compile"):
        return name
    return None


def _is_triton_kernel(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted(target) or ""
        if name in ("triton.jit", "triton.autotune"):
            return True
    return False


def _is_memoized(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if last_component(dotted(target)) in _MEMO_DECORATORS:
            return True
    return False


def _module_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                out.update(assigned_names(t))
    return out


def _keeps(fn: ast.AST, value_names: Set[str], call: ast.Call,
           module_names: Set[str]) -> bool:
    """True when ``fn`` stores the build's result (the call itself or a
    name bound to it) where a later call finds it."""
    globals_: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            globals_.update(node.names)
    for node in ast.walk(fn):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not (value is call or (isinstance(value, ast.Name)
                                  and value.id in value_names)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id in module_names):
                return True
            if isinstance(t, ast.Name) and t.id in globals_:
                return True
            if (isinstance(t, ast.Attribute)
                    and (dotted(t) or "").startswith("self.")):
                return True
    return False


@register
class KernelBuildPerCall(Rule):
    id = "JC801"
    name = "kernel-build-per-call"
    family = "kernel-build"
    description = ("a kernel library loaded or compiled (ctypes.CDLL, "
                   "cpp_extension.load/load_inline, triton.compile, a "
                   "@triton.jit def inside the launcher) in a function "
                   "that neither is memoized nor keeps the result — "
                   "rebuilt on every launch; load through "
                   "ops/_build.load")
    paths = TRACER_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        module_names = _module_names(ctx.tree)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _is_memoized(fn):
                continue
            for node in self._own_nodes(fn):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    if _is_triton_kernel(node):
                        yield ctx.finding(
                            self.id, node,
                            f"@triton.jit kernel {node.name!r} defined "
                            f"inside {fn.name}() — a fresh kernel object "
                            f"(and compile) per call; define it at "
                            f"module level or memoize {fn.name}()")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                what = build_call(node)
                if what is None:
                    continue
                bound: Set[str] = set()
                for stmt in ast.walk(fn):
                    if isinstance(stmt, ast.Assign) and stmt.value is node:
                        for t in stmt.targets:
                            bound.update(assigned_names(t))
                if _keeps(fn, bound, node, module_names):
                    continue
                yield ctx.finding(
                    self.id, node,
                    f"{what}() in {fn.name}() runs on every call — the "
                    f"library is reopened (or rebuilt) per launch; keep "
                    f"it in a module-level table or memoize {fn.name}()")

    @staticmethod
    def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
        """Nodes of ``fn``'s own body; nested defs are yielded but not
        entered (their own walk judges their calls)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
