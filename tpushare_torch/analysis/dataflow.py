"""Flow-sensitive dataflow layer: def-use chains over an abstract lattice.

The call graph's summaries are flow-insensitive: they know THAT a
function copies or syncs, not in which order along which path. Some
faults are pure value flow — a host buffer read while the
``non_blocking`` copy that fills it may still be in flight (DN601) — so
this module adds the half the call graph cannot express: per-function
def-use chains over a small abstract-value lattice, walked
path-sensitively.

The lattice (``Value``) carries origin-tagged abstract values. Each
rule family's ``Domain`` owns its tags (DN601: ``pinned`` and
``inflight``); the walker owns one of its own:

- ``alias``    — a plain name-to-name binding; state updates apply at
  the alias root, so a fact about ``b`` after ``b = a`` is a fact about
  ``a``.

Facts survive assignment, tuple unpacking, attribute stores on
``self`` (places like ``"self._buf"``), and ONE level of container
put/get (cells like ``"bufs[0]"``; a non-constant index deliberately
yields an untracked value rather than a guessed cell). Branches fork
the environment and join per-place (``Domain.join``); loops run two
passes so an iteration-1 fact reaches iteration 2; findings dedupe on
(rule, line, col) so re-visited paths report once.

Resolvability: a function using ``global``/``nonlocal`` can rebind
locals behind the walker's back, so ``resolvable()`` is False there
and the rules built on this engine decline the function.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Value", "Env", "Domain", "FlowWalker", "resolvable",
    "iter_functions",
]


# NOTE: these two mirror rules/_util.dotted/last_component on purpose
# — importing the rules package from here would be circular (the rule
# modules import this one).

def dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_component(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


# ---------------------------------------------------------------------------
# The lattice
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Value:
    """One abstract value. ``data`` is tag-specific payload (origin
    lines, the alias root place)."""
    tag: str
    state: str = ""
    line: int = 0
    data: Tuple = ()


def resolvable(fn: ast.AST) -> bool:
    """True when the flow engine models this function soundly.
    ``global``/``nonlocal`` (anywhere in the body, nested defs
    included) can rebind names behind the walker's back, so those
    functions are declined."""
    return not any(isinstance(n, (ast.Global, ast.Nonlocal))
                   for n in ast.walk(fn))


def iter_functions(tree: ast.Module):
    """(class_name_or_None, function_node) for EVERY def in the file,
    nested ones included — each is analyzed as its own scope (closures
    run later; their captured state is not this frame's)."""
    def walk(node, cls_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls_name, child
                yield from walk(child, None)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            else:
                yield from walk(child, cls_name)
    yield from walk(tree, None)


# ---------------------------------------------------------------------------
# Environment: places -> abstract values
# ---------------------------------------------------------------------------

class Env:
    """Maps *places* to Values. A place is a local name (``"buf"``),
    a self attribute (``"self._buf"``), or a one-level container cell
    (``"bufs[0]"``). Rebinding a base name drops its cells.
    ``terminated`` marks a path that left this suite — ``"frame"``
    for return/raise (the function is over), ``"loop"`` for
    break/continue (only the current loop pass is over) — so a
    terminated branch contributes nothing to a join
    (``if x: return buf.tolist()`` does not poison the fall-through
    path), and a frame-terminating loop body does not leak its
    effects into the zero-iteration fall-through."""

    __slots__ = ("v", "terminated")

    def __init__(self, v: Optional[Dict[str, Value]] = None):
        self.v: Dict[str, Value] = dict(v or {})
        self.terminated = False

    def copy(self) -> "Env":
        return Env(self.v)

    def get(self, place: str) -> Optional[Value]:
        return self.v.get(place)

    def bind(self, place: str, value: Optional[Value]) -> None:
        """STATE-UPDATE bind: the place keeps denoting the same
        abstract object, only its state changes — aliases pointing
        here stay live (a copy into ``buf`` must be visible through
        ``b0 = buf``). Domains use this."""
        prefix = place + "["
        for cell in [c for c in self.v if c.startswith(prefix)]:
            del self.v[cell]
        if value is None:
            self.v.pop(place, None)
        else:
            self.v[place] = value

    def rebind(self, place: str, value: Optional[Value]) -> None:
        """ASSIGNMENT bind: the place now denotes a DIFFERENT object.
        Aliases pointing at it are severed first — each direct alias
        materializes the root's old value, so ``b0 = buf; buf =
        torch.empty_like(buf)`` leaves ``b0`` denoting the ORIGINAL
        buffer, not the rebound one. The walker uses this for assignment targets."""
        old = self.v.get(place)
        for k, v in list(self.v.items()):
            if v.tag == "alias" and v.data and v.data[0] == place:
                if old is None:
                    del self.v[k]
                else:
                    self.v[k] = old
        self.bind(place, value)

    def resolve(self, place: str) -> Tuple[str, Optional[Value]]:
        """Follow alias links to the root place; returns (root, value
        at root)."""
        seen: Set[str] = set()
        while place not in seen:
            seen.add(place)
            val = self.v.get(place)
            if val is not None and val.tag == "alias" and val.data:
                place = val.data[0]
                continue
            return place, val
        return place, self.v.get(place)


# ---------------------------------------------------------------------------
# Domain: the per-rule-family transfer functions
# ---------------------------------------------------------------------------

class Domain:
    """Transfer functions + finding sink for one rule family. The
    walker owns control flow and source-ordered expression events; the
    domain owns what the events mean."""

    def __init__(self, rule, ctx, facts=None, index=None,
                 class_name: Optional[str] = None):
        self.rule = rule
        self.ctx = ctx
        self.facts = facts          # FuncFacts of the walked function
        self.index = index          # ProjectIndex
        self.class_name = class_name
        self.findings: List = []
        self._emitted: Set[Tuple[str, int, int]] = set()

    # -- findings ----------------------------------------------------------
    def emit(self, rule_id: str, node, message: str) -> None:
        key = (rule_id, getattr(node, "lineno", 0),
               getattr(node, "col_offset", 0))
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.findings.append(self.ctx.finding(rule_id, node, message))

    # -- hooks (defaults are no-ops) ---------------------------------------
    def enter(self, env: Env, fn: ast.AST) -> None:
        pass

    def on_call(self, env: Env, call: ast.Call,
                walker: "FlowWalker") -> Optional[Value]:
        return None

    def on_load(self, env: Env, node: ast.Name) -> None:
        pass

    def on_attr_load(self, env: Env, place: str, node: ast.AST) -> None:
        pass

    def element_of(self, env: Env, container: Optional[Value],
                   index) -> Optional[Value]:
        """Value of ``container[index]`` for a constant index with no
        bound cell yet."""
        return None

    def iter_element(self, env: Env, container: Optional[Value]
                     ) -> Optional[Value]:
        """Value bound to a ``for`` target iterating ``container``."""
        return None

    def join(self, a: Optional[Value], b: Optional[Value]
             ) -> Optional[Value]:
        """Per-place join of two branch environments."""
        if a == b:
            return a
        return None


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------

class FlowWalker:
    """Path-forking abstract interpreter over ONE function body.
    Control flow: If forks and joins; For/While run the body twice
    (loop-carried facts reach the second pass; loop targets re-bind
    fresh each pass); Try walks handlers on forked copies and joins
    their may-effects; nested defs/lambdas are separate scopes and are
    skipped."""

    def __init__(self, domain: Domain):
        self.domain = domain
        self._values: Dict[int, Optional[Value]] = {}

    def run(self, fn: ast.AST) -> List:
        env = Env()
        self.domain.enter(env, fn)
        self._stmts(fn.body, env)
        return self.domain.findings

    # -- statements --------------------------------------------------------
    def _stmts(self, stmts: Sequence[ast.stmt], env: Env) -> None:
        for stmt in stmts:
            if env.terminated:
                return  # dead code past return/raise/break/continue
            self._stmt(stmt, env)

    def _stmt(self, stmt: ast.stmt, env: Env) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, env)
            env_t, env_f = env.copy(), env.copy()
            self._stmts(stmt.body, env_t)
            self._stmts(stmt.orelse, env_f)
            # a terminated arm contributes nothing to the join
            if env_t.terminated and env_f.terminated:
                # break/continue is the weaker termination: a "loop"
                # arm still reaches the loop's continuation, a "frame"
                # arm (return/raise) reaches nothing — so the state
                # that flows on is the LOOP arm's, never the frame
                # arm's (a return-arm draw must not poison the state
                # past a sibling break).
                kinds = (env_t.terminated, env_f.terminated)
                if kinds == ("loop", "loop"):
                    env.v = self._join(env_t, env_f).v
                elif env_t.terminated == "loop":
                    env.v = env_t.v
                elif env_f.terminated == "loop":
                    env.v = env_f.v
                else:          # both frame: nothing continues anyway
                    env.v = env_t.v
                env.terminated = ("loop" if "loop" in kinds else "frame")
            elif env_t.terminated:
                env.v = env_f.v
            elif env_f.terminated:
                env.v = env_t.v
            else:
                env.v = self._join(env_t, env_f).v
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, env)
            it_val = self.value_of(env, stmt.iter)
            pre = env.copy()
            for _pass in range(2):
                elem = self.domain.iter_element(env, it_val)
                self._bind_target(env, stmt.target, elem, None)
                self._stmts(stmt.body, env)
                if self._loop_pass_done(env, pre):
                    break
            self._stmts(stmt.orelse, env)
            return
        if isinstance(stmt, ast.While):
            pre = env.copy()
            for _pass in range(2):
                self._expr(stmt.test, env)
                self._stmts(stmt.body, env)
                if self._loop_pass_done(env, pre):
                    break
            self._stmts(stmt.orelse, env)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind_target(env, item.optional_vars,
                                      self.value_of(env, item.context_expr),
                                      item.context_expr)
            self._stmts(stmt.body, env)
            return
        if isinstance(stmt, ast.Try):
            # Handlers run after ANY prefix of the body — including
            # none of it (the first statement raised). Walking them
            # from the post-body env would make the idiomatic
            # fallback (try: return draw(k) / except: draw(k)) look
            # like a double consumption; the pre-body env is the
            # low-noise approximation (a mid-body raise after real
            # consumption is under-reported — documented limit).
            pre = env.copy()
            self._stmts(stmt.body, env)
            branches = [env] if not env.terminated else []
            for h in stmt.handlers:
                henv = pre.copy()
                self._stmts(h.body, henv)
                if not henv.terminated:
                    branches.append(henv)
            if branches:
                joined = branches[0]
                for b in branches[1:]:
                    joined = self._join(joined, b)
                env.v = joined.v
                env.terminated = False
            else:
                env.terminated = "frame"
            # orelse runs only when the body completed (the terminated
            # guard in _stmts is correct for it); finally runs on
            # EVERY path, including the all-paths-terminated one.
            self._stmts(stmt.orelse, env)
            term = env.terminated
            env.terminated = False
            self._stmts(stmt.finalbody, env)
            env.terminated = env.terminated or term
            return
        if isinstance(stmt, (ast.Break, ast.Continue)):
            env.terminated = "loop"
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            if value is not None:
                self._expr(value, env)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            v = self.value_of(env, value) if value is not None else None
            for t in targets:
                self._bind_target(env, t, v, value)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, env)
            if isinstance(stmt.target, ast.Name):
                # the target is read-then-rebound
                self.domain.on_load(env, stmt.target)
                env.rebind(stmt.target.id, None)
            return
        if isinstance(stmt, (ast.Return, ast.Expr, ast.Raise, ast.Assert,
                             ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, env)
            if isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        env.rebind(t.id, None)
            if isinstance(stmt, (ast.Return, ast.Raise)):
                env.terminated = "frame"
            return
        # fallback: visit expression children in order, recurse stmts
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, env)
            elif isinstance(child, ast.stmt):
                self._stmt(child, env)

    @staticmethod
    def _loop_pass_done(env: Env, pre: Env) -> bool:
        """Handle a loop-body pass that terminated on EVERY path.
        ``frame`` (all paths return/raise): the only way past the loop
        is zero iterations, so the fall-through continues from the
        pre-loop env and no second pass runs. ``loop`` (unconditional
        break/continue): the body runs at most once, so the post-body
        env continues and no second pass runs. Returns True when the
        pass loop should stop."""
        if env.terminated == "frame":
            env.v = dict(pre.v)
            env.terminated = False
            return True
        if env.terminated == "loop":
            env.terminated = False
            return True
        return False

    def _join(self, a: Env, b: Env) -> Env:
        out: Dict[str, Value] = {}
        for place in set(a.v) | set(b.v):
            v = self.domain.join(a.v.get(place), b.v.get(place))
            if v is not None:
                out[place] = v
        return Env(out)

    # -- targets -----------------------------------------------------------
    def _bind_target(self, env: Env, target: ast.AST,
                     value: Optional[Value],
                     value_expr: Optional[ast.AST]) -> None:
        if isinstance(target, ast.Name):
            # Alias sources: a plain name, or a tracked self-attr place
            # (``buf = self._buf``).
            src: Optional[str] = None
            if isinstance(value_expr, ast.Name):
                src = value_expr.id
            elif isinstance(value_expr, ast.Attribute):
                src = self._self_place(value_expr)
            if src is not None and (value is None
                                    or value.tag != "alias"):
                root, _ = env.resolve(src)
                if root != target.id:
                    env.rebind(target.id, Value("alias", data=(root,)))
                    return
            env.rebind(target.id, value)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            sub_exprs: List[Optional[ast.AST]] = [None] * len(elts)
            sub_vals: List[Optional[Value]] = [None] * len(elts)
            if isinstance(value_expr, (ast.Tuple, ast.List)) \
                    and len(value_expr.elts) == len(elts):
                sub_exprs = list(value_expr.elts)
                sub_vals = [self.value_of(env, e) for e in value_expr.elts]
            elif value is not None:
                unpacked = self.domain.iter_element(env, value)
                sub_vals = [unpacked] * len(elts)
            for t, sv, se in zip(elts, sub_vals, sub_exprs):
                if isinstance(t, ast.Starred):
                    t = t.value
                self._bind_target(env, t, sv, se)
            return
        if isinstance(target, ast.Attribute):
            place = self._self_place(target)
            if place is not None:
                env.rebind(place, value)
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Name):
                if isinstance(target.slice, ast.Constant):
                    env.rebind(f"{base.id}[{target.slice.value!r}]", value)
                else:
                    # unknown cell: drop every tracked cell of the base
                    env.bind(base.id, env.get(base.id))
            return
        if isinstance(target, ast.Starred):
            self._bind_target(env, target.value, None, None)

    @staticmethod
    def _self_place(node: ast.AST) -> Optional[str]:
        name = dotted(node)
        if name and name.startswith("self.") and name.count(".") == 1:
            return name
        return None

    # -- expressions: source-ordered events --------------------------------
    def _expr(self, expr: ast.expr, env: Env) -> None:
        events: List[Tuple[Tuple[int, int, int], ast.AST]] = []
        func_roots: Set[int] = set()

        def collect(node: ast.AST) -> None:
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                return  # separate scope
            if isinstance(node, ast.Call):
                # Calls fire at their END position: arguments are read
                # (and their loads flagged) before the call's effects
                # (a copy, a synchronize) apply.
                end = (getattr(node, "end_lineno", node.lineno) or
                       node.lineno,
                       getattr(node, "end_col_offset", node.col_offset)
                       or node.col_offset)
                events.append(((end[0], end[1], 1), node))
                # A PLAIN-Name callee (`f(x)`) is a function-value
                # load, not a data read — suppress it. The root of an
                # ATTRIBUTE-chain callee (`buf.tolist()`) IS a data
                # read of that object and must reach on_load.
                if isinstance(node.func, ast.Name):
                    func_roots.add(id(node.func))
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                events.append(((node.lineno, node.col_offset, 0), node))
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                place = self._self_place(node)
                if place is not None:
                    events.append(((node.lineno, node.col_offset, 0),
                                   node))
            for child in ast.iter_child_nodes(node):
                collect(child)

        collect(expr)
        events.sort(key=lambda e: e[0])
        for _pos, node in events:
            if isinstance(node, ast.Call):
                self._values[id(node)] = self.domain.on_call(env, node,
                                                             self)
            elif isinstance(node, ast.Name):
                if id(node) not in func_roots:
                    self.domain.on_load(env, node)
            else:  # self.<attr> load
                place = self._self_place(node)
                if place:
                    self.domain.on_attr_load(env, place, node)

    # -- abstract evaluation ----------------------------------------------
    def value_of(self, env: Env, expr: Optional[ast.AST]
                 ) -> Optional[Value]:
        if expr is None:
            return None
        if isinstance(expr, ast.Constant):
            return Value("const")
        if isinstance(expr, ast.Name):
            _, v = env.resolve(expr.id)
            return v
        if isinstance(expr, ast.Call):
            return self._values.get(id(expr))
        if isinstance(expr, ast.Attribute):
            place = self._self_place(expr)
            return env.get(place) if place else None
        if isinstance(expr, ast.Subscript):
            base = expr.value
            if isinstance(base, ast.Name):
                if isinstance(expr.slice, ast.Constant):
                    cell = f"{base.id}[{expr.slice.value!r}]"
                    hit = env.get(cell)
                    if hit is not None:
                        return hit
                    _, container = env.resolve(base.id)
                    v = self.domain.element_of(env, container,
                                               expr.slice.value)
                    if v is not None:
                        env.bind(cell, v)
                    return v
            return None
        if isinstance(expr, ast.IfExp):
            return self.domain.join(self.value_of(env, expr.body),
                                    self.value_of(env, expr.orelse))
        if isinstance(expr, ast.Starred):
            return self.value_of(env, expr.value)
        return None
