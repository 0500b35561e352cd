"""Inter-procedural layer: project call graph + per-function summaries.

Per-file rules are strictly intra-function, and the bugs that escape
that scope have to be caught by hand: an orphaned ACTIVE slot leaking
capacity forever, a helper three frames below ``step()`` quietly
``.tolist()``-ing every tick, lock-order hazards between the engine
loop, the supervisor, and the HTTP handlers. All of those are *inter-procedural* properties, so
this module builds what the per-file engine cannot see:

- a **call graph** over every module function and method in the
  project, with ``self``-type heuristics for the serving/plugin
  classes (``self.srv``-style attrs resolved through their
  ``__init__`` assignments, plus a duck fallback onto the
  ``*SlotServer`` family for the known adapter seams);
- **per-function summaries** — directly syncs host, acquires/releases
  which locks, may raise, releases/stores which parameters — and a
  fixpoint that propagates them over call chains;
- a per-file **mtime cache** of the extracted facts so the whole-tree
  tier-1 gate re-pays parsing only for files that actually changed.

Resolution is heuristic by design (no type inference): bare names
resolve to same-module functions and project ``from``-imports, and
``self.attr.m()`` to the classes ``attr`` is assigned from in
``__init__``. Dynamic dispatch, ``getattr``, decorators that swap the
callee, and callables passed as values stay unresolved — summaries
treat unresolved calls as silent (no sync, no raise), which is the
low-noise direction for a linter.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tpushare_torch.analysis.engine import relativize

#: with/acquire targets whose leaf looks like a lock even when the
#: assignment from a Lock factory is not in view
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}
#: factories whose locks are reentrant: re-acquiring while held is
#: legal, so they never produce a self-edge in the lock-order graph
REENTRANT_FACTORIES = {"RLock", "Condition"}

#: the host-sync vocabulary — THE single home; rules/tracer_safety.py
#: imports these so TS101/TS103/TS104 can never drift apart. These are
#: PyTorch's spellings of a device->host wait:
#: - methods: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, and
#:   ``.synchronize()`` (``torch.cuda.synchronize``, ``Event`` and
#:   ``Stream.synchronize``);
#: - ``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``
#:   without ``non_blocking=True`` (``is_host_copy``; a non_blocking copy
#:   into pinned memory is not a wait — reading its result before the
#:   copy is done is DN601's business);
#: - ``float()`` / ``int()`` / ``bool()`` of a tensor expression
#:   (``is_tensor_scalar_cast``: statically, a cast of a tensor method's
#:   or a ``torch.*`` call's result);
#: - the port's multi-host fetch wrappers, host syncs by contract.
#: (``torch.as_tensor`` / ``.to(device)`` host->device is asynchronous
#: and deliberately absent; ``np.asarray`` of a CUDA tensor raises rather
#: than syncs, and of a host tensor reads host memory.)
SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_CALLS = {"addressable_fetch", "host_scalar",
              "multihost.addressable_fetch", "multihost.host_scalar"}
#: tensor methods whose result, cast by float()/int()/bool(), is a
#: device value read on the host
TENSOR_RESULT_METHODS = {"sum", "mean", "max", "min", "amax", "amin",
                         "argmax", "argmin", "any", "all", "norm",
                         "count_nonzero", "prod", "abs", "std", "var"}


def _is_host_device(node: ast.AST) -> bool:
    """``"cpu"`` / ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and _leaf(_dotted(node.func)) == "device" and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking"
               and not (isinstance(kw.value, ast.Constant)
                        and not kw.value.value)
               for kw in call.keywords)


def is_host_copy(call: ast.Call) -> bool:
    """``x.to("cpu")`` (or ``device="cpu"``) — a blocking copy to the
    host unless ``non_blocking`` is passed."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "to"):
        return False
    dev = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "device"), None)
    return dev is not None and _is_host_device(dev) and \
        not _non_blocking(call)


def is_tensor_scalar_cast(call: ast.Call) -> bool:
    """``float(t.sum())`` / ``int(torch.argmax(x))`` / ``bool(t.any())``:
    a Python scalar made from a tensor expression."""
    if not (isinstance(call.func, ast.Name)
            and call.func.id in ("float", "int", "bool")
            and len(call.args) == 1):
        return False
    arg = call.args[0]
    if not isinstance(arg, ast.Call):
        return False
    name = _dotted(arg.func) or ""
    if name.startswith("torch."):
        return True
    return (isinstance(arg.func, ast.Attribute)
            and arg.func.attr in TENSOR_RESULT_METHODS)


def sync_desc(call: ast.Call) -> Optional[str]:
    """How ``call`` waits on the device, or None: THE one matcher over
    the vocabulary above (summaries and the TS rules all call it)."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in SYNC_ATTRS:
        if func.attr == "cpu" and _non_blocking(call):
            return None
        return f".{func.attr}()"
    if is_host_copy(call):
        return '.to("cpu")'
    if is_tensor_scalar_cast(call):
        return f"{call.func.id}() of a tensor"
    name = _dotted(func)
    if name in SYNC_CALLS:
        return f"{name}()"
    return None

#: resource vocabulary for the RL rules: kind -> (acquire leaf names,
#: release leaf names). Slot activation and pool-block allocation are
#: the two handle-shaped resources in the tree; chaos quarantine
#: entries move by pop-and-requeue (ownership transfer), which the
#: param_store summary models instead.
RESOURCE_KINDS: Dict[str, Tuple[Set[str], Set[str]]] = {
    "slot": ({"admit", "admit_start"},
             {"evict", "_safe_evict", "release"}),
    "blocks": ({"alloc_blocks"},
               {"_unref", "free_blocks", "release"}),
}

ALL_RELEASE_NAMES: Set[str] = set()
for _acq, _rel in RESOURCE_KINDS.values():
    ALL_RELEASE_NAMES |= _rel

#: container methods that take ownership of an argument
STORE_METHODS = {"append", "appendleft", "add", "insert", "put",
                 "put_nowait", "setdefault", "extend"}

#: container methods that MUTATE their receiver — ``self.x.append(v)``
#: is a write to the field ``x`` for the thread-ownership layer, even
#: though the attribute itself is only read
MUTATING_METHODS = STORE_METHODS | {
    "pop", "popitem", "popleft", "clear", "update", "remove",
    "discard", "extendleft", "sort"}

#: machine-readable ownership declarations (tpushare_torch/analysis/threads.py
#: consumes these): trailing comments on a ``self.X = ...`` assignment
#: (``# tpushare: owner[engine]`` / ``# tpushare: lock[_durable_lock]``)
#: and on a ``def`` line (``# tpushare: reader`` marks a sanctioned
#: lock-free cross-role reader that copies atomically).
_DECL_RE = re.compile(r"#\s*tpushare:\s*(owner|lock)\[([A-Za-z_][\w.\-]*)\]")
_READER_RE = re.compile(r"#\s*tpushare:\s*reader\b")

#: module-level registry name for cross-class ownership contracts
OWNERSHIP_REGISTRY_NAME = "TPUSHARE_OWNERSHIP"

#: attr names duck-typed onto the *SlotServer family when __init__
#: gives no assignment to resolve them (the ServeEngine/_MoEServerAdapter
#: seams: self.srv / self._inner hold whichever server the config chose)
DUCK_SERVER_ATTRS = {"srv", "_inner", "inner", "server"}
DUCK_CLASS_SUFFIX = "SlotServer"


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


@dataclasses.dataclass
class CallFact:
    """One call site inside a function body."""
    line: int
    col: int
    kind: str                 # bare | self | selfattr | attr | module
    data: Tuple[str, ...]     # kind-specific: ("name",) / ("attr","meth")
    guarded: bool             # inside a try that has except handlers
    locks_held: Tuple[str, ...]
    arg_names: Tuple[Tuple[int, str], ...]   # positional Name args
    #: resolved callee quals, filled by ProjectIndex.link()
    resolved: Tuple[str, ...] = ()


@dataclasses.dataclass
class SyncSite:
    line: int
    col: int
    desc: str                 # e.g. ".item()"


@dataclasses.dataclass
class DictKeyFact:
    """What one dict key is assigned, summarized for the wire layer.

    ``kind`` is the shape of the value expression: ``const`` (only
    constants observed), ``call`` (a call whose site joins back to the
    CallFact at the same (line, col) — resolution happens at link
    time, through ``CallFact.resolved``), ``dict`` (an inline literal
    or comprehension, summarized in ``nested``), ``attr`` (a plain
    ``self.X`` read, attr name in ``hint``), or ``other``. ``consts``
    keeps every constant observed across merged productions (IfExp
    arms, or-fallbacks, re-assignment) so null-vs-zero contracts stay
    checkable; ``nullable`` means a constant ``None`` was one of them.
    ``conditional`` means every production sits under some branch —
    the key may be absent entirely."""
    line: int
    col: int
    kind: str = "other"
    consts: Tuple = ()
    call_site: Optional[Tuple[int, int]] = None
    nullable: bool = False
    conditional: bool = False
    #: builtin-call type hint ("round"/"len"/...) or attr name for
    #: ``kind == "attr"``
    hint: str = ""
    nested: Optional["DictShape"] = None


@dataclasses.dataclass
class DictShape:
    """A dict value assembled in one function body: literal keys,
    spread sources (``dict(self.X)`` / ``out.update(...)``), and an
    optional ``dynamic`` summary for comprehension-style maps whose
    keys are not constants. ``open`` means some contribution could not
    be modeled — consumers must treat membership as unknown."""
    line: int
    keys: Dict[str, DictKeyFact] = dataclasses.field(default_factory=dict)
    #: ("selfattr", attr) — merged from the owning class's attr_dicts
    #: at resolution time
    spreads: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    dynamic: Optional[DictKeyFact] = None
    open: bool = False


@dataclasses.dataclass
class FuncFacts:
    qual: str                 # "relpath::Class.meth" / "relpath::func"
    relpath: str
    name: str
    class_name: Optional[str]
    line: int
    params: Tuple[str, ...]
    calls: List[CallFact] = dataclasses.field(default_factory=list)
    syncs: List[SyncSite] = dataclasses.field(default_factory=list)
    direct_raise: bool = False
    #: (lock_id, line, col) for every direct acquisition
    lock_acquires: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)
    #: (held_id, acquired_id, line, col) for directly nested with-blocks
    lock_edges: List[Tuple[str, str, int, int]] = dataclasses.field(
        default_factory=list)
    #: names this function stores into a container/attr, returns,
    #: yields, or hands to a store-method — ownership leaves the frame
    stored_names: Set[str] = dataclasses.field(default_factory=set)
    #: names passed to a release-vocabulary call
    released_names: Set[str] = dataclasses.field(default_factory=set)
    # -- dict-shape summary (the wire-contract layer) -----------------
    #: one DictShape per ``return <dict-ish>`` statement; the wire
    #: layer unions them (a key present in some returns only is
    #: conditional)
    returned_dicts: List[DictShape] = dataclasses.field(
        default_factory=list)
    #: (line, col) of each ``return self.<meth>(...)``: the wire layer
    #: takes that method's dict shapes as this function's own
    returned_self_calls: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    #: True when some return yields a constant ``None`` (incl. bare
    #: ``return`` and IfExp arms) — callee-level nullability
    returns_none: bool = False
    # -- field-effect summary (the thread-ownership layer) ------------
    #: (attr, line, col, locks_held) for every ``self.<attr>`` load
    attr_reads: List[Tuple[str, int, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: (attr, line, col, locks_held) for every ``self.<attr>`` store:
    #: plain/aug/subscript assignment, ``del``, or a mutating container
    #: method call on the attribute
    attr_writes: List[Tuple[str, int, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: (name, line, col, locks_held) for stores to ``global``-declared
    #: module names
    global_writes: List[Tuple[str, int, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: self-method names handed to ``threading.Thread(target=self.X)``
    #: in this body — thread-role inference roots
    thread_targets: List[str] = dataclasses.field(default_factory=list)
    # -- fixpoint results (ProjectIndex.link) -------------------------
    may_raise: bool = False
    trans_locks: Set[str] = dataclasses.field(default_factory=set)
    param_release: Set[str] = dataclasses.field(default_factory=set)
    param_store: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ClassFacts:
    name: str
    relpath: str
    bases: Tuple[str, ...]
    methods: Dict[str, FuncFacts] = dataclasses.field(default_factory=dict)
    #: self.<attr> -> class names assigned to it (self.srv = Paged...(...))
    attr_types: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    #: self.<attr> = {literal} assignments anywhere in the class —
    #: the wire layer resolves ``dict(self._stats)`` spreads through
    #: this map; subscript stores onto the attr fold in as extra keys
    attr_dicts: Dict[str, DictShape] = dataclasses.field(
        default_factory=dict)
    #: self.<attr> = <constant> type names observed ("int"/"NoneType"/
    #: ...) — scalar type/nullability hints for wire ``attr`` values
    attr_scalars: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    #: lock attrs: attr -> factory name ("Lock"/"RLock"/...)
    lock_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attr -> owning role, from ``# tpushare: owner[role]`` comments
    field_owners: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attr -> lock attr, from ``# tpushare: lock[attr]`` comments
    field_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: methods declared ``# tpushare: reader`` — sanctioned lock-free
    #: cross-role readers (held to single-site atomic-copy reads)
    sanctioned_readers: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ModuleFacts:
    relpath: str
    functions: Dict[str, FuncFacts] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassFacts] = dataclasses.field(default_factory=dict)
    #: local name -> dotted module ("import tpushare_torch.k8s.watch as w")
    module_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: local name -> (dotted module, original name) for from-imports
    from_imports: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    #: module-level lock names -> factory name
    module_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: the literal ``TPUSHARE_OWNERSHIP`` registry dict, when the
    #: module declares one (cross-class contracts: extra owners,
    #: sanctioned readers, serialized role pairs)
    ownership_registry: Dict[str, object] = dataclasses.field(
        default_factory=dict)


# ---------------------------------------------------------------------------
# Per-file fact extraction (the cached, expensive half)
# ---------------------------------------------------------------------------

class _FuncVisitor:
    """Linear walk of one function body collecting CallFacts, sync
    sites, lock acquisitions, and ownership facts. Nested function
    defs/lambdas are skipped (their bodies run later, under unknown
    lock state — same conservatism as CC201)."""

    def __init__(self, facts: FuncFacts, mod: ModuleFacts,
                 cls: Optional[ClassFacts]):
        self.f = facts
        self.mod = mod
        self.cls = cls
        #: ``global``-declared names in this body (effect targets)
        self._globals: Set[str] = set()
        #: Attribute node ids already folded into a write effect (or a
        #: plain self-method call) — the generic load pass skips them
        self._skip_reads: Set[int] = set()

    def run(self, fn: ast.AST) -> None:
        # global declarations apply to the whole body regardless of
        # statement order, so collect them before the effect walk
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                self._globals.update(node.names)
        for stmt in fn.body:
            self._visit(stmt, locks=(), guarded=False)

    # -- field effects (the thread-ownership layer) -------------------
    def _self_attr(self, node: ast.AST) -> Optional[str]:
        """``self.X`` (exactly one level) -> ``X``, else None."""
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _effect_write(self, target: ast.AST, locks: Tuple[str, ...]
                      ) -> None:
        """Record the field/global write ``target`` names, if any."""
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        attr = self._self_attr(node)
        if attr is not None:
            self.f.attr_writes.append(
                (attr, node.lineno, node.col_offset, locks))
            self._skip_reads.add(id(node))
            return
        if (isinstance(node, ast.Name) and node.id in self._globals):
            self.f.global_writes.append(
                (node.id, node.lineno, node.col_offset, locks))

    # -- lock identity -----------------------------------------------------
    def _lock_id(self, expr: ast.AST) -> Optional[str]:
        name = _dotted(expr)
        if name is None:
            return None
        if name.startswith("self."):
            attr = name[len("self."):]
            known = self.cls is not None and attr in self.cls.lock_attrs
            if known or _lockish(attr):
                owner = self.cls.name if self.cls else "?"
                return f"{owner}.{attr}"
            return None
        if "." not in name:
            if name in self.mod.module_locks or _lockish(name):
                return f"{self.mod.relpath}::{name}"
        return None

    def _reentrant(self, lock_id: str) -> bool:
        if self.cls is not None:
            attr = lock_id.split(".", 1)[-1]
            if self.cls.lock_attrs.get(attr) in REENTRANT_FACTORIES:
                return True
        leaf = lock_id.rsplit("::", 1)[-1]
        return self.mod.module_locks.get(leaf) in REENTRANT_FACTORIES

    # -- the walk ----------------------------------------------------------
    def _visit(self, node: ast.AST, locks: Tuple[str, ...],
               guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = list(locks)
            for item in node.items:
                self._visit(item.context_expr, tuple(held), guarded)
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    self.f.lock_acquires.append(
                        (lid, item.context_expr.lineno,
                         item.context_expr.col_offset))
                    for h in held:
                        if h == lid and self._reentrant(lid):
                            continue
                        self.f.lock_edges.append(
                            (h, lid, item.context_expr.lineno,
                             item.context_expr.col_offset))
                    held.append(lid)
            for child in node.body:
                self._visit(child, tuple(held), guarded)
            return
        if isinstance(node, ast.Try):
            body_guarded = guarded or bool(node.handlers)
            for child in node.body:
                self._visit(child, locks, body_guarded)
            for h in node.handlers:
                for child in h.body:
                    self._visit(child, locks, guarded)
            for child in node.orelse + node.finalbody:
                self._visit(child, locks, guarded)
            return
        if isinstance(node, ast.Raise) and not guarded:
            # A raise inside a try that has handlers is presumed
            # locally handled (same conservatism as guarded calls):
            # counting it would mark every catch-and-recover helper
            # may-raise and flood RL4xx with false escapes.
            self.f.direct_raise = True
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            value = getattr(node, "value", None)
            self.f.stored_names.update(_top_names(value))
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = getattr(node, "value", None)
            if value is not None:       # bare ``self.x: T`` stores nothing
                for t in targets:
                    self._effect_write(t, locks)
            for t in targets:
                if isinstance(t, ast.Subscript):
                    # d[slot] = req: both the index and the value have
                    # been handed off to a container. Only TOP-LEVEL
                    # names count: returning/storing a value DERIVED
                    # from a handle (f(slot), slot + 1) does not move
                    # ownership of the handle itself.
                    self.f.stored_names.update(_top_names(t.slice))
                    self.f.stored_names.update(_top_names(value))
                elif isinstance(t, ast.Attribute):
                    self.f.stored_names.update(_top_names(value))
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._effect_write(t, locks)
        if isinstance(node, ast.Call):
            self._record_call(node, locks, guarded)
        if (isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and id(node) not in self._skip_reads):
            attr = self._self_attr(node)
            if attr is not None:
                self.f.attr_reads.append(
                    (attr, node.lineno, node.col_offset, locks))
        for child in ast.iter_child_nodes(node):
            self._visit(child, locks, guarded)

    def _record_call(self, call: ast.Call, locks: Tuple[str, ...],
                     guarded: bool) -> None:
        func = call.func
        name = _dotted(func)
        leaf = _leaf(name)
        # host-sync vocabulary (direct sites; TS104 reaches them
        # through the chain)
        desc = sync_desc(call)
        if desc is not None:
            self.f.syncs.append(SyncSite(call.lineno, call.col_offset,
                                         desc))
        # explicit lock.acquire()
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            lid = self._lock_id(func.value)
            if lid is not None:
                self.f.lock_acquires.append(
                    (lid, call.lineno, call.col_offset))
                for h in locks:
                    if not (h == lid and self._reentrant(lid)):
                        self.f.lock_edges.append(
                            (h, lid, call.lineno, call.col_offset))
        # ownership facts
        arg_names = tuple((i, a.id) for i, a in enumerate(call.args)
                          if isinstance(a, ast.Name))
        if leaf in ALL_RELEASE_NAMES:
            self.f.released_names.update(n for _, n in arg_names)
        if isinstance(func, ast.Attribute) and func.attr in STORE_METHODS:
            self.f.stored_names.update(n for _, n in arg_names)
        # field effects: self.x.append(v) mutates x; self.meth() is a
        # call, not a field read
        if isinstance(func, ast.Attribute):
            if self._self_attr(func) is not None:
                self._skip_reads.add(id(func))
            elif func.attr in MUTATING_METHODS:
                recv = self._self_attr(func.value)
                if recv is not None:
                    self.f.attr_writes.append(
                        (recv, func.value.lineno,
                         func.value.col_offset, locks))
                    self._skip_reads.add(id(func.value))
        # thread-role roots: threading.Thread(target=self.X)
        if leaf == "Thread":
            for kw in call.keywords:
                if kw.arg != "target":
                    continue
                tname = _dotted(kw.value)
                if (tname and tname.startswith("self.")
                        and tname.count(".") == 1):
                    self.f.thread_targets.append(tname[len("self."):])
        # callee classification
        kind_data = self._classify(func)
        if kind_data is not None:
            kind, data = kind_data
            self.f.calls.append(CallFact(
                line=call.lineno, col=call.col_offset, kind=kind,
                data=data, guarded=guarded, locks_held=locks,
                arg_names=arg_names))

    def _classify(self, func: ast.AST
                  ) -> Optional[Tuple[str, Tuple[str, ...]]]:
        if isinstance(func, ast.Name):
            return "bare", (func.id,)
        name = _dotted(func)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] == "self":
            if len(parts) == 2:
                return "self", (parts[1],)
            return "selfattr", (parts[1], parts[-1])
        if parts[0] in self.mod.module_aliases:
            return "module", (self.mod.module_aliases[parts[0]],
                              parts[-1])
        if len(parts) >= 2:
            return "attr", (parts[0], parts[-1])
        return None


def _lockish(attr: str) -> bool:
    leaf = attr.rsplit(".", 1)[-1].lower()
    return "lock" in leaf or "cond" in leaf or "mutex" in leaf


def _top_names(expr: Optional[ast.expr]) -> List[str]:
    """Top-level names of an expression: a bare Name, or the Name
    elements of a top-level Tuple. Derived values (calls, arithmetic)
    are excluded on purpose — they don't transfer handle ownership."""
    if isinstance(expr, ast.Name):
        return [expr.id]
    if isinstance(expr, ast.Tuple):
        return [e.id for e in expr.elts if isinstance(e, ast.Name)]
    return []


def _extract_function(node: ast.AST, mod: ModuleFacts,
                      cls: Optional[ClassFacts]) -> FuncFacts:
    qual = (f"{mod.relpath}::{cls.name}.{node.name}" if cls
            else f"{mod.relpath}::{node.name}")
    params = tuple(a.arg for a in node.args.args
                   if a.arg not in ("self", "cls"))
    facts = FuncFacts(qual=qual, relpath=mod.relpath, name=node.name,
                      class_name=cls.name if cls else None,
                      line=node.lineno, params=params)
    _FuncVisitor(facts, mod, cls).run(node)
    (facts.returned_dicts, facts.returned_self_calls,
     facts.returns_none) = _dict_shapes(node)
    return facts


# ---------------------------------------------------------------------------
# Dict-shape extraction (raw material for the wire-contract layer)
# ---------------------------------------------------------------------------

#: builtin calls whose return type is knowable without resolution
_BUILTIN_HINTS = {"round": "float", "len": "int", "int": "int",
                  "sum": "int", "float": "float", "str": "str",
                  "bool": "bool", "sorted": "list", "list": "list",
                  "tuple": "list", "min": "number", "max": "number"}

#: merge preference when the same key is produced twice with different
#: value shapes (IfExp arms, if/else updates)
_KIND_RANK = {"dict": 4, "call": 3, "attr": 2, "const": 1, "other": 0}


def _merge_key_facts(a: DictKeyFact, b: DictKeyFact) -> DictKeyFact:
    consts = list(a.consts)
    for c in b.consts:
        if not any(c is p or (type(c) is type(p) and c == p)
                   for p in consts):
            consts.append(c)
    kind = a.kind if _KIND_RANK[a.kind] >= _KIND_RANK[b.kind] else b.kind
    return DictKeyFact(
        line=a.line, col=a.col, kind=kind, consts=tuple(consts),
        call_site=a.call_site or b.call_site,
        nullable=a.nullable or b.nullable,
        # both productions conditional -> still conditional; an
        # unconditional production anywhere makes the key always
        # present (if/else pairs are NOT detected — documented limit)
        conditional=a.conditional and b.conditional,
        hint=a.hint or b.hint,
        nested=a.nested if a.nested is not None else b.nested)


def _classify_value(expr: ast.AST, env: Dict[str, DictShape],
                    envval: Dict[str, DictKeyFact]) -> DictKeyFact:
    """Summarize a dict-value expression into a DictKeyFact."""
    line = getattr(expr, "lineno", 0)
    col = getattr(expr, "col_offset", 0)
    if isinstance(expr, ast.Constant):
        try:
            hash(expr.value)
            consts: Tuple = (expr.value,)
        except TypeError:
            consts = ()
        return DictKeyFact(line, col, kind="const", consts=consts,
                           nullable=expr.value is None)
    if isinstance(expr, ast.IfExp):
        return _merge_key_facts(
            _classify_value(expr.body, env, envval),
            _classify_value(expr.orelse, env, envval))
    if isinstance(expr, ast.BoolOp):
        out = _classify_value(expr.values[0], env, envval)
        for v in expr.values[1:]:
            out = _merge_key_facts(out, _classify_value(v, env, envval))
        return out
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        nested = _shape_of(expr, env, envval)
        return DictKeyFact(line, col, kind="dict", nested=nested)
    if isinstance(expr, ast.Call):
        fname = _dotted(expr.func)
        if fname == "dict":
            nested = _shape_of(expr, env, envval)
            return DictKeyFact(line, col, kind="dict", nested=nested)
        if fname in _BUILTIN_HINTS:
            return DictKeyFact(line, col, kind="other",
                               hint=_BUILTIN_HINTS[fname])
        return DictKeyFact(line, col, kind="call",
                           call_site=(expr.lineno, expr.col_offset))
    if isinstance(expr, ast.Name):
        if expr.id in envval:
            return dataclasses.replace(envval[expr.id],
                                       line=line, col=col)
        if expr.id in env:
            return DictKeyFact(line, col, kind="dict",
                               nested=env[expr.id])
        return DictKeyFact(line, col)
    if isinstance(expr, ast.Attribute):
        attr = _dotted(expr)
        if attr and attr.startswith("self.") and attr.count(".") == 1:
            return DictKeyFact(line, col, kind="attr",
                               hint=attr[len("self."):])
        return DictKeyFact(line, col)
    return DictKeyFact(line, col)


def _shape_of(expr: ast.AST, env: Dict[str, DictShape],
              envval: Dict[str, DictKeyFact]) -> Optional[DictShape]:
    """A DictShape for a dict-producing expression, or None when the
    expression is not dict-shaped. ``Name`` aliases return the SHARED
    shape object — Python dict aliasing means later subscript stores
    through either name mutate the same dict."""
    if isinstance(expr, ast.Dict):
        shape = DictShape(line=expr.lineno)
        for knode, vnode in zip(expr.keys, expr.values):
            if knode is None:                      # **spread
                _fold_spread(shape, vnode, env, envval)
            elif (isinstance(knode, ast.Constant)
                    and isinstance(knode.value, str)):
                _set_key(shape, knode.value,
                         _classify_value(vnode, env, envval), False)
            else:
                shape.open = True                  # non-str-const key
        return shape
    if isinstance(expr, ast.DictComp):
        shape = DictShape(line=expr.lineno)
        shape.dynamic = _classify_value(expr.value, env, envval)
        return shape
    if (isinstance(expr, ast.Call) and _dotted(expr.func) == "dict"):
        shape = DictShape(line=expr.lineno)
        if len(expr.args) > 1:
            shape.open = True
        elif expr.args:
            _fold_spread(shape, expr.args[0], env, envval)
        for kw in expr.keywords:
            if kw.arg is None:
                _fold_spread(shape, kw.value, env, envval)
            else:
                _set_key(shape, kw.arg,
                         _classify_value(kw.value, env, envval), False)
        return shape
    if isinstance(expr, ast.Name) and expr.id in env:
        return env[expr.id]
    return None


def _fold_spread(shape: DictShape, src: ast.AST,
                 env: Dict[str, DictShape],
                 envval: Dict[str, DictKeyFact]) -> None:
    """Fold ``dict(src)`` / ``{**src}`` / ``out.update(src)`` in."""
    attr = _dotted(src)
    if attr and attr.startswith("self.") and attr.count(".") == 1:
        shape.spreads.append(("selfattr", attr[len("self."):]))
        return
    inner = _shape_of(src, env, envval)
    if inner is not None and inner is not shape:
        for k, f in inner.keys.items():
            _set_key(shape, k, dataclasses.replace(f), False)
        shape.spreads.extend(inner.spreads)
        if inner.dynamic is not None and shape.dynamic is None:
            shape.dynamic = inner.dynamic
        shape.open = shape.open or inner.open
        return
    shape.open = True


def _set_key(shape: DictShape, key: str, fact: DictKeyFact,
             cond: bool) -> None:
    if cond:
        fact.conditional = True
    old = shape.keys.get(key)
    shape.keys[key] = (_merge_key_facts(old, fact) if old is not None
                       else fact)


class _DictPass:
    """Flow-insensitive symbolic walk of one function body tracking
    dict-valued locals (literals, ``dict(...)`` copies, ``.update``,
    subscript stores) and the shapes it returns. Assignments under a
    branch/loop mark their keys conditional."""

    def __init__(self) -> None:
        self.env: Dict[str, DictShape] = {}
        self.envval: Dict[str, DictKeyFact] = {}
        self.returned: List[DictShape] = []
        self.returned_self_calls: List[Tuple[int, int]] = []
        self.returns_none = False

    def run(self, fn: ast.AST) -> None:
        self._stmts(fn.body, cond=False)

    def _stmts(self, body: List[ast.stmt], cond: bool) -> None:
        for stmt in body:
            self._stmt(stmt, cond)

    def _stmt(self, stmt: ast.stmt, cond: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            stmt = ast.Assign(targets=[stmt.target], value=stmt.value,
                              lineno=stmt.lineno,
                              col_offset=stmt.col_offset)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name):
                shape = _shape_of(stmt.value, self.env, self.envval)
                if shape is not None:
                    if cond:
                        for f in shape.keys.values():
                            f.conditional = True
                    self.env[t.id] = shape
                    self.envval.pop(t.id, None)
                else:
                    self.envval[t.id] = _classify_value(
                        stmt.value, self.env, self.envval)
                    self.env.pop(t.id, None)
            elif (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in self.env):
                shape = self.env[t.value.id]
                fact = _classify_value(stmt.value, self.env, self.envval)
                if (isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)):
                    _set_key(shape, t.slice.value, fact, cond)
                else:
                    shape.dynamic = (fact if shape.dynamic is None
                                     else _merge_key_facts(shape.dynamic,
                                                           fact))
        elif (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "update"
                and isinstance(stmt.value.func.value, ast.Name)
                and stmt.value.func.value.id in self.env):
            shape = self.env[stmt.value.func.value.id]
            call = stmt.value
            for arg in call.args:
                inner = _shape_of(arg, self.env, self.envval)
                if inner is not None and inner is not shape:
                    for k, f in inner.keys.items():
                        _set_key(shape, k, dataclasses.replace(f), cond)
                    shape.spreads.extend(inner.spreads)
                    shape.open = shape.open or inner.open
                else:
                    _fold_spread(shape, arg, self.env, self.envval)
            for kw in call.keywords:
                if kw.arg is not None:
                    _set_key(shape, kw.arg,
                             _classify_value(kw.value, self.env,
                                             self.envval), cond)
                else:
                    _fold_spread(shape, kw.value, self.env, self.envval)
        elif isinstance(stmt, ast.Return):
            self._return(stmt)
        elif isinstance(stmt, ast.If):
            self._stmts(stmt.body, True)
            self._stmts(stmt.orelse, True)
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            self._stmts(stmt.body, True)
            self._stmts(stmt.orelse, True)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._stmts(stmt.body, cond)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body, cond)
            for h in stmt.handlers:
                self._stmts(h.body, True)
            self._stmts(stmt.orelse, True)
            self._stmts(stmt.finalbody, cond)

    def _return(self, stmt: ast.Return) -> None:
        value = stmt.value
        if value is None or (isinstance(value, ast.Constant)
                             and value.value is None):
            self.returns_none = True
            return
        if isinstance(value, ast.IfExp):
            for arm in (value.body, value.orelse):
                if (isinstance(arm, ast.Constant)
                        and arm.value is None):
                    self.returns_none = True
                else:
                    shape = _shape_of(arm, self.env, self.envval)
                    if shape is not None:
                        self.returned.append(shape)
            return
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and isinstance(value.func.value, ast.Name)
                and value.func.value.id == "self"):
            self.returned_self_calls.append((value.lineno,
                                             value.col_offset))
            return
        shape = _shape_of(value, self.env, self.envval)
        if shape is not None:
            self.returned.append(shape)


def _scan_class_attr_dicts(cls_node: ast.ClassDef,
                           cls: ClassFacts) -> None:
    """``self.X = {literal}`` shapes + scalar-constant attr types, any
    method. Subscript stores onto a known dict attr fold in as extra
    keys (non-constant slices mark the shape dynamic-open)."""
    subscripts: List[Tuple[str, ast.Subscript, ast.expr]] = []
    for method in cls_node.body:
        if not isinstance(method, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(method):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                tname = _dotted(t)
                if (tname and tname.startswith("self.")
                        and "." not in tname[len("self."):]):
                    attr = tname[len("self."):]
                    shape = _shape_of(node.value, {}, {})
                    if shape is not None:
                        if attr in cls.attr_dicts:
                            for k, f in shape.keys.items():
                                _set_key(cls.attr_dicts[attr], k,
                                         dataclasses.replace(f), True)
                        else:
                            cls.attr_dicts[attr] = shape
                    elif isinstance(node.value, ast.Constant):
                        cls.attr_scalars.setdefault(attr, set()).add(
                            type(node.value.value).__name__)
                    else:
                        fact = _classify_value(node.value, {}, {})
                        if fact.nullable:
                            cls.attr_scalars.setdefault(
                                attr, set()).add("NoneType")
                elif (isinstance(t, ast.Subscript)
                        and _dotted(t.value)
                        and _dotted(t.value).startswith("self.")
                        and _dotted(t.value).count(".") == 1):
                    subscripts.append((_dotted(t.value)[len("self."):],
                                       t, node.value))
    for attr, sub, value in subscripts:
        shape = cls.attr_dicts.get(attr)
        if shape is None:
            continue
        if (isinstance(sub.slice, ast.Constant)
                and isinstance(sub.slice.value, str)):
            _set_key(shape, sub.slice.value,
                     _classify_value(value, {}, {}), True)
        else:
            fact = _classify_value(value, {}, {})
            shape.dynamic = (fact if shape.dynamic is None
                             else _merge_key_facts(shape.dynamic, fact))


def _dict_shapes(fn: ast.AST
                 ) -> Tuple[List[DictShape], List[Tuple[int, int]], bool]:
    p = _DictPass()
    p.run(fn)
    return p.returned, p.returned_self_calls, p.returns_none


#: typing-module names that look like classes but type nothing
_TYPING_NAMES = frozenset((
    "Optional", "Dict", "List", "Tuple", "Set", "FrozenSet", "Union",
    "Any", "Callable", "Sequence", "Iterable", "Iterator", "Mapping",
    "MutableMapping", "Deque", "DefaultDict", "Type", "ClassVar"))


def _annotation_classes(ann: ast.AST) -> Set[str]:
    """Candidate class names out of an annotation: Name/Attribute
    leaves and identifiers inside string (forward-ref) annotations,
    uppercase-initial and not typing vocabulary."""
    out: Set[str] = set()
    for node in ast.walk(ann):
        if isinstance(node, ast.Name):
            names = [node.id]
        elif isinstance(node, ast.Attribute):
            names = [node.attr]
        elif (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            names = re.findall(r"[A-Za-z_]\w*", node.value)
        else:
            continue
        out.update(n for n in names
                   if n[0].isupper() and n not in _TYPING_NAMES)
    return out


def _scan_class_attrs(cls_node: ast.ClassDef, cls: ClassFacts) -> None:
    """self.<attr> = ClassName(...) / threading.Lock() assignments in
    any method, plus ``self.<attr>: Ann = ...`` annotations: the
    attr-type and lock-attr maps resolution uses."""
    for method in cls_node.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(method):
            if isinstance(node, ast.AnnAssign):
                tname = _dotted(node.target)
                if (tname and tname.startswith("self.")
                        and "." not in tname[len("self."):]):
                    attr = tname[len("self."):]
                    for cand in _annotation_classes(node.annotation):
                        cls.attr_types.setdefault(attr, set()).add(cand)
                continue
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            # look through the guard idiom
            # ``self.x = Cls(...) if cond else None``
            if isinstance(value, ast.IfExp):
                value = (value.body if isinstance(value.body, ast.Call)
                         else value.orelse)
            if not isinstance(value, ast.Call):
                continue
            vname = _dotted(value.func)
            vleaf = _leaf(vname)
            for t in node.targets:
                tname = _dotted(t)
                if not (tname and tname.startswith("self.")):
                    continue
                attr = tname[len("self."):]
                if "." in attr:
                    continue
                if vleaf in LOCK_FACTORIES:
                    cls.lock_attrs[attr] = vleaf
                elif vname and vleaf and vleaf[0].isupper():
                    cls.attr_types.setdefault(attr, set()).add(vleaf)


def _scan_ownership_comments(source: str
                             ) -> Tuple[Dict[int, Tuple[str, str]],
                                        Set[int]]:
    """lineno -> (kind, value) for owner/lock declarations, plus the
    set of linenos carrying a ``# tpushare: reader`` marker. Comments
    never reach the AST, so this is a source-line pass; the class
    walk below ties each declaration to the assignment (or ``def``)
    on its line."""
    decls: Dict[int, Tuple[str, str]] = {}
    readers: Set[int] = set()
    for i, line in enumerate(source.splitlines(), start=1):
        if "tpushare:" not in line:
            continue
        m = _DECL_RE.search(line)
        if m:
            decls[i] = (m.group(1), m.group(2))
        if _READER_RE.search(line):
            readers.add(i)
    return decls, readers


def _apply_ownership_decls(cls_node: ast.ClassDef, cls: ClassFacts,
                           decls: Dict[int, Tuple[str, str]],
                           readers: Set[int]) -> None:
    """Bind declaration comments to the class: an owner/lock comment
    on a ``self.X = ...`` line (any method, typically ``__init__``)
    declares field X; a reader comment on a ``def`` line sanctions
    that method as a cross-role reader."""
    for method in cls_node.body:
        if not isinstance(method, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
            continue
        # trailing on the def line, or a standalone marker line
        # directly above it (above any decorators)
        first = min([method.lineno]
                    + [d.lineno for d in method.decorator_list])
        if method.lineno in readers or (first - 1) in readers:
            cls.sanctioned_readers.add(method.name)
        for node in ast.walk(method):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            kind_value = decls.get(node.lineno)
            if kind_value is None:
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                tname = _dotted(t)
                if not (tname and tname.startswith("self.")):
                    continue
                attr = tname[len("self."):]
                if "." in attr:
                    continue
                kind, value = kind_value
                if kind == "owner":
                    cls.field_owners[attr] = value
                else:
                    cls.field_locks[attr] = value


def extract_module(relpath: str, tree: ast.Module,
                   source: Optional[str] = None) -> ModuleFacts:
    mod = ModuleFacts(relpath=relpath)
    decls: Dict[int, Tuple[str, str]] = {}
    readers: Set[int] = set()
    if source is not None:
        decls, readers = _scan_ownership_comments(source)
    for stmt in tree.body:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                mod.module_aliases[alias.asname or
                                   alias.name.split(".")[0]] = alias.name
        elif isinstance(stmt, ast.ImportFrom) and stmt.module:
            for alias in stmt.names:
                mod.from_imports[alias.asname or alias.name] = (
                    stmt.module, alias.name)
        elif isinstance(stmt, ast.Assign):
            value = stmt.value
            if (isinstance(value, ast.Call)
                    and _leaf(_dotted(value.func)) in LOCK_FACTORIES):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        mod.module_locks[t.id] = _leaf(_dotted(value.func))
            elif any(isinstance(t, ast.Name)
                     and t.id == OWNERSHIP_REGISTRY_NAME
                     for t in stmt.targets):
                try:
                    reg = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    reg = None
                if isinstance(reg, dict):
                    mod.ownership_registry = reg
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[stmt.name] = _extract_function(stmt, mod, None)
        elif isinstance(stmt, ast.ClassDef):
            cls = ClassFacts(
                name=stmt.name, relpath=relpath,
                bases=tuple(b for b in (_leaf(_dotted(bn))
                                        for bn in stmt.bases) if b))
            _scan_class_attrs(stmt, cls)
            _scan_class_attr_dicts(stmt, cls)
            if decls or readers:
                _apply_ownership_decls(stmt, cls, decls, readers)
            for item in stmt.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    cls.methods[item.name] = _extract_function(
                        item, mod, cls)
            mod.classes[stmt.name] = cls
    # function-level from-imports (the lazy-import idiom: heavy deps
    # pulled inside the function that needs them). Module-level names
    # win on collision; adding these lets ``bare`` calls on lazily
    # imported helpers resolve instead of staying silent.
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                mod.from_imports.setdefault(
                    alias.asname or alias.name,
                    (node.module, alias.name))
    return mod


#: abspath -> (mtime_ns, size, ModuleFacts) — facts survive across
#: repeated gate/test invocations in one process; a changed file
#: re-extracts, everything else is a dict hit.
_FACTS_CACHE: Dict[str, Tuple[int, int, ModuleFacts]] = {}


def module_facts(path: str, root: Optional[str]) -> Optional[ModuleFacts]:
    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
    except OSError:
        return None
    key = (st.st_mtime_ns, st.st_size)
    hit = _FACTS_CACHE.get(ap)
    if hit is not None and (hit[0], hit[1]) == key:
        return hit[2]
    try:
        with open(ap, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=ap)
    except (OSError, UnicodeDecodeError, SyntaxError):
        return None
    facts = extract_module(relativize(ap, root), tree, source=source)
    _FACTS_CACHE[ap] = (st.st_mtime_ns, st.st_size, facts)
    return facts


def clear_cache() -> None:
    _FACTS_CACHE.clear()
    _INDEX_CACHE.clear()


# ---------------------------------------------------------------------------
# Project index: linking + summary fixpoint
# ---------------------------------------------------------------------------

class ProjectIndex:
    """The linked view over every module's facts: global name maps,
    per-call resolution, and the propagated summaries."""

    def __init__(self, modules: Sequence[ModuleFacts]):
        self.modules: Dict[str, ModuleFacts] = {m.relpath: m
                                                for m in modules}
        self.functions: Dict[str, FuncFacts] = {}
        self.classes_by_name: Dict[str, List[ClassFacts]] = {}
        #: rule-scoped memo space (e.g. CC204's global cycle set)
        self.memo: Dict[str, object] = {}
        for m in modules:
            for f in m.functions.values():
                self.functions[f.qual] = f
            for c in m.classes.values():
                self.classes_by_name.setdefault(c.name, []).append(c)
                for f in c.methods.values():
                    self.functions[f.qual] = f
        self._link()

    # -- resolution --------------------------------------------------------
    def _module_by_dotted(self, dotted_mod: str) -> Optional[ModuleFacts]:
        rel = dotted_mod.replace(".", "/")
        for cand in (rel + ".py", rel + "/__init__.py"):
            if cand in self.modules:
                return self.modules[cand]
        # relative to any package root in view (e.g. "models.paged"
        # when the index holds "tpushare_torch/models/paged.py")
        suffix = "/" + rel + ".py"
        for rp in self.modules:
            if rp.endswith(suffix):
                return self.modules[rp]
        return None

    def _class_by_name(self, name: str,
                       prefer_relpath: Optional[str] = None
                       ) -> List[ClassFacts]:
        cands = self.classes_by_name.get(name, [])
        if prefer_relpath:
            same = [c for c in cands if c.relpath == prefer_relpath]
            if same:
                return same
        return cands

    def _method_in_mro(self, cls: ClassFacts, meth: str,
                       depth: int = 0) -> List[FuncFacts]:
        if meth in cls.methods:
            return [cls.methods[meth]]
        if depth >= 4:
            return []
        out: List[FuncFacts] = []
        for base in cls.bases:
            for bc in self._class_by_name(base, cls.relpath):
                out.extend(self._method_in_mro(bc, meth, depth + 1))
        return out

    def resolve(self, caller: FuncFacts, call: CallFact) -> List[FuncFacts]:
        mod = self.modules.get(caller.relpath)
        if mod is None:
            return []
        kind, data = call.kind, call.data
        if kind == "bare":
            name = data[0]
            if name in mod.functions:
                return [mod.functions[name]]
            if name in mod.classes:
                return self._method_in_mro(mod.classes[name], "__init__")
            if name in mod.from_imports:
                src_mod, orig = mod.from_imports[name]
                target = self._module_by_dotted(src_mod)
                if target is not None:
                    if orig in target.functions:
                        return [target.functions[orig]]
                    if orig in target.classes:
                        return self._method_in_mro(
                            target.classes[orig], "__init__")
            return []
        if kind == "self":
            if caller.class_name is None:
                return []
            for cls in self._class_by_name(caller.class_name,
                                           caller.relpath):
                found = self._method_in_mro(cls, data[0])
                if found:
                    return found
            return []
        if kind == "selfattr":
            attr, meth = data
            if caller.class_name is None:
                return []
            out: List[FuncFacts] = []
            for cls in self._class_by_name(caller.class_name,
                                           caller.relpath):
                for tname in sorted(cls.attr_types.get(attr, ())):
                    for tc in self._class_by_name(tname, cls.relpath):
                        out.extend(self._method_in_mro(tc, meth))
            if not out and attr in DUCK_SERVER_ATTRS:
                # the adapter seams: whichever *SlotServer the config
                # chose at runtime — take the whole family
                for cname in sorted(self.classes_by_name):
                    if cname.endswith(DUCK_CLASS_SUFFIX):
                        for tc in self.classes_by_name[cname]:
                            out.extend(self._method_in_mro(tc, meth))
            return out
        if kind == "module":
            dotted_mod, fname = data
            target = self._module_by_dotted(dotted_mod)
            if target is not None and fname in target.functions:
                return [target.functions[fname]]
            return []
        if kind == "attr":
            base, meth = data
            # a from-imported CLASS used as a namespace is rare; a
            # from-imported module object is covered by module_aliases
            # already. Locals stay unresolved (no type inference).
            if base in mod.from_imports:
                src_mod, orig = mod.from_imports[base]
                target = self._module_by_dotted(f"{src_mod}.{orig}")
                if target is not None and meth in target.functions:
                    return [target.functions[meth]]
            return []
        return []

    # -- fixpoint summaries ------------------------------------------------
    def _link(self) -> None:
        funcs = list(self.functions.values())
        for f in funcs:
            for call in f.calls:
                call.resolved = tuple(c.qual
                                      for c in self.resolve(f, call))
        # may_raise / trans_locks / param dispositions to fixpoint:
        # monotone boolean/set lattices, so iteration terminates.
        for f in funcs:
            f.may_raise = f.direct_raise
            f.trans_locks = {l for l, _, _ in f.lock_acquires}
            f.param_release = {p for p in f.params
                               if p in f.released_names}
            f.param_store = {p for p in f.params if p in f.stored_names}
        changed = True
        while changed:
            changed = False
            for f in funcs:
                for call in f.calls:
                    for qual in call.resolved:
                        callee = self.functions[qual]
                        if (callee.may_raise and not call.guarded
                                and not f.may_raise):
                            f.may_raise = True
                            changed = True
                        new_locks = callee.trans_locks - f.trans_locks
                        if new_locks:
                            f.trans_locks |= new_locks
                            changed = True
                        # a param forwarded into a releasing/storing
                        # param of the callee leaves this frame too
                        for i, aname in call.arg_names:
                            if aname not in f.params:
                                continue
                            base = 0
                            if call.kind in ("self", "selfattr"):
                                base = 0   # params exclude self already
                            if i - base < len(callee.params):
                                cp = callee.params[i - base]
                                if (cp in callee.param_release
                                        and aname not in f.param_release):
                                    f.param_release.add(aname)
                                    changed = True
                                if (cp in callee.param_store
                                        and aname not in f.param_store):
                                    f.param_store.add(aname)
                                    changed = True

    # -- queries the rules use --------------------------------------------
    def func(self, qual: str) -> Optional[FuncFacts]:
        return self.functions.get(qual)

    def class_of(self, relpath: str, name: str) -> Optional[ClassFacts]:
        mod = self.modules.get(relpath)
        return mod.classes.get(name) if mod else None

    def sync_chains(self, entry: FuncFacts,
                    skip: Optional[callable] = None,
                    max_depth: int = 8
                    ) -> List[Tuple[CallFact, List[str], SyncSite]]:
        """Call chains from ``entry`` that reach a DIRECT host sync in
        a callee: [(call site in entry, [qualname chain], sync site)].
        ``skip(facts)`` prunes callees another rule already polices
        (TS103's step-loop methods). Depth-limited, cycle-safe."""
        out: List[Tuple[CallFact, List[str], SyncSite]] = []
        seen_pairs: Set[Tuple[int, int, str, int]] = set()
        for call in entry.calls:
            for qual in call.resolved:
                callee = self.functions[qual]
                if skip is not None and skip(callee):
                    continue
                self._sync_dfs(call, callee, [entry.qual, qual],
                               {entry.qual, qual}, out, seen_pairs,
                               max_depth, skip)
        return out

    def _sync_dfs(self, entry_call: CallFact, facts: FuncFacts,
                  chain: List[str], visited: Set[str],
                  out: List, seen_pairs: Set, depth: int,
                  skip) -> None:
        for s in facts.syncs:
            key = (entry_call.line, entry_call.col, facts.qual, s.line)
            if key not in seen_pairs:
                seen_pairs.add(key)
                out.append((entry_call, list(chain), s))
        if depth <= 1:
            return
        for call in facts.calls:
            for qual in call.resolved:
                if qual in visited:
                    continue
                callee = self.functions[qual]
                if skip is not None and skip(callee):
                    continue
                self._sync_dfs(entry_call, callee, chain + [qual],
                               visited | {qual}, out, seen_pairs,
                               depth - 1, skip)


#: frozenset of (abspath, mtime_ns, size) -> ProjectIndex
_INDEX_CACHE: Dict[frozenset, ProjectIndex] = {}


def _extract_worker(item: Tuple[str, int, int, Optional[str]]
                    ) -> Tuple[str, int, int, Optional[ModuleFacts]]:
    """Process-pool worker: parse + extract one file. ModuleFacts is
    plain dataclasses (no AST refs survive extraction), so it pickles
    back to the parent cheaply."""
    ap, mtime_ns, size, root = item
    try:
        with open(ap, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=ap)
    except (OSError, UnicodeDecodeError, SyntaxError):
        return ap, mtime_ns, size, None
    return ap, mtime_ns, size, extract_module(relativize(ap, root), tree,
                                              source=source)


def prefetch_facts(files: Iterable[str], root: Optional[str] = None,
                   jobs: Optional[int] = None) -> None:
    """Fan per-file parse/extraction out over a process pool and merge
    the results into the facts cache. Results are byte-identical to
    the serial path by construction — the pool only PREFILLS the same
    cache ``module_facts`` reads; linking and rule execution stay
    serial. Files already cached (same mtime/size) are skipped, so a
    warm gate never pays pool startup."""
    jobs = jobs or 1
    if jobs <= 1:
        return
    todo: List[Tuple[str, int, int, Optional[str]]] = []
    for p in files:
        ap = os.path.abspath(p)
        try:
            st = os.stat(ap)
        except OSError:
            continue
        hit = _FACTS_CACHE.get(ap)
        if hit is not None and (hit[0], hit[1]) == (st.st_mtime_ns,
                                                    st.st_size):
            continue
        todo.append((ap, st.st_mtime_ns, st.st_size, root))
    if len(todo) < 2:
        return
    import concurrent.futures
    import multiprocessing
    try:
        # spawn, not fork: the tier-1 suite runs this inside a
        # multithreaded pytest process (torch and jax loaded), where
        # fork can deadlock. Workers only import the analysis package,
        # so spawn startup is cheap.
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(jobs, len(todo)),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for ap, mt, sz, facts in ex.map(_extract_worker, todo,
                                            chunksize=8):
                if facts is not None:
                    _FACTS_CACHE[ap] = (mt, sz, facts)
    except (OSError, RuntimeError):
        # sandboxes without fork/semaphores: the serial path below
        # produces the identical result, just without the fan-out
        pass


def build_index(files: Iterable[str],
                root: Optional[str] = None,
                jobs: Optional[int] = None) -> ProjectIndex:
    """ProjectIndex over ``files``, memoized on the exact (path,
    mtime, size) set: the tier-1 tests call the gate several times per
    process and must relink only when something changed. ``jobs`` > 1
    prefetches per-file facts through a process pool (same results,
    parallel parse)."""
    paths = sorted({os.path.abspath(p) for p in files})
    sig_parts = []
    for p in paths:
        try:
            st = os.stat(p)
            sig_parts.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            sig_parts.append((p, -1, -1))
    sig = frozenset(sig_parts)
    hit = _INDEX_CACHE.get(sig)
    if hit is not None:
        return hit
    prefetch_facts(paths, root=root, jobs=jobs)
    modules = []
    for p in paths:
        facts = module_facts(p, root)
        if facts is not None:
            modules.append(facts)
    index = ProjectIndex(modules)
    if len(_INDEX_CACHE) > 16:      # unbounded growth guard (tmp files
        _INDEX_CACHE.clear()        # in tests churn the signature)
    _INDEX_CACHE[sig] = index
    return index
