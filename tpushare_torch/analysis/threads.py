"""Thread-ownership layer: role inference, field effects, declarations.

The repo's concurrency contracts ("TierStats is engine-thread-owned",
"KvQuota.snapshot copies atomically", "every _requests mutation holds
_durable_lock") lived in prose and were enforced by manual review.
This module turns them into checkable facts, three layers deep:

1. **Thread-role inference.** Roots are ``threading.Thread(target=
   self.X)`` sites (the callgraph records them), HTTP/RPC handler
   methods (``config.handler_methods``), and bare thread entry points
   (``config.thread_entry_methods``). Each root gets a canonical role
   (``config.thread_role_map``: ``_loop`` -> ``engine``,
   ``_supervise`` -> ``supervisor``, ``_poll_loop`` -> ``poll``,
   ``do_*`` -> ``handler``; unlisted targets become their own
   stripped name) and roles propagate over every resolved call edge
   to a fixpoint — a method reachable from two roots runs under both
   roles.

2. **Field-effect summaries.** The callgraph's per-function
   ``attr_reads`` / ``attr_writes`` (self-attr loads and stores with
   the locks lexically held at each site) are widened with an
   **entry-lock fold**: when every resolved call site of a method
   holds lock L, the method's body effects count as under L — the
   ``trans_locks``-style fixpoint, pointed the other way (what the
   callee can ASSUME, not what it acquires).

3. **Ownership declarations.** ``# tpushare: owner[role]`` /
   ``# tpushare: lock[attr]`` on a ``self.X = ...`` assignment and
   ``# tpushare: reader`` on a ``def`` line (parsed by the callgraph
   extractor), plus the module-level ``TPUSHARE_OWNERSHIP`` registry
   for cross-class contracts::

       TPUSHARE_OWNERSHIP = {
           "owners": {"KvQuota.used": "engine"},
           "readers": ["KvQuota.snapshot"],
           "serialized": [["engine", "supervisor"]],
       }

   ``serialized`` pairs are roles with a happens-before edge between
   them (the supervisor only touches engine-owned state after joining
   the dead engine thread) — writes across a serialized pair are not
   races.

rules/ownership.py turns violations into TO901/TO902 findings;
``--overlap-report`` uses the same footprints to print what the
engine's overlapped tick (dispatch of tick N beside the host-side pick
of tick N+1) contends on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from tpushare_torch.analysis.callgraph import FuncFacts, ProjectIndex

#: role every ``config.handler_methods`` entry runs under
HANDLER_ROLE = "handler"

#: index.memo keys (one model + one findings list per ProjectIndex)
MEMO_MODEL = "thread_ownership_model"
MEMO_FINDINGS = "thread_ownership_findings"

#: named entry sets for --overlap-report. tick-dispatch is everything a
#: tick runs (``cli/serve.py`` ``ServeEngine._tick``, the overlapped
#: ``_tick_overlap`` among its callees); tick-schedule is the host-side
#: work the overlapped tick runs inside tick N's flight window: the PURE
#: pick — ``TickScheduler.peek`` / ``peek_admission`` (choice without
#: rotation credit), the quota verdict over a ``ledger_view`` snapshot,
#: and the engine's ``_plan_next_pick`` that assembles them. The impure
#: halves (pop, commit_admission, charge, evict/activation) stay
#: dispatch-side. Their footprint intersection is the serialization
#: checklist: every entry of ``overlap_baseline.json`` carries its
#: written story.
DEFAULT_SURFACES: Dict[str, Tuple[str, ...]] = {
    "tick-dispatch": ("ServeEngine._tick",),
    "tick-schedule": ("ServeEngine._plan_next_pick",
                      "TickScheduler.peek",
                      "TickScheduler.peek_admission",
                      "KvQuota.admit_verdict",
                      "KvQuota.ledger_view"),
}

_MAX_SITES = 3          # example sites kept per overlap entry
_BFS_DEPTH = 10

@dataclasses.dataclass
class OwnershipModel:
    """The linked ownership view rules and reports query."""
    #: qual -> roles that can execute the function
    roles: Dict[str, FrozenSet[str]]
    #: qual -> lock ids held at EVERY resolved call site (entry fold)
    entry_locks: Dict[str, FrozenSet[str]]
    #: (class name, attr) -> owning role
    owners: Dict[Tuple[str, str], str]
    #: (class name, attr) -> required lock attr on that class
    locks: Dict[Tuple[str, str], str]
    #: (class name, method) sanctioned cross-role readers
    readers: Set[Tuple[str, str]]
    #: role pairs with a happens-before edge (never racing)
    serialized: Set[FrozenSet[str]]

    def is_serialized(self, a: str, b: str) -> bool:
        return a == b or frozenset((a, b)) in self.serialized


def _role_for_entry(name: str, role_map: Dict[str, str]) -> str:
    return role_map.get(name) or name.strip("_") or name


def _collect_declarations(index: ProjectIndex, model: OwnershipModel
                          ) -> None:
    for mod in index.modules.values():
        for cls in mod.classes.values():
            for attr, role in cls.field_owners.items():
                model.owners[(cls.name, attr)] = role
            for attr, lock in cls.field_locks.items():
                model.locks[(cls.name, attr)] = lock
            for meth in cls.sanctioned_readers:
                model.readers.add((cls.name, meth))
        reg = mod.ownership_registry
        if not reg:
            continue
        for qual, role in (reg.get("owners") or {}).items():
            if isinstance(qual, str) and "." in qual:
                cname, attr = qual.rsplit(".", 1)
                model.owners[(cname, attr)] = str(role)
        for qual in (reg.get("readers") or ()):
            if isinstance(qual, str) and "." in qual:
                cname, meth = qual.rsplit(".", 1)
                model.readers.add((cname, meth))
        for pair in (reg.get("serialized") or ()):
            if (isinstance(pair, (list, tuple)) and len(pair) == 2
                    and all(isinstance(r, str) for r in pair)):
                model.serialized.add(frozenset(pair))


def _root_roles(index: ProjectIndex, config) -> Dict[str, Set[str]]:
    """Seed roles: thread targets, handler methods, thread entries."""
    role_map = {k: v for k, v in config.thread_role_map}
    handler_methods = set(config.handler_methods)
    entry_methods = set(config.thread_entry_methods)
    roots: Dict[str, Set[str]] = {}

    def seed(qual: str, role: str) -> None:
        roots.setdefault(qual, set()).add(role)

    for f in index.functions.values():
        if f.class_name is not None:
            if f.name in handler_methods:
                seed(f.qual, HANDLER_ROLE)
            elif f.name in entry_methods:
                seed(f.qual, _role_for_entry(f.name, role_map))
        if not f.thread_targets or f.class_name is None:
            continue
        for cls in index._class_by_name(f.class_name, f.relpath):
            for target in f.thread_targets:
                for tf in index._method_in_mro(cls, target):
                    seed(tf.qual, _role_for_entry(target, role_map))
    return roots


def _propagate_roles(index: ProjectIndex,
                     roots: Dict[str, Set[str]]
                     ) -> Dict[str, FrozenSet[str]]:
    roles: Dict[str, Set[str]] = {q: set(r) for q, r in roots.items()}
    work = list(roots)
    while work:
        qual = work.pop()
        f = index.functions.get(qual)
        if f is None:
            continue
        mine = roles[qual]
        for call in f.calls:
            for callee in call.resolved:
                have = roles.setdefault(callee, set())
                if not mine <= have:
                    have |= mine
                    work.append(callee)
    return {q: frozenset(r) for q, r in roles.items() if r}


def _fold_entry_locks(index: ProjectIndex,
                      roots: Dict[str, Set[str]]
                      ) -> Dict[str, FrozenSet[str]]:
    """Locks provably held at every call into each function: the
    intersection over resolved call sites of (site locks | caller's
    entry locks), to fixpoint. Thread/handler roots and functions
    nobody calls enter lock-free. ``None`` is top (not yet reached)."""
    incoming: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for f in index.functions.values():
        for call in f.calls:
            locks = frozenset(call.locks_held)
            for callee in call.resolved:
                incoming.setdefault(callee, []).append((f.qual, locks))
    empty: FrozenSet[str] = frozenset()
    entry: Dict[str, Optional[FrozenSet[str]]] = {
        q: None for q in index.functions}
    for q in index.functions:
        if q in roots or q not in incoming:
            entry[q] = empty
    changed = True
    while changed:
        changed = False
        for q, sites in incoming.items():
            if q in roots:
                continue
            parts = [locks | entry[caller]
                     for caller, locks in sites
                     if entry.get(caller) is not None]
            if not parts:
                continue
            new = frozenset.intersection(*parts)
            if entry[q] != new:
                entry[q] = new
                changed = True
    return {q: (v if v is not None else empty)
            for q, v in entry.items()}


def build_model(index: ProjectIndex, config) -> OwnershipModel:
    """Compute (memoized per index) the full ownership model."""
    cached = index.memo.get(MEMO_MODEL)
    if cached is not None:
        return cached
    model = OwnershipModel(roles={}, entry_locks={}, owners={},
                           locks={}, readers=set(), serialized=set())
    _collect_declarations(index, model)
    roots = _root_roles(index, config)
    model.roles = _propagate_roles(index, roots)
    model.entry_locks = _fold_entry_locks(index, roots)
    index.memo[MEMO_MODEL] = model
    return model


# ---------------------------------------------------------------------------
# TO901 / TO902 findings
# ---------------------------------------------------------------------------

def _held(model: OwnershipModel, f: FuncFacts,
          site_locks: Sequence[str]) -> Set[str]:
    return set(site_locks) | set(model.entry_locks.get(f.qual, ()))


def ownership_findings(index: ProjectIndex, config
                       ) -> List[Tuple[str, int, int, str, str]]:
    """All TO findings over the index: (relpath, line, col, rule, msg).
    Computed once per index (the rules fan it back out per file)."""
    cached = index.memo.get(MEMO_FINDINGS)
    if cached is not None:
        return cached
    model = build_model(index, config)
    out: List[Tuple[str, int, int, str, str]] = []
    if model.owners or model.locks:
        for f in index.functions.values():
            if f.class_name is None or f.name == "__init__":
                continue
            out.extend(_check_writes(model, f))
            out.extend(_check_reads(model, f))
    out.sort()
    index.memo[MEMO_FINDINGS] = out
    return out


def _check_writes(model: OwnershipModel, f: FuncFacts
                  ) -> List[Tuple[str, int, int, str, str]]:
    cls = f.class_name
    roles = model.roles.get(f.qual, frozenset())
    out: List[Tuple[str, int, int, str, str]] = []
    for attr, line, col, site_locks in f.attr_writes:
        owner = model.owners.get((cls, attr))
        if owner is not None and roles:
            offending = sorted(r for r in roles
                               if not model.is_serialized(r, owner))
            if offending:
                qualifier = (
                    " (a lock does not serialize against the owner's "
                    "bare writes)" if site_locks else "")
                out.append((f.relpath, line, col, "TO901",
                            f"cross-thread write to {cls}.{attr}: "
                            f"owned by role '{owner}' but written "
                            f"from role(s) {', '.join(offending)} in "
                            f"{f.name}(){qualifier}"))
                continue
        lock_attr = model.locks.get((cls, attr))
        if lock_attr is not None and roles:
            if f"{cls}.{lock_attr}" not in _held(model, f, site_locks):
                out.append((f.relpath, line, col, "TO901",
                            f"bare write to {cls}.{attr}: declared "
                            f"lock[{lock_attr}] but {f.name}() writes "
                            f"it without holding {cls}.{lock_attr}"))
    return out


def _check_reads(model: OwnershipModel, f: FuncFacts
                 ) -> List[Tuple[str, int, int, str, str]]:
    cls = f.class_name
    roles = model.roles.get(f.qual, frozenset())
    if not roles:
        return []
    #: attr -> list of bare cross-role read sites
    cross: Dict[str, List[Tuple[int, int]]] = {}
    for attr, line, col, site_locks in f.attr_reads:
        owner = model.owners.get((cls, attr))
        if owner is not None:
            if any(not model.is_serialized(r, owner) for r in roles):
                cross.setdefault(attr, []).append((line, col))
            continue
        lock_attr = model.locks.get((cls, attr))
        if lock_attr is not None:
            if f"{cls}.{lock_attr}" not in _held(model, f, site_locks):
                cross.setdefault(attr, []).append((line, col))
    if not cross:
        return []
    sanctioned = (cls, f.name) in model.readers
    out: List[Tuple[str, int, int, str, str]] = []
    repeated = {a: sites for a, sites in cross.items()
                if len(sites) > 1}
    if sanctioned:
        # A declared reader is held to the atomic-copy discipline:
        # each contested field read at exactly ONE site (the copy).
        # Multi-site reads are the live-iteration shape the KvQuota
        # snapshot fix removed — the declaration does not excuse it.
        for attr, sites in sorted(repeated.items()):
            line, col = sites[0]
            out.append((f.relpath, line, col, "TO902",
                        f"declared reader {cls}.{f.name}() reads "
                        f"{cls}.{attr} at {len(sites)} sites — the "
                        f"atomic-copy discipline allows one"))
        return out
    if len(cross) >= 2 or repeated:
        fields = ", ".join(sorted(cross))
        first = min(min(sites) for sites in cross.values())
        out.append((f.relpath, first[0], first[1], "TO902",
                    f"torn multi-field read in {cls}.{f.name}() "
                    f"(role(s) {', '.join(sorted(roles))}): lock-free "
                    f"reads of contested field(s) {fields}"))
    return out


# ---------------------------------------------------------------------------
# --overlap-report: read/write footprint intersection of two surfaces
# ---------------------------------------------------------------------------

def resolve_entries(index: ProjectIndex, specs: Sequence[str]
                    ) -> Tuple[List[FuncFacts], List[str]]:
    """``Class.method`` / ``func`` / full ``relpath::qual`` specs ->
    (matched functions, unmatched specs)."""
    found: List[FuncFacts] = []
    missing: List[str] = []
    for spec in specs:
        if spec in index.functions:
            found.append(index.functions[spec])
            continue
        matches = [f for q, f in index.functions.items()
                   if q.endswith("::" + spec)]
        if matches:
            found.extend(matches)
        else:
            missing.append(spec)
    return found, missing


def _footprint(index: ProjectIndex, entries: Sequence[FuncFacts]
               ) -> Dict[str, Dict[str, List[str]]]:
    """field -> {"reads": [sites], "writes": [sites]} over everything
    reachable from ``entries`` (resolved edges, depth-limited)."""
    foot: Dict[str, Dict[str, List[str]]] = {}

    def note(field: str, kind: str, relpath: str, line: int) -> None:
        slot = foot.setdefault(field, {"reads": [], "writes": []})
        site = f"{relpath}:{line}"
        if site not in slot[kind]:
            slot[kind].append(site)

    seen: Set[str] = set()
    frontier = [(f, 0) for f in entries]
    while frontier:
        f, depth = frontier.pop()
        if f.qual in seen:
            continue
        seen.add(f.qual)
        prefix = f"{f.class_name}." if f.class_name else \
            f"{f.relpath}::"
        for attr, line, _col, _locks in f.attr_reads:
            note(prefix + attr, "reads", f.relpath, line)
        for attr, line, _col, _locks in f.attr_writes:
            note(prefix + attr, "writes", f.relpath, line)
        for name, line, _col, _locks in f.global_writes:
            note(f"{f.relpath}::{name}", "writes", f.relpath, line)
        if depth >= _BFS_DEPTH:
            continue
        for call in f.calls:
            for qual in call.resolved:
                callee = index.functions.get(qual)
                if callee is not None and callee.qual not in seen:
                    frontier.append((callee, depth + 1))
    for slot in foot.values():
        slot["reads"] = slot["reads"][:_MAX_SITES]
        slot["writes"] = slot["writes"][:_MAX_SITES]
    return foot


def _access(slot: Dict[str, List[str]]) -> str:
    kinds = [k for k in ("read", "write") if slot[k + "s"]]
    return "+".join(kinds)


def overlap_report(index: ProjectIndex, config,
                   entries_a: Sequence[str], entries_b: Sequence[str],
                   names: Tuple[str, str] = ("a", "b")) -> Dict:
    """The overlapped tick's gate artifact: fields both surfaces touch
    where at least one side writes — every entry is shared state an
    overlapped pipeline must serialize (or prove immutable)."""
    build_model(index, config)        # roles feed nothing here yet,
    fa, missing_a = resolve_entries(index, entries_a)   # but keep the
    fb, missing_b = resolve_entries(index, entries_b)   # memo warm
    foot_a = _footprint(index, fa)
    foot_b = _footprint(index, fb)
    conflicts = []
    for field in sorted(set(foot_a) & set(foot_b)):
        a, b = foot_a[field], foot_b[field]
        if not (a["writes"] or b["writes"]):
            continue                  # read/read never contends
        conflicts.append({
            "field": field,
            f"{names[0]}_access": _access(a),
            f"{names[1]}_access": _access(b),
            f"{names[0]}_sites": a["writes"][:_MAX_SITES]
            or a["reads"][:_MAX_SITES],
            f"{names[1]}_sites": b["writes"][:_MAX_SITES]
            or b["reads"][:_MAX_SITES],
        })
    return {
        names[0]: {"entries": list(entries_a),
                   "resolved": sorted(f.qual for f in fa),
                   "unresolved": missing_a},
        names[1]: {"entries": list(entries_b),
                   "resolved": sorted(f.qual for f in fb),
                   "unresolved": missing_b},
        "conflicts": conflicts,
    }


def render_overlap_text(report: Dict,
                        names: Tuple[str, str] = ("a", "b")) -> str:
    lines = []
    for side in names:
        info = report[side]
        lines.append(f"[{side}] entries: {', '.join(info['entries'])}"
                     f" ({len(info['resolved'])} functions)")
        for spec in info["unresolved"]:
            lines.append(f"[{side}] unresolved entry: {spec}")
    if not report["conflicts"]:
        lines.append("no overlapping read/write footprint")
    for c in report["conflicts"]:
        lines.append(
            f"{c['field']}: {names[0]}={c[names[0] + '_access']} "
            f"{names[1]}={c[names[1] + '_access']} "
            f"(e.g. {c[names[0] + '_sites'][0]} vs "
            f"{c[names[1] + '_sites'][0]})")
    lines.append(f"{len(report['conflicts'])} overlapping field(s)")
    return "\n".join(lines)


def render_overlap_sarif(report: Dict,
                         names: Tuple[str, str] = ("a", "b")) -> Dict:
    results = []
    for c in report["conflicts"]:
        site = c[names[0] + "_sites"][0]
        path, _, line = site.rpartition(":")
        results.append({
            "ruleId": "TO900",
            "level": "note",
            "message": {"text": (
                f"overlap on {c['field']}: "
                f"{names[0]}={c[names[0] + '_access']} "
                f"{names[1]}={c[names[1] + '_access']}")},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": int(line or 1)},
            }}],
        })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "tpushare-torch-analysis-overlap",
                "rules": [{
                    "id": "TO900",
                    "name": "overlap-footprint",
                    "shortDescription": {
                        "text": "read/write footprint overlap between "
                                "two execution surfaces"},
                    "properties": {"category": "ownership"},
                }],
            }},
            "results": results,
        }],
    }
