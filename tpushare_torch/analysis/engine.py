"""AST static-analysis engine: findings, rule registry, suppression.

The port's bug classes that hurt in production — host syncs in the
serving tick and in autograd, draws off the process-global random
stream, unlocked shared state on watcher threads, wire-contract literal
drift — are all statically detectable. This module is the framework
half: rules live in tpushare_torch/analysis/rules/, the ratchet in
baseline.py, the CLI in __main__.py.

Suppression: append ``# tpushare: ignore[RULE-ID]`` (or a bare
``# tpushare: ignore`` for all rules) to the flagged line. Suppressions
are per-line and per-rule so they never hide a *second* violation
arriving on the same line under a different rule.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*tpushare:\s*ignore(?:\[([A-Za-z0-9_,\s-]*)\])?")

#: sentinel for "every rule suppressed on this line"
ALL_RULES = "*"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str      # rule id, e.g. "TS101"
    path: str      # repo-relative posix path
    line: int      # 1-based
    col: int       # 0-based
    message: str
    snippet: str   # stripped source line: the baseline identity, so
                   # findings survive unrelated line-number drift

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: WHERE (file) and WHAT (rule + exact
        source text), deliberately not the line number."""
        return (self.rule, self.path, self.snippet)

    @property
    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """Everything a rule needs about one source file."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module, config, project=None):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config = config
        self._docstrings: Optional[Set[int]] = None
        self._project = project

    @property
    def project(self):
        """The inter-procedural ProjectIndex. analyze_paths passes the
        project-wide one; a standalone analyze_file (fixture tests)
        lazily builds a single-file index so self-contained call
        chains still resolve."""
        if self._project is None:
            from tpushare_torch.analysis import callgraph
            self._project = callgraph.build_index(
                [self.path], root=getattr(self.config, "root", None))
        return self._project

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule, path=self.relpath, line=line, col=col,
                       message=message, snippet=snippet)

    def docstring_nodes(self) -> Set[int]:
        """ids of Constant nodes that are module/class/function
        docstrings (documentation may NAME wire strings freely)."""
        if self._docstrings is None:
            ids: Set[int] = set()
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.Module, ast.ClassDef,
                                     ast.FunctionDef, ast.AsyncFunctionDef)):
                    body = getattr(node, "body", [])
                    if (body and isinstance(body[0], ast.Expr)
                            and isinstance(body[0].value, ast.Constant)
                            and isinstance(body[0].value.value, str)):
                        ids.add(id(body[0].value))
            self._docstrings = ids
        return self._docstrings


class Rule:
    """One check. Subclasses set ``id``/``name``/``family``/
    ``description`` and ``paths`` (repo-relative prefixes the rule is
    scoped to; empty = whole tree) and implement ``check``.
    ``family`` groups rules for SARIF ``rule.category`` tags and the
    generated rule table (the README doc-sync)."""

    id: str = ""
    name: str = ""
    family: str = ""
    description: str = ""
    paths: Sequence[str] = ()

    def applies_to(self, relpath: str) -> bool:
        if not self.paths:
            return True
        rp = relpath.replace(os.sep, "/")
        return any(rp.startswith(p) for p in self.paths)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: List[Rule] = []


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    _REGISTRY.append(cls())
    return cls


def all_rules() -> List[Rule]:
    from tpushare_torch.analysis import rules  # noqa: F401  (registers on import)
    return list(_REGISTRY)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

def parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number (1-based) -> set of suppressed rule ids (or ALL_RULES)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        inner = m.group(1)
        if inner is None or not inner.strip():
            out[i] = {ALL_RULES}
        else:
            out[i] = {part.strip() for part in inner.split(",") if part.strip()}
    return out


def _suppressed(finding: Finding, suppressions: Dict[int, Set[str]]) -> bool:
    rules_on_line = suppressions.get(finding.line)
    if not rules_on_line:
        return False
    return ALL_RULES in rules_on_line or finding.rule in rules_on_line


# ---------------------------------------------------------------------------
# File walking + running
# ---------------------------------------------------------------------------

def iter_py_files(paths: Iterable[str],
                  exclude: Sequence[str] = ()) -> Iterator[str]:
    """Yield .py files under ``paths`` (files pass through), skipping
    any whose normalized path ends with an ``exclude`` entry."""
    def excluded(p: str) -> bool:
        q = p.replace(os.sep, "/")
        return any(q.endswith(e) for e in exclude)

    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py") and not excluded(path):
                yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                if fn.endswith(".py") and not excluded(full):
                    yield full


def relativize(path: str, root: Optional[str]) -> str:
    """Repo-relative posix path when under ``root``; otherwise the
    path as given (fixtures/tmp files keep their own identity)."""
    ap = os.path.abspath(path)
    if root:
        ar = os.path.abspath(root)
        if ap == ar or ap.startswith(ar + os.sep):
            return os.path.relpath(ap, ar).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def analyze_file(path: str, config, rules: Optional[Sequence[Rule]] = None,
                 respect_scope: bool = True, project=None) -> List[Finding]:
    """Run ``rules`` (default: all registered) over one file.
    Suppression comments are honored; scoping can be disabled for
    fixture-driven rule tests. ``project``: the ProjectIndex the
    inter-procedural rules resolve against (default: this file alone)."""
    rules = all_rules() if rules is None else list(rules)
    relpath = relativize(path, getattr(config, "root", None))
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding(rule="PARSE", path=relpath, line=1, col=0,
                        message=f"unreadable: {e}", snippet="")]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="PARSE", path=relpath, line=e.lineno or 1,
                        col=e.offset or 0, message=f"syntax error: {e.msg}",
                        snippet="")]
    ctx = FileContext(path, relpath, source, tree, config, project=project)
    suppressions = parse_suppressions(ctx.lines)
    findings: List[Finding] = []
    for rule in rules:
        if respect_scope and not rule.applies_to(relpath):
            continue
        for f in rule.check(ctx):
            if not _suppressed(f, suppressions):
                findings.append(f)
    return findings


def analyze_paths(paths: Iterable[str], config,
                  rules: Optional[Sequence[Rule]] = None,
                  project_paths: Optional[Iterable[str]] = None,
                  jobs: Optional[int] = None) -> List[Finding]:
    """Analyze every .py under ``paths``. The inter-procedural index
    is built over ``project_paths`` (default: the analyzed set) UNION
    the analyzed files — a ``--diff`` run hands the full configured
    tree here so transitive rules stay sound while only the changed
    files are re-reported. ``jobs`` > 1 fans the per-file parse/
    summary extraction over a process pool (results byte-identical to
    serial; the CLI exposes it as ``--jobs``)."""
    exclude = tuple(getattr(config, "exclude", ()))
    files = list(iter_py_files(paths, exclude=exclude))
    index_files = list(files)
    if project_paths is not None:
        index_files.extend(iter_py_files(project_paths, exclude=exclude))
    from tpushare_torch.analysis import callgraph
    project = callgraph.build_index(index_files,
                                    root=getattr(config, "root", None),
                                    jobs=jobs)
    findings: List[Finding] = []
    for path in files:
        findings.extend(analyze_file(path, config, rules=rules,
                                     project=project))
    return sorted(findings, key=lambda f: f.sort_key)
