"""Rule self-documentation: ``--explain RULE`` and the generated
rule-family table.

``--explain`` is grounded in the FIXTURES, not prose: the positive
example is the first line the rule actually flags in its own positive
fixture under tests/fixtures/torch_analysis/ (re-analyzed live), and
the negative fixture is re-checked to scan clean. A rule whose fixture
has drifted — or a rule registered with no fixture at all — fails to
explain, and a tier-1 test walks the whole registry, so orphan rules
and fixture drift are structurally impossible.

``render_rule_table()`` is the single source of the port's rule table
embedded in README.md's port section between its own ``PORT RULE
TABLE`` markers (apart from the JAX package's ``RULE TABLE`` markers,
which no port marker contains); a doc-sync test regenerates it from
the registry and compares byte-for-byte.
"""

from __future__ import annotations

import os
from typing import Optional

from tpushare_torch.analysis.engine import Rule, all_rules, analyze_file

FIXTURE_SUBDIR = os.path.join("tests", "fixtures", "torch_analysis")

TABLE_BEGIN = "<!-- PORT RULE TABLE BEGIN (generated from the port's "\
    "registry; regenerate: python -m tpushare_torch.analysis --rule-table) -->"
TABLE_END = "<!-- PORT RULE TABLE END -->"


class ExplainError(RuntimeError):
    """A rule cannot explain itself: missing fixture, fixture drift
    (positive yields nothing / negative yields findings)."""


def _family_prefix(rule_id: str) -> str:
    return "".join(c for c in rule_id if c.isalpha()).lower()


def fixture_for(rule_id: str, kind: str, root: str) -> Optional[str]:
    """Path of the rule's ``{kind}`` fixture: the rule-specific file
    (``ts103_positive.py``) when present, else the family file
    (``ts_positive.py``)."""
    base = os.path.join(root, FIXTURE_SUBDIR)
    for stem in (rule_id.lower(), _family_prefix(rule_id)):
        cand = os.path.join(base, f"{stem}_{kind}.py")
        if os.path.isfile(cand):
            return cand
    return None


def _context_block(path: str, line: int, radius: int = 2) -> str:
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    lo = max(0, line - 1 - radius)
    hi = min(len(lines), line + radius)
    out = []
    for i in range(lo, hi):
        marker = ">>" if i == line - 1 else "  "
        out.append(f"  {marker} {i + 1:4d} | {lines[i]}")
    return "\n".join(out)


def explain(rule: Rule, config) -> str:
    """Human-readable explanation of one rule, grounded in its live
    fixtures. Raises ExplainError on any drift."""
    root = getattr(config, "root", ".")
    pos = fixture_for(rule.id, "positive", root)
    neg = fixture_for(rule.id, "negative", root)
    if pos is None or neg is None:
        raise ExplainError(
            f"{rule.id}: no {'positive' if pos is None else 'negative'} "
            f"fixture under {FIXTURE_SUBDIR}/ — every registered rule "
            f"must ship one (orphan rule)")
    pos_findings = [f for f in analyze_file(pos, config, rules=[rule],
                                            respect_scope=False)
                    if f.rule == rule.id]
    if not pos_findings:
        raise ExplainError(
            f"{rule.id}: positive fixture {os.path.basename(pos)} "
            f"yields no {rule.id} finding — fixture drift")
    neg_findings = [f for f in analyze_file(neg, config, rules=[rule],
                                            respect_scope=False)
                    if f.rule == rule.id]
    if neg_findings:
        raise ExplainError(
            f"{rule.id}: negative fixture {os.path.basename(neg)} "
            f"yields {len(neg_findings)} finding(s) — fixture drift: "
            + "; ".join(f.render() for f in neg_findings))
    first = pos_findings[0]
    scope = ", ".join(rule.paths) if rule.paths else "whole tree"
    lines = [
        f"{rule.id} {rule.name}  [{rule.family or 'unfamilied'}]",
        f"  scope: {scope}",
        "",
        f"  {rule.description}",
        "",
        f"  positive example ({os.path.basename(pos)}:{first.line} — "
        f"{len(pos_findings)} finding(s) in the fixture):",
        _context_block(pos, first.line),
        f"     {first.message}",
        "",
        f"  negative fixture {os.path.basename(neg)} scans clean "
        f"({rule.id}).",
        "",
        f"  suppress on the flagged line with:",
        f"      # tpushare: ignore[{rule.id}]",
    ]
    return "\n".join(lines)


def render_rule_table() -> str:
    """The markdown rule table, one row per registered rule, sorted by
    id — THE text between the port's RULE TABLE markers in README.md
    (doc-sync test enforced)."""
    rows = ["| id | family | name | scope |",
            "| --- | --- | --- | --- |"]
    for rule in sorted(all_rules(), key=lambda r: r.id):
        scope = ", ".join(f"`{p}`" for p in rule.paths) or "whole tree"
        rows.append(f"| {rule.id} | {rule.family} | {rule.name} "
                    f"| {scope} |")
    return "\n".join(rows)


def table_block() -> str:
    return f"{TABLE_BEGIN}\n{render_rule_table()}\n{TABLE_END}"


def extract_table(doc_text: str) -> Optional[str]:
    """The generated table embedded in a doc, or None if the markers
    are missing."""
    try:
        start = doc_text.index(TABLE_BEGIN) + len(TABLE_BEGIN)
        end = doc_text.index(TABLE_END, start)
    except ValueError:
        return None
    return doc_text[start:end].strip("\n")
