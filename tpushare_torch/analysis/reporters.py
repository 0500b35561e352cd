"""Finding reporters: human text, JSON, and SARIF 2.1.0.

Baselined-vs-new tagging is by finding IDENTITY against the ``new``
list the baseline diff produced — not by key sets — so duplicate
identical findings (same rule+path+snippet, two lines) where only some
are baselined tag and count exactly as the gate enforces.

SARIF is the GitHub code-scanning ingestion format: an upload of
``--format sarif`` output annotates the exact lines of a diff. ``partialFingerprints`` carries the baseline's snippet
identity, which keeps alert tracking stable across unrelated
line-number drift — the same ratchet semantics, surfaced in the PR
UI.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional, Sequence

from tpushare_torch.analysis.engine import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def render_text(findings: Sequence[Finding],
                new: Optional[Sequence[Finding]] = None,
                stale: Sequence[dict] = ()) -> str:
    """One line per finding, ``[baselined]``-tagged when ratcheted,
    plus a stale-entry footer nudging a baseline update."""
    new_ids = None if new is None else {id(f) for f in new}
    lines = []
    for f in findings:
        tag = ""
        if new_ids is not None and id(f) not in new_ids:
            tag = "  [baselined]"
        lines.append(f.render() + tag)
    if new_ids is not None:
        n_new = sum(1 for f in findings if id(f) in new_ids)
        lines.append(f"{len(findings)} finding(s), {n_new} new")
    else:
        lines.append(f"{len(findings)} finding(s)")
    for e in stale:
        lines.append(
            f"stale baseline entry (violation fixed — run "
            f"--update-baseline): {e.get('rule')} {e.get('path')} "
            f"{e.get('snippet', '')[:60]!r}")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding],
                new: Optional[Sequence[Finding]] = None,
                stale: Sequence[dict] = ()) -> str:
    new_ids = None if new is None else {id(f) for f in new}
    out = []
    for f in findings:
        d = f.to_dict()
        if new_ids is not None:
            d["baselined"] = id(f) not in new_ids
        out.append(d)
    payload = {"findings": out, "stale_baseline_entries": list(stale)}
    return json.dumps(payload, indent=1)


def _fingerprint(f: Finding) -> str:
    """Stable identity hash over the baseline key (rule, path,
    stripped source line) — deliberately NOT the line number, so a
    code-scanning alert survives unrelated drift exactly like a
    baseline entry does."""
    h = hashlib.sha256()
    for part in f.key:
        h.update(part.encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.hexdigest()


def render_sarif(findings: Sequence[Finding],
                 new: Optional[Sequence[Finding]] = None,
                 stale: Sequence[dict] = (),
                 rules: Sequence = ()) -> str:
    """SARIF 2.1.0 run. Baselined findings report at ``note`` level,
    new ones at ``error`` — code scanning then surfaces exactly what
    the gate would fail on. ``rules`` (Rule instances) populate the
    tool's rule metadata so the UI can show descriptions."""
    new_ids = None if new is None else {id(f) for f in new}
    rule_meta = []
    seen_rules = set()
    for r in rules:
        if r.id in seen_rules:
            continue
        seen_rules.add(r.id)
        rule_meta.append({
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.name},
            "fullDescription": {"text": r.description},
            "defaultConfiguration": {"level": "error"},
            # per-family category tag: code scanning groups findings
            # by family (tracer-safety / concurrency / wire-contract /
            # resource-leak / ownership / generator-discipline /
            # async-copy / tensor-escape / kernel-build)
            "properties": {"category": getattr(r, "family", "")},
        })
    results = []
    for f in findings:
        baselined = new_ids is not None and id(f) not in new_ids
        results.append({
            "ruleId": f.rule,
            "level": "note" if baselined else "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": f.col + 1,
                               "snippet": {"text": f.snippet}},
                },
            }],
            "partialFingerprints": {
                "tpushareSnippetIdentity/v1": _fingerprint(f)},
            "properties": {"baselined": baselined},
        })
    payload = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "tpushare-torch-analysis",
                "informationUri":
                    "https://github.com/tpushare_torch/tpushare"
                    "/blob/main/README.md",
                "rules": rule_meta,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
            "properties": {
                "staleBaselineEntries": list(stale),
            },
        }],
    }
    return json.dumps(payload, indent=1)
