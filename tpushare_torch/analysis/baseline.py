"""Baseline ratchet: pre-existing findings are recorded, not ignored.

The baseline file is a checked-in JSON list of finding identities
(rule, path, stripped source line) plus a one-line justification each;
``--check`` fails on an entry without one (``unjustified``).
``--check`` fails only on findings NOT in the baseline, so the finding
count can only ratchet down: fixing a finding leaves a stale entry the
reporter calls out, introducing one fails the gate. Matching is by
source text, not line number, so unrelated edits don't churn the file.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from tpushare_torch.analysis.engine import Finding

VERSION = 1


def load(path: str) -> List[dict]:
    """Baseline entries; a missing file is an empty baseline."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    if isinstance(data, dict):
        entries = data.get("entries", [])
    else:
        entries = data
    return [e for e in entries if isinstance(e, dict)]


def entry_key(entry: dict) -> Tuple[str, str, str]:
    return (str(entry.get("rule", "")), str(entry.get("path", "")),
            str(entry.get("snippet", "")))


def diff(findings: Sequence[Finding],
         entries: Sequence[dict]) -> Tuple[List[Finding], List[dict]]:
    """(new_findings, stale_entries) under multiset matching — two
    identical violations on different lines need two entries."""
    budget = Counter(entry_key(e) for e in entries)
    new: List[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    stale: List[dict] = []
    remaining = Counter(budget)
    for e in entries:
        k = entry_key(e)
        if remaining[k] > 0:
            remaining[k] -= 1
            stale.append(e)
    return new, stale


def unjustified(entries: Sequence[dict]) -> List[dict]:
    """Entries without a ``note``: the port's gate holds every recorded
    exception to a written cause, so these fail ``--check``."""
    return [e for e in entries if not str(e.get("note", "")).strip()]


def save(path: str, findings: Sequence[Finding],
         old_entries: Sequence[dict] = ()) -> None:
    """Write the baseline for the current findings, carrying forward
    any justification notes from matching old entries."""
    notes: Dict[Tuple[str, str, str], List[str]] = {}
    for e in old_entries:
        if e.get("note"):
            notes.setdefault(entry_key(e), []).append(str(e["note"]))
    entries = []
    for f in sorted(findings, key=lambda f: f.sort_key):
        pool = notes.get(f.key, [])
        entries.append({
            "rule": f.rule, "path": f.path, "snippet": f.snippet,
            "note": pool.pop(0) if pool else "",
        })
    payload = {"version": VERSION, "entries": entries}
    # write-tmp -> fsync -> rename (utils/atomicio, RL403): the
    # baseline is re-read by every later gate run — a crash mid-write
    # must leave the old complete file, never a torn one. The old
    # hand-rolled tmp+replace here lacked the fsync (a power loss
    # could rename a zero-length tmp into place).
    from tpushare_torch.utils import atomicio
    atomicio.write_json(path, payload)
