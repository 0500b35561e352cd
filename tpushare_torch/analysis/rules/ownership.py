"""TO901/TO902 — thread-ownership violations over declared contracts.

The CC2xx family catches *lexical* concurrency bugs (a handler method
touching a field the same class's loop touches). What it cannot see is
the interprocedural, cross-class shape a review once had to fix: the
engine thread owns ``TierStats._c`` outright, the HTTP stats handler
reads it through ``snapshot()``'s atomic copies, and nothing but prose
said so. The ownership layer (``analysis/threads.py``) makes the
contract machine-readable — ``# tpushare: owner[engine]`` /
``# tpushare: lock[attr]`` on the ``__init__`` assignment, ``#
tpushare: reader`` on the sanctioned cross-role reader, and the
``TPUSHARE_OWNERSHIP`` module registry for cross-class and
serialized-role contracts — and these rules enforce it:

- **TO901 cross-thread-bare-write**: a method that thread-role
  inference places on a role other than the declared owner (and not
  serialized with it) writes an owned field — holding some lock does
  not help, because the owner writes bare by contract. For
  ``lock[attr]`` fields the check is the dual: any role writing
  without the lock provably held (lexically or via the entry-lock
  fold) fires.
- **TO902 torn-multi-field-read**: a method reads ≥2 contested fields
  (or one field at ≥2 sites) lock-free from a foreign role — the
  inconsistent-snapshot read CC201 can't see across classes. A
  declared ``reader`` is exempt only while it keeps the atomic-copy
  discipline: each contested field read at exactly one site.

Both rules compute once per ProjectIndex (CC204-style memo) and fan
findings back out per file, so whole-tree runs stay inside the
wall-time budget.
"""

from __future__ import annotations

from typing import Iterator

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis import threads

OWNERSHIP_PATHS = ("tpushare_torch",)


class _Pos:
    def __init__(self, line: int, col: int):
        self.lineno = line
        self.col_offset = col


class _OwnershipRule(Rule):
    family = "ownership"
    paths = OWNERSHIP_PATHS

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for relpath, line, col, rule_id, msg in \
                threads.ownership_findings(ctx.project, ctx.config):
            if rule_id == self.id and relpath == ctx.relpath:
                yield ctx.finding(self.id, _Pos(line, col), msg)


@register
class CrossThreadBareWrite(_OwnershipRule):
    id = "TO901"
    name = "cross-thread-bare-write"
    description = ("write to a declared-owner field from a thread "
                   "role that is neither the owner nor serialized "
                   "with it, or to a lock[attr] field without the "
                   "lock held — the interprocedural, role-aware "
                   "generalization of CC201")


@register
class TornMultiFieldRead(_OwnershipRule):
    id = "TO902"
    name = "torn-multi-field-read"
    description = ("lock-free cross-role read of multiple contested "
                   "fields (or one field at multiple sites) — an "
                   "inconsistent snapshot; declared readers are held "
                   "to the one-site atomic-copy discipline")
