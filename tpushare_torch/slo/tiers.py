"""The port's copy of ``tpushare/slo/tiers.py`` (stdlib only; a test holds it
equal to the original).

Priority-tier model: the vocabulary every SLO policy speaks.

Three tiers cover the production traffic mix the north star names —
latency-tier chat, throughput-tier batch, and the standard middle:

=============  ====  ======  ============  ===============
tier           rank  weight  TTFT deadline  per-token deadline
=============  ====  ======  ============  ===============
interactive    0     4       500 ms        100 ms
standard       1     2       2000 ms       250 ms
batch          2     1       (none)        (none)
=============  ====  ======  ============  ===============

``rank`` orders strict priority (0 wins); ``weight`` is the
weighted-fair share of admission slots and tick-budget chunk room
(the batch-size/latency tradeoff knob — PAPERS.md 1812.11731
characterizes exactly the curve these weights walk); the deadlines
are the SLO the per-tier breach counters measure against. ``batch``
has no deadline by design: it exists to saturate the chip with
whatever the latency tiers leave, and is first in the shed order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One priority class. ``rank`` 0 is the highest priority;
    ``weight`` is the weighted-fairness share; deadlines are ``None``
    for best-effort (never counted as breached, never "at risk")."""
    name: str
    rank: int
    weight: int
    ttft_deadline_ms: Optional[float]
    per_token_deadline_ms: Optional[float]


#: Priority order, highest first — the admission preference.
TIER_ORDER = ("interactive", "standard", "batch")

#: Shed order, first-to-shed first — the router refuses ``batch``
#: before ``standard`` before ``interactive`` when the fleet
#: saturates (the exact inverse of TIER_ORDER, spelled out because
#: the two orders serve different readers).
SHED_ORDER = ("batch", "standard", "interactive")

DEFAULT_TIER = "standard"

TIERS: Dict[str, TierSpec] = {
    "interactive": TierSpec("interactive", rank=0, weight=4,
                            ttft_deadline_ms=500.0,
                            per_token_deadline_ms=100.0),
    "standard": TierSpec("standard", rank=1, weight=2,
                         ttft_deadline_ms=2000.0,
                         per_token_deadline_ms=250.0),
    "batch": TierSpec("batch", rank=2, weight=1,
                      ttft_deadline_ms=None,
                      per_token_deadline_ms=None),
}


def parse_tier(value, default: str = DEFAULT_TIER,
               specs: Optional[Dict[str, TierSpec]] = None) -> str:
    """Validate a request's ``tier`` field against ``specs`` (the
    built-in table by default; an engine running custom tier_specs
    passes its own). ``None`` takes the engine's default; anything
    not in the table is a loud ValueError — a typo'd ``"interactve"``
    silently landing in the default tier would be an SLO downgrade
    nobody asked for."""
    table = specs or TIERS
    if value is None:
        return default
    if not isinstance(value, str) or value not in table:
        raise ValueError(
            f"unknown tier {value!r}; known tiers: {tuple(table)}")
    return value


def tier_rank(tier: str,
              specs: Optional[Dict[str, TierSpec]] = None) -> int:
    return (specs or TIERS)[tier].rank
