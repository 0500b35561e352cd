"""CC201 fixture — the SLO-tier-counter positive. Parsed by
the analyzer, never run.

Preserves the exact hazard the tpushare/slo sweep exists to catch: a
poll thread folding per-tier deadline-breach deltas into a shared
tier-counter map while an HTTP handler thread records sheds into the
same maps, with the poll-side stores holding no lock. The real
consumers (router/core.py's _tier_breaches_observed and shed_by_tier)
take ``self._lock`` around every one of these stores and are pinned
clean by tests/test_slo.py — this fixture is what it would look like
the day someone "simplifies" that away. Mirrors
cc201_router_shape.py, one subsystem up."""
import threading


class LeakyTierLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._tier_breaches = {"interactive": 0, "standard": 0,
                               "batch": 0}
        self._shed_by_tier = {"interactive": 0, "standard": 0,
                              "batch": 0}
        self._poll = threading.Thread(target=self._poll_loop,
                                      daemon=True)

    def _poll_loop(self):
        while True:
            for tier in list(self._tier_breaches):
                # CC201: poll-thread store into the breach map, no lock
                self._tier_breaches[tier] = self._tier_breaches[tier] + 1
                # CC201: same hazard on the shed map
                self._shed_by_tier[tier] = 0

    def do_POST(self):
        tier = "batch"
        with self._lock:
            self._tier_breaches[tier] = 0   # locked: not a finding
        # CC201: handler-side store into the shed map outside the lock
        self._shed_by_tier[tier] = self._shed_by_tier[tier] + 1
