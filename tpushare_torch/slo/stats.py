"""The port's copy of ``tpushare/slo/stats.py`` (stdlib only; a test holds it
equal to the original).

Per-tier fairness and SLO counters — the ``/stats`` ``per_tier``
surface the router's shed order and ``/scale`` advisory consume.

Engine-thread-owned, like the engine's flat ``_stats`` dict: only the
engine mutates; handler threads read a ``snapshot()``. Latency
percentiles come off bounded sample rings (newest ``SAMPLE_CAP``
observations) so the surface reflects CURRENT behavior — lifetime
histograms would let ancient good latency mask a live regression,
the same misread the router's uptime-scoped delta discipline exists
to prevent on the counter side.

Deadline semantics: a tier with no deadline (batch) never breaches.
TTFT is measured submit -> first pushed token and is recorded ONCE
per request — a quarantine/replay does not restart the clock (the
tier contract survives replay; the chaos pin holds this).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from tpushare_torch.slo.tiers import TIERS, TierSpec

#: newest latency observations kept per (tier, metric)
SAMPLE_CAP = 512

_COUNTERS = ("admitted", "completed", "preempted", "quarantined",
             "deadline_breaches", "tokens")


def _pct(samples, q: float) -> Optional[float]:
    """Nearest-rank percentile over a small ring; None when empty."""
    if not samples:
        return None
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return round(ordered[idx], 2)


class TierStats:
    def __init__(self, specs: Optional[Dict[str, TierSpec]] = None):
        self.specs = dict(specs or TIERS)
        self._c = {name: dict.fromkeys(_COUNTERS, 0)  # tpushare: owner[engine]
                   for name in self.specs}
        # Plain lists, not deques: snapshot() runs on a handler thread
        # while the engine appends, and a list's [:] copy is one
        # GIL-atomic op — iterating a deque mid-append raises.
        self._ttft: Dict[str, List[float]] = {  # tpushare: owner[engine]
            name: [] for name in self.specs}
        self._per_tok: Dict[str, List[float]] = {  # tpushare: owner[engine]
            name: [] for name in self.specs}

    @staticmethod
    def _push(ring: List[float], v: float) -> None:
        ring.append(v)
        if len(ring) > SAMPLE_CAP:
            del ring[:len(ring) - SAMPLE_CAP]

    def bump(self, tier: str, counter: str, n: int = 1) -> None:
        self._c[tier][counter] += n

    def record_first_token(self, tier: str, ttft_ms: float) -> None:
        """First pushed token: the TTFT observation + breach check."""
        self._push(self._ttft[tier], ttft_ms)
        deadline = self.specs[tier].ttft_deadline_ms
        if deadline is not None and ttft_ms > deadline:
            self._c[tier]["deadline_breaches"] += 1

    def record_completion(self, tier: str, n_tokens: int,
                          gen_ms: float) -> None:
        """Terminal success: token count + the stream's mean
        inter-token latency (first token -> done over n-1 gaps; a
        one-token stream contributes no per-token sample)."""
        self._c[tier]["completed"] += 1
        if n_tokens > 1:
            per_tok = gen_ms / (n_tokens - 1)
            self._push(self._per_tok[tier], per_tok)
            deadline = self.specs[tier].per_token_deadline_ms
            if deadline is not None and per_tok > deadline:
                self._c[tier]["deadline_breaches"] += 1

    # tpushare: reader
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name in self.specs:
            row: Dict[str, Any] = dict(self._c[name])
            ttft, per_tok = self._ttft[name][:], self._per_tok[name][:]
            row["ttft_p50_ms"] = _pct(ttft, 0.50)
            row["ttft_p99_ms"] = _pct(ttft, 0.99)
            row["per_token_p50_ms"] = _pct(per_tok, 0.50)
            row["per_token_p99_ms"] = _pct(per_tok, 0.99)
            out[name] = row
        return out
