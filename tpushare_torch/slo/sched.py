"""The port's copy of ``tpushare/slo/sched.py`` (stdlib only; a test holds it
equal to the original).

Deadline-aware tick scheduling: the per-tick policy decisions.

The engine already owns the mechanisms — a bounded intake queue,
chunked admission fused into the decode forward, a tick token budget,
token-exact preemption+replay. This module owns the POLICY: which
request admits next, which in-flight admission's chunk rides the
fused tick, which side wins the decode/admission alternation when the
budget leaves no chunk room, and which slot a preemption evicts.
Every decision is pure host arithmetic (jax-free, no device syncs) so
the engine's one-fetch-per-tick invariant survives tiering untouched.

Request duck contract (the engine's ``_Request`` satisfies it; unit
tests pass stubs): ``.tier`` (name in the spec table), ``.seq``
(admit order, newest highest), ``.t_submit`` (monotonic seconds),
``.tokens`` (list — empty means no first token yet, so the TTFT clock
is still running).

Policy, per the tier table (tiers.py):

* **Admission order** — weighted fairness across non-empty tier
  queues (deficit counters fed by tier weight, so ``batch`` keeps
  flowing at its share instead of starving), with a STRICT-PRIORITY
  override the moment the head ``interactive`` request's TTFT
  deadline is at risk: at-risk latency traffic preempts the fair
  rotation entirely.
* **Fused-chunk arbitration** — same two-level rule over the
  in-flight chunked admissions: an at-risk ``interactive`` admission
  always advances; otherwise tiers take weighted turns.
* **Alternation override** — when the tick budget leaves no chunk
  room beside the decode batch, the engine alternates decode-only and
  admission-only ticks; an at-risk higher-priority admission claims
  the tick outright, and a ``batch`` admission never steals a tick
  from an active higher-tier decode row (its prefill can wait;
  their per-token deadlines cannot).
* **Preemption victims** — lowest tier first, newest admit within the
  tier (least work lost); preempt-for-high additionally requires the
  victim to be STRICTLY below the incoming tier, so equal-tier
  traffic never churns itself.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional

from tpushare_torch.slo.tiers import DEFAULT_TIER, TIER_ORDER, TIERS, TierSpec


class AdmissionChoice:
    """A fused-chunk pick computed WITHOUT its deficit-counter side
    effect — the pure half of ``pick_admission``, so an overlapped
    engine can arbitrate tick N+1 while tick N's dispatch is still in
    flight and apply (``commit_admission``) the rotation debit only
    when the pick is actually used. Carries everything the commit
    needs: the winning slot, the tier that won, the non-empty tier
    rotation it won against, and whether a strict-priority (at-risk)
    override decided it (at-risk picks never spend credit)."""

    __slots__ = ("slot", "tier", "tiers", "risk")

    def __init__(self, slot: int, tier: str, tiers: List[str],
                 risk: Optional[str]):
        self.slot = slot
        self.tier = tier
        self.tiers = list(tiers)
        self.risk = risk

#: Fraction of a TTFT deadline after which a first-token-less request
#: counts as "at risk" — early enough that the strict-priority
#: override still has ticks to spend before the breach lands.
AT_RISK_FRACTION = 0.5


def _rank(req, specs: Optional[Dict[str, TierSpec]] = None) -> int:
    return (specs or TIERS)[req.tier].rank


def choose_victim(active: Dict[int, object],
                  below_rank: Optional[int] = None,
                  specs: Optional[Dict[str, TierSpec]] = None
                  ) -> Optional[int]:
    """Preemption victim among ``{slot: request}``: lowest tier
    (highest rank) first, newest (highest seq) within it — the newest
    low-tier admit loses the least work. ``below_rank`` restricts to
    victims STRICTLY lower-priority than the incoming rank
    (preempt-low-for-HIGH only); None means pool pressure with no
    incoming request, where any newest-lowest victim will do.
    ``specs`` defaults to the built-in tier table — an engine running
    custom tier_specs passes its own so every policy speaks the same
    vocabulary."""
    cands = [(slot, req) for slot, req in active.items()
             if below_rank is None or _rank(req, specs) > below_rank]
    if not cands:
        return None
    return max(cands,
               key=lambda sr: (_rank(sr[1], specs), sr[1].seq))[0]


class TickScheduler:
    """Priority admission queues + the per-tick arbitration policy.

    Single-threaded by contract: mutated only from the engine thread
    (the engine holds its ``_pop_lock`` around the queue-facing calls
    so ``drain()``'s cross-thread idle check stays honest, exactly as
    it did for the flat queue this replaces). ``now_fn`` is injectable
    so tests drive deadline risk deterministically."""

    def __init__(self, specs: Optional[Dict[str, TierSpec]] = None,
                 default_tier: str = DEFAULT_TIER, now_fn=time.monotonic):
        self.specs = dict(specs or TIERS)
        if default_tier not in self.specs:
            raise ValueError(f"default tier {default_tier!r} not in "
                             f"{tuple(self.specs)}")
        self.default_tier = default_tier
        self._now = now_fn
        self._queues: Dict[str, Deque] = {
            name: collections.deque() for name in self.specs}
        # Weighted-fairness deficit counters: one table for the
        # admission queues, a separate one for the fused-chunk
        # rotation (the two decisions run at different rates and must
        # not steal each other's credit).
        self._pop_credit = {name: 0 for name in self.specs}
        self._chunk_credit = {name: 0 for name in self.specs}

    # -- deadline clocks ---------------------------------------------
    def at_risk(self, req) -> bool:
        """TTFT deadline at risk: no first token yet and more than
        AT_RISK_FRACTION of the tier's TTFT budget already burned.
        Deadline-less tiers (batch) are never at risk."""
        spec = self.specs[req.tier]
        if spec.ttft_deadline_ms is None or req.tokens:
            return False
        elapsed_ms = (self._now() - req.t_submit) * 1e3
        return elapsed_ms >= AT_RISK_FRACTION * spec.ttft_deadline_ms

    # -- admission queues --------------------------------------------
    def push(self, req) -> None:
        """Newly accepted request joins the back of its tier."""
        self._queues[req.tier].append(req)

    def push_front(self, req) -> None:
        """Held work (pool-pressure re-admits, preempted victims,
        quarantine replays) resumes at the FRONT of its tier — it
        keeps its place against its own tier, while the tier rotation
        still decides across tiers."""
        self._queues[req.tier].appendleft(req)

    def backlog(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def backlog_by_tier(self) -> Dict[str, int]:
        return {name: len(q) for name, q in self._queues.items()}

    def drain(self) -> List:
        """Pop everything (priority order) — the engine's
        fail-the-backlog path on shutdown/dead-engine."""
        out: List = []
        for name in sorted(self._queues, key=lambda n: self.specs[n].rank):
            q = self._queues[name]
            while q:
                out.append(q.popleft())
        return out

    def _peek_tier(self, nonempty: List[str], credit: Dict[str, int],
                   risk_head: Optional[str]) -> str:
        """``_pick_tier``'s answer WITHOUT the deficit mutation —
        computed off a shadow of the credit table, so it is safe to
        call while a dispatch is in flight and again (idempotently)
        until the pick is committed."""
        if risk_head is not None:
            return risk_head
        shadow = {n: credit[n] + self.specs[n].weight for n in nonempty}
        return min(nonempty,
                   key=lambda n: (-shadow[n], self.specs[n].rank))

    def _commit_tier(self, nonempty: List[str], credit: Dict[str, int],
                     risk_head: Optional[str], pick: str) -> None:
        """Apply the deficit update ``_peek_tier`` deferred. No-op for
        a strict-priority (at-risk) pick, exactly as ``_pick_tier``
        never spent credit on one."""
        if risk_head is not None:
            return
        total = sum(self.specs[n].weight for n in nonempty)
        for n in nonempty:
            credit[n] += self.specs[n].weight
        credit[pick] -= total

    def _pick_tier(self, nonempty: List[str], credit: Dict[str, int],
                   risk_head: Optional[str]) -> str:
        """Two-level pick: strict priority for an at-risk head, else
        deficit-weighted rotation. Deterministic: credit ties break to
        the higher-priority (lower-rank) tier. Peek + commit, so the
        pure half is reusable on its own."""
        pick = self._peek_tier(nonempty, credit, risk_head)
        self._commit_tier(nonempty, credit, risk_head, pick)
        return pick

    def peek(self):
        """The request the next ``pop()`` would return, WITHOUT
        popping it or spending rotation credit — the pure half of
        ``pop()``, for precomputing admission work inside an overlap
        window. Pure by contract: no queue or credit mutation, no
        device syncs."""
        nonempty = [n for n in self._queues if self._queues[n]]
        if not nonempty:
            return None
        nonempty.sort(key=lambda n: self.specs[n].rank)
        risk = next((n for n in nonempty
                     if self.at_risk(self._queues[n][0])), None)
        name = self._peek_tier(nonempty, self._pop_credit, risk)
        return self._queues[name][0]

    def pop(self):
        """Next request to admit, or None when every queue is empty."""
        nonempty = [n for n in self._queues if self._queues[n]]
        if not nonempty:
            return None
        nonempty.sort(key=lambda n: self.specs[n].rank)
        risk = next((n for n in nonempty
                     if self.at_risk(self._queues[n][0])), None)
        name = self._pick_tier(nonempty, self._pop_credit, risk)
        return self._queues[name].popleft()

    # -- fused-tick arbitration --------------------------------------
    def peek_admission(self, admitting: Dict[int, object]
                       ) -> Optional[AdmissionChoice]:
        """The pure half of ``pick_admission``: compute which
        in-flight chunked admission WOULD advance, without spending
        the rotation's deficit credit. The returned choice is applied
        later with ``commit_admission`` — or simply dropped if the
        admitting set changed while a dispatch was in flight."""
        if not admitting:
            return None
        by_tier: Dict[str, List[int]] = {}
        for slot, req in admitting.items():
            by_tier.setdefault(req.tier, []).append(slot)
        nonempty = sorted(by_tier, key=lambda n: self.specs[n].rank)
        risk = next(
            (n for n in nonempty
             if any(self.at_risk(admitting[s]) for s in by_tier[n])),
            None)
        tier = self._peek_tier(nonempty, self._chunk_credit, risk)
        slot = min(by_tier[tier], key=lambda s: admitting[s].seq)
        return AdmissionChoice(slot, tier, nonempty, risk)

    def commit_admission(self, choice: Optional[AdmissionChoice]
                         ) -> Optional[int]:
        """Apply the deficit debit a ``peek_admission`` deferred and
        return its winning slot — the impure half of
        ``pick_admission``."""
        if choice is None:
            return None
        self._commit_tier(choice.tiers, self._chunk_credit,
                          choice.risk, choice.tier)
        return choice.slot

    def pick_admission(self, admitting: Dict[int, object]) -> Optional[int]:
        """Which in-flight chunked admission advances this tick.
        ``admitting``: {slot: request} (engine reaps cancelled entries
        before calling). Strict priority for an at-risk request, else
        weighted rotation across the tiers present; within a tier the
        oldest admission (lowest seq) goes first so chunk progress is
        FIFO per tier. Exactly ``peek_admission`` + ``commit_admission``
        — the overlapped engine calls the halves separately."""
        return self.commit_admission(self.peek_admission(admitting))

    def alternation(self, admit_req, active: Dict[int, object]
                    ) -> Optional[str]:
        """Budget left no chunk room beside the decode batch: who gets
        the tick? Returns ``"admit"`` (admission-only tick),
        ``"decode"`` (decode-only), or None (keep the engine's fair
        alternation). An at-risk admission STRICTLY above every active
        row claims the tick; an admission strictly below the best
        active tier never steals one (a batch prefill must not stall
        an interactive stream's per-token clock — batch starvation is
        bounded by the active streams' own lifetimes, and shedding
        batch first is the tier contract). Equal tiers keep the fair
        alternation, so a single-tier deployment behaves exactly as
        it did before tiering existed."""
        if not active:
            return "admit"
        best_active = min(_rank(r, self.specs) for r in active.values())
        a_rank = _rank(admit_req, self.specs)
        if a_rank < best_active and self.at_risk(admit_req):
            return "admit"
        if a_rank > best_active:
            return "decode"
        return None
