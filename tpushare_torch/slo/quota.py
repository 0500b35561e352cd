"""The port's copy of ``tpushare/slo/quota.py`` (stdlib only; a test holds it
equal to the original).

Per-tenant KV-block quotas over the paged pool's host counters.

utils/tenant.py enforces the plugin's HBM-byte grant; this module
extends that contract one level up the stack, to the unit the serving
engine actually allocates: KV POOL BLOCKS. Each tenant gets

* a **reserve floor** — blocks the rest of the fleet must leave
  claimable for this tenant (admissions by OTHER tenants that would
  eat into an unmet floor are refused as transient pressure), and
* a **burstable ceiling** — the most blocks the tenant may hold at
  once (admissions past it are refused against the tenant itself,
  not held against the pool).

The ledger is jax-free bookkeeping: the paged server charges fresh
block allocations per slot (shared prefix-cache blocks are charged to
their first writer only — a hit costs the hitting tenant nothing,
which is the whole point of sharing) and refunds the slot's charge on
release. ``models/paged.py`` raises its tier-aware ``QuotaExceeded``
(a ``PoolExhausted`` subclass, so the engine's hold/preempt paths
compose) from the verdicts this ledger returns; the ledger itself
never raises — it is policy, not mechanism.

Single-threaded by contract, like every other host-side pool
structure: mutated only from the engine thread that owns the server.
The one cross-thread reader is ``snapshot()`` (the ``/stats`` handler
thread), which copies the ledger atomically before iterating.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TenantQuotaSpec:
    """``reserve`` blocks are this tenant's guaranteed floor;
    ``ceiling`` (None = unlimited) caps its burst; ``host_bytes``
    (None = unlimited) caps how much of the host offload tier its
    demoted blocks may occupy — the spill budget that lets a
    burst tenant shed to host RAM instead of 429ing, without letting
    it monopolize the shared tier."""
    reserve: int = 0
    ceiling: Optional[int] = None
    host_bytes: Optional[int] = None


def parse_quota_spec(text: str) -> Dict[str, TenantQuotaSpec]:
    """Parse the CLI spelling: ``tenant=reserve:ceiling`` pairs,
    comma-separated — ``acme=16:64,internal=0:32``. An empty ceiling
    (``acme=16:``) means unlimited burst above the floor. A third
    segment caps the tenant's host-tier bytes
    (``acme=16:64:1048576``); omitted or empty = unlimited host
    spill — the two-segment spelling keeps parsing exactly as
    before."""
    out: Dict[str, TenantQuotaSpec] = {}
    for part in (p.strip() for p in text.split(",") if p.strip()):
        try:
            tenant, rc = part.split("=", 1)
            r, c = rc.split(":", 1)
            h = ""
            if ":" in c:
                c, h = c.split(":", 1)
            spec = TenantQuotaSpec(reserve=int(r or 0),
                                   ceiling=int(c) if c else None,
                                   host_bytes=int(h) if h else None)
        except ValueError:
            raise ValueError(
                f"bad quota {part!r}; expected "
                f"tenant=reserve:ceiling[:host_bytes] "
                f"(e.g. acme=16:64; empty ceiling = unlimited)")
        if spec.reserve < 0 or (spec.ceiling is not None
                                and spec.ceiling < spec.reserve):
            raise ValueError(
                f"bad quota {part!r}: need 0 <= reserve <= ceiling")
        if spec.host_bytes is not None and spec.host_bytes < 0:
            raise ValueError(
                f"bad quota {part!r}: host_bytes must be >= 0")
        out[tenant.strip()] = spec
    return out


class KvQuota:
    """The per-tenant block ledger. Tenants without an explicit spec
    get (reserve=0, ceiling=None): unlimited burst, no floor — the
    zero-config behavior is exactly the pre-quota pool."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuotaSpec]] = None):
        self.quotas: Dict[str, TenantQuotaSpec] = dict(quotas or {})
        self.used: Dict[str, int] = {}
        # Host-tier byte ledger. Unlike ``used`` (engine-thread
        # only), this one is mutated under the HostKvTier's lock —
        # put/evict/pop all hold it — so charge/refund need no lock of
        # their own and snapshot() keeps its atomic-copy discipline.
        self.host_used: Dict[str, int] = {}

    def spec(self, tenant: str) -> TenantQuotaSpec:
        return self.quotas.get(tenant, TenantQuotaSpec())

    # -- accounting (paged server calls these at alloc/free) ---------
    def charge(self, tenant: str, n: int) -> None:
        if n:
            self.used[tenant] = self.used.get(tenant, 0) + n

    def refund(self, tenant: str, n: int) -> None:
        if not n:
            return
        left = self.used.get(tenant, 0) - n
        if left < 0:
            # A negative balance means the charge/refund pairing
            # drifted — fail loudly in tests, clamp in production
            # (an under-counted tenant is a policy miss, not
            # corruption; the pool's own free list stays exact).
            left = 0
        if left:
            self.used[tenant] = left
        else:
            self.used.pop(tenant, None)

    # -- host-tier byte accounting (HostKvTier calls these under its
    # lock at put/evict/pop) -----------------------------------------
    def host_charge(self, tenant: str, nbytes: int) -> None:
        if nbytes:
            self.host_used[tenant] = self.host_used.get(tenant, 0) \
                + nbytes

    def host_refund(self, tenant: str, nbytes: int) -> None:
        if not nbytes:
            return
        left = self.host_used.get(tenant, 0) - nbytes
        if left > 0:
            self.host_used[tenant] = left
        else:
            self.host_used.pop(tenant, None)

    def host_over(self, tenant: str) -> bool:
        """True when ``tenant``'s resident host-tier bytes exceed its
        ``host_bytes`` cap — the tier's cue to shed that tenant's OWN
        oldest entries (spill isolation: a burst never evicts a
        neighbor's warm state through the per-tenant path)."""
        cap = self.spec(tenant).host_bytes
        return (cap is not None
                and self.host_used.get(tenant, 0) > cap)

    def ledger_view(self) -> Dict[str, int]:
        """One atomic copy of the usage ledger — the overlapped
        engine's pick-time snapshot. A scheduling decision computed
        while a dispatch is in flight reads ONE consistent ledger
        (``admit_verdict(..., view=...)``) instead of racing the
        dispatch-side charge/refund traffic; the authoritative charge
        still lands dispatch-side, against the live ledger, when the
        admission actually allocates."""
        return dict(self.used)

    def reserved_headroom(self, tenant: str,
                          view: Optional[Dict[str, int]] = None) -> int:
        """Blocks that must stay claimable for OTHER tenants' unmet
        reserve floors — the amount ``tenant`` may not dig into.
        ``view`` evaluates against a ``ledger_view`` snapshot instead
        of the live ledger."""
        used = self.used if view is None else view
        return sum(max(0, spec.reserve - used.get(name, 0))
                   for name, spec in self.quotas.items()
                   if name != tenant)

    # -- verdicts (paged server raises QuotaExceeded from these) -----
    def admit_verdict(self, tenant: str, need: int,
                      allocatable: int,
                      view: Optional[Dict[str, int]] = None
                      ) -> Optional[Tuple[str, str]]:
        """None = admit; else ("ceiling"|"reserve", message).
        ``allocatable``: blocks the pool could hand out right now
        (free + zero-ref reclaimable). "ceiling" is pressure the
        tenant created (only its own completions cure it); "reserve"
        is pool-wide pressure (any completion cures it) — the engine
        holds both as transient but aims preemption differently.
        ``view`` renders the verdict against a ``ledger_view``
        snapshot (the overlap window's advisory pick); the default
        reads the live ledger (the dispatch-side reconciliation)."""
        used_map = self.used if view is None else view
        spec_ = self.spec(tenant)
        used = used_map.get(tenant, 0)
        if spec_.ceiling is not None and used + need > spec_.ceiling:
            return ("ceiling",
                    f"tenant {tenant!r} over KV-block ceiling: "
                    f"{used} used + {need} needed > {spec_.ceiling}")
        headroom = self.reserved_headroom(tenant, view=view)
        if allocatable - need < headroom:
            return ("reserve",
                    f"admission would breach reserved floors: "
                    f"{allocatable} allocatable - {need} needed < "
                    f"{headroom} reserved for other tenants")
        return None

    def attainable_blocks(self, tenant: str, total: int) -> int:
        """Upper bound on blocks one admission by ``tenant`` could
        EVER be granted: even a fully idle pool (every block free,
        every other tenant's usage at zero) still owes the other
        tenants their full reserve floors. An admission whose fresh
        need exceeds this is permanently infeasible — holding it can
        only livelock, so the engine answers 429 instead."""
        floors = sum(spec.reserve for name, spec in self.quotas.items()
                     if name != tenant)
        return total - floors

    def over_floor(self, tenant: str) -> bool:
        """True when ``tenant`` holds more than its own reserve floor
        — the only victims whose eviction raises net headroom for a
        reserve-held admission (freeing an at-or-under-floor tenant's
        blocks grows its unmet floor by the same amount)."""
        return self.used.get(tenant, 0) > self.spec(tenant).reserve

    def over_ceiling(self, tenant: str) -> bool:
        spec_ = self.spec(tenant)
        return (spec_.ceiling is not None
                and self.used.get(tenant, 0) > spec_.ceiling)

    def snapshot(self) -> Dict[str, Dict[str, Optional[int]]]:
        """The ``/stats`` ``tenants`` surface: one row per tenant with
        a spec or live usage. This is the ONE reader that runs off the
        engine thread (the HTTP handler serving ``/stats``) while
        ``charge``/``refund`` add and pop keys, so it reads one atomic
        ``dict()`` copy instead of iterating the live ledger — safety
        by construction, not by GIL iteration-atomicity trivia.
        ``self.quotas`` is immutable after __init__."""
        used = dict(self.used)
        host = dict(self.host_used)
        names = sorted(set(self.quotas) | set(used) | set(host))
        return {name: {"used_blocks": used.get(name, 0),
                       "reserve": self.spec(name).reserve,
                       "ceiling": self.spec(name).ceiling,
                       "host_bytes_used": host.get(name, 0),
                       "host_bytes": self.spec(name).host_bytes}
                for name in names}
