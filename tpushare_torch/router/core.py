"""Cluster front door: prefix-aware routing, failover, load-shed.

The port's copy of ``tpushare/router/core.py`` (a test holds its code
equal to the original's): the same router in front of the port's
engines (``tpushare-torch-serve``), importing the port's own
``chaos``, ``slo`` and ``router.chainkeys`` copies.

The serving plane scales *down* into one replica (sharded mesh ticks,
quarantine-and-replay, drain/undrain); this module is what keeps
traffic flowing when any single replica degrades or dies. One Router
spreads the existing ``POST /v1/completions`` contract over N engine
replicas and is engineered for failure first:

Routing — prefix affinity by default. The request's block-aligned
chain keys (tpushare_torch.router.chainkeys — the SAME sha256 chain
the paged prefix cache publishes) are matched against each replica's
``/prefixes`` gossip; the replica holding the longest chain match gets
the request, so requests sharing a prompt prefix land where those KV
blocks already live. No match falls back to least-loaded by ``/stats``
(``queue_depth``, ``pool_free_frac``, ``tick_in_flight_ms``), divided
by the replica's health score.

Robustness — the headline:

* health scoring from ``/readyz`` + ``/stats`` deltas: climbing
  ``quarantines`` / ``deadline_breaches`` / ``engine_restarts``
  between polls halve the score; quiet polls decay it back to 1.0;
* a per-replica circuit breaker: ``breaker_threshold`` consecutive
  proxy failures open it; it backs off exponentially and HALF-OPENs a
  ``/readyz`` probe — a replica that answers but reports draining
  keeps the breaker open (work must not land there), so the breaker
  closes exactly when the replica returns via ``/undrain``;
* bounded retry-on-another-replica for idempotent admissions that
  503/timeout/refuse the connection — a draining replica's "retry
  another replica" 503 is the signal, and the router honors it
  (generation is deterministic under greedy, so a fresh retry
  elsewhere is token-exact, never a duplicate);
* optional hedged requests: after ``hedge_ms`` without a first byte,
  the same admission fires at the second-best replica and the first
  success wins (latency-tier insurance against a slow replica);
* graceful degradation: when no replica is routable the request waits
  ``shed_wait_s`` for one to free, then sheds with a clean 503 +
  ``Retry-After`` instead of parking forever;
* a ``/scale`` advisory: recommends a replica count from
  pool-exhaustion and deadline-breach rates (the host-side
  telemetry-driven diagnosis→action loop, PAPERS.md 2510.16946).

Thread discipline: the stats-poll thread and the HTTP handler threads
share the per-replica state maps; EVERY cross-thread mutation holds
``self._lock``.

torch-free by design: stdlib + the chainkeys module's numpy. The
router is a transport, not a tenant.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from tpushare_torch.chaos import ENV_CHAOS, Injector
# jax-free like the router itself: the tier table is the shared
# vocabulary between the front door's shed order and the engines'
# per_tier /stats counters.
from tpushare_torch.slo import DEFAULT_TIER, TIERS

#: breaker states (strings, not an enum: they go straight into /stats)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: routing policies
POLICIES = ("affinity", "least_loaded", "random")


class NoReplicaAvailable(Exception):
    """Every routable replica was excluded, open, or saturated — the
    caller sheds with a 503 + Retry-After."""


class Replica:
    """Per-replica routing state. Plain data: every field that both
    the poll thread and handler threads touch is mutated ONLY under
    the owning Router's lock."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        p = urllib.parse.urlparse(self.url)
        self.host = p.hostname or "127.0.0.1"
        self.port = p.port or 80
        # health (poll thread writes, handlers read)
        self.alive = True           # connection-level reachability
        self.ready = True           # /readyz verdict (drain-aware)
        self.score = 1.0            # telemetry health in (0, 1]
        self.stats: Dict[str, Any] = {}
        self._last_counters: Optional[Dict[str, int]] = None
        self._last_tier_breaches: Optional[Dict[str, int]] = None
        # circuit breaker
        self.breaker = CLOSED
        self.consecutive_failures = 0
        self.open_until = 0.0
        self.backoff_s = 0.0
        # prefix gossip: hex chain keys this replica holds, + the
        # block size its pool hashes at (None until first gossip)
        self.prefix_keys: Set[str] = set()
        self.block_size: Optional[int] = None
        # counters (router /stats)
        self.proxied = 0
        self.proxy_errors = 0
        # Requests dispatched and not yet answered: the router-side
        # load signal that is LIVE during a storm (polled queue_depth
        # lags by a poll interval, so without this every tie lands on
        # the same replica until the next poll).
        self.inflight = 0

    def snapshot(self) -> Dict[str, Any]:
        s = self.stats
        return {
            "url": self.url, "alive": self.alive, "ready": self.ready,
            "score": round(self.score, 3), "breaker": self.breaker,
            "consecutive_failures": self.consecutive_failures,
            "proxied": self.proxied, "proxy_errors": self.proxy_errors,
            "inflight": self.inflight,
            "prefix_keys": len(self.prefix_keys),
            "block_size": self.block_size,
            "queue_depth": s.get("queue_depth"),
            "active_slots": s.get("active_slots"),
            "pool_free_frac": s.get("pool_free_frac"),
            "tick_in_flight_ms": s.get("tick_in_flight_ms"),
            # Mesh failure domain: a degraded replica is
            # serving on a shrunken mesh — its capacity is scaled by
            # current/configured devices in _load and /scale argues
            # up while any replica reports degraded=true.
            "degraded": s.get("degraded"),
            "num_devices": s.get("num_devices"),
            "num_devices_configured": s.get("num_devices_configured"),
            # Host failure domain: the process axis — a
            # replica serving with a lost host is degraded across a
            # process boundary; /scale names it separately from chip
            # loss because the fix is different (reschedule the gang
            # member, not swap a chip).
            "num_processes": s.get("num_processes"),
            "healthy_processes": s.get("healthy_processes"),
            "host_losses": s.get("host_losses"),
        }


#: /stats counters whose climb marks a replica as degrading
_DEGRADE_COUNTERS = ("quarantines", "deadline_breaches",
                     "engine_restarts")


class Router:
    """The front-door brain: replica registry, poll loop, routing,
    retries/hedging, shed, scale advisory. Transport-agnostic — the
    HTTP surface (daemon.py) calls ``proxy_completion`` /
    ``open_stream`` and serializes ``stats()`` / ``scale_advice()``."""

    def __init__(self, replica_urls: Sequence[str], *,
                 policy: str = "affinity",
                 poll_interval_s: float = 0.5,
                 breaker_threshold: int = 3,
                 breaker_backoff_s: float = 0.5,
                 breaker_backoff_max_s: float = 30.0,
                 retry_budget: int = 2,
                 hedge_ms: Optional[float] = None,
                 shed_wait_s: float = 0.5,
                 retry_after_s: float = 1.0,
                 request_timeout_s: float = 300.0,
                 probe_timeout_s: float = 2.0,
                 seed: int = 0,
                 chaos_spec: Optional[str] = None,
                 default_tier: str = DEFAULT_TIER,
                 migrate_min_blocks: int = 2):
        if default_tier not in TIERS:
            raise ValueError(f"unknown default tier {default_tier!r}; "
                             f"known: {tuple(TIERS)}")
        self.default_tier = default_tier
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"known: {POLICIES}")
        if not replica_urls:
            raise ValueError("router needs at least one --replicas URL")
        self.policy = policy
        self.replicas = [Replica(u) for u in replica_urls]
        self._lock = threading.Lock()
        self._poll_interval_s = poll_interval_s
        self._breaker_threshold = max(1, int(breaker_threshold))
        self._breaker_backoff_s = breaker_backoff_s
        self._breaker_backoff_max_s = breaker_backoff_max_s
        self._retry_budget = max(0, int(retry_budget))
        self._hedge_ms = hedge_ms
        self._shed_wait_s = shed_wait_s
        self.retry_after_s = retry_after_s
        self._request_timeout_s = request_timeout_s
        self._probe_timeout_s = probe_timeout_s
        # Cross-replica block migration: on a routable prefix
        # miss, instruct the CHOSEN replica to pull the longest
        # published chain from the sibling that gossips it (POST
        # /kv/migrate) before the admission lands — fleet-wide prefix
        # reuse instead of a local recompute. Fires only when a
        # sibling's match beats the chosen replica's by at least this
        # many blocks (pulling one block rarely beats its own network
        # round trip); 0 disables the instruction entirely.
        self._migrate_min_blocks = max(0, int(migrate_min_blocks))
        # random-policy draws come off a seeded PRNG so a routed storm
        # replays (the bench's random-vs-affinity comparison needs the
        # same trace to hit the same replicas twice).
        self._rng = random.Random(seed)
        self._stats = {"requests": 0, "proxied": 0,  # tpushare: lock[_lock]
                       "retries": 0,
                       "hedges": 0, "hedge_wins": 0, "shed": 0,
                       "rejected": 0, "breaker_opens": 0,
                       "breaker_closes": 0, "poll_errors": 0,
                       "affinity_hits": 0, "fallback_routes": 0,
                       # Exactly-once retries: keys this
                       # router minted for clients that sent none
                       # (every retry/hedge attempt of one admission
                       # reuses ONE key, so an ambiguous failure can
                       # never double-execute), re-attach retries to
                       # a replica that failed at transport level
                       # (it may have restarted and recovered the
                       # request — the same key re-attaches instead
                       # of re-routing), and resume streams proxied.
                       "idempotency_keys_generated": 0,
                       "reattach_retries": 0,
                       "resumes_proxied": 0,
                       # Tier-aware shed accounting: the
                       # shed ORDER is batch -> standard ->
                       # interactive (tier-scaled shed waits), and
                       # this map is the proof /stats publishes.
                       "shed_by_tier": {name: 0 for name in TIERS},
                       # Migration instructions: issued, failed
                       # (transport/chaos — the admission proceeds on
                       # local recompute), and blocks the sinks
                       # reported landed.
                       "migrations_instructed": 0,
                       "migrations_failed": 0,
                       "migrated_blocks": 0}
        self._t0 = time.monotonic()
        # deadline-breach deltas observed by THIS router (scale_advice
        # rates these over router uptime; lifetime engine counters
        # would misread history as a current rate)
        self._breaches_observed = 0     # tpushare: lock[_lock]
        # Same uptime-scoped delta discipline, per tier, off the
        # engines' per_tier counters: interactive breaches are the
        # scale-up signal (a batch breach is by definition impossible
        # — it has no deadline — and a standard one argues less).
        self._tier_breaches_observed = {  # tpushare: lock[_lock]
            name: 0 for name in TIERS}
        # Fault injection at the router's own seams (tpushare.chaos):
        # router.proxy fires before every upstream attempt (a raise is
        # an InjectedUnavailable — exactly the connection-refused shape
        # the retry path handles), router.replica_stats inside each
        # poll (a flaking telemetry plane must degrade scoring, never
        # kill the poll thread). Unarmed points are the shared no-op.
        if chaos_spec is None:
            chaos_spec = os.environ.get(ENV_CHAOS, "")
        self._chaos = Injector.from_spec(chaos_spec)
        self._fault_proxy = self._chaos.point("router.proxy")
        self._fault_stats = self._chaos.point("router.replica_stats")
        # Fires before each /kv/migrate instruction: a raise skips
        # the pull (local recompute — the default path anyway), never
        # the admission.
        self._fault_block_fetch = self._chaos.point("router.block_fetch")
        self._stop = threading.Event()
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------
    def start(self) -> None:
        self._started = True
        self._poll_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._poll_thread.join(timeout=5)

    def healthy(self) -> bool:
        """Router liveness: the poll thread is the router's engine."""
        return self._poll_thread.is_alive() or not self._started

    def ready(self) -> bool:
        """Router readiness: at least one replica is routable."""
        with self._lock:
            return any(self._routable(r) for r in self.replicas)

    # -- poll loop (thread entry) ------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._poll_interval_s)

    def poll_once(self) -> None:
        """One scoring pass over every replica: /readyz verdict,
        /stats deltas -> score, /prefixes gossip, and the breaker's
        half-open probe. Public so tests (and the smoke runner) can
        drive scoring synchronously instead of sleeping on the
        poll interval."""
        for rep in self.replicas:
            try:
                self._fault_stats()
                ready, state = self._probe_ready(rep)
                stats = self._fetch_json(rep, "/stats")
                prefixes = self._fetch_json(rep, "/prefixes")
            except Exception as e:
                with self._lock:
                    self._stats["poll_errors"] += 1
                    rep.alive = False
                    rep.ready = False
                    self._note(rep, f"poll: {e}")
                continue
            with self._lock:
                rep.alive = True
                rep.ready = ready
                rep.stats = stats
                if rep.breaker == CLOSED:
                    # A healthy poll breaks the failure streak:
                    # without this, isolated blips hours apart
                    # accumulate into a spurious open ("consecutive"
                    # must mean consecutive). An OPEN/HALF_OPEN
                    # breaker keeps its count — only the ready probe
                    # below may close it.
                    rep.consecutive_failures = 0
                self._rescore(rep, stats)
                if prefixes.get("keys") is not None:
                    rep.prefix_keys = set(prefixes["keys"])
                    rep.block_size = prefixes.get("block_size")
                # Breaker half-open probe rides the poll: an OPEN
                # breaker past its backoff closes iff the replica
                # reports READY — answering-but-draining keeps it
                # open, so the close lands exactly on /undrain.
                if rep.breaker in (OPEN, HALF_OPEN):
                    if time.monotonic() >= rep.open_until:
                        if ready:
                            rep.breaker = CLOSED
                            rep.consecutive_failures = 0
                            rep.backoff_s = 0.0
                            self._stats["breaker_closes"] += 1
                        else:
                            rep.breaker = HALF_OPEN

    def _probe_ready(self, rep: Replica) -> Tuple[bool, str]:
        body = self._fetch_json(rep, "/readyz", ok_codes=(200, 503))
        return bool(body.get("ready")), str(body.get("state", ""))

    def _fetch_json(self, rep: Replica, path: str,
                    ok_codes: Tuple[int, ...] = (200,)) -> Dict:
        conn = http.client.HTTPConnection(rep.host, rep.port,
                                          timeout=self._probe_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status not in ok_codes:
                raise OSError(f"GET {path} -> {resp.status}")
            return json.loads(data or b"{}")
        finally:
            conn.close()

    def _rescore(self, rep: Replica, stats: Dict[str, Any]) -> None:
        """Telemetry health from /stats deltas — caller holds the
        lock. Climbing failure counters halve the score per incident
        (floored); quiet polls decay it back toward 1.0."""
        counters = {k: int(stats.get(k) or 0) for k in _DEGRADE_COUNTERS}
        # Per-tier breach deltas, same discipline: only the
        # climbs THIS router watched count toward the scale signal.
        per_tier = stats.get("per_tier") or {}
        tier_b = {name: int((per_tier.get(name) or {})
                            .get("deadline_breaches") or 0)
                  for name in TIERS}
        last_tier = rep._last_tier_breaches
        rep._last_tier_breaches = tier_b
        if last_tier is not None:
            for name in TIERS:
                self._tier_breaches_observed[name] += max(
                    0, tier_b[name] - last_tier[name])
        last = rep._last_counters
        rep._last_counters = counters
        if last is None:
            return
        # Breach pressure for /scale accumulates from the DELTAS this
        # router observed, never the engines' lifetime counters: a
        # freshly restarted router in front of day-old engines must
        # not read ancient history as a current rate.
        self._breaches_observed += max(
            0, counters["deadline_breaches"]
            - last["deadline_breaches"])
        incidents = sum(max(0, counters[k] - last[k])
                        for k in _DEGRADE_COUNTERS)
        if incidents:
            rep.score = max(0.05, rep.score * 0.5 ** min(incidents, 4))
        else:
            rep.score = min(1.0, rep.score * 0.9 + 0.1)

    def _note(self, rep: Replica, msg: str) -> None:
        # Poll/proxy failures share the breaker accounting (caller
        # holds the lock): consecutive failures past the threshold
        # open it with exponential backoff.
        rep.consecutive_failures += 1
        if (rep.breaker == CLOSED
                and rep.consecutive_failures >= self._breaker_threshold):
            self._open_breaker(rep)
        elif rep.breaker == HALF_OPEN:
            self._open_breaker(rep)     # the probe request failed

    def _open_breaker(self, rep: Replica) -> None:
        rep.breaker = OPEN
        rep.backoff_s = min(self._breaker_backoff_max_s,
                            (rep.backoff_s * 2) or self._breaker_backoff_s)
        rep.open_until = time.monotonic() + rep.backoff_s
        self._stats["breaker_opens"] += 1

    # -- routing -----------------------------------------------------
    def _routable(self, rep: Replica) -> bool:
        return rep.alive and rep.ready and rep.breaker == CLOSED

    def _load(self, rep: Replica) -> float:
        """Least-loaded metric from the /stats fields the engine
        publishes for exactly this purpose. NULL-safe: dense-row
        replicas report pool counters as null (NOT 0 — the PR-2
        contract), so a missing pool reads as half-pressure instead of
        exhausted, and a missing tick_in_flight_ms (idle engine) as
        zero wedge."""
        s = rep.stats
        n_slots = max(1, int(s.get("n_slots") or 1))
        # Mesh failure domain: a DEGRADED replica serves on
        # a shrunken mesh — same slot count, a fraction of the chips,
        # so each slot-tick streams the full weights over fewer
        # devices. Scale the n_slots-derived capacity by
        # current/configured device count so its load reads honestly
        # (a tp=1 survivor of a tp=2 replica carries half the
        # capacity, not "the same slots, must be fine").
        nd_cur = s.get("num_devices")
        nd_conf = s.get("num_devices_configured")
        cap_frac = 1.0
        if nd_cur and nd_conf:
            cap_frac = max(float(nd_cur) / float(nd_conf), 1e-3)
        depth = (rep.inflight
                 + int(s.get("queue_depth") or 0)
                 + int(s.get("active_slots") or 0)
                 + int(s.get("admissions_in_flight") or 0))
        free_frac = s.get("pool_free_frac")
        pool_pressure = (1.0 - float(free_frac)
                         if free_frac is not None else 0.5)
        wedge_ms = float(s.get("tick_in_flight_ms") or 0.0)
        # Host-tier pressure: a tier near its byte budget is
        # about to start EVICTING demoted chains (lost reuse, not
        # lost correctness) — a small tiebreak term, weighted well
        # under a real pool signal. Null host_tier (unconfigured /
        # dense rows) contributes nothing: neutral, per the /stats
        # null-not-0 contract.
        ht = s.get("host_tier")
        host_pressure = 0.0
        if isinstance(ht, dict) and ht.get("budget_bytes"):
            host_pressure = 0.25 * min(
                1.0, float(ht.get("bytes_resident") or 0)
                / float(ht["budget_bytes"]))
        # Host failure domain: a replica missing a whole
        # host is already capacity-scaled by the device fraction
        # above (the dead rank's devices left the serving mesh), but
        # it is also mid-ladder — its next reshard burns budget
        # toward drained-sticky, so shed a little extra load toward
        # whole gangs. Null process fields (single-process replicas)
        # contribute nothing.
        n_proc = s.get("num_processes")
        h_proc = s.get("healthy_processes")
        host_loss_pressure = 0.0
        if n_proc and h_proc is not None and h_proc < n_proc:
            host_loss_pressure = 0.5 * (1.0 - float(h_proc)
                                        / float(n_proc))
        return (depth / (n_slots * cap_frac) + pool_pressure
                + host_pressure + host_loss_pressure
                + min(wedge_ms / 1000.0, 1.0))

    def _effective_load(self, rep: Replica) -> float:
        """Load divided by health — the one ranking the fallback and
        affinity tie-breaks sort by. The +0.01 floor keeps the score
        meaningful at zero load (an idle degraded replica must still
        lose the tie to an idle healthy one)."""
        return (self._load(rep) + 0.01) / max(rep.score, 0.05)

    def _match_len(self, rep: Replica, keys_hex: Sequence[str]) -> int:
        """Longest chain match: the digest is cumulative, so matching
        stops at the first miss (a later hit without its parents would
        be a different chain entirely)."""
        n = 0
        for k in keys_hex:
            if k not in rep.prefix_keys:
                break
            n += 1
        return n

    def route(self, keys_hex: Sequence[str] = (),
              exclude: Optional[Set[str]] = None) -> Replica:
        """Pick the replica for one admission. Raises
        NoReplicaAvailable when nothing is routable."""
        exclude = exclude or set()
        with self._lock:
            cands = [r for r in self.replicas
                     if self._routable(r) and r.url not in exclude]
            if not cands:
                raise NoReplicaAvailable(
                    f"0/{len(self.replicas)} replicas routable")
            if self.policy == "random":
                return self._rng.choice(cands)
            if self.policy == "affinity" and keys_hex:
                scored = [(self._match_len(r, keys_hex), r)
                          for r in cands]
                best = max(m for m, _ in scored)
                if best > 0:
                    holders = [r for m, r in scored if m == best]
                    self._stats["affinity_hits"] += 1
                    return min(holders, key=self._effective_load)
            self._stats["fallback_routes"] += 1
            return min(cands, key=self._effective_load)

    def shed_wait_s(self, tier: str) -> float:
        """Tier-scaled shed wait — the mechanism behind the shed
        ORDER (batch -> standard -> interactive): when nothing is
        routable, ``batch`` sheds immediately (factor 0) and
        ``interactive`` holds on past the configured window. The
        scale is anchored at this router's CONFIGURED default tier:
        requests that never name one wait exactly ``--shed-wait-s``
        (so a deployment that predates tiers keeps the window its
        operator sized), each rank below the default waits one full
        window less (floored at zero — immediate shed), each rank
        above waits one more. Under a saturation storm the refusals
        therefore land on the lowest tier first, which is exactly
        the quality degradation order the tier contract promises."""
        spec = TIERS.get(tier, TIERS[self.default_tier])
        anchor = TIERS[self.default_tier].rank
        factor = max(0.0, 1.0 + anchor - spec.rank)
        return self._shed_wait_s * factor

    def route_or_shed(self, keys_hex: Sequence[str] = (),
                      exclude: Optional[Set[str]] = None,
                      tier: str = DEFAULT_TIER) -> Replica:
        """route() with graceful degradation: wait up to the TIER's
        share of shed_wait_s for a replica to become routable (a
        breaker closing, a drain lifting), then shed. The caller
        turns NoReplicaAvailable into a 503 with Retry-After."""
        # When the caller's per-request exclusions already cover the
        # whole fleet (every replica tried and failed), no breaker
        # close or undrain inside the window can help: raise NOW —
        # waiting adds shed_wait_s of tail latency to every
        # retry-exhausted request and inflates the shed counter
        # /scale keys scale-up on (this is retry exhaustion, not
        # fleet saturation).
        if exclude and all(r.url in exclude for r in self.replicas):
            raise NoReplicaAvailable(
                f"all {len(self.replicas)} replicas already tried")
        deadline = time.monotonic() + self.shed_wait_s(tier)
        while True:
            try:
                return self.route(keys_hex, exclude=exclude)
            except NoReplicaAvailable:
                if time.monotonic() >= deadline:
                    with self._lock:
                        self._stats["shed"] += 1
                        by_tier = self._stats["shed_by_tier"]
                        by_tier[tier] = by_tier.get(tier, 0) + 1
                    raise
                time.sleep(min(0.05, self._poll_interval_s))

    # -- cross-replica block migration -------------------------
    def plan_migration(self, keys_hex: Sequence[str], chosen: Replica
                       ) -> Optional[Tuple[Replica, List[str]]]:
        """Does a SIBLING hold a meaningfully longer published chain
        than the replica this admission is about to land on? Returns
        (source, keys_to_pull) when some alive, non-open sibling's
        match beats the chosen replica's by >= migrate_min_blocks
        (and both pools hash at the same block size — the digests are
        block-size-scoped, so a mismatch can never match anyway), else
        None. Pure planning under the lock; the instruction itself
        (_maybe_migrate) does its network I/O outside it."""
        if self._migrate_min_blocks <= 0 or not keys_hex:
            return None
        with self._lock:
            if chosen.block_size is None:
                return None         # dense rows / no gossip yet
            have = self._match_len(chosen, keys_hex)
            best, best_n = None, have
            for r in self.replicas:
                if r is chosen or not r.alive or r.breaker == OPEN:
                    continue
                if r.block_size != chosen.block_size:
                    continue
                n = self._match_len(r, keys_hex)
                if n > best_n:
                    best, best_n = r, n
            if (best is None
                    or best_n - have < self._migrate_min_blocks):
                return None
            return best, list(keys_hex[:best_n])

    def _maybe_migrate(self, chosen: Replica,
                       keys_hex: Sequence[str],
                       tenant: Optional[str]) -> None:
        """Best-effort pull instruction ahead of one admission: tell
        ``chosen`` to fetch the planned chain from its sibling into
        its host tier, so the admission that follows promotes instead
        of recomputing. EVERY failure shape — chaos raise, transport
        death, non-200, sink refusal — is swallowed and counted: the
        admission proceeds on local recompute, which was its path
        before this method existed."""
        plan = self.plan_migration(keys_hex, chosen)
        if plan is None:
            return
        source, pull = plan
        with self._lock:
            self._stats["migrations_instructed"] += 1
        try:
            self._fault_block_fetch()
            conn = http.client.HTTPConnection(
                chosen.host, chosen.port,
                timeout=min(self._request_timeout_s, 30.0))
            try:
                conn.request(
                    "POST", "/kv/migrate",
                    json.dumps({"source": source.url, "keys": pull,
                                "tenant": tenant}).encode(),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                out = json.loads(resp.read() or b"{}")
                if resp.status != 200:
                    raise OSError(f"/kv/migrate -> {resp.status}")
            finally:
                conn.close()
            landed = int(out.get("migrated") or 0)
        except Exception:
            with self._lock:
                self._stats["migrations_failed"] += 1
            return
        with self._lock:
            self._stats["migrated_blocks"] += landed
            if landed:
                # Learn NOW, like _post_once's publish learning: the
                # chosen replica's host tier holds this chain prefix,
                # so the next sharer routes straight to it.
                chosen.prefix_keys.update(pull[:landed])

    # -- proxying ----------------------------------------------------
    def _ensure_idem_key(self, idem_key: Optional[str]) -> str:
        """One idempotency key per ADMISSION (not per attempt): the
        client's own key passes through; a client that sent none gets
        a router-minted one, so the retry and hedge paths — the
        documented at-least-once hole — become exactly-once (every
        attempt carries the same key and the engines' dedupe window
        collapses duplicates)."""
        if idem_key:
            return idem_key
        with self._lock:
            self._stats["idempotency_keys_generated"] += 1
        return "router-" + uuid.uuid4().hex

    def proxy_completion(self, body: bytes, keys_hex: Sequence[str],
                         n_publishable: int, tier: str = DEFAULT_TIER,
                         idem_key: Optional[str] = None,
                         tenant: Optional[str] = None
                         ) -> Tuple[int, Dict[str, Any]]:
        """One non-streaming admission through the front door:
        route -> POST -> learn -> (retry|hedge) -> (status, body).

        Retry-on-another-replica is bounded by retry_budget and only
        ever fires for IDEMPOTENT outcomes: a connection that refused/
        reset/timed out before a response, a 503 (the draining
        replica's "retry another replica" — honored here), or a 429.
        A 2xx/4xx answer is the answer. Every attempt carries the SAME
        Idempotency-Key (``idem_key`` or a router-minted one), so an
        ambiguous transport failure can never double-execute — and a
        replica that failed at TRANSPORT level is deliberately NOT
        excluded from the retry (it may be a restarted daemon that
        recovered the request from its journal: the key re-attaches
        to the recovered stream instead of re-routing it). A 503/429
        answered the request and does exclude. ``n_publishable`` is
        how many of ``keys_hex`` the serving replica will have
        published after this admission (S // block_size full blocks):
        on success the router learns them, so the NEXT request
        sharing the prefix routes to the holder without waiting for
        gossip."""
        with self._lock:
            self._stats["requests"] += 1
        idem_key = self._ensure_idem_key(idem_key)
        tried: Set[str] = set()
        transport_fails: Dict[str, int] = {}
        attempt = 0
        while True:
            try:
                rep = self.route_or_shed(keys_hex, exclude=tried,
                                         tier=tier)
            except NoReplicaAvailable as e:
                return 503, {"error": f"all replicas saturated or "
                                      f"unavailable ({e})",
                             "retry_after_s": self.retry_after_s}
            if attempt == 0:
                # First attempt only: a retry re-routed away from a
                # failing replica — instructing ANOTHER pull there
                # would double the storm the failure already started.
                self._maybe_migrate(rep, keys_hex, tenant)
            status, out = self._attempt(rep, body, keys_hex,
                                        n_publishable, idem_key)
            if status is not None and not self._retryable(status):
                return status, out
            if status is not None:
                tried.add(rep.url)      # answered 503/429: move on
            else:
                # Transport death: give the SAME replica exactly one
                # more chance — it may be a restarted daemon whose
                # journal recovered this admission, and the shared
                # key re-attaches instead of re-routing. One chance
                # only: a hard-down replica must not eat the whole
                # retry budget while healthy replicas sit unused.
                transport_fails[rep.url] = \
                    transport_fails.get(rep.url, 0) + 1
                if transport_fails[rep.url] >= 2:
                    tried.add(rep.url)
                with self._lock:
                    self._stats["reattach_retries"] += 1
            if attempt >= self._retry_budget:
                return 503, {
                    "error": f"retries exhausted after "
                             f"{attempt + 1} attempt(s); last: "
                             f"{out.get('error', status)}",
                    "retry_after_s": self.retry_after_s}
            attempt += 1
            with self._lock:
                self._stats["retries"] += 1

    @staticmethod
    def _retryable(status: int) -> bool:
        # 503: draining/overload — the engine's own docstring says
        # "retry another replica". 429: bounded queue full. Everything
        # else answered the request (incl. 400s: resubmitting a bad
        # prompt elsewhere cannot fix it).
        return status in (503, 429)

    def _attempt(self, rep: Replica, body: bytes,
                 keys_hex: Sequence[str], n_publishable: int,
                 idem_key: Optional[str] = None
                 ) -> Tuple[Optional[int], Dict[str, Any]]:
        """One upstream POST (hedged when configured). Returns
        (None, {...}) for transport-level failure — the caller's
        retry loop treats it like a 503."""
        if self._hedge_ms is None:
            return self._post_once(rep, body, keys_hex, n_publishable,
                                   idem_key)
        return self._post_hedged(rep, body, keys_hex, n_publishable,
                                 idem_key)

    def _headers(self, idem_key: Optional[str]) -> Dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if idem_key:
            headers["Idempotency-Key"] = idem_key
        return headers

    def _post_once(self, rep: Replica, body: bytes,
                   keys_hex: Sequence[str], n_publishable: int,
                   idem_key: Optional[str] = None
                   ) -> Tuple[Optional[int], Dict[str, Any]]:
        with self._lock:
            rep.inflight += 1
        try:
            try:
                self._fault_proxy()
                conn = http.client.HTTPConnection(
                    rep.host, rep.port,
                    timeout=self._request_timeout_s)
                try:
                    conn.request("POST", "/v1/completions", body,
                                 self._headers(idem_key))
                    resp = conn.getresponse()
                    data = resp.read()
                finally:
                    conn.close()
            except Exception as e:
                with self._lock:
                    rep.proxy_errors += 1
                    self._note(rep, f"proxy: {e}")
                return None, {"error": f"{rep.url}: {e}"}
            try:
                out = json.loads(data or b"{}")
            except ValueError:
                out = {"error": "non-JSON upstream response"}
            with self._lock:
                if resp.status == 200:
                    rep.proxied += 1
                    rep.consecutive_failures = 0
                    self._stats["proxied"] += 1
                    # Learn the published chains NOW (gossip will
                    # confirm later): the replica prefilled this
                    # prompt, so its pool holds every full-block
                    # chain of it.
                    rep.prefix_keys.update(keys_hex[:n_publishable])
                elif self._retryable(resp.status):
                    rep.proxy_errors += 1
                    self._note(rep, f"upstream {resp.status}")
            return resp.status, out
        finally:
            with self._lock:
                rep.inflight -= 1

    def _post_hedged(self, rep: Replica, body: bytes,
                     keys_hex: Sequence[str], n_publishable: int,
                     idem_key: Optional[str] = None
                     ) -> Tuple[Optional[int], Dict[str, Any]]:
        """Primary + (after hedge_ms) one backup; first SUCCESS wins,
        and a failed primary falls through to the backup's verdict.
        Both attempts carry the SAME Idempotency-Key, so when primary
        and backup land on the same recovered/deduping replica the
        admission still executes once; on distinct replicas the
        loser's generation runs to completion server-side (greedy
        generation is deterministic and its blocks publish either way
        — wasted compute, bounded by one extra replica, which is the
        price of the latency insurance)."""
        results: "list" = []
        cond = threading.Condition()

        def fire(target: Replica) -> None:
            r = self._post_once(target, body, keys_hex, n_publishable,
                                idem_key)
            with cond:
                results.append((target, r))
                cond.notify_all()

        t1 = threading.Thread(target=fire, args=(rep,), daemon=True)
        t1.start()
        with cond:
            cond.wait_for(lambda: results, timeout=self._hedge_ms / 1e3)
            if results and results[0][1][0] == 200:
                return results[0][1]
        try:
            backup = self.route(keys_hex, exclude={rep.url})
        except NoReplicaAvailable:
            with cond:
                cond.wait_for(lambda: results,
                              timeout=self._request_timeout_s)
            return results[0][1] if results else (None, {
                "error": "hedge: primary never answered"})
        with self._lock:
            self._stats["hedges"] += 1
        t2 = threading.Thread(target=fire, args=(backup,), daemon=True)
        t2.start()
        deadline = time.monotonic() + self._request_timeout_s
        with cond:
            while True:
                for target, (status, out) in results:
                    if status == 200:
                        if target is backup:
                            with self._lock:
                                self._stats["hedge_wins"] += 1
                        return status, out
                if len(results) >= 2:
                    # Both answered, neither 200: surface the
                    # PRIMARY's verdict — results is append-ordered
                    # by completion, so [0] can be the backup's, and
                    # the retry loop excludes the replica it thinks
                    # answered (attributing the backup's 503 to the
                    # primary would re-route onto the backup that
                    # just failed).
                    return next(r for t, r in results if t is rep)
                if not cond.wait(timeout=max(0.0,
                                             deadline - time.monotonic())):
                    return None, {"error": "hedge: no answer in time"}

    # -- streaming ---------------------------------------------------
    def open_stream(self, body: bytes, keys_hex: Sequence[str],
                    n_publishable: int, tier: str = DEFAULT_TIER,
                    idem_key: Optional[str] = None,
                    tenant: Optional[str] = None):
        """Route + open an SSE upstream, retrying on another replica
        only while NO byte has been forwarded (once events flow, a
        mid-stream death surfaces to the client, who RESUMES via
        GET /v1/completions/{id} with its Last-Event-ID — replaying a
        half-consumed stream here would re-emit tokens). Every
        attempt carries the same Idempotency-Key, so a pre-byte retry
        can never double-admit. Returns
        (connection, response, release): the caller pumps the
        response, closes the connection, and calls ``release()`` when
        done — the stream counts toward the replica's live in-flight
        load for its whole life (an open SSE stream is exactly the
        long-lived load the polled counters lag on)."""
        idem_key = self._ensure_idem_key(idem_key)
        tried: Set[str] = set()
        last_err: Optional[str] = None
        for attempt in range(self._retry_budget + 1):
            try:
                rep = self.route_or_shed(keys_hex, exclude=tried,
                                         tier=tier)
            except NoReplicaAvailable as e:
                raise NoReplicaAvailable(str(e)) from None
            if attempt == 0:
                self._maybe_migrate(rep, keys_hex, tenant)
            with self._lock:
                rep.inflight += 1
            try:
                self._fault_proxy()
                conn = http.client.HTTPConnection(
                    rep.host, rep.port,
                    timeout=self._request_timeout_s)
                conn.request("POST", "/v1/completions", body,
                             self._headers(idem_key))
                resp = conn.getresponse()
            except Exception as e:
                with self._lock:
                    rep.inflight -= 1
                    rep.proxy_errors += 1
                    self._note(rep, f"stream: {e}")
                tried.add(rep.url)
                last_err = str(e)
                continue
            if self._retryable(resp.status):
                resp.read()
                conn.close()
                with self._lock:
                    rep.inflight -= 1
                    rep.proxy_errors += 1
                    self._note(rep, f"upstream {resp.status}")
                tried.add(rep.url)
                last_err = f"upstream {resp.status}"
                if attempt < self._retry_budget:
                    with self._lock:
                        self._stats["retries"] += 1
                continue
            with self._lock:
                if resp.status == 200:
                    # Mirrors _post_once: only a 200 counts as served
                    # (a passed-through 400 answered the client but
                    # proves nothing about this replica's health).
                    rep.proxied += 1
                    rep.consecutive_failures = 0
                    self._stats["proxied"] += 1
                    rep.prefix_keys.update(keys_hex[:n_publishable])

            released = [False]

            def release() -> None:
                with self._lock:
                    if not released[0]:
                        released[0] = True
                        rep.inflight -= 1

            return conn, resp, release
        raise NoReplicaAvailable(
            f"stream retries exhausted ({last_err})")

    def open_resume(self, request_id: str,
                    from_n: Optional[int] = None,
                    last_event_id: Optional[str] = None):
        """Find the replica holding ``request_id`` and re-open its
        event stream (GET /v1/completions/{id}) — the front-door half
        of mid-generation stream resumption. The router
        keeps no request->replica map (it must survive its own
        restarts stateless), so it asks: a 404 means 'not mine', the
        first non-404 answer is the stream. DRAINING replicas are
        asked too — a drain refuses NEW work, but a resume attaches
        to work the replica already accepted (and a freshly restarted
        daemon is often not-ready exactly when its recovered streams
        are being resumed). Returns (conn, resp, release) like
        open_stream."""
        path = f"/v1/completions/{request_id}"
        if from_n is not None:
            path += f"?from={int(from_n)}"
        headers = {}
        if last_event_id is not None:
            headers["Last-Event-ID"] = str(last_event_id)
        with self._lock:
            # Routable first (cheapest answer), then anything alive:
            # resume is attached work, not new admission.
            reps = sorted(self.replicas,
                          key=lambda r: not self._routable(r))
        last_err: Optional[str] = None
        for rep in reps:
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port,
                    timeout=self._request_timeout_s)
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
            except Exception as e:
                last_err = str(e)
                continue
            if resp.status == 404:
                resp.read()
                conn.close()
                last_err = f"{rep.url}: 404"
                continue
            with self._lock:
                rep.inflight += 1
                self._stats["resumes_proxied"] += 1
            released = [False]

            def release(rep=rep) -> None:
                with self._lock:
                    if not released[0]:
                        released[0] = True
                        rep.inflight -= 1

            return conn, resp, release
        raise NoReplicaAvailable(
            f"no replica holds request {request_id!r} ({last_err})")

    # -- observability -----------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            # Deep-copy the nested map: the shallow dict() above would
            # hand the caller a live reference the shed path keeps
            # mutating while the handler serializes it.
            out["shed_by_tier"] = dict(self._stats["shed_by_tier"])
            out.update({
                "policy": self.policy,
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "replicas": [r.snapshot() for r in self.replicas],
                "routable": sum(self._routable(r)
                                for r in self.replicas),
                "chaos_active": self._chaos.active,
                "chaos_spec": self._chaos.spec_summary(),
                "chaos_fired": (self._chaos.fired_snapshot()
                                if self._chaos.active else None),
            })
        return out

    def scale_advice(self) -> Dict[str, Any]:
        """Autoscale advisory from the counters the engines publish
        for exactly this loop (ROADMAP item 2): pool exhaustion and
        deadline-breach pressure argue UP, an idle fleet argues DOWN,
        and a not-routable replica always argues at least replacing
        itself. Advisory only — the router never scales anything."""
        with self._lock:
            n = len(self.replicas)
            routable = [r for r in self.replicas if self._routable(r)]
            reasons: List[str] = []
            recommend = max(1, len(routable))
            free_fracs = [r.stats.get("pool_free_frac")
                          for r in routable
                          if r.stats.get("pool_free_frac") is not None]
            min_free = min(free_fracs) if free_fracs else None
            uptime = max(1.0, time.monotonic() - self._t0)
            breach_per_min = 60.0 * self._breaches_observed / uptime
            # The TIERED scale key: interactive SLO
            # breaches observed by this router, rated over ITS
            # uptime (the same delta discipline as the tick-deadline
            # counter — lifetime engine history is not a rate). A
            # much lower trip point than the engine-tick breaches:
            # one interactive breach a minute is already an SLO
            # violation a human would page on.
            i_breach_per_min = (60.0 * self._tier_breaches_observed[
                "interactive"] / uptime)
            shed_per_min = 60.0 * self._stats["shed"] / uptime
            depth = sum(int(r.stats.get("queue_depth") or 0)
                        for r in routable)
            if len(routable) < n:
                reasons.append(f"{n - len(routable)} replica(s) not "
                               f"routable (dead/draining/open breaker)")
                recommend = n
            # Mesh failure domain: a degraded replica is
            # routable but shrunken — it answers, at a fraction of
            # its sized capacity. Argue UP while any replica serves
            # degraded: the missing chips are real lost capacity the
            # shrunken mesh is papering over.
            n_degraded = sum(1 for r in routable
                             if r.stats.get("degraded") is True)
            if n_degraded:
                reasons.append(f"{n_degraded} replica(s) serving "
                               f"DEGRADED (shrunken mesh after chip "
                               f"loss)")
                recommend = max(recommend, n + 1)
            # Host failure domain: a replica with a lost
            # HOST is a gang-scheduling problem, not a chip swap —
            # name it separately so the operator reschedules the
            # dead rank (the engine grows back on its own once the
            # rank rejoins).
            n_host_lost = sum(
                1 for r in routable
                if r.stats.get("num_processes")
                and r.stats.get("healthy_processes") is not None
                and r.stats["healthy_processes"]
                < r.stats["num_processes"])
            if n_host_lost:
                reasons.append(f"{n_host_lost} replica(s) missing a "
                               f"HOST (gang member down; reschedule "
                               f"the rank)")
                recommend = max(recommend, n + 1)
            if min_free is not None and min_free < 0.1:
                reasons.append(f"pool exhaustion: min pool_free_frac "
                               f"{min_free:.2f} < 0.10")
                recommend = max(recommend, n + 1)
            if breach_per_min > 5.0:
                reasons.append(f"deadline breaches at "
                               f"{breach_per_min:.1f}/min")
                recommend = max(recommend, n + 1)
            if i_breach_per_min > 1.0:
                reasons.append(f"interactive SLO breaches at "
                               f"{i_breach_per_min:.1f}/min")
                recommend = max(recommend, n + 1)
            if shed_per_min > 1.0:
                reasons.append(f"shedding load at "
                               f"{shed_per_min:.1f}/min")
                recommend = max(recommend, n + 1)
            if (not reasons and len(routable) == n and n > 1
                    and depth == 0
                    and (min_free is None or min_free > 0.5)
                    and breach_per_min == 0.0
                    and i_breach_per_min == 0.0):
                reasons.append("fleet idle: zero queue depth, pools "
                               "free, no breaches")
                recommend = n - 1
            if not reasons:
                reasons.append("steady state")
                recommend = n
            return {
                "replicas": n, "routable": len(routable),
                "recommend": recommend, "reasons": reasons,
                "signals": {
                    "min_pool_free_frac": min_free,
                    "deadline_breaches_per_min": round(breach_per_min, 2),
                    "interactive_breaches_per_min": round(
                        i_breach_per_min, 2),
                    "tier_breaches_observed": dict(
                        self._tier_breaches_observed),
                    "shed_per_min": round(shed_per_min, 2),
                    "shed_by_tier": dict(self._stats["shed_by_tier"]),
                    "total_queue_depth": depth,
                    "degraded_replicas": n_degraded,
                    "host_lost_replicas": n_host_lost,
                },
            }
