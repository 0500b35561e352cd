"""Lease-based leader election for the scheduler extender: the port's
copy of ``tpushare/extender/leader.py``.

The reference ships its companion extender as a single replica; running
more than one tpushare extender is safe for the read-only verbs but NOT
for /bind (chip choice depends on cluster state the bind mutates). This
module implements the standard Kubernetes resource-lock election over a
coordination.k8s.io/v1 Lease — the same protocol client-go's
leaderelection package speaks, so a tpushare extender can share a lock
with any conformant implementation:

- acquire: create the Lease if absent, or take it over when the
  holder's renewTime is older than leaseDurationSeconds (bumping
  leaseTransitions).
- renew: the holder PUTs a fresh renewTime each retry period; the PUT
  carries resourceVersion, so a concurrent takeover loses with a 409
  and mutual exclusion holds at the apiserver.
- followers keep serving /filter and /prioritize (read-only, mild
  staleness is fine) and refuse /bind, which kube-scheduler retries —
  landing on the leader through the Service.

Clock and sleep are injectable so tests drive the whole protocol
synchronously against a fake client.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from typing import Callable, Optional

from tpushare_torch.k8s.client import ApiError

log = logging.getLogger("tpushare.extender.leader")


def _fmt(ts: float) -> str:
    return _time.strftime("%Y-%m-%dT%H:%M:%S",
                          _time.gmtime(ts)) + ".%06dZ" % int(ts % 1 * 1e6)


def _parse(s: str) -> float:
    import calendar
    base, _, frac = s.rstrip("Z").partition(".")
    t = calendar.timegm(_time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
    return t + (float("0." + frac) if frac else 0.0)


class LeaderElector:
    """Lease acquire/renew loop; ``is_leader`` is the only state
    consumers read."""

    def __init__(self, kube, identity: str, *,
                 namespace: str = "kube-system",
                 name: str = "tpushare-extender",
                 lease_duration_s: float = 15.0,
                 retry_period_s: float = 2.0,
                 now: Callable[[], float] = _time.time,
                 sleep: Callable[[float], None] = _time.sleep,
                 on_change: Optional[Callable[[bool], None]] = None):
        self.kube = kube
        self.identity = identity
        self.namespace = namespace
        self.name = name
        self.lease_duration_s = lease_duration_s
        self.retry_period_s = retry_period_s
        self._now = now
        self._sleep = sleep
        self._leader = False
        self._last_renew: Optional[float] = None  # our last successful write
        self._on_change = on_change   # called on every leadership flip
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- state -------------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self._leader

    # -- protocol ----------------------------------------------------------
    def _spec(self, acquire_ts: Optional[str], transitions: int) -> dict:
        now = _fmt(self._now())
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration_s),
            "acquireTime": acquire_ts or now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns leadership. 409/conflict means
        another replica won the write — immediately a follower."""
        try:
            lease = self.kube.get_lease(self.namespace, self.name)
        except ApiError as e:
            if e.status_code != 404:
                log.warning("lease get failed: %s", e)
                return self._retain_on_error()
            try:
                self.kube.create_lease(self.namespace, {
                    "metadata": {"name": self.name,
                                 "namespace": self.namespace},
                    "spec": self._spec(None, 0),
                })
                return self._set(True)
            except ApiError as e2:
                log.info("lost create race: %s", e2)
                return self._set(False)

        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        renew = spec.get("renewTime")
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration_s)
        fresh = (renew is not None
                 and self._now() - _parse(renew) < duration)
        if holder not in (None, "", self.identity) and fresh:
            return self._set(False)

        transitions = int(spec.get("leaseTransitions") or 0)
        acquire = spec.get("acquireTime")
        if holder != self.identity:          # takeover (expired/vacant)
            transitions += 1
            acquire = None
        lease["spec"] = self._spec(acquire, transitions)
        try:
            self.kube.update_lease(self.namespace, self.name, lease)
            return self._set(True)
        except ApiError as e:
            if e.status_code == 409:
                # Definitive: another replica's write landed first.
                log.info("lost renew/takeover race: %s", e)
                return self._set(False)
            log.warning("lease update failed: %s", e)
            return self._retain_on_error()

    def _retain_on_error(self) -> bool:
        """Transient apiserver errors must not depose a leader whose
        lease is still fresh on the server — followers cannot take over
        until it expires, so stepping down instantly would leave NO
        replica serving /bind (client-go keeps leadership until its own
        renew deadline the same way). Leadership is retained while our
        last successful write is within the lease duration."""
        if (self._leader and self._last_renew is not None
                and self._now() - self._last_renew < self.lease_duration_s):
            return True
        return self._set(False)

    def _set(self, leader: bool) -> bool:
        changed = leader != self._leader
        if changed:
            log.info("%s %s leadership of %s/%s", self.identity,
                     "acquired" if leader else "lost",
                     self.namespace, self.name)
        self._leader = leader
        if leader:
            self._last_renew = self._now()
        if changed and self._on_change is not None:
            # Observers (metrics gauge, leader pod label) live where
            # the state changes — a flip during quiet periods must be
            # visible without waiting for a /bind request.
            try:
                self._on_change(leader)
            except Exception as e:  # pragma: no cover - best-effort
                log.warning("leadership on_change failed: %s", e)
        return leader

    # -- loop --------------------------------------------------------------
    def run_forever(self) -> None:
        while not self._stop.is_set():
            self.try_acquire_or_renew()
            self._sleep(self.retry_period_s)

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self.run_forever,
                                        name="lease-elector", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and, when leading, release the Lease (clear
        holder + zero duration) so another replica can take over
        immediately instead of waiting out lease_duration_s — the
        client-go ReleaseOnCancel behavior."""
        self._stop.set()
        if not self._leader:
            return
        try:
            lease = self.kube.get_lease(self.namespace, self.name)
            spec = lease.get("spec") or {}
            if spec.get("holderIdentity") == self.identity:
                spec["holderIdentity"] = ""
                spec["leaseDurationSeconds"] = 1
                lease["spec"] = spec
                self.kube.update_lease(self.namespace, self.name, lease)
        except ApiError as e:
            log.info("lease release failed (harmless): %s", e)
        self._set(False)
