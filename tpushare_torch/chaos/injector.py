"""The port's copy of ``tpushare/chaos/injector.py`` (stdlib only; a test holds it
equal to the original).

Deterministic, seeded fault injection for the serving stack.

The engine's recovery paths (quarantine/replay, tick deadlines, the
loop supervisor — cli/serve.py) exist to survive exactly the failures
that never happen in a clean test run: an ``XlaRuntimeError`` out of a
forward, NaN logits poisoning a token fetch, a hung ``device_get``, an
apiserver that stops answering, a health probe that wedges. This
module makes those failures a reproducible input instead of a
production surprise: every fault point is named, every draw comes off
one seeded PRNG, and the same spec string replays the same storm.

Fault points (the real seams; short names accepted in specs):

  ====================  =============  ========================================
  canonical             short          fired by
  ====================  =============  ========================================
  engine.tick.forward   forward        ServeEngine._tick, before srv.step()
  engine.token_fetch    token_fetch    ServeEngine._tick, on the fetched tokens
  engine.admit          admit          ServeEngine._admit_popped, before admit
  mesh.chip_failure     chip_failure   ServeEngine._tick (sharded engines):
                                       a fired ``raise`` flips one chip
                                       unhealthy (set_chip_health
                                       semantics at the engine seam) AND
                                       poisons this tick's sharded
                                       dispatch with the
                                       XlaRuntimeError-shaped fault —
                                       driving the degrade-and-replay
                                       reshard path. Unsharded engines
                                       never call the point (their chip
                                       domain is the daemon drain)
  k8s.apiserver         apiserver      KubeClient._request, before the HTTP call
  plugin.health_probe   health_probe   health.composite_prober, inside probe()
  plugin.kubelet_restart kubelet_restart  SharedTpuManager.run, per loop
                                       iteration: a fired ``raise`` is a
                                       simulated kubelet.sock recreation —
                                       the manager must stop/re-register
                                       (with backoff) exactly as on the
                                       real inotify event
  router.proxy          proxy          Router, before each upstream POST attempt
  router.replica_stats  replica_stats  Router.poll_once, per replica poll
  journal.write         journal_write  durable.Journal.append, before the
                                       frame write (raise = counted +
                                       swallowed: journaling degrades,
                                       serving never stops)
  journal.fsync         journal_fsync  durable.Journal flush, before
                                       os.fsync (raise/latency: a dying
                                       volume's shapes)
  process.kill          kill           ServeEngine._loop_once, tick start:
                                       a fired ``raise`` SIGKILLs the
                                       process (the crash-recovery storm
                                       harness's deterministic kill -9)
  kv.demote             demote         models/paged._demote_block, before
                                       the d2h copy (raise = the block is
                                       destroyed instead of demoted —
                                       eviction semantics, nothing lost)
  kv.promote            promote        HostKvTier.begin_promote, before
                                       admission commits to a promoted
                                       chain (raise = clean miss, the
                                       prefix recomputes token-exact)
  router.block_fetch    block_fetch    Router, before the /kv/migrate
                                       instruction to the chosen replica
                                       (raise = migration skipped, local
                                       recompute)
  host.loss             host_loss      ServeEngine tick preamble
                                       (multi-process engines): a fired
                                       ``raise`` takes one whole host
                                       (process rank) dark — with a gang
                                       liaison attached, its heartbeats
                                       are severed and the loss is
                                       *detected* by the timeout path; a
                                       liaison-less engine marks the rank
                                       down directly (process-kill
                                       flavor) — either way the rank's
                                       device range goes unhealthy and
                                       the mesh shrinks across the
                                       process boundary
  ====================  =============  ========================================

Spec grammar (``--chaos-spec`` / the ``TPUSHARE_CHAOS`` env var)::

    forward:raise@p=0.02;token_fetch:nan@p=0.01;seed=7
    forward:latency@p=0.1,ms=50;apiserver:raise@p=0.3
    health_probe:hang@p=0.05;seed=3

``point:kind@p=<prob>[,ms=<millis>]`` clauses separated by ``;``; a
bare ``seed=N`` clause seeds the PRNG (default 0). Kinds:

  raise    raise an XlaRuntimeError-shaped InjectedXlaRuntimeError at
           engine points (an InjectedUnavailable OSError at the
           apiserver/probe points — the shape their retry paths see)
  nan      poison the value passing through the point (the token fetch:
           one slot's token becomes NaN, the host-visible signature of
           NaN logits); at other points, a no-op
  latency  sleep ``ms`` milliseconds (default 50)
  hang     sleep a BOUNDED hang: ``ms`` if given, else 2x the engine's
           tick deadline, else 500 ms — long enough to breach the
           deadline counter, never long enough to wedge a test

Zero overhead when unset: ``Injector.point()`` for an unarmed point
returns the module-level ``NOOP`` function, so a disabled deployment
pays exactly one no-op call per fault point per tick (enforced by
tests/test_chaos.py). No jax import here — the module is pure stdlib
so the plugin/k8s layers can hook points without dragging in a
runtime.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

ENV_CHAOS = "TPUSHARE_CHAOS"

#: canonical fault-point names (the real seams)
POINTS = (
    "engine.tick.forward",
    "engine.token_fetch",
    "engine.admit",
    "mesh.chip_failure",
    "k8s.apiserver",
    "plugin.health_probe",
    "plugin.kubelet_restart",
    "router.proxy",
    "router.replica_stats",
    "journal.write",
    "journal.fsync",
    "process.kill",
    "kv.demote",
    "kv.promote",
    "router.block_fetch",
    "host.loss",
)

#: spec short names -> canonical
ALIASES = {
    "forward": "engine.tick.forward",
    "token_fetch": "engine.token_fetch",
    "admit": "engine.admit",
    "chip_failure": "mesh.chip_failure",
    "apiserver": "k8s.apiserver",
    "health_probe": "plugin.health_probe",
    "kubelet_restart": "plugin.kubelet_restart",
    "proxy": "router.proxy",
    "replica_stats": "router.replica_stats",
    "journal_write": "journal.write",
    "journal_fsync": "journal.fsync",
    "kill": "process.kill",
    "demote": "kv.demote",
    "promote": "kv.promote",
    "block_fetch": "router.block_fetch",
    "host_loss": "host.loss",
}

KINDS = ("raise", "nan", "latency", "hang")

#: points whose ``raise`` kind is infra-shaped (OSError), not XLA-shaped
#: (the router's seams are network seams: a proxy/poll fault must look
#: exactly like the connection-refused its retry/scoring paths handle)
_OSERROR_POINTS = {"k8s.apiserver", "plugin.health_probe",
                   "plugin.kubelet_restart",
                   "router.proxy", "router.replica_stats",
                   # journal faults are disk-shaped (ENOSPC, a dying
                   # volume) — the journal's degrade path catches
                   # OSError-adjacent failures, never XLA ones
                   "journal.write", "journal.fsync",
                   # the router's migration instruction is a network
                   # call to a sibling replica — its failure shape is
                   # connection-refused, and the fallback is local
                   # recompute, same as any proxy fault
                   "router.block_fetch"}


class InjectedFault(Exception):
    """Base of every chaos-raised exception (tests and recovery code
    can distinguish injected faults from real ones without string
    matching — and CATCH the whole family with one except clause:
    the kubelet-restart and process-kill seams do exactly that)."""


class InjectedXlaRuntimeError(InjectedFault, RuntimeError):
    """XlaRuntimeError-shaped: what a bad forward / wedged device
    surfaces as through jax (a RuntimeError whose message starts with
    an XLA status code). The engine's recovery must treat it exactly
    like the real thing — which is the point."""


class InjectedUnavailable(InjectedFault, OSError):
    """Connection-shaped: what a flaking apiserver or wedged probe
    backend surfaces as (an OSError the retry paths already handle)."""


def NOOP(value=None):
    """The disabled fault point: one call, returns None, nothing else.
    Module-level and shared so callers (and tests) can check
    ``point is NOOP`` — the zero-overhead contract."""
    return None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    point: str                   # canonical point name
    kind: str                    # raise | nan | latency | hang
    p: float                     # per-fire probability in [0, 1]
    ms: Optional[float] = None   # latency/hang duration override


def canonical_point(name: str) -> str:
    """Resolve a spec's point name (short or canonical); raises
    ValueError on unknown names — a typo'd chaos spec must fail the
    process at startup, not silently inject nothing."""
    full = ALIASES.get(name, name)
    if full not in POINTS:
        raise ValueError(
            f"unknown fault point {name!r}; known: "
            f"{sorted(ALIASES)} (or canonical {list(POINTS)})")
    return full


def parse_spec(text: str) -> Tuple[List[FaultSpec], int]:
    """Parse a chaos spec string into (faults, seed). Empty/whitespace
    text parses to ([], 0) — the disabled injector."""
    faults: List[FaultSpec] = []
    seed = 0
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        if ":" not in clause:
            raise ValueError(f"bad chaos clause {clause!r} "
                             f"(want point:kind@p=...)")
        point_s, rest = clause.split(":", 1)
        point = canonical_point(point_s.strip())
        if "@" not in rest:
            raise ValueError(f"bad chaos clause {clause!r} (missing @p=)")
        kind, params_s = rest.split("@", 1)
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in "
                             f"{clause!r}; known: {KINDS}")
        p, ms = None, None
        for part in params_s.split(","):
            part = part.strip()
            if part.startswith("p="):
                p = float(part[2:])
            elif part.startswith("ms="):
                ms = float(part[3:])
            elif part:
                raise ValueError(f"unknown fault param {part!r} in "
                                 f"{clause!r} (want p= / ms=)")
        if p is None or not (0.0 <= p <= 1.0):
            raise ValueError(f"fault {clause!r} needs p= in [0, 1]")
        faults.append(FaultSpec(point=point, kind=kind, p=p, ms=ms))
    return faults, seed


class Injector:
    """One seeded fault source. Thread-safe: the engine tick, the
    health loop, and k8s client calls may all draw concurrently, and
    a shared unlocked ``random.Random`` can corrupt its Mersenne
    state. Determinism holds per-thread-interleaving for multi-point
    storms; single-threaded drives (the unit tests, the smoke runner's
    serial engine ticks) are exactly reproducible."""

    def __init__(self, faults: Optional[List[FaultSpec]] = None,
                 seed: int = 0, deadline_ms: Optional[float] = None):
        self._faults: Dict[str, List[FaultSpec]] = {}
        for f in faults or []:
            self._faults.setdefault(f.point, []).append(f)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.seed = seed
        self.deadline_ms = deadline_ms
        #: per-point count of faults actually fired (stats/tests)
        self.fired: Dict[str, int] = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def from_spec(cls, text: Optional[str],
                  deadline_ms: Optional[float] = None) -> "Injector":
        faults, seed = parse_spec(text or "")
        return cls(faults, seed=seed, deadline_ms=deadline_ms)

    @classmethod
    def from_env(cls, deadline_ms: Optional[float] = None) -> "Injector":
        return cls.from_spec(os.environ.get(ENV_CHAOS, ""),
                             deadline_ms=deadline_ms)

    # -- interface --------------------------------------------------------
    @property
    def active(self) -> bool:
        return bool(self._faults)

    def fired_snapshot(self) -> Dict[str, int]:
        """Copy of the per-point fired counts, taken under the lock
        (a bare dict() copy can race a concurrent first-fire insert
        and raise mid-iteration on another thread)."""
        with self._lock:
            return dict(self.fired)

    def spec_summary(self) -> Optional[str]:
        """Round-trippable summary for /stats (None when disabled)."""
        if not self.active:
            return None
        parts = []
        for point in POINTS:
            for f in self._faults.get(point, []):
                s = f"{point}:{f.kind}@p={f.p:g}"
                if f.ms is not None:
                    s += f",ms={f.ms:g}"
                parts.append(s)
        parts.append(f"seed={self.seed}")
        return ";".join(parts)

    def point(self, name: str) -> Callable:
        """The fault-point callable for ``name``. Unarmed points get
        the shared NOOP — the caller holds the result and pays one
        no-op call per tick, nothing more. Armed points get a closure:
        ``fire(value=None) -> None | poisoned value`` which may raise
        (kind=raise), sleep (latency/hang), or return a poisoned copy
        of ``value`` (nan)."""
        name = canonical_point(name)
        faults = self._faults.get(name)
        if not faults:
            return NOOP

        def fire(value=None):
            out = None
            for f in faults:
                with self._lock:
                    draw = self._rng.random()
                    if draw < f.p:
                        # Under the lock: concurrent fire()s must not
                        # lose counts, and a /stats thread copying
                        # .fired must never see a mid-insert dict.
                        self.fired[name] = self.fired.get(name, 0) + 1
                if draw >= f.p:
                    continue
                if f.kind == "raise":
                    if name in _OSERROR_POINTS:
                        raise InjectedUnavailable(
                            f"injected fault at {name} (chaos)")
                    raise InjectedXlaRuntimeError(
                        f"INTERNAL: injected fault at {name} (chaos)")
                if f.kind == "latency":
                    time.sleep((f.ms if f.ms is not None else 50.0) / 1e3)
                elif f.kind == "hang":
                    time.sleep(self._hang_s(f))
                elif f.kind == "nan":
                    # Chain onto any earlier nan fault's output: each
                    # armed fault that fires must poison one MORE
                    # slot, not re-poison a fresh copy of the input.
                    out = _poison(out if out is not None else value,
                                  self._rng, self._lock)
            return out

        return fire

    def _hang_s(self, f: FaultSpec) -> float:
        """Bounded hang: explicit ms wins; else 2x the tick deadline
        (long enough to count a breach, short enough to return); else
        500 ms. An unbounded hang would turn the harness into the very
        wedge it exists to prove recovery from."""
        if f.ms is not None:
            return f.ms / 1e3
        if self.deadline_ms:
            return 2.0 * self.deadline_ms / 1e3
        return 0.5


def _poison(value, rng: random.Random, lock: threading.Lock):
    """NaN-poison a token-fetch value: for a {slot: token-or-list}
    dict, one rng-chosen slot's entry becomes float('nan') — the
    host-visible signature of NaN logits (argmax over NaN logits
    yields garbage; the engine's token validation must catch it and
    quarantine exactly that slot). Non-dict / empty values pass
    through untouched (the fault drew but had nothing to poison)."""
    if not isinstance(value, dict) or not value:
        return None
    out = dict(value)
    with lock:
        slot = rng.choice(sorted(out))
    out[slot] = float("nan")
    return out


# -- process-default injector (env-driven seams) --------------------------
#
# The engine builds its own Injector (it knows its deadline and takes
# --chaos-spec); the plugin/k8s seams have no natural config surface,
# so they share one lazily-built injector read from TPUSHARE_CHAOS.

_default: Optional[Injector] = None
_default_lock = threading.Lock()


def default_injector() -> Injector:
    """The process-wide env-configured injector (built once; tests can
    call reset_default_injector() after monkeypatching the env)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Injector.from_env()
        return _default


def reset_default_injector() -> None:
    global _default
    with _default_lock:
        _default = None


def fault_point(name: str) -> Callable:
    """Convenience: the default injector's point — what the plugin and
    k8s seams hold. NOOP unless TPUSHARE_CHAOS arms the point."""
    return default_injector().point(name)
