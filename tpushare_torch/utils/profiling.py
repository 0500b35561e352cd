"""Host-gap accounting for the overlapped engine tick and the chained
phase timer. The port's copy of ``gap_percentiles``, ``HOST_GAP_CAP``
and ``PhaseTimer`` from ``tpushare/utils/profiling.py`` (the original
module imports jax); a test holds the copies to the originals."""

from __future__ import annotations

import time
from typing import Optional

import torch

#: newest host-gap samples kept by the engine's ring (matches the
#: tier-latency SAMPLE_CAP in slo/stats.py).
HOST_GAP_CAP = 512


def gap_percentiles(samples_ms) -> dict:
    """{p50, p99} (ms, nearest-rank) over a host-gap sample ring —
    the /stats ``host_gap_ms`` spelling. Values are None until the
    first overlapped dispatch records a gap; callers in serial mode
    report the whole block as null instead (null-not-0: a serial
    engine has no host gap to hide, not a zero-length one)."""
    out = {}
    for name, q in (("p50", 0.50), ("p99", 0.99)):
        if not samples_ms:
            out[name] = None
            continue
        ordered = sorted(samples_ms)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        out[name] = round(ordered[idx], 3)
    return out


def _drain(block_on) -> None:
    """Wait for the work that produced ``block_on`` (a tensor or a
    nested list/tuple/dict of them): one synchronize per CUDA device
    the tensors live on. CPU tensors are already computed."""
    devices = set()
    stack = [block_on]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Chained per-phase wall-clock accumulator: ``start()`` opens a
    chain, each ``mark(phase, block_on=...)`` closes the span since the
    previous mark/start and charges it to ``phase``. Passing the
    phase's output tensors as ``block_on`` drains their card first, so
    asynchronously launched work is attributed to the phase that
    launched it.

    MEASUREMENT MODE ONLY: the barriers it inserts are exactly the
    host-device syncs the serving hot loop must never make (the
    one-fetch-per-tick invariant). Callers that time their own spans
    (``models/kvtier.CrossoverEstimator``) use only its accounting."""

    def __init__(self):
        self.seconds: dict = {}
        self.counts: dict = {}
        self._t0: Optional[float] = None

    def start(self) -> None:
        """Open a chain; the next mark() measures from here."""
        self._t0 = time.perf_counter()

    def mark(self, phase: str, block_on=None) -> None:
        """Close the open span as ``phase`` (no-op when no chain is
        open, so an un-started timer costs nothing on any path)."""
        if self._t0 is None:
            return
        if block_on is not None:
            _drain(block_on)
        now = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) \
            + (now - self._t0)
        self.counts[phase] = self.counts.get(phase, 0) + 1
        self._t0 = now

    def snapshot(self) -> dict:
        """{phase: {seconds, count, fraction}} — fractions over the
        total accumulated time (the bench-row spelling)."""
        total = sum(self.seconds.values())
        return {
            ph: {"seconds": round(s, 6),
                 "count": self.counts.get(ph, 0),
                 "fraction": round(s / total, 4) if total else None}
            for ph, s in self.seconds.items()
        }
