"""Host-gap accounting for the overlapped engine tick. The port's copy
of ``gap_percentiles`` and ``HOST_GAP_CAP`` from
``tpushare/utils/profiling.py`` (the original module imports jax); a
test holds the copy equal to the original."""

from __future__ import annotations

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
