"""Profiling and throughput accounting for tenant workloads on the card.
Counterpart of ``tpushare/utils/profiling.py`` (the original imports
jax): a ``torch.profiler`` trace context, steady-state step timers, the
host-gap accounting of the overlapped engine tick, the chained phase
timer, and model FLOPs and HBM-byte accounting, so a run can report MFU
(model FLOPs utilization) and roofline shares against the card's
published peaks: the numbers that tell whether co-located tenants are
compute-starved or only HBM-bound.

The peak tables hold the cards the port has been measured on, keyed by
``card_key``; an unknown card or a CPU has no key, and every share
(``mfu``, ``bandwidth_utilization``, ``phase_roofline``) is then None:
no number is ever shown against a peak assumed for another card."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Iterator, Optional

import torch

#: Peak dense bf16 FLOP/s per card — the MFU denominator. NVIDIA's H100
#: data sheet, SXM part: the tensor cores' dense rate without sparsity,
#: at the 700 W power limit (a card set below it runs slower under load).
PEAK_FLOPS = {
    "h100-sxm": 989e12,
}

#: Peak HBM bandwidth per card, bytes/s (the same data sheet: HBM3 of
#: the SXM part). Decode is bandwidth-bound, so its utilization
#: denominator is bytes streamed per step / this, not FLOPs.
HBM_BANDWIDTH = {
    "h100-sxm": 3.35e12,
}

#: ``torch.cuda.get_device_name`` -> peak-table key. Exact names only:
#: the PCIe and NVL parts of the H100 have other peaks and no key.
CARD_KEYS = {
    "NVIDIA H100 80GB HBM3": "h100-sxm",
}


def card_key(device=None) -> Optional[str]:
    """The peak-table key of the CUDA card ``device`` names (a device,
    its string or index; None: the current card), or None for a CPU,
    no card, or a card the tables do not hold."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if isinstance(device, int):
        device = torch.device("cuda", device)
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return CARD_KEYS.get(torch.cuda.get_device_name(device))


def _key(generation: Optional[str]) -> Optional[str]:
    return card_key() if generation is None else generation


def bandwidth_utilization(bytes_per_step: float, step_seconds: float,
                          generation: Optional[str] = None,
                          n_chips: int = 1) -> Optional[float]:
    """Achieved HBM bandwidth as a fraction of peak, or None for an
    unknown card (``generation`` None: the current card's key).
    ``bytes_per_step`` = bytes that MUST move between HBM and the SMs
    per step (weights read once + live KV read + KV writes) — the
    decode-regime roofline denominator."""
    bw = HBM_BANDWIDTH.get(_key(generation))
    if not bw or step_seconds <= 0:
        return None
    return bytes_per_step / step_seconds / (bw * n_chips)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """``torch.profiler`` trace around a block, exported as a Chrome
    trace into ``log_dir``: ``with trace(d) as path: step()``, then
    read ``path``. CPU activity always, CUDA activity when a card is
    present. The main thread only: a profiler running while other
    threads launch work on the card has crashed the process."""
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("profiling.trace runs on the main thread only")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def tree_tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested list/tuple/dict, depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)


def time_step(fn: Callable, *args, warmup: int = 2, iters: int = 10,
              **kwargs) -> float:
    """Median wall-clock seconds of ``fn(*args)`` at steady state; each
    call ends in a synchronize of the cards its outputs live on."""
    for _ in range(warmup):
        _drain(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _drain(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_step_chained(body: Callable, init, *consts, k_lo: int = 16,
                      k_hi: int = 256, iters: int = 5,
                      min_credible_delta_s: float = 0.020) -> tuple:
    """Per-step seconds of ``body`` (carry[, *consts] -> carry);
    returns ``(seconds, credible)``.

    Each timed call is a chain of K data-dependent ``body`` calls (a
    Python loop; ``consts`` are the loop-invariant operands, passed to
    every call) ending in ONE device-to-host scalar read of the final
    carry's first tensor (``.item()``, the only barrier). The per-step
    time is the difference between the median k_hi-long and k_lo-long
    chains (``time_step``, ``iters`` each) divided by (k_hi - k_lo),
    so the per-chain fixed cost (the read, the first launch's latency)
    cancels. In PyTorch each step of the chain is dispatched by the
    host: where a step is host-bound, its per-step time includes that
    dispatch. ``credible`` is False when the chain delta is inside the
    jitter floor — callers must not report such a reading as a
    measured value."""

    def make(k):
        def chained(c, *cs):
            for _ in range(k):
                c = body(c, *cs)
            leaf = next(tree_tensors(c))
            return float(leaf.float().sum().item())    # scalar read
        return chained

    t_lo = time_step(make(k_lo), init, *consts, warmup=2, iters=iters)
    t_hi = time_step(make(k_hi), init, *consts, warmup=2, iters=iters)
    delta = t_hi - t_lo
    credible = delta >= min_credible_delta_s
    return max(delta, 1e-9) / (k_hi - k_lo), credible


#: PhaseTimer phase name for the host-side scheduling gap of an
#: overlapped engine tick: finalize-of-tick-N-1 done -> tick N's
#: dispatch launched. The serving loop itself never attaches a
#: PhaseTimer (measurement mode only — see the class docstring); it
#: records raw monotonic deltas and summarizes them with
#: ``gap_percentiles`` below. Benches that DO attach a timer charge
#: the same span to this row so the two spellings line up.
HOST_GAP = "host_gap"

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
    for dev in {t.device for t in tree_tensors(block_on) if t.is_cuda}:
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


def phase_roofline(snapshot: dict, phase_bytes: dict, n_steps: int,
                   generation: Optional[str] = None, n_chips: int = 1,
                   on_chip: bool = True) -> dict:
    """PhaseTimer snapshot + per-phase must-move bytes -> the
    phase x roofline table of a decode window:
    {phase: {fraction, ms_per_step, bytes_per_step_mib,
    pct_of_roofline}}.

    ``fraction`` is the phase's share of the measured step (where the
    time goes); ``pct_of_roofline`` is that phase's achieved HBM
    bandwidth against ITS OWN mandatory byte floor (how good the
    phase is at moving what it must) — a phase with a large fraction
    AND a low roofline % is the one paying for traffic its floor does
    not include. Zero-byte phases (dequant, dispatch: pure overhead at
    decode shapes) report pct None — their fraction IS the indictment.
    Off the card (``on_chip`` False, or no peak for ``generation``;
    None: the current card's key) every pct is None: CPU fractions
    prove the machinery, not the bandwidth story."""
    bw = HBM_BANDWIDTH.get(_key(generation))
    rows = {}
    for ph, rec in snapshot.items():
        sec = rec["seconds"] / max(n_steps, 1)
        nb = phase_bytes.get(ph)
        pct = None
        if on_chip and bw and nb and sec > 0:
            pct = round(100.0 * nb / sec / (bw * n_chips), 1)
        rows[ph] = {
            "fraction": rec["fraction"],
            "ms_per_step": round(sec * 1e3, 3),
            "bytes_per_step_mib": (round(nb / 2 ** 20, 2) if nb
                                   else None),
            "pct_of_roofline": pct,
        }
    return rows


def transformer_flops(cfg, batch: int, seq: int, *,
                      training: bool = False) -> float:
    """Dense-transformer FLOPs for one forward (x3 for fwd+bwd).

    2·params·tokens for the matmuls plus the attention score/value
    terms (2·2·B·S²·H·Dh per layer, halved for causal masking). The
    count ignores sliding windows and activation recompute (remat)."""
    tokens = batch * seq
    # The input-embedding gather does no matmul FLOPs, so the vocab
    # projection counts exactly once whether or not embeddings are
    # tied: num_params() holds one table copy when tied (it *is* the
    # unembed matmul) and two when untied (drop the gather-only one).
    embed_table = cfg.vocab_size * cfg.d_model
    active = cfg.num_params()
    if not getattr(cfg, "tie_embeddings", True):
        active -= embed_table
    matmul = 2.0 * active * tokens
    attn = cfg.n_layers * 2 * 2 * batch * seq * seq * cfg.q_dim / 2
    total = matmul + attn
    return 3.0 * total if training else total


def mfu(flops_per_step: float, step_seconds: float,
        generation: Optional[str] = None,
        n_chips: int = 1) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None for an unknown card
    (``generation`` None: the current card's key)."""
    peak = PEAK_FLOPS.get(_key(generation))
    if not peak or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / (peak * n_chips)
