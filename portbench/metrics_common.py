"""Arithmetic the metric readers share."""

from portbench import flops
from portbench.harness import percentile


def roofline_pct(run, family: str):
    """Least seconds of a span family's calls over the device seconds of
    their kernels, in percent; None when the window has neither."""
    if run.trace is None or run.kernel_work is None:
        return None
    least = run.kernel_work.get(family, 0.0)
    spent = run.trace["family_s"].get(family, 0.0)
    if not least or not spent:
        return None
    return 100.0 * least / spent


def output_tok_s(run):
    """Tokens served to every request inside the window, over its
    seconds."""
    return run.tokens_between(run.t0, run.t1) / run.window_s


def itl_p95_ms(run):
    """The 95th percentile of the gaps between a request's consecutive
    tokens, over every gap that ends inside the window."""
    gaps = []
    for r in run.records:
        ts = r.t_tokens
        gaps += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])
                 if run.t0 <= b < run.t1]
    return percentile(gaps, 95)


def step_mfu_pct(run):
    """The model FLOPs of the work done inside the window's untraced part
    (each prompt whose first token came inside it, from its first
    uncached position, and each later token served inside it) over its
    seconds times the card's dense bf16 peak; None off a card."""
    if run.peaks is None:
        return None
    t0, t1 = run.untraced
    total = 0.0
    for r in run.records:
        ts = r.t_tokens
        if not ts:
            continue
        P = len(r.prompt)
        if t0 <= ts[0] < t1:
            total += flops.prefill_flops(run.conf, r.cached_prefix, P)
        for i, t in enumerate(ts[1:], start=1):
            if t0 <= t < t1:
                total += flops.decode_flops(run.conf, P + i - 1)
    if not total:
        return None
    return 100.0 * total / ((t1 - t0) * run.peaks[0])
