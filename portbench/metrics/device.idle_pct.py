"""device.idle_pct: the share of the traced window (the window's last
20 s) in which nothing ran on the card (the profiler's kernels, copies
and sets, merged)."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
