"""ttft_p90_ms: the 90th percentile of the time from a request's send to
its first token, over every request sent inside the window (host
clock). A request that failed, was refused or got no first token
counts as infinitely late."""

import math

from portbench.harness import percentile


def read(run):
    ttft = [(r.t_tokens[0] - r.t_send) * 1e3 if r.t_tokens else math.inf
            for r in run.sent_in_window()]
    return percentile(ttft, 90)
