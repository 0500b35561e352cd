"""itl_p95_ms: the 95th percentile of the gaps between consecutive
tokens of a request, over every gap of every request that ends inside
the window (host clock), in the cells whose pace the host sets."""

from portbench.metrics_common import itl_p95_ms as read  # noqa: F401
