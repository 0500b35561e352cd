"""output_tok_s: tokens served to every request inside the window, over
the window's seconds (host clock), in the cells whose pace the host
sets."""

from portbench.metrics_common import output_tok_s as read  # noqa: F401
