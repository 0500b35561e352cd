"""model.step_mfu_pct: the model FLOPs of the work done in the traced
run's untraced part (portbench/flops.py: the routed experts only, the
causal attention, the head only where a token is emitted) over its
seconds times the card's dense bf16 peak, in the host-paced cells."""

from portbench.metrics_common import step_mfu_pct as read  # noqa: F401
