"""prefill_attn_roofline: the least time of every call of the
prefill_attn entries inside the traced window (portbench/flops.py: FLOPs over
peak or bytes over bandwidth, whichever is larger) over the device time
of the kernels those calls launched."""

from portbench.metrics_common import roofline_pct


def read(run):
    return roofline_pct(run, "prefill_attn")
