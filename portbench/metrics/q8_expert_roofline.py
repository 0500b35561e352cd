"""q8_expert_roofline: the least time of the routed work of
every q8_expert call inside the traced window (portbench/flops.py: the
rows the router gave each expert it touched, FLOPs over peak or bytes
over bandwidth, whichever is larger) over the device time of the
kernels those calls launched. Work the kernel is handed beyond the
routed rows (dense dispatch gives every expert every row) counts as
time, not as work."""

from portbench.metrics_common import roofline_pct


def read(run):
    return roofline_pct(run, "q8_expert")
