"""WC fixture — violations silenced by per-line suppressions."""
from tpushare_torch.deviceplugin import pb

LEGACY = "ALIYUN_COM_TPU_MEM_POD"  # tpushare: ignore[WC301]


def poke():
    dev = pb.Device(voltage=3)  # tpushare: ignore[WC302]
    return dev
