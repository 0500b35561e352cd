"""WC fixture — true positives. Parsed by the analyzer, never run."""
from tpushare_torch.deviceplugin import pb

VISIBLE = "TPU_VISIBLE_CHIPS"                 # WC301 env literal
ANN = "ALIYUN_COM_TPU_MEM_IDX"                # WC301 annotation literal
RES = "aliyun.com/tpu-mem"                    # WC301 resource literal
CARD = "NVIDIA_VISIBLE_DEVICES"               # WC301 card selector literal


def build():
    dev = pb.Device(ID="x", health="Healthy", wattage=5)  # WC302 kwarg
    req = pb.BogusMessage(devices=[])                     # WC302 message
    resp = pb.AllocateResponse()
    return dev.wattage, resp.container_responses, req     # WC302 attr
