"""WC fixture — clean contract usage the rules must NOT flag.

Mentions TPU_VISIBLE_CHIPS and aliyun.com/tpu-mem right here in the
docstring: documentation is not wire traffic.
"""
from tpushare_torch.deviceplugin import pb
from tpushare_torch.plugin import const


def build():
    dev = pb.Device(ID="x", health="Healthy")
    resp = pb.AllocateResponse(container_responses=[
        pb.ContainerAllocateResponse(
            envs={const.ENV_TPU_VISIBLE_CHIPS: "0"})])
    return dev.ID, resp.container_responses


MESSAGE = "set TPU_VISIBLE_CHIPS_FIRST"   # prose, not the exact contract key
