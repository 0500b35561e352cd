"""kubelet deviceplugin/v1beta1 wire protocol: the port's copy of
``tpushare/deviceplugin/__init__.py``. Messages in ``api_pb2`` (generated
from ``tpushare/deviceplugin/api.proto``), the hand-written gRPC plumbing
in ``rpc``, and the v1beta1 constants. A test holds the copy equal to its
original.
"""

from . import api_pb2 as pb  # noqa: F401
from .rpc import (  # noqa: F401
    DevicePluginServicer,
    DevicePluginStub,
    RegistrationServicer,
    RegistrationStub,
    add_DevicePluginServicer_to_server,
    add_RegistrationServicer_to_server,
)

# Mirror of k8s.io/kubelet deviceplugin/v1beta1 constants
# (reference uses them via the pluginapi import, e.g. server.go:120,
# const.go:13, nvidia.go:74).
VERSION = "v1beta1"
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
KUBELET_SOCKET = DEVICE_PLUGIN_PATH + "kubelet.sock"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"
