"""Hand-written gRPC service plumbing for deviceplugin/v1beta1: the
port's copy of ``tpushare/deviceplugin/rpc.py``. The method paths
(``/v1beta1.DevicePlugin/Allocate`` etc.) are the wire contract the
kubelet dials, the same as the reference plugin's (server.go:114-128,
158-177).
"""

from __future__ import annotations

import grpc

from . import api_pb2 as pb

_DP = "v1beta1.DevicePlugin"
_REG = "v1beta1.Registration"


class DevicePluginServicer:
    """Base servicer; subclass and override (reference: server.go NvidiaDevicePlugin)."""

    def GetDevicePluginOptions(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "GetDevicePluginOptions")

    def ListAndWatch(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "ListAndWatch")

    def GetPreferredAllocation(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "GetPreferredAllocation")

    def Allocate(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Allocate")

    def PreStartContainer(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "PreStartContainer")


def add_DevicePluginServicer_to_server(servicer: DevicePluginServicer, server: grpc.Server) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(_DP, handlers),))


class DevicePluginStub:
    """Client stub — what a kubelet (or our test harness) uses to drive the plugin."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_DP}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_DP}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_DP}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{_DP}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_DP}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class RegistrationServicer:
    """Kubelet side of Register — implemented by the test kubelet simulator."""

    def Register(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Register")


def add_RegistrationServicer_to_server(servicer: RegistrationServicer, server: grpc.Server) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(_REG, handlers),))


class RegistrationStub:
    """Plugin→kubelet Register client (reference: server.go:158-177)."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_REG}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )
