"""Hand-written gRPC bindings for the v1beta1 device-plugin API.

Counterpart of ``gpushare_device_plugin_tpu/plugin/api/api_grpc.py``, copied.

grpc_tools (the protoc gRPC python plugin) is not available in the build
image, so the service stubs/servicers normally emitted into
``*_pb2_grpc.py`` are written by hand against the generated message classes.
Method paths must match the canonical API exactly
(``/v1beta1.Registration/Register`` etc.) — kubelet dials these by name.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb

_REGISTRATION = "v1beta1.Registration"
_DEVICE_PLUGIN = "v1beta1.DevicePlugin"


# --- client stubs ----------------------------------------------------------


class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_REGISTRATION}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


class DevicePluginStub:
    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_DEVICE_PLUGIN}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


# --- servicer base classes -------------------------------------------------


class RegistrationServicer:
    def Register(self, request: pb.RegisterRequest, context) -> pb.Empty:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


class DevicePluginServicer:
    def GetDevicePluginOptions(self, request, context) -> pb.DevicePluginOptions:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def ListAndWatch(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def GetPreferredAllocation(self, request, context) -> pb.PreferredAllocationResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Allocate(self, request, context) -> pb.AllocateResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def PreStartContainer(self, request, context) -> pb.PreStartContainerResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


# --- server registration ---------------------------------------------------


def add_registration_servicer(servicer: RegistrationServicer, server: grpc.Server) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_REGISTRATION, handlers),)
    )


def add_device_plugin_servicer(servicer: DevicePluginServicer, server: grpc.Server) -> None:
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
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_DEVICE_PLUGIN, handlers),)
    )
