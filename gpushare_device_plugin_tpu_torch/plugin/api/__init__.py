"""The kubelet device-plugin API v1beta1: messages (``pb``) and the
hand-written gRPC bindings."""

from . import deviceplugin_pb2 as pb
from .api_grpc import (
    DevicePluginServicer,
    DevicePluginStub,
    RegistrationServicer,
    RegistrationStub,
    add_device_plugin_servicer,
    add_registration_servicer,
)

__all__ = [
    "pb",
    "DevicePluginServicer",
    "DevicePluginStub",
    "RegistrationServicer",
    "RegistrationStub",
    "add_device_plugin_servicer",
    "add_registration_servicer",
]
