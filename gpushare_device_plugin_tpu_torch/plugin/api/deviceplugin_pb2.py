"""The kubelet device-plugin API v1beta1's messages (``deviceplugin.proto``).

The reference's ``plugin/api/deviceplugin_pb2.py`` holds the same
serialized file descriptor, but registers it in protobuf's default
descriptor pool. The port builds its own pool instead, so both packages'
messages load in one process (as the tests' workers do) without the two
registrations meeting. The wire bytes are the same: the messages of one
package parse the other's.
"""

from google.protobuf import descriptor_pool, message_factory

# protoc's serialization of deviceplugin.proto (package v1beta1).
_SERIALIZED = b'\n\x12\x64\x65viceplugin.proto\x12\x07v1beta1\"]\n\x13\x44\x65vicePluginOptions\x12\x1a\n\x12pre_start_required\x18\x01 \x01(\x08\x12*\n\"get_preferred_allocation_available\x18\x02 \x01(\x08\"z\n\x0fRegisterRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x02 \x01(\t\x12\x15\n\rresource_name\x18\x03 \x01(\t\x12-\n\x07options\x18\x04 \x01(\x0b\x32\x1c.v1beta1.DevicePluginOptions\"\x07\n\x05\x45mpty\"8\n\x14ListAndWatchResponse\x12 \n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x0f.v1beta1.Device\"0\n\x0cTopologyInfo\x12 \n\x05nodes\x18\x01 \x03(\x0b\x32\x11.v1beta1.NUMANode\"\x16\n\x08NUMANode\x12\n\n\x02ID\x18\x01 \x01(\x03\"M\n\x06\x44\x65vice\x12\n\n\x02ID\x18\x01 \x01(\t\x12\x0e\n\x06health\x18\x02 \x01(\t\x12\'\n\x08topology\x18\x03 \x01(\x0b\x32\x15.v1beta1.TopologyInfo\"f\n\x1aPreferredAllocationRequest\x12H\n\x12\x63ontainer_requests\x18\x01 \x03(\x0b\x32,.v1beta1.ContainerPreferredAllocationRequest\"{\n#ContainerPreferredAllocationRequest\x12\x1b\n\x13\x61vailable_deviceIDs\x18\x01 \x03(\t\x12\x1e\n\x16must_include_deviceIDs\x18\x02 \x03(\t\x12\x17\n\x0f\x61llocation_size\x18\x03 \x01(\x05\"i\n\x1bPreferredAllocationResponse\x12J\n\x13\x63ontainer_responses\x18\x01 \x03(\x0b\x32-.v1beta1.ContainerPreferredAllocationResponse\"9\n$ContainerPreferredAllocationResponse\x12\x11\n\tdeviceIDs\x18\x01 \x03(\t\"/\n\x18PreStartContainerRequest\x12\x13\n\x0b\x64\x65vices_ids\x18\x01 \x03(\t\"\x1b\n\x19PreStartContainerResponse\"P\n\x0f\x41llocateRequest\x12=\n\x12\x63ontainer_requests\x18\x01 \x03(\x0b\x32!.v1beta1.ContainerAllocateRequest\".\n\x18\x43ontainerAllocateRequest\x12\x12\n\ndevicesIDs\x18\x01 \x03(\t\"S\n\x10\x41llocateResponse\x12?\n\x13\x63ontainer_responses\x18\x01 \x03(\x0b\x32\".v1beta1.ContainerAllocateResponse\"\xc8\x02\n\x19\x43ontainerAllocateResponse\x12:\n\x04\x65nvs\x18\x01 \x03(\x0b\x32,.v1beta1.ContainerAllocateResponse.EnvsEntry\x12\x1e\n\x06mounts\x18\x02 \x03(\x0b\x32\x0e.v1beta1.Mount\x12$\n\x07\x64\x65vices\x18\x03 \x03(\x0b\x32\x13.v1beta1.DeviceSpec\x12H\n\x0b\x61nnotations\x18\x04 \x03(\x0b\x32\x33.v1beta1.ContainerAllocateResponse.AnnotationsEntry\x1a+\n\tEnvsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"E\n\x05Mount\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x11\n\tread_only\x18\x03 \x01(\x08\"L\n\nDeviceSpec\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x13\n\x0bpermissions\x18\x03 \x01(\t2F\n\x0cRegistration\x12\x36\n\x08Register\x12\x18.v1beta1.RegisterRequest\x1a\x0e.v1beta1.Empty\"\x00\x32\xa3\x03\n\x0c\x44\x65vicePlugin\x12H\n\x16GetDevicePluginOptions\x12\x0e.v1beta1.Empty\x1a\x1c.v1beta1.DevicePluginOptions\"\x00\x12\x41\n\x0cListAndWatch\x12\x0e.v1beta1.Empty\x1a\x1d.v1beta1.ListAndWatchResponse\"\x00\x30\x01\x12\x65\n\x16GetPreferredAllocation\x12#.v1beta1.PreferredAllocationRequest\x1a$.v1beta1.PreferredAllocationResponse\"\x00\x12\x41\n\x08\x41llocate\x12\x18.v1beta1.AllocateRequest\x1a\x19.v1beta1.AllocateResponse\"\x00\x12\\\n\x11PreStartContainer\x12!.v1beta1.PreStartContainerRequest\x1a\".v1beta1.PreStartContainerResponse\"\x00\x62\x06proto3'

POOL = descriptor_pool.DescriptorPool()
POOL.AddSerializedFile(_SERIALIZED)
DESCRIPTOR = POOL.FindFileByName("deviceplugin.proto")


def _message(name: str) -> type:
    return message_factory.GetMessageClass(DESCRIPTOR.message_types_by_name[name])


DevicePluginOptions = _message("DevicePluginOptions")
RegisterRequest = _message("RegisterRequest")
Empty = _message("Empty")
ListAndWatchResponse = _message("ListAndWatchResponse")
TopologyInfo = _message("TopologyInfo")
NUMANode = _message("NUMANode")
Device = _message("Device")
PreferredAllocationRequest = _message("PreferredAllocationRequest")
ContainerPreferredAllocationRequest = _message("ContainerPreferredAllocationRequest")
PreferredAllocationResponse = _message("PreferredAllocationResponse")
ContainerPreferredAllocationResponse = _message("ContainerPreferredAllocationResponse")
PreStartContainerRequest = _message("PreStartContainerRequest")
PreStartContainerResponse = _message("PreStartContainerResponse")
AllocateRequest = _message("AllocateRequest")
ContainerAllocateRequest = _message("ContainerAllocateRequest")
AllocateResponse = _message("AllocateResponse")
ContainerAllocateResponse = _message("ContainerAllocateResponse")
Mount = _message("Mount")
DeviceSpec = _message("DeviceSpec")
