"""The port's gRPC device plugin (gpushare_device_plugin_tpu_torch:
``plugin/server.py``, ``plugin/api/``) against the reference's, over real
unix sockets in a tmp dir, each registered with the reference's
``tests/fake_kubelet.FakeKubelet`` (so the kubelet side of every wire
speaks the reference's messages).

For the same mock inventory and the same grants, ListAndWatch's device
list, GetPreferredAllocation and Allocate's response are the reference
plugin's; a health flip re-sends Unhealthy and then the recovery; a
request that does not fit aborts with INVALID_ARGUMENT; ``drain`` waits
for an in-flight Allocate. Both packages' messages load in one process
(the port's live in a descriptor pool of their own) and parse each
other's bytes. Every RPC has a timeout.
"""

from __future__ import annotations

import threading

import grpc
import pytest

from gpushare_device_plugin_tpu import const as JC
from gpushare_device_plugin_tpu.allocator.local import LocalAllocator as JLocal
from gpushare_device_plugin_tpu.device import DeviceInventory as JInventory
from gpushare_device_plugin_tpu.discovery import MockBackend as JMock
from gpushare_device_plugin_tpu.discovery.base import ChipHealth as JHealth
from gpushare_device_plugin_tpu.plugin import PluginConfig as JConfig
from gpushare_device_plugin_tpu.plugin import TpuSharePlugin as JPlugin
from gpushare_device_plugin_tpu.plugin.api import pb as jpb
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator.local import LocalAllocator
from gpushare_device_plugin_tpu_torch.device import DeviceInventory
from gpushare_device_plugin_tpu_torch.discovery import MockBackend
from gpushare_device_plugin_tpu_torch.discovery.base import ChipHealth
from gpushare_device_plugin_tpu_torch.plugin import PluginConfig, TpuSharePlugin, wait_for_socket
from gpushare_device_plugin_tpu_torch.plugin.api import DevicePluginStub, pb

from fake_kubelet import FakeKubelet

GIB = 1 << 30
TIMEOUT = 5.0
PORT = dict(plugin=TpuSharePlugin, config=PluginConfig, inventory=DeviceInventory,
            mock=MockBackend, local=LocalAllocator, health=ChipHealth)
REF = dict(plugin=JPlugin, config=JConfig, inventory=JInventory, mock=JMock, local=JLocal,
           health=JHealth)


class Stack:
    """A FakeKubelet and one package's mem plugin on a mock 4 x 32 GiB host,
    each in its own directory (its own sockets)."""

    def __init__(self, pkg: dict, plugin_dir: str, allocate_fn=None):
        self.pkg = pkg
        self.kubelet = FakeKubelet(plugin_dir)
        self.kubelet.start()
        self.inv = pkg["inventory"](pkg["mock"](num_chips=4, hbm_bytes=32 * GIB).chips())
        self.allocator = pkg["local"](self.inv)
        self.plugin = pkg["plugin"](
            self.inv,
            allocate_fn=allocate_fn or (
                lambda granted: self.allocator.allocate([len(g) for g in granted])),
            config=pkg["config"](plugin_dir=plugin_dir),
        )
        self.plugin.serve()
        self.reg = self.kubelet.wait_for_registration(timeout=TIMEOUT)
        self.kubelet.begin_watch(self.reg.resource_name, self.reg.endpoint)
        self.devices = self._ids(self.kubelet.wait_for_devices(self.reg.resource_name, TIMEOUT))

    @staticmethod
    def _ids(devs):
        return [(d.ID, d.health) for d in devs]

    def next_devices(self):
        return self._ids(self.kubelet.wait_for_devices(self.reg.resource_name, TIMEOUT))

    def allocate(self, counts):
        """Grant each container its first ``n`` fake ids, like kubelet."""
        ids = [d for d, _ in self.devices]
        return self.kubelet.allocate(self.reg.endpoint, [ids[:n] for n in counts])

    def close(self):
        self.plugin.stop()
        self.kubelet.stop()


@pytest.fixture
def stacks(tmp_path):
    made = []

    def make(pkg, name, **kw):
        stack = Stack(pkg, str(tmp_path / name), **kw)
        made.append(stack)
        return stack

    yield make
    for stack in made:
        stack.close()


def _response_doc(resp) -> list[dict]:
    return [{"envs": dict(c.envs), "annotations": dict(c.annotations),
             "devices": [(d.container_path, d.host_path, d.permissions) for d in c.devices],
             "mounts": len(c.mounts)} for c in resp.container_responses]


def test_register_list_and_allocate_match_the_reference_plugin(stacks):
    port, ref = stacks(PORT, "port"), stacks(REF, "ref")
    assert (port.reg.resource_name, port.reg.endpoint, port.reg.version) == (
        ref.reg.resource_name, ref.reg.endpoint, ref.reg.version) == (
        const.RESOURCE_MEM, const.MEM_SOCKET_NAME, const.API_VERSION)
    assert port.reg.options == ref.reg.options
    assert port.devices == ref.devices and len(port.devices) == 128
    for counts in ([2], [16], [3, 5], [20], [30], [1]):
        assert _response_doc(port.allocate(counts)) == _response_doc(ref.allocate(counts))
    assert port.allocator.used_by_chip() == ref.allocator.used_by_chip() == {0: 27, 1: 20, 2: 30}
    envs = port.allocate([6]).container_responses[0].envs  # 5 units left on chip 0
    assert envs[const.ENV_TPU_VISIBLE_CHIPS] == "1" and envs[const.ENV_MEM_POD] == "6"
    assert envs[JC.ENV_XLA_PYTHON_MEM_FRACTION] == "0.1875"

    def preferred(stack):
        stub = stack.kubelet.stub_for(stack.reg.endpoint)
        req = jpb.PreferredAllocationRequest(container_requests=[
            jpb.ContainerPreferredAllocationRequest(
                available_deviceIDs=[d for d, _ in stack.devices[5:12]], allocation_size=3)])
        opts = stub.GetDevicePluginOptions(jpb.Empty(), timeout=TIMEOUT)
        return list(stub.GetPreferredAllocation(req, timeout=TIMEOUT)
                    .container_responses[0].deviceIDs), opts

    assert preferred(port) == preferred(ref)


def test_health_flip_resends_unhealthy_then_recovery(stacks):
    port, ref = stacks(PORT, "port"), stacks(REF, "ref")
    seen = {}
    for name, stack in (("port", port), ("ref", ref)):
        chip = stack.inv.chips()[2].id
        stack.plugin.set_chip_health(chip, stack.pkg["health"].UNHEALTHY)
        sick = stack.next_devices()
        assert stack.plugin.unhealthy_chip_indices() == [2]
        stack.plugin.set_chip_health(chip, stack.pkg["health"].HEALTHY)
        seen[name] = (sick, stack.next_devices())
    assert seen["port"] == seen["ref"]
    sick, healed = seen["port"]
    assert [d for d, h in sick if h == "Unhealthy"] == [d for d, _ in port.devices[64:96]]
    assert healed == port.devices


def test_a_request_that_does_not_fit_aborts_invalid_argument(stacks):
    codes = []
    for stack in (stacks(PORT, "port"), stacks(REF, "ref")):
        with pytest.raises(grpc.RpcError) as err:
            stack.allocate([33])
        codes.append((err.value.code(), err.value.details()))
    assert codes[0] == codes[1]
    assert codes[0][0] == grpc.StatusCode.INVALID_ARGUMENT
    assert "no chip can fit 33 units" in codes[0][1]


def test_drain_waits_for_an_inflight_allocate(stacks):
    entered, release = threading.Event(), threading.Event()
    inner = {}

    def slow(granted):
        entered.set()
        assert release.wait(TIMEOUT)
        return inner["stack"].allocator.allocate([len(g) for g in granted])

    stack = inner["stack"] = stacks(PORT, "port", allocate_fn=slow)
    out = {}
    caller = threading.Thread(target=lambda: out.setdefault("resp", stack.allocate([4])))
    caller.start()
    assert entered.wait(TIMEOUT)
    assert stack.plugin.drain(timeout_s=0.2) is False  # one Allocate still in flight
    release.set()
    assert stack.plugin.drain(timeout_s=TIMEOUT) is True
    caller.join(TIMEOUT)
    assert not caller.is_alive()
    assert out["resp"].container_responses[0].envs[const.ENV_MEM_POD] == "4"
    with pytest.raises(grpc.RpcError) as err:  # drained: new admissions refused
        stack.allocate([1])
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE


def test_plugin_socket_and_self_dial(tmp_path):
    inv = DeviceInventory(MockBackend(num_chips=1, hbm_bytes=8 * GIB).chips())
    plugin = TpuSharePlugin(inv, None, config=PluginConfig(plugin_dir=str(tmp_path)))
    plugin.start()
    try:
        assert wait_for_socket(plugin.socket_path, timeout=TIMEOUT)
        assert not plugin.registered
        with grpc.insecure_channel(f"unix:{plugin.socket_path}") as ch:
            stub = DevicePluginStub(ch)
            opts = stub.GetDevicePluginOptions(pb.Empty(), timeout=TIMEOUT)
            assert opts.get_preferred_allocation_available
            with pytest.raises(grpc.RpcError) as err:  # no allocator bound yet
                stub.Allocate(pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=["x"])]), timeout=TIMEOUT)
            assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        plugin.stop()
    assert not (tmp_path / const.MEM_SOCKET_NAME).exists()


def _populated(mod):
    """One instance of every message the API defines, fields set."""
    return {
        "RegisterRequest": mod.RegisterRequest(
            version="v1beta1", endpoint="a.sock", resource_name=const.RESOURCE_MEM,
            options=mod.DevicePluginOptions(pre_start_required=True,
                                            get_preferred_allocation_available=True)),
        "ListAndWatchResponse": mod.ListAndWatchResponse(devices=[
            mod.Device(ID="GPU-0-_-0", health="Healthy",
                       topology=mod.TopologyInfo(nodes=[mod.NUMANode(ID=1)])),
            mod.Device(ID="GPU-0-_-1", health="Unhealthy")]),
        "PreferredAllocationRequest": mod.PreferredAllocationRequest(container_requests=[
            mod.ContainerPreferredAllocationRequest(
                available_deviceIDs=["a", "b"], must_include_deviceIDs=["a"],
                allocation_size=2)]),
        "PreferredAllocationResponse": mod.PreferredAllocationResponse(container_responses=[
            mod.ContainerPreferredAllocationResponse(deviceIDs=["a", "b"])]),
        "PreStartContainerRequest": mod.PreStartContainerRequest(devices_ids=["a"]),
        "AllocateRequest": mod.AllocateRequest(container_requests=[
            mod.ContainerAllocateRequest(devicesIDs=["a", "b", "c"])]),
        "AllocateResponse": mod.AllocateResponse(container_responses=[
            mod.ContainerAllocateResponse(
                envs={"TPU_VISIBLE_CHIPS": "0", "ALIYUN_COM_TPU_MEM_POD": "3"},
                annotations={"k": "v"},
                mounts=[mod.Mount(container_path="/c", host_path="/h", read_only=True)],
                devices=[mod.DeviceSpec(container_path="/dev/nvidia0",
                                        host_path="/dev/nvidia0", permissions="rw")])]),
    }


def test_both_packages_messages_coexist_and_round_trip():
    from google.protobuf import descriptor_pool

    assert pb.DESCRIPTOR.pool is not descriptor_pool.Default()
    assert jpb.DESCRIPTOR.pool is descriptor_pool.Default()
    names = sorted(pb.DESCRIPTOR.message_types_by_name)
    assert names == sorted(jpb.DESCRIPTOR.message_types_by_name)
    assert sorted(pb.DESCRIPTOR.services_by_name) == ["DevicePlugin", "Registration"]
    port, ref = _populated(pb), _populated(jpb)
    for name in names:
        mine = port.get(name, getattr(pb, name)())
        theirs = ref.get(name, getattr(jpb, name)())
        assert getattr(jpb, name).FromString(mine.SerializeToString()) == theirs, name
        assert getattr(pb, name).FromString(theirs.SerializeToString()) == mine, name
