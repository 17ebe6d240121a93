"""The port's node agent in standalone mode (gpushare_device_plugin_tpu_torch:
``manager/lifecycle.py``) against the reference's ``TpuShareManager``.

Each case runs both packages' managers on the same ``MockBackend`` shape,
each in its own plugin dir against its own ``tests/fake_kubelet.FakeKubelet``
(the reference's, so the kubelet side of every wire speaks the reference's
messages), with ``run`` in a thread as the reference's tests do. The two
must show the same registrations, ListAndWatch device lists (mem and
core), ``GetPreferredAllocation`` ranking, Allocate responses (envs,
annotations, device mounts) for the same grants, health flips, core-hold
refusals, re-registration after a kubelet restart and after a vanished
plugin socket, the drain of an in-flight Allocate, and parking on zero
cards. The reference's cases: tests/test_manager.py (:28, :127, :203,
:257), tests/test_chaos.py:285-310, tests/test_restart_recovery.py:348
and :384 (there in cluster mode or on the plugin alone; here standalone,
through the manager). Every wait and RPC has a timeout.
"""

from __future__ import annotations

import json
import os
import threading
import time

import grpc
import pytest

from gpushare_device_plugin_tpu.discovery import MockBackend as JMock
from gpushare_device_plugin_tpu.manager import ManagerConfig as JConfig
from gpushare_device_plugin_tpu.manager import TpuShareManager as JManager
from gpushare_device_plugin_tpu.plugin.api import pb as jpb
from gpushare_device_plugin_tpu.utils.faults import FAULTS as JFAULTS
from gpushare_device_plugin_tpu.utils.metrics import REGISTRY as JREGISTRY
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.discovery import MockBackend
from gpushare_device_plugin_tpu_torch.manager import ManagerConfig, TpuShareManager
from gpushare_device_plugin_tpu_torch.utils.faults import FAULTS
from gpushare_device_plugin_tpu_torch.utils.metrics import REGISTRY

from fake_kubelet import FakeKubelet

GIB = 1 << 30
TIMEOUT = 10.0
RESTARTS = "tpushare_health_watcher_restarts_total"
PORT = dict(name="port", manager=TpuShareManager, config=ManagerConfig, mock=MockBackend,
            faults=FAULTS, registry=REGISTRY)
REF = dict(name="ref", manager=JManager, config=JConfig, mock=JMock, faults=JFAULTS,
           registry=JREGISTRY)
BOTH = (PORT, REF)


def wait_until(pred, timeout=TIMEOUT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Node:
    """One package's standalone manager on a mock host, running in a
    thread, with its own plugin dir and FakeKubelet."""

    def __init__(self, pkg, root, *, chips=4, hbm_gib=32, health=False, kubelet=True, **cfg):
        self.pkg = pkg
        self.dir = str(root / pkg["name"])
        os.makedirs(self.dir, exist_ok=True)
        self.health_file = os.path.join(self.dir, "health.json") if health else None
        self.kubelet = None
        if kubelet:
            self.kubelet = FakeKubelet(os.path.join(self.dir, "plugins"))
            self.kubelet.start()
        self.backend = pkg["mock"](num_chips=chips, hbm_bytes=hbm_gib * GIB,
                                   health_file=self.health_file, poll_interval_s=0.02)
        self.manager = pkg["manager"](self.backend, pkg["config"](
            plugin_dir=os.path.join(self.dir, "plugins"), standalone=True,
            health_check=health, **cfg))
        self.thread = threading.Thread(target=self.manager.run, daemon=True,
                                       name=f"manager-{pkg['name']}")
        self.thread.start()
        self.regs = {}

    @property
    def chip_ids(self):
        return [c.id for c in self.backend.chips()]

    def register(self, n=2, kubelet=None):
        """The next ``n`` registrations, by resource name."""
        kubelet = kubelet or self.kubelet
        regs = {}
        for _ in range(n):
            reg = kubelet.wait_for_registration(timeout=TIMEOUT)
            regs[reg.resource_name] = reg
        self.regs = regs
        return regs

    def watch(self, resource):
        self.kubelet.begin_watch(resource, self.regs[resource].endpoint)
        return self.devices(resource)

    def devices(self, resource):
        return [(d.ID, d.health) for d in self.kubelet.wait_for_devices(resource, TIMEOUT)]

    def allocate(self, resource, granted):
        return self.kubelet.allocate(self.regs[resource].endpoint, granted)

    def refusal(self, resource, granted):
        with pytest.raises(grpc.RpcError) as err:
            self.allocate(resource, granted)
        return err.value.code(), err.value.details()

    def preferred(self, resource, available, size):
        stub = self.kubelet.stub_for(self.regs[resource].endpoint)
        req = jpb.PreferredAllocationRequest(container_requests=[
            jpb.ContainerPreferredAllocationRequest(available_deviceIDs=available,
                                                    allocation_size=size)])
        resp = stub.GetPreferredAllocation(req, timeout=TIMEOUT)
        return list(resp.container_responses[0].deviceIDs)

    def set_health(self, states):
        with open(self.health_file, "w") as f:
            json.dump(states, f)

    def close(self):
        self.manager.trigger_stop("test")
        self.thread.join(TIMEOUT)
        if self.kubelet is not None:
            self.kubelet.stop()
        assert not self.thread.is_alive(), f"{self.pkg['name']} manager did not stop"


@pytest.fixture
def nodes(tmp_path):
    made = []

    def make(**kw):
        pair = [Node(pkg, tmp_path, **kw) for pkg in BOTH]
        made.extend(pair)
        return pair

    yield make
    for node in made:
        node.close()


def _registration(reg):
    return (reg.resource_name, reg.endpoint, reg.version, reg.options.SerializeToString())


def _response_doc(resp):
    return [{"envs": dict(c.envs), "annotations": dict(c.annotations),
             "devices": [(d.container_path, d.host_path, d.permissions) for d in c.devices],
             "mounts": len(c.mounts)} for c in resp.container_responses]


def _same(port_value, ref_value):
    assert port_value == ref_value
    return port_value


# ---------------------------------------------------------------------------


def test_parks_without_chips(tmp_path):
    """tests/test_manager.py:28: no cards -> park (alive, ready, serving
    nothing) instead of crash-looping; a stop returns."""
    seen = []
    for pkg in BOTH:
        node = Node(pkg, tmp_path, chips=0, kubelet=False)
        try:
            assert wait_until(lambda: node.manager.ready(), timeout=5)
            time.sleep(0.2)
            assert node.thread.is_alive()  # parked, not crashed
            seen.append((node.manager.ready(), os.listdir(node.dir)))
        finally:
            node.close()
    _same(*seen)
    assert seen[0] == (True, [])  # no plugin dir, no socket


def test_serves_both_resources_lists_ranks_and_allocates(nodes):
    """The standalone counterpart of tests/test_manager.py:69: both
    resources register, the fan-out and the core list stream, the core
    plugin ranks cards away from fractional usage, and Allocate's env is
    the reference's for the same grants."""
    port, ref = nodes()
    regs = _same(*[{k: _registration(r) for k, r in n.register().items()} for n in (port, ref)])
    assert set(regs) == {const.RESOURCE_MEM, const.RESOURCE_CORE}
    assert regs[const.RESOURCE_CORE][1] == const.CORE_SOCKET_NAME
    assert wait_until(lambda: all(n.manager.ready() for n in (port, ref)))
    mem = _same(*[n.watch(const.RESOURCE_MEM) for n in (port, ref)])
    core = _same(*[n.watch(const.RESOURCE_CORE) for n in (port, ref)])
    assert len(mem) == 128 and [d for d, _ in core] == port.chip_ids
    ids = [d for d, _ in mem]
    for granted in ([ids[:4]], [ids[4:6], ids[6:9]], [ids[9:40]]):
        _same(*[_response_doc(n.allocate(const.RESOURCE_MEM, granted)) for n in (port, ref)])
    # chips 0 (9 units) and 1 (31) are in use: the ranking puts the free
    # chips first, then the less used
    for available, size in ((port.chip_ids, 2), (port.chip_ids, 4), (port.chip_ids[:2], 1)):
        _same(*[n.preferred(const.RESOURCE_CORE, available, size) for n in (port, ref)])
    assert port.preferred(const.RESOURCE_CORE, port.chip_ids, 4) == [
        port.chip_ids[i] for i in (2, 3, 0, 1)]
    # the mem plugin takes the first N
    _same(*[n.preferred(const.RESOURCE_MEM, ids[5:12], 3) for n in (port, ref)])
    doc = _same(*[_response_doc(n.allocate(const.RESOURCE_CORE, [[n.chip_ids[2]]]))
                  for n in (port, ref)])
    assert doc[0]["envs"][const.ENV_TPU_VISIBLE_CHIPS] == "2"
    assert doc[0]["devices"] == [("/dev/accel2", "/dev/accel2", "rw")]
    # a held chip ranks last; a second hold of it is refused alike
    _same(*[n.preferred(const.RESOURCE_CORE, n.chip_ids, 4) for n in (port, ref)])
    code, details = _same(*[n.refusal(const.RESOURCE_CORE, [[n.chip_ids[2]]])
                            for n in (port, ref)])
    assert code == grpc.StatusCode.INVALID_ARGUMENT and "already exclusively held" in details


def test_health_file_drives_listandwatch(nodes):
    """tests/test_manager.py:127: a health flip re-streams the chip's
    units Unhealthy, then the recovery."""
    port, ref = nodes(chips=2, hbm_gib=4, health=True, serve_core_resource=False)
    _same(*[{k: _registration(r) for k, r in n.register(1).items()} for n in (port, ref)])
    devs = _same(*[n.watch(const.RESOURCE_MEM) for n in (port, ref)])
    assert all(h == "Healthy" for _, h in devs)
    for n in (port, ref):
        n.set_health({n.chip_ids[0]: "Unhealthy"})
    sick = _same(*[n.devices(const.RESOURCE_MEM) for n in (port, ref)])
    assert sum(h == "Unhealthy" for _, h in sick) == 4
    for n in (port, ref):
        n.set_health({})
    assert _same(*[n.devices(const.RESOURCE_MEM) for n in (port, ref)]) == devs


def test_standalone_health_excludes_chip_from_binpack(nodes):
    """tests/test_manager.py:203: the health watcher feeds the standalone
    allocator, so mem binpack routes around a sick chip and a core grant
    of it fails admission; the healthy chip cannot be held either, since
    it now has fractional usage."""
    port, ref = nodes(chips=2, hbm_gib=4, health=True)
    for n in (port, ref):
        n.register()
    _same(*[n.watch(const.RESOURCE_MEM) for n in (port, ref)])
    for n in (port, ref):
        n.set_health({n.chip_ids[0]: "Unhealthy"})
    sick = _same(*[n.devices(const.RESOURCE_MEM) for n in (port, ref)])
    assert sum(h == "Unhealthy" for _, h in sick) == 4
    # the plugin saw the flip; the allocator's sink runs after it
    assert wait_until(lambda: all(0 in n.manager._local._unhealthy for n in (port, ref)))
    doc = _same(*[_response_doc(n.allocate(const.RESOURCE_MEM, [["g0"]])) for n in (port, ref)])
    assert doc[0]["envs"][const.ENV_TPU_VISIBLE_CHIPS] == "1"
    refusals = _same(*[[n.refusal(const.RESOURCE_CORE, [[c]]) for c in n.chip_ids]
                       for n in (port, ref)])
    assert [code for code, _ in refusals] == [grpc.StatusCode.INVALID_ARGUMENT] * 2
    assert "unhealthy" in refusals[0][1] and "fractional units in use" in refusals[1][1]


def test_standalone_core_hold_blocks_mem_binpack(nodes):
    """tests/test_manager.py:257: a core hold of chip 0 sends the next mem
    pod to chip 1; a pod that holds both chips at once is refused whole,
    leaking no hold."""
    port, ref = nodes(chips=2, hbm_gib=4)
    for n in (port, ref):
        n.register()
    doc = _same(*[_response_doc(n.allocate(const.RESOURCE_CORE, [[n.chip_ids[0]]]))
                  for n in (port, ref)])
    assert doc[0]["envs"][const.ENV_TPU_VISIBLE_CHIPS] == "0"
    doc = _same(*[_response_doc(n.allocate(const.RESOURCE_MEM, [["g0"]])) for n in (port, ref)])
    assert doc[0]["envs"][const.ENV_TPU_VISIBLE_CHIPS] == "1"
    # chip 0 held, chip 1 fractional: the two-container pod is refused
    # atomically, and chip 0's hold is still the only one
    _same(*[n.refusal(const.RESOURCE_CORE, [[n.chip_ids[0]], [n.chip_ids[1]]])
            for n in (port, ref)])
    assert _same(*[n.manager._local.core_held() for n in (port, ref)]) == {0}
    # 3 units left on chip 1 only: a 3-unit pod fits, then nothing does
    _same(*[_response_doc(n.allocate(const.RESOURCE_MEM, [["a", "b", "c"]]))
            for n in (port, ref)])
    code, details = _same(*[n.refusal(const.RESOURCE_MEM, [["z", "y"]]) for n in (port, ref)])
    assert code == grpc.StatusCode.INVALID_ARGUMENT and "no chip can fit 2 units" in details


def test_health_watcher_survives_backend_crashes(nodes):
    """tests/test_chaos.py:285-310: the health stream killed twice is
    revived by the supervisor (counted), and transitions still flow."""
    FAULTS.clear()
    JFAULTS.clear()
    before = [pkg["registry"].counter_value(RESTARTS) for pkg in BOTH]
    port, ref = nodes(chips=2, hbm_gib=4, health=True, serve_core_resource=False)
    try:
        for n in (port, ref):
            n.register(1)
        _same(*[n.watch(const.RESOURCE_MEM) for n in (port, ref)])
        assert wait_until(lambda: all(n.manager._health is not None for n in (port, ref)))
        for pkg in BOTH:
            pkg["faults"].inject("discovery.watch_health", mode="error", times=2)
        assert wait_until(lambda: all(n.manager._health.restarts >= 2 for n in (port, ref)))
        for pkg, was in zip(BOTH, before):
            assert pkg["registry"].counter_value(RESTARTS) >= was + 2
        assert wait_until(lambda: all(n.manager._health.alive for n in (port, ref)))
        assert _same(*[n.manager._health.restarts for n in (port, ref)]) == 2
        for n in (port, ref):
            n.set_health({n.chip_ids[0]: "Unhealthy"})
        sick = _same(*[n.devices(const.RESOURCE_MEM) for n in (port, ref)])
        assert sum(h == "Unhealthy" for _, h in sick) == 4
    finally:
        FAULTS.clear()
        JFAULTS.clear()


def test_kubelet_restart_triggers_reregistration(nodes):
    """The standalone counterpart of tests/test_manager.py:102: a new
    kubelet (its socket recreated) gets both plugins registered again."""
    port, ref = nodes(chips=2, hbm_gib=4)
    _same(*[{k: _registration(r) for k, r in n.register().items()} for n in (port, ref)])
    seen = []
    for n in (port, ref):
        n.kubelet.stop()
        n.kubelet = FakeKubelet(n.kubelet.plugin_dir)
        n.kubelet.start()
        seen.append({k: _registration(r) for k, r in n.register().items()})
    assert set(_same(*seen)) == {const.RESOURCE_MEM, const.RESOURCE_CORE}
    assert wait_until(lambda: all(n.manager.ready() for n in (port, ref)))
    _same(*[_response_doc(n.allocate(const.RESOURCE_MEM, [["g0", "g1"]])) for n in (port, ref)])


def test_plugin_socket_vanish_triggers_reregistration(nodes):
    """tests/test_restart_recovery.py:348, standalone: kubelet wiping a
    plugin socket without touching kubelet.sock silently unregisters the
    plugin; the plugin-dir watcher notices and rebuilds both plugins."""
    port, ref = nodes(chips=2, hbm_gib=4)
    for n in (port, ref):
        n.register()
    seen = []
    for n in (port, ref):
        os.unlink(os.path.join(n.dir, "plugins", const.MEM_SOCKET_NAME))
        seen.append({k: _registration(r) for k, r in n.register().items()})
        assert os.path.exists(os.path.join(n.dir, "plugins", const.MEM_SOCKET_NAME))
    assert set(_same(*seen)) == {const.RESOURCE_MEM, const.RESOURCE_CORE}


def test_stop_drains_an_inflight_allocate(nodes):
    """tests/test_restart_recovery.py:384, through the manager: on stop,
    every plugin is quiesced, then drained against one deadline. The slow
    in-flight Allocate completes; a new one during the drain is refused
    UNAVAILABLE; then the sockets close."""
    FAULTS.clear()
    JFAULTS.clear()
    port, ref = nodes(chips=2, hbm_gib=4, drain_timeout_s=TIMEOUT)
    try:
        for n in (port, ref):
            n.register()
        results = []
        for n in (port, ref):
            n.pkg["faults"].inject("plugin.allocate", "latency", latency_s=1.5)
            n.kubelet.stub_for(n.regs[const.RESOURCE_CORE].endpoint)  # dialled before the drain
            mem = n.manager._plugins[0]
            out = {}

            def call(n=n, out=out):
                try:
                    out["resp"] = n.allocate(const.RESOURCE_MEM, [["g0", "g1"]])
                except grpc.RpcError as e:
                    out["err"] = e

            caller = threading.Thread(target=call, daemon=True)
            caller.start()
            assert wait_until(lambda: mem._inflight_allocates == 1)
            n.manager.trigger_stop("test")
            assert wait_until(lambda: all(p._stopping for p in n.manager._plugins[:2]))
            late = n.refusal(const.RESOURCE_CORE, [[n.chip_ids[1]]])
            caller.join(TIMEOUT)
            n.thread.join(TIMEOUT)
            assert not n.thread.is_alive()
            assert "resp" in out, f"in-flight Allocate failed: {out.get('err')}"
            sockets = sorted(os.listdir(os.path.join(n.dir, "plugins")))
            results.append((_response_doc(out["resp"]), late[0], sockets))
            n.pkg["faults"].clear()
        doc, code, sockets = _same(*results)
        assert doc[0]["envs"][const.ENV_MEM_POD] == "2"
        assert code == grpc.StatusCode.UNAVAILABLE
        assert sockets == ["kubelet.sock"]
    finally:
        FAULTS.clear()
        JFAULTS.clear()


def test_cluster_mode_raises_not_implemented(tmp_path):
    """An apiserver client makes the manager build the cluster allocators
    (the mem plugin's ClusterAllocator and the core plugin's
    ClusterCoreAllocator over one shared ledger, journaling to the WAL).
    Defrag's move hooks register and dispatch; a drained snapshot with no
    restore hook raises (so the move is retried, never dropped). A
    standalone config ignores the client."""
    from gpushare_device_plugin_tpu_torch.allocator.cluster import (
        ClusterAllocator,
        ClusterCoreAllocator,
    )
    from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
    from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource

    from fake_apiserver import FakeApiServer

    api = FakeApiServer()
    api.add_node("node-a")
    api.start()
    try:
        client = ApiServerClient(api.url)
        cfg = ManagerConfig(plugin_dir=str(tmp_path), node_name="node-a",
                            checkpoint_path=str(tmp_path / "wal.ckpt"))
        manager = TpuShareManager(MockBackend(num_chips=2), cfg, api_client=client,
                                  pod_source=ApiServerPodSource(client, "node-a"))
        inv = manager._build_inventory()
        mem_fn = manager._build_allocator(inv, unhealthy_fn=set)
        core_fn = manager._build_core_allocate_fn(inv, unhealthy_fn=set)
        assert isinstance(mem_fn.__self__, ClusterAllocator)
        assert isinstance(core_fn.__self__, ClusterCoreAllocator)
        assert mem_fn.__self__._assume is core_fn.__self__._assume is manager._alloc_assume
        assert mem_fn.__self__._ckpt is core_fn.__self__._ckpt is manager._ckpt is not None
        with pytest.raises(RuntimeError, match="no restore hook"):
            manager._move_restore_dispatch(("default", "p"), {"requests": []})
        manager._move_restore_dispatch(("default", "p"), None)  # nothing drained
        assert manager._move_drain_dispatch(("default", "p")) is None
        restored = []
        manager.set_move_hooks(lambda key: {"drained": key},
                               lambda key, snap: restored.append((key, snap)))
        assert manager._move_drain_dispatch(("default", "p")) == {"drained": ("default", "p")}
        manager._move_restore_dispatch(("default", "p"), {"requests": []})
        assert restored == [(("default", "p"), {"requests": []})]
        manager._ckpt.close()
        manager._patch_pipeline.stop()
        standalone = TpuShareManager(
            MockBackend(num_chips=1),
            ManagerConfig(plugin_dir=str(tmp_path), standalone=True,
                          checkpoint_path=str(tmp_path / "unused.ckpt")),
            api_client=client,
        )
        assert standalone._ckpt is None and standalone._patch_pipeline is None
    finally:
        api.stop()
    manager = standalone
    assert not manager.ready()  # nothing served yet
