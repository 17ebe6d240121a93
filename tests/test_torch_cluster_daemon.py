"""The port's daemon in cluster mode, as a subprocess, through a crash.

``python -m gpushare_device_plugin_tpu_torch.cli.daemon --discovery mock
--node-name N`` (no ``--standalone``) against an in-process
``tests/fake_apiserver.FakeApiServer`` (reached through a JSON kubeconfig)
and the reference's ``tests/fake_kubelet.FakeKubelet``. The first daemon
runs with ``TPUSHARE_FAULTS=allocator.post_persist=crash:1`` and
``--reconcile-interval 0``: its one Allocate dies after the pod's
annotations landed, leaving an unresolved begin in the WAL, and it is
SIGKILLed. A second daemon on the same plugin dir and WAL re-registers,
replays exactly that entry, raises the node's fence generation by one,
lets its reconciler commit the entry, reclaims the units of a deleted
pod, admits a fresh one, and exits 0 on SIGTERM. Neither daemon imports
torch, the JAX package, requests, urllib3 or yaml (``-X importtime``).
Every wait has a timeout, and every process is killed in a ``finally``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import grpc

from gpushare_device_plugin_tpu.plugin.api import pb
from gpushare_device_plugin_tpu_torch import const

from fake_apiserver import FakeApiServer
from fake_kubelet import FakeKubelet
from k8s_fixtures import make_pod

ROOT = Path(__file__).resolve().parents[1]
NODE = "verify-node"
TIMEOUT = 15.0
FORBIDDEN = ("torch", "jax", "jaxlib", "gpushare_device_plugin_tpu",
             "requests", "urllib3", "yaml")
FENCE = "tpushare.aliyun.com/fence-generation"


def wait_until(pred, timeout=TIMEOUT, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def wal_pending(path: Path) -> set:
    """Keys begun and not yet committed or aborted, read from the file."""
    pending: set = set()
    if not path.exists():
        return pending
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # a torn tail
        key = tuple(rec.get("key") or ())
        if rec.get("op") == "begin":
            pending.add(key)
        elif rec.get("op") in ("commit", "abort"):
            pending.discard(key)
    return pending


class Daemon:
    def __init__(self, tmp: Path, name: str, kubeconfig: Path, *args: str, faults: str = ""):
        self.log_path = tmp / f"{name}.log"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(KUBECONFIG=str(kubeconfig), HOME=str(tmp), TPUSHARE_MOCK_CHIPS="1",
                   TPUSHARE_MOCK_HBM_GIB="8", TPUSHARE_FAULTS=faults)
        cmd = [sys.executable, "-X", "importtime", "-m",
               "gpushare_device_plugin_tpu_torch.cli.daemon", "--discovery", "mock",
               "--node-name", NODE, "--plugin-dir", str(tmp / "plugins"),
               "--coredump-dir", str(tmp), "-v", "1", *args]
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=self._log,
                                     stderr=subprocess.STDOUT)

    def log(self) -> str:
        return self.log_path.read_text()

    def imported(self) -> set:
        return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in self.log().splitlines()
                if line.startswith("import time:") and "|" in line}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(TIMEOUT)
        self._log.close()


def _mem_ids(kubelet, endpoint, n):
    kubelet.begin_watch(const.RESOURCE_MEM, endpoint)
    return [d.ID for d in kubelet.wait_for_devices(const.RESOURCE_MEM, TIMEOUT)[:n]]


def _registrations(kubelet) -> dict:
    return {r.resource_name: r for r in
            (kubelet.wait_for_registration(timeout=TIMEOUT) for _ in range(2))}


def test_cluster_daemon_crash_replay_reclaim_and_drain(tmp_path):
    api = FakeApiServer()
    api.add_node(NODE)
    api.start()
    kubeconfig = tmp_path / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api.url}}],
        "users": [{"name": "fake", "user": {}}],
    }))
    plugin_dir = tmp_path / "plugins"
    plugin_dir.mkdir()
    wal = plugin_dir / "tpushare-allocations.ckpt"
    kubelet = FakeKubelet(str(plugin_dir))
    kubelet.start()
    daemons = []
    try:
        # --- daemon 1 dies inside its first admission ---------------------
        d1 = Daemon(tmp_path, "d1", kubeconfig, "--reconcile-interval", "0",
                    faults="allocator.post_persist=crash:1")
        daemons.append(d1)
        regs = _registrations(kubelet)
        assert set(regs) == {const.RESOURCE_MEM, const.RESOURCE_CORE}, d1.log()
        assert int(api.nodes[NODE]["status"]["capacity"][const.RESOURCE_COUNT]) == 1
        gen1 = int(api.nodes[NODE]["metadata"]["annotations"][FENCE].partition(":")[0])
        api.add_pod(make_pod("victim", 6, node=NODE))
        ids = _mem_ids(kubelet, regs[const.RESOURCE_MEM].endpoint, 8)
        try:  # the crashed admission never answers: a short deadline
            kubelet.stub_for(regs[const.RESOURCE_MEM].endpoint).Allocate(
                pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=ids[:6])]), timeout=2)
            raise AssertionError("the crash site did not fire")
        except grpc.RpcError:  # the RPC died with the admission
            pass
        ann = api.pods[("default", "victim")]["metadata"]["annotations"]
        assert ann[const.ENV_ASSIGNED_FLAG] == "true"  # the PATCH landed
        assert wal_pending(wal) == {("default", "victim")}  # begin unresolved
        d1.proc.send_signal(signal.SIGKILL)
        d1.proc.wait(TIMEOUT)

        # --- daemon 2 replays, reconciles, reclaims, admits, drains -------
        d2 = Daemon(tmp_path, "d2", kubeconfig, "--reconcile-interval", "0.5")
        daemons.append(d2)
        regs = _registrations(kubelet)
        assert set(regs) == {const.RESOURCE_MEM, const.RESOURCE_CORE}, d2.log()
        assert wait_until(lambda: "device-state replay: 1 in-flight" in d2.log()), d2.log()
        gen2 = int(api.nodes[NODE]["metadata"]["annotations"][FENCE].partition(":")[0])
        assert gen2 == gen1 + 1
        assert wait_until(lambda: wal_pending(wal) == set()), d2.log()
        # the victim's controller recreates it elsewhere: deleting it frees
        # its 6 units, so a pod of the whole card fits
        api.delete_pod("default", "victim")
        api.add_pod(make_pod("fresh", 8, node=NODE))
        ids = _mem_ids(kubelet, regs[const.RESOURCE_MEM].endpoint, 8)
        deadline = time.monotonic() + TIMEOUT
        while True:  # the informer may not have seen the delete yet
            try:
                resp = kubelet.allocate(regs[const.RESOURCE_MEM].endpoint, [ids])
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        envs = dict(resp.container_responses[0].envs)
        assert envs[const.ENV_MEM_POD] == "8" and envs[const.ENV_MEM_IDX] == "0"
        fresh = api.pods[("default", "fresh")]["metadata"]["annotations"]
        assert fresh[const.ENV_ASSIGNED_FLAG] == "true"
        d2.proc.send_signal(signal.SIGTERM)
        assert d2.proc.wait(TIMEOUT) == 0, d2.log()
        assert wal_pending(wal) == set()
        for d in daemons:
            assert not d.imported() & set(FORBIDDEN), d.imported() & set(FORBIDDEN)
    finally:
        for d in daemons:
            d.close()
        kubelet.stop()
        api.stop()
