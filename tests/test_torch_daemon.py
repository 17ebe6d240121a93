"""The port's node agent as the DaemonSet runs it: ``python -m
gpushare_device_plugin_tpu_torch.cli.daemon --standalone --discovery mock
--health-check --metrics-port N`` as a subprocess, against the reference's
``tests/fake_kubelet.FakeKubelet`` on a tmp plugin dir.

It checks ``/readyz`` (503 before registration, 200 after), that both
resources register and an Allocate succeeds with the reference's env,
that SIGHUP re-registers, that SIGQUIT writes a stack dump and SIGUSR1 a
flight record, that SIGTERM during a slow in-flight Allocate drains it and
exits 0, that the process never imports torch or the JAX package (``-X
importtime`` lists every module it imports), and that without
``--standalone`` it exits nonzero. Every wait and RPC has a timeout, and
every daemon is killed in a ``finally``.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import grpc

from gpushare_device_plugin_tpu.allocator.local import LocalAllocator as JLocal
from gpushare_device_plugin_tpu.device import DeviceInventory as JInventory
from gpushare_device_plugin_tpu.discovery import MockBackend as JMock
from gpushare_device_plugin_tpu_torch import const

from fake_kubelet import FakeKubelet

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 15.0
GIB = 1 << 30
FORBIDDEN = ("torch", "jax", "jaxlib", "gpushare_device_plugin_tpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_until(pred, timeout=TIMEOUT, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Daemon:
    """The daemon subprocess on a mock 2 x 4 GiB host; its stderr (logs
    and ``-X importtime``'s lines) goes to a file."""

    def __init__(self, tmp: Path, *args: str, faults: str = "", standalone: bool = True):
        self.plugin_dir = tmp / "plugins"
        self.dump_dir = tmp / "dumps"
        self.dump_dir.mkdir()
        self.port = _free_port()
        self.log_path = tmp / "daemon.log"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(TPUSHARE_MOCK_CHIPS="2", TPUSHARE_MOCK_HBM_GIB="4", TPUSHARE_FAULTS=faults)
        cmd = [sys.executable, "-X", "importtime", "-m",
               "gpushare_device_plugin_tpu_torch.cli.daemon",
               "--discovery", "mock", "--health-check", "--metrics-port", str(self.port),
               "--plugin-dir", str(self.plugin_dir), "--coredump-dir", str(self.dump_dir),
               "--node-name", "node-a", *args]
        if standalone:
            cmd.insert(5, "--standalone")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=self._log,
                                     stderr=subprocess.STDOUT)

    def readyz(self):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/readyz", timeout=2) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except OSError:
            return None  # not listening yet

    def log(self) -> str:
        return self.log_path.read_text()

    def imported(self) -> list[str]:
        """Every module the process imported, from ``-X importtime``."""
        return [line.rsplit("|", 1)[1].strip() for line in self.log().splitlines()
                if line.startswith("import time:") and "|" in line]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(TIMEOUT)
        self._log.close()


def _registrations(kubelet, n=2):
    return {r.resource_name: r for r in
            (kubelet.wait_for_registration(timeout=TIMEOUT) for _ in range(n))}


def _drain_registrations(kubelet, quiet=1.5):
    """Registrations until none comes for ``quiet`` seconds."""
    got = []
    while True:
        try:
            got.append(kubelet.wait_for_registration(timeout=quiet).resource_name)
        except Exception:  # queue.Empty
            return got


def test_readiness_registration_allocate_and_no_torch_or_jax(tmp_path):
    daemon = Daemon(tmp_path)
    kubelet = None
    try:
        # no kubelet yet: the plugins serve but cannot register
        assert wait_until(lambda: daemon.readyz() is not None), daemon.log()
        assert daemon.readyz() == 503
        kubelet = FakeKubelet(str(daemon.plugin_dir))
        kubelet.start()
        regs = _registrations(kubelet)
        assert set(regs) == {const.RESOURCE_MEM, const.RESOURCE_CORE}
        assert regs[const.RESOURCE_MEM].endpoint == const.MEM_SOCKET_NAME
        # the watcher then sees kubelet.sock appear and registers again
        # (the reference's rule: a change during a rebuild still fires)
        assert set(_drain_registrations(kubelet)) <= set(regs)
        assert wait_until(lambda: daemon.readyz() == 200)
        kubelet.begin_watch(const.RESOURCE_MEM, regs[const.RESOURCE_MEM].endpoint)
        devs = kubelet.wait_for_devices(const.RESOURCE_MEM, TIMEOUT)
        assert len(devs) == 8 and all(d.health == "Healthy" for d in devs)
        resp = kubelet.allocate(regs[const.RESOURCE_MEM].endpoint, [[d.ID for d in devs[:3]]])
        envs = dict(resp.container_responses[0].envs)
        # the reference's allocator on the same host grants the same env
        ref = JLocal(JInventory(JMock(num_chips=2, hbm_bytes=4 * GIB).chips()))
        assert envs == ref.allocate([3])[0].envs
        assert envs[const.ENV_TPU_VISIBLE_CHIPS] == "0" and envs[const.ENV_MEM_POD] == "3"
        resp = kubelet.allocate(regs[const.RESOURCE_CORE].endpoint, [["tpu-v4-host0-chip1"]])
        assert resp.container_responses[0].envs[const.ENV_TPU_VISIBLE_CHIPS] == "1"
        bad = sorted({m for m in daemon.imported() if m.split(".")[0] in FORBIDDEN})
        assert daemon.imported() and not bad, bad
        assert "gpushare_device_plugin_tpu_torch.manager.lifecycle" in daemon.imported()
        assert "grpc" in {m.split(".")[0] for m in daemon.imported()}
    finally:
        daemon.close()
        if kubelet is not None:
            kubelet.stop()


def test_sighup_reregisters_and_sigquit_sigusr1_write_their_files(tmp_path):
    kubelet = FakeKubelet(str(tmp_path / "plugins"))
    kubelet.start()
    daemon = Daemon(tmp_path)
    try:
        first = _registrations(kubelet)
        assert wait_until(lambda: daemon.readyz() == 200), daemon.log()
        daemon.proc.send_signal(signal.SIGHUP)
        assert set(_registrations(kubelet)) == set(first)
        assert wait_until(lambda: daemon.readyz() == 200)
        daemon.proc.send_signal(signal.SIGQUIT)
        assert wait_until(lambda: glob.glob(str(daemon.dump_dir / "tpushare_*.txt")))
        daemon.proc.send_signal(signal.SIGUSR1)
        assert wait_until(lambda: glob.glob(str(daemon.dump_dir / "tpushare-flightrec-*.json")))
        (stack,) = glob.glob(str(daemon.dump_dir / "tpushare_*.txt"))
        assert "--- thread MainThread" in Path(stack).read_text()
        (record,) = glob.glob(str(daemon.dump_dir / "tpushare-flightrec-*-SIGUSR1.json"))
        doc = json.loads(Path(record).read_text())
        assert doc["reason"] == "SIGUSR1" and doc["pid"] == daemon.proc.pid
        assert {"traces", "logs", "timeline"} <= set(doc)
        assert any("restart requested (SIGHUP)" in e["message"] for e in doc["logs"])
        assert daemon.proc.poll() is None  # the signals did not stop it
    finally:
        daemon.close()
        kubelet.stop()


def test_sigterm_drains_a_slow_inflight_allocate_and_exits_zero(tmp_path):
    kubelet = FakeKubelet(str(tmp_path / "plugins"))
    kubelet.start()
    daemon = Daemon(tmp_path, faults="plugin.allocate=latency:1.5")
    try:
        regs = _registrations(kubelet)
        assert wait_until(lambda: daemon.readyz() == 200), daemon.log()
        mem = regs[const.RESOURCE_MEM].endpoint
        kubelet.stub_for(mem)
        out = {}

        def call():
            try:
                out["resp"] = kubelet.allocate(mem, [["g0", "g1"]])
            except grpc.RpcError as e:
                out["err"] = e

        caller = threading.Thread(target=call, daemon=True)
        caller.start()
        # the channel is dialled, so the call reaches the daemon within
        # milliseconds; the injected latency then holds it 1.5 s
        time.sleep(0.3)
        daemon.proc.send_signal(signal.SIGTERM)
        caller.join(TIMEOUT)
        assert daemon.proc.wait(TIMEOUT) == 0, daemon.log()
        assert "resp" in out, f"in-flight Allocate failed: {out.get('err')}"
        assert out["resp"].container_responses[0].envs[const.ENV_MEM_POD] == "2"
        assert "stop requested (SIGTERM)" in daemon.log()
        assert not (tmp_path / "plugins" / const.MEM_SOCKET_NAME).exists()
    finally:
        daemon.close()
        kubelet.stop()


def test_without_standalone_it_exits_nonzero(tmp_path):
    daemon = Daemon(tmp_path, standalone=False)
    try:
        assert daemon.proc.wait(TIMEOUT) != 0
        assert "cluster mode is not ported yet" in daemon.log()
        assert not daemon.plugin_dir.exists()
    finally:
        daemon.close()
