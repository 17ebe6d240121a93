"""The port's ``manager/health.py::HealthWatcher`` against the reference's:
one scripted event stream, with a crash and an early end of the backend's
stream between its parts, through both packages' watchers gives the same
sink calls, the same ``unhealthy_ids`` after each, the same events on the
``on_event`` hook, the same restarts and the same metric deltas.

Then the port's watcher over ``NvmlBackend`` on a fake NVML that stops
answering: the whole-host fault reaches the sinks for every card, with no
restart of the watch loop, and so does the recovery."""

from __future__ import annotations

import threading
import time

from gpushare_device_plugin_tpu.discovery import base as JBase
from gpushare_device_plugin_tpu.manager.health import HealthWatcher as JWatcher
from gpushare_device_plugin_tpu.utils import metric_catalog as JCat
from gpushare_device_plugin_tpu.utils.metrics import REGISTRY as JREGISTRY
from gpushare_device_plugin_tpu_torch.discovery import base as Base
from gpushare_device_plugin_tpu_torch.discovery.nvmldev import NvmlBackend
from gpushare_device_plugin_tpu_torch.manager import HealthWatcher
from gpushare_device_plugin_tpu_torch.native.nvml import NvmlDevice, NvmlError
from gpushare_device_plugin_tpu_torch.utils import metric_catalog as Cat
from gpushare_device_plugin_tpu_torch.utils.metrics import REGISTRY

CHIPS = ("GPU-0", "GPU-1", "GPU-2")
CRASH = "crash"
# Three runs of the backend's stream: the first crashes, the second ends
# on its own (the supervisor treats both as a dead loop), the third holds
# until the watcher stops. (chip, health, reason, severity)
RUNS = [
    [("GPU-0", "Unhealthy", "uncorrectable-errors+1", "hard"),
     ("GPU-1", "Healthy", "correctable-errors+2", "app"),
     (None, "Unhealthy", "nvml-runtime", "hard"),
     CRASH],
    [(None, "Healthy", "nvml-runtime", "hard"),
     ("GPU-1", "Unhealthy", "device-file-gone(2 polls)", "hard"),
     ("GPU-2", "Healthy", "device-file-blip(1 polls)", "transient")],
    [("GPU-1", "Healthy", "device-file-restored", "hard"),
     ("GPU-0", "Unhealthy", "uncorrectable-errors+3", "hard")],
]
HARD = sum(1 for run in RUNS for ev in run if ev != CRASH and ev[3] == "hard")


class Scripted:
    """A discovery backend that plays ``RUNS``, one per watch_health call."""

    def __init__(self, base):
        self._base = base
        self._runs = [list(run) for run in RUNS]

    def chips(self):
        return [self._base.TpuChip(id=c, index=i, device_path="", hbm_bytes=1 << 30)
                for i, c in enumerate(CHIPS)]

    def watch_health(self, stop):
        run = self._runs.pop(0) if self._runs else None
        for ev in run or []:
            if ev == CRASH:
                raise RuntimeError("driver poll wedged")
            chip, health, reason, severity = ev
            yield self._base.HealthEvent(chip, self._base.ChipHealth(health), reason, severity)
        if not self._runs and run is not None:
            while not stop():
                time.sleep(0.005)


def _drive(watcher_cls, base):
    log = {"sink": [], "events": []}
    holder = {}

    def sink(chip_id, health):
        log["sink"].append((chip_id, health.value, sorted(holder["w"].unhealthy_ids())))

    def broken_sink(chip_id, health):
        raise RuntimeError("a dead sink must not kill the watcher")

    def on_event(ev):
        log["events"].append((ev.chip_id, ev.health.value, ev.reason, ev.severity))

    w = holder["w"] = watcher_cls(Scripted(base), [sink, broken_sink], on_event=on_event)
    w.start()
    deadline = time.monotonic() + 15
    while (len(log["sink"]) < HARD or w.restarts < 2) and time.monotonic() < deadline:
        time.sleep(0.01)
    alive = w.alive
    w.stop()
    assert not w.alive
    log.update(restarts=w.restarts, alive=alive, unhealthy=sorted(w.unhealthy_ids()))
    return log


def _metrics(registry, cat):
    doc = {(s, h): registry.counter_value(cat.HEALTH_EVENTS_TOTAL, severity=s, health=h)
           for s in ("hard", "app", "transient") for h in ("Healthy", "Unhealthy")}
    doc["restarts"] = registry.counter_value(cat.HEALTH_WATCHER_RESTARTS_TOTAL)
    return doc


def test_one_event_stream_gives_the_reference_watchers_state():
    before = _metrics(REGISTRY, Cat), _metrics(JREGISTRY, JCat)
    got = _drive(HealthWatcher, Base)
    want = _drive(JWatcher, JBase)
    after = _metrics(REGISTRY, Cat), _metrics(JREGISTRY, JCat)
    assert got == want
    assert got["restarts"] == 2 and got["alive"]
    assert got["unhealthy"] == ["GPU-0"]
    assert [s[2] for s in got["sink"]] == [
        ["GPU-0"], ["GPU-0", "GPU-1", "GPU-2"], [], ["GPU-1"], [], ["GPU-0"]]
    assert len(got["events"]) == sum(len(r) for r in RUNS) - 1  # every event but the crash
    deltas = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]
    assert deltas[0]["restarts"] == 2 and deltas[0][("app", "Healthy")] == 1
    assert REGISTRY.gauge_value(Cat.UNHEALTHY_CHIPS) == 1.0


class DownNvml:
    """Stands in for ``native.nvml.Nvml``: two sound cards, and NVML
    failing every call while ``down`` is set."""

    def __init__(self):
        self.cards = [
            NvmlDevice(index=i, uuid=f"GPU-{i:08x}-1111-2222-3333-444444444444",
                       name="NVIDIA H100 80GB HBM3", minor=i,
                       pci_bus_id=f"00000000:{0x18 + i:02X}:00.0", memory_total=80 << 30)
            for i in range(2)
        ]
        self.down = threading.Event()

    def devices(self):
        if self.down.is_set():
            raise NvmlError("nvmlDeviceGetCount_v2", 999)
        return list(self.cards)

    def ecc_errors(self, index):
        if self.down.is_set():
            raise NvmlError("nvmlDeviceGetTotalEccErrors", 999)
        return 0, 0


def test_nvml_going_down_reaches_every_card_without_a_restart(tmp_path):
    """NVML failing is the whole-host signal, and the backend's chips()
    fails with it: the watcher expands the event from the cards it saw
    last, instead of dying on chips() and replaying the event forever."""
    nvml = DownNvml()
    for d in nvml.cards:
        (tmp_path / f"nvidia{d.minor}").touch()
    ids = sorted(d.uuid for d in nvml.cards)
    sink_calls = []
    w = HealthWatcher(NvmlBackend(nvml=nvml, dev_root=str(tmp_path), poll_s=0.01),
                      [lambda chip_id, health: sink_calls.append((chip_id, health.value))])

    def wait_for(n):
        deadline = time.monotonic() + 10
        while len(sink_calls) < n and time.monotonic() < deadline:
            time.sleep(0.01)

    w.start()
    try:
        time.sleep(0.1)  # a few sound polls first
        assert sink_calls == [] and w.unhealthy_ids() == set()
        nvml.down.set()
        wait_for(1)
        assert sink_calls == [(None, "Unhealthy")]
        assert sorted(w.unhealthy_ids()) == ids
        time.sleep(0.1)  # more polls with NVML down: no new event, no crash
        assert sink_calls == [(None, "Unhealthy")] and w.restarts == 0
        nvml.down.clear()
        wait_for(2)
        assert sink_calls == [(None, "Unhealthy"), (None, "Healthy")]
        assert w.unhealthy_ids() == set()
        assert w.restarts == 0 and w.alive
    finally:
        w.stop()
