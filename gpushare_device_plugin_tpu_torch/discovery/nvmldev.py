"""NVML discovery backend: the device plugin's production backend on a
CUDA host.

Counterpart of ``gpushare_device_plugin_tpu/discovery/tpuvm.py::TpuVmBackend``,
and of upstream's NVML layer (``nvidia.go:47-91``): one chip a card,
ordered by PCI bus id (the order ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` gives a
pod), its id the NVML UUID, its device file ``/dev/nvidia<minor>``, its
memory NVML's total. NVML is loaded lazily (``native/nvml.py``), and
nothing here imports ``torch`` or opens a CUDA context.

``pair_with_cuda`` holds this backend's cards against the CUDA backend's.

Health keeps the reference's classification signal for signal, reason
strings included (``tpuvm.py``:245-377); NVML's volatile ECC counts take
the place of the sysfs error counters, and NVML answering at all takes
the place of the libtpu runtime's liveness.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Iterator, Sequence

from ..native import nvml as nvml_lib
from .base import ChipHealth, HealthEvent, TpuChip, TpuTopology

# A device file must stay missing for MORE than this many consecutive polls
# before the card goes Unhealthy: a shorter blip (driver reset) never
# surfaces, so the allocator never excludes the card.
DEVICE_GONE_GRACE_POLLS = 1
# After a hard error-counter hit, this many quiet polls heal the card.
COUNTER_QUIET_POLLS = 6
# Uncorrected ECC errors are infrastructure faults -> hard; corrected ones
# are the app-level analog of XID 31/43/45 (``nvidia.go:133-137``) -> never
# de-advertise.
HARD_COUNTERS = ("uncorrected",)
APP_COUNTERS = ("corrected",)
GIB = 1 << 30


class NvmlBackend:
    def __init__(
        self,
        nvml: Any = None,
        dev_root: str = "/dev",
        poll_s: float = 5.0,
        grace_polls: int = DEVICE_GONE_GRACE_POLLS,
        library: str | None = None,
    ):
        """``nvml``: an initialized :class:`~..native.nvml.Nvml` (or an
        object with its ``devices()`` and ``ecc_errors(index)``); None
        loads ``library`` (default ``libnvidia-ml.so.1``) at first use."""
        self._nvml = nvml
        self._library = library
        self._dev_root = dev_root
        self._poll_s = poll_s
        self._grace_polls = grace_polls

    def _handle(self) -> Any:
        if self._nvml is None:
            self._nvml = nvml_lib.load(self._library)
        return self._nvml

    def _devices(self) -> list:
        """NVML's cards ordered by PCI bus id (by NVML's index where the
        driver hides the bus)."""
        return sorted(self._handle().devices(), key=lambda d: (d.pci_bus_id, d.index))

    def probe(self) -> bool:
        try:
            return bool(self._devices())
        except OSError:
            return False

    def chips(self) -> Sequence[TpuChip]:
        return self._chips(self._devices())

    def _chips(self, devices: list) -> list[TpuChip]:
        return [
            TpuChip(
                id=d.uuid,
                index=i,
                device_path=os.path.join(self._dev_root, f"nvidia{d.minor}"),
                hbm_bytes=d.memory_total,
            )
            for i, d in enumerate(devices)
        ]

    def topology(self) -> TpuTopology:
        devices = self._devices()
        return TpuTopology(
            generation=devices[0].name if devices else "unknown",
            chips_per_host=len(devices),
        )

    def error_counters(self, devices: list | None = None) -> dict[str, dict[str, int]]:
        """Each card's volatile ECC counts by chip id; ``{}`` for a card
        where NVML reports none (ECC off, or the call failed)."""
        out: dict[str, dict[str, int]] = {}
        for d in self._devices() if devices is None else devices:
            try:
                corrected, uncorrected = self._handle().ecc_errors(d.index)
            except OSError:
                out[d.uuid] = {}
                continue
            out[d.uuid] = {"corrected": corrected, "uncorrected": uncorrected}
        return out

    def watch_health(self, stop: Callable[[], bool]) -> Iterator[HealthEvent]:
        """Per-card classified health poll (default 5 s, ``nvidia.go:128``).

        Three signals, classified per card as the reference classifies
        them (``tpuvm.py::TpuVmBackend.watch_health``):

        - **device file presence** with a grace window: a file missing for
          <= ``grace_polls`` consecutive polls is a transient blip and
          surfaces nothing; longer outages go Unhealthy with reason
          ``device-file-gone``, and recover the moment the file returns.
        - **ECC counters**: an uncorrected-error delta is a hard fault
          (immediate Unhealthy, healed after ``COUNTER_QUIET_POLLS`` quiet
          polls); a corrected-error delta is an ``"app"``-severity event
          that never flips schedulability.
        - **NVML liveness**, whole-host, hard: NVML failing to answer
          takes every card with it.
        """
        state: dict[str, bool] = {}  # cid -> currently advertised healthy
        miss: dict[str, int] = {}  # cid -> consecutive missing polls
        quiet: dict[str, int] = {}  # cid -> polls since last hard counter hit
        counters: dict[str, dict[str, int]] = {}
        seen: dict[str, str] = {}  # chip id -> device path, sticky
        nvml_ok = True
        while not stop():
            try:
                devices = self._devices()
                ok = True
            except OSError:
                devices, ok = [], False
            if ok != nvml_ok:
                yield HealthEvent(
                    chip_id=None,
                    health=ChipHealth.HEALTHY if ok else ChipHealth.UNHEALTHY,
                    reason="nvml-runtime",
                )
                nvml_ok = ok
            # Re-enumerate each cycle so cards appearing after a late driver
            # init get watched; keep previously-seen cards in ``seen`` so a
            # vanished device file still reports unhealthy and recovers
            # when it returns.
            for chip in self._chips(devices):
                seen.setdefault(chip.id, chip.device_path)
            read = self.error_counters(devices)
            for cid, path in seen.items():
                healthy = state.get(cid, True)
                if os.path.exists(path):
                    blip = miss.pop(cid, 0)
                    if not healthy and quiet.get(cid) is None:
                        # gone past grace, now back: recover immediately
                        state[cid] = True
                        yield HealthEvent(
                            chip_id=cid, health=ChipHealth.HEALTHY,
                            reason="device-file-restored",
                        )
                        continue
                    if blip and healthy:
                        # infrastructure blip inside the grace window:
                        # informational, schedulability untouched
                        yield HealthEvent(
                            chip_id=cid, health=ChipHealth.HEALTHY,
                            reason=f"device-file-blip({blip} polls)",
                            severity="transient",
                        )
                else:
                    miss[cid] = miss.get(cid, 0) + 1
                    if healthy and miss[cid] > self._grace_polls:
                        state[cid] = False
                        quiet.pop(cid, None)  # cause: device, not counters
                        yield HealthEvent(
                            chip_id=cid, health=ChipHealth.UNHEALTHY,
                            reason=f"device-file-gone({miss[cid]} polls)",
                        )
                    continue  # no counters to read while the file is gone

                cur = read.get(cid, {})
                last = counters.get(cid)
                if cur:
                    counters[cid] = cur
                if not cur or last is None:
                    # No counters (ECC off, NVML down) or first observation:
                    # no deltas to classify, but a counter-unhealthy card
                    # still makes quiet progress.
                    hard_delta = app_delta = 0
                else:
                    hard_delta = sum(
                        cur.get(f, 0) - last.get(f, 0)
                        for f in HARD_COUNTERS
                        if cur.get(f, 0) > last.get(f, 0)
                    )
                    app_delta = sum(
                        cur.get(f, 0) - last.get(f, 0)
                        for f in APP_COUNTERS
                        if cur.get(f, 0) > last.get(f, 0)
                    )
                if app_delta:
                    yield HealthEvent(
                        chip_id=cid, health=ChipHealth.HEALTHY,
                        reason=f"correctable-errors+{app_delta}",
                        severity="app",
                    )
                if hard_delta:
                    quiet[cid] = 0
                    if state.get(cid, True):
                        state[cid] = False
                        yield HealthEvent(
                            chip_id=cid, health=ChipHealth.UNHEALTHY,
                            reason=f"uncorrectable-errors+{hard_delta}",
                        )
                elif quiet.get(cid) is not None:
                    quiet[cid] += 1
                    if quiet[cid] >= COUNTER_QUIET_POLLS:
                        quiet.pop(cid)
                        if not state.get(cid, True):
                            state[cid] = True
                            yield HealthEvent(
                                chip_id=cid, health=ChipHealth.HEALTHY,
                                reason=f"error-counter-quiet({COUNTER_QUIET_POLLS} polls)",
                            )
            # stop-aware wait (0.1 s stop latency)
            waited = 0.0
            while waited < self._poll_s:
                if stop():
                    return
                step = min(0.1, self._poll_s - waited)
                time.sleep(step)
                waited += step


def pair_with_cuda(
    nvml_chips: Sequence[TpuChip], cuda_chips: Sequence[TpuChip]
) -> tuple[list[tuple[TpuChip, TpuChip]], list[str]]:
    """Pair the NVML backend's cards with the CUDA backend's, and list
    where the two disagree.

    Cards pair by UUID. A CUDA card with no partner is a disagreement (CUDA may see fewer cards, never others), and so is a
    pair whose whole GiB differ (the byte counts differ by the driver's
    reservation) or whose device paths differ where CUDA knows one.
    """
    by_id = {c.id: c for c in nvml_chips}
    pairs = [(by_id[c.id], c) for c in cuda_chips if c.id in by_id]
    unpaired = [c for c in cuda_chips if c.id not in by_id]
    problems = [f"CUDA's card {c.index} ({c.id}) is not one of NVML's" for c in unpaired]
    for nv, cu in pairs:
        if nv.hbm_bytes // GIB != cu.hbm_bytes // GIB:
            problems.append(f"card {nv.id}: NVML's {nv.hbm_bytes // GIB} GiB, "
                            f"CUDA's {cu.hbm_bytes // GIB}")
        if cu.device_path and cu.device_path != nv.device_path:
            problems.append(f"card {nv.id}: NVML's device file {nv.device_path}, "
                            f"CUDA's {cu.device_path}")
    return pairs, problems
