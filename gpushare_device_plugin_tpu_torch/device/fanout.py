"""Fake-device fan-out: the core resource-virtualization trick.

Counterpart of ``gpushare_device_plugin_tpu/device/fanout.py``, copied.
Kubernetes extended resources are opaque integers: kubelet cannot count
"GiB of memory on card 3". So one fake ``Device`` is advertised per memory
unit: a card with 79 GiB becomes 79 devices with IDs ``"<chipID>-_-<j>"``
(upstream's ``nvidia.go:26-31,75-87``). A pod requesting
``aliyun.com/tpu-mem: 4`` is granted 4 fake IDs by kubelet; ``Allocate()``
ignores which IDs and only counts them, then picks the real card itself.

Capacity is tracked per chip (upstream latches the first GPU's memory as
every device's capacity, ``nvidia.go:71-74``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from ..const import MemoryUnit
from ..discovery.base import ChipHealth, TpuChip

FAKE_ID_SEP = "-_-"


def generate_fake_device_id(chip_id: str, unit_index: int) -> str:
    """Upstream's format ``%s-_-%d`` (``nvidia.go:26-28``)."""
    return f"{chip_id}{FAKE_ID_SEP}{unit_index}"


def extract_real_chip_id(fake_id: str) -> str:
    """Strip the unit suffix (``nvidia.go:30-31``)."""
    return fake_id.rsplit(FAKE_ID_SEP, 1)[0]


@dataclasses.dataclass(frozen=True)
class FakeDevice:
    id: str
    chip_id: str
    healthy: bool = True


class DeviceInventory:
    """Host inventory: chips, their unit capacities, and the fan-out lists."""

    def __init__(self, chips: Sequence[TpuChip], unit: MemoryUnit = MemoryUnit.GiB):
        self._unit = unit
        # single source of truth: chip id -> TpuChip (index/units derived),
        # plus the one inverse map needed for index lookups
        self._chips: dict[str, TpuChip] = {}
        self._id_by_index: dict[int, str] = {}
        for chip in sorted(chips, key=lambda c: c.index):
            if chip.id in self._chips:
                raise ValueError(f"duplicate chip id {chip.id!r}")
            if chip.index in self._id_by_index:
                raise ValueError(f"duplicate chip index {chip.index}")
            self._chips[chip.id] = chip
            self._id_by_index[chip.index] = chip.id

    # --- basic accessors ---------------------------------------------------

    @property
    def unit(self) -> MemoryUnit:
        return self._unit

    @property
    def chip_count(self) -> int:
        return len(self._chips)

    def chips(self) -> Sequence[TpuChip]:
        return sorted(self._chips.values(), key=lambda c: c.index)

    def chip_by_id(self, chip_id: str) -> TpuChip:
        return self._chips[chip_id]

    def index_of(self, chip_id: str) -> int:
        return self._chips[chip_id].index

    def id_of_index(self, index: int) -> str:
        """Inverse map, used to log the assigned chip (``server.go:76-87``)."""
        return self._id_by_index[index]

    def units_of(self, chip_id: str) -> int:
        """Memory units (= fake devices) on one chip."""
        return self._chips[chip_id].hbm_bytes // self._unit.num_bytes

    def units_by_index(self) -> Mapping[int, int]:
        """chip index -> total memory units; the binpack capacity vector."""
        return {c.index: self.units_of(c.id) for c in self._chips.values()}

    def total_units(self) -> int:
        return sum(self.units_of(cid) for cid in self._chips)

    # --- fan-out -----------------------------------------------------------

    def mem_fake_devices(
        self, health: Mapping[str, ChipHealth] | None = None
    ) -> list[FakeDevice]:
        """One fake device per memory unit, ordered by chip index then unit.

        ``health`` overrides the chips' discovered health (the live view kept
        by the health watcher).
        """
        out: list[FakeDevice] = []
        for chip in self.chips():
            h = (health or {}).get(chip.id, chip.health)
            ok = h == ChipHealth.HEALTHY
            out.extend(
                FakeDevice(
                    id=generate_fake_device_id(chip.id, j),
                    chip_id=chip.id,
                    healthy=ok,
                )
                for j in range(self.units_of(chip.id))
            )
        return out

    def core_devices(
        self, health: Mapping[str, ChipHealth] | None = None
    ) -> list[FakeDevice]:
        """One device per physical chip, for the whole-chip resource."""
        out = []
        for chip in self.chips():
            h = (health or {}).get(chip.id, chip.health)
            out.append(
                FakeDevice(id=chip.id, chip_id=chip.id, healthy=h == ChipHealth.HEALTHY)
            )
        return out
