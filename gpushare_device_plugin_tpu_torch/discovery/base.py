"""Discovery data model shared by all backends.

Counterpart of ``gpushare_device_plugin_tpu/discovery/base.py``, copied
with the reference's names (``TpuChip``, ``TpuTopology``), because the
plugin's env and the control plane speak them whatever the card. Upstream
collapses discovery to: per-GPU UUID, ``/dev/nvidia<i>`` path, total
memory, and an XID-event health feed (``nvidia.go:53-91,102-154``); the
model here carries the same essentials plus the slice topology.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterator, Protocol, Sequence


class ChipHealth(enum.Enum):
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"


@dataclasses.dataclass(frozen=True)
class TpuChip:
    """One physical card on this host."""

    id: str  # stable unique ID: the NVML UUID ("GPU-...") of a card
    index: int  # local chip index, the value injected as TPU_VISIBLE_CHIPS
    device_path: str  # /dev/nvidia<minor> (or "" when virtual)
    hbm_bytes: int  # total device memory on this chip
    health: ChipHealth = ChipHealth.HEALTHY


@dataclasses.dataclass(frozen=True)
class TpuTopology:
    """Host-local view of the slice topology.

    ``process_bounds`` / ``chips_per_process_bounds`` are the strings a
    multi-host workload needs to form its mesh; empty strings mean
    single-host, which every CUDA host is here.
    """

    generation: str = "v4"  # the card's name for a CUDA backend
    chips_per_host: int = 4
    host_index: int = 0
    num_hosts: int = 1
    process_bounds: str = ""
    chips_per_process_bounds: str = ""


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """A health transition for one chip (or all chips when ``chip_id=None``).

    Analog of an NVML XID critical event (``nvidia.go:121-152``): events
    without a device attribution mark every chip unhealthy.

    ``severity`` classifies the fault the way upstream classifies XIDs
    (``nvidia.go:133-137`` skips application-level XIDs 31/43/45):

    - ``"hard"``: infrastructure fault; flips schedulability (the
      allocator excludes the chip, ListAndWatch marks it Unhealthy).
    - ``"transient"``: infrastructure blip that self-healed inside the
      grace window (driver reset); informational only, never flips health.
    - ``"app"``: application-level fault (a corrected-error counter
      ticked); surfaced as a log line but NEVER changes chip health: a
      user bug must not de-advertise hardware.
    """

    chip_id: str | None
    health: ChipHealth
    reason: str = ""
    severity: str = "hard"


class DiscoveryBackend(Protocol):
    """Chip enumeration + health feed. Implementations: mock, nvml, cuda."""

    def probe(self) -> bool:
        """Cheap check whether this backend can run on this host."""
        ...

    def chips(self) -> Sequence[TpuChip]:
        """Enumerate local chips. Stable order by ``index``."""
        ...

    def topology(self) -> TpuTopology:
        ...

    def watch_health(self, stop: Callable[[], bool]) -> Iterator[HealthEvent]:
        """Yield health transitions until ``stop()`` returns True.

        Implementations poll; callers run this in a thread (upstream runs
        ``watchXIDs`` with a 5 s event wait, ``nvidia.go:121-128``).
        """
        ...
