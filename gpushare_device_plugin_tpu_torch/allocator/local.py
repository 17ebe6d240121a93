"""Standalone allocator: binpack with in-process accounting, no Kubernetes.

Counterpart of ``gpushare_device_plugin_tpu/allocator/local.py``, copied:
the allocator of single-node standalone mode, of tests, and of
``chip_smoke.py``'s pods. (The reference's cluster allocator derives
usage from the apiserver instead; the port has not taken it yet.)

Frees are driven by ``release(pod_key)``.
"""

from __future__ import annotations

from typing import Sequence

from ..device.fanout import DeviceInventory
from ..utils.lockrank import make_lock
from .binpack import assign_chip
from .env import ContainerAllocation, build_mem_allocation


class LocalAllocator:
    def __init__(
        self,
        inventory: DeviceInventory,
        policy: str = "first-fit",
        disable_isolation: bool = False,
    ) -> None:
        self._inv = inventory
        self._policy = policy
        self._disable_isolation = disable_isolation
        self._lock = make_lock("allocator.local")
        self._used: dict[int, int] = {}  # chip index -> units
        self._by_pod: dict[str, tuple[int, int]] = {}  # pod key -> (chip, units)
        self._unhealthy: set[int] = set()
        self._core_held: set[int] = set()  # whole-chip (tpu-core) holds

    def set_chip_health(self, chip_index: int, healthy: bool) -> None:
        with self._lock:
            if healthy:
                self._unhealthy.discard(chip_index)
            else:
                self._unhealthy.add(chip_index)

    def hold_chips(self, chip_indices: Sequence[int]) -> None:
        """Exclusively hold whole chips for a tpu-core pod; fails if any
        chip has fractional usage, an existing hold, or is unhealthy."""
        with self._lock:
            for idx in chip_indices:
                if idx in self._core_held:
                    raise RuntimeError(f"chip {idx} already exclusively held")
                if self._used.get(idx, 0) > 0:
                    raise RuntimeError(
                        f"chip {idx} has {self._used[idx]} fractional units in use"
                    )
                if idx in self._unhealthy:
                    raise RuntimeError(f"chip {idx} is unhealthy")
            self._core_held.update(chip_indices)

    def release_chips(self, chip_indices: Sequence[int]) -> None:
        with self._lock:
            self._core_held.difference_update(chip_indices)

    def core_held(self) -> set[int]:
        with self._lock:
            return set(self._core_held)

    def allocate(
        self, container_counts: Sequence[int], pod_key: str | None = None
    ) -> list[ContainerAllocation]:
        """Place one pod: ``container_counts`` = granted fake-IDs per container.

        Mirrors the Allocate contract: the request total is the pod's demand;
        which fake IDs kubelet picked is irrelevant (``allocate.go:37-39``).
        """
        pod_units = sum(container_counts)
        with self._lock:
            idx = assign_chip(
                pod_units,
                self._inv.units_by_index(),
                self._used,
                unhealthy=sorted(self._unhealthy | self._core_held),
                policy=self._policy,
            )
            self._used[idx] = self._used.get(idx, 0) + pod_units
            if pod_key is not None:
                self._by_pod[pod_key] = (idx, pod_units)
        chip = self._inv.chip_by_id(self._inv.id_of_index(idx))
        total = self._inv.units_of(chip.id)
        return [
            build_mem_allocation(
                chip=chip,
                chip_total_units=total,
                pod_units=pod_units,
                container_units=n,
                disable_isolation=self._disable_isolation,
            )
            for n in container_counts
        ]

    def release(self, pod_key: str) -> None:
        with self._lock:
            entry = self._by_pod.pop(pod_key, None)
            if entry is None:
                return
            idx, units = entry
            self._used[idx] = max(0, self._used.get(idx, 0) - units)

    def used_by_chip(self) -> dict[int, int]:
        with self._lock:
            return dict(self._used)

    def utilization(self) -> float:
        """Fraction of advertised memory units currently allocated."""
        total = self._inv.total_units()
        if total == 0:
            return 0.0
        with self._lock:
            return sum(self._used.values()) / total
