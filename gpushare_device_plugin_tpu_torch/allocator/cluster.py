"""The core plugin's card ranking.

Counterpart of ``gpushare_device_plugin_tpu/allocator/cluster.py``, cut to
:func:`preferred_core_chips`, which the standalone daemon's core plugin
ranks cards with. The rest of that module (the apiserver-backed
allocators, their chip state and gang placement) is cluster mode, not
ported yet.
"""

from __future__ import annotations

from typing import Callable

from ..device.fanout import DeviceInventory
from ..utils.log import get_logger

log = get_logger("allocator.cluster")


def preferred_core_chips(
    inventory: DeviceInventory,
    state_fn: Callable[[], tuple[dict[int, int], set[int]]],
) -> Callable[[list[str], int], list[str]]:
    """GetPreferredAllocation hook for the core plugin: steer kubelet toward
    cards with no fractional usage and no existing exclusive hold, so core
    grants rarely conflict with the mem binpack.

    ``state_fn() -> (mem_used_by_chip, core_held_chips)``: standalone mode
    passes the LocalAllocator's in-process view; the ranking policy lives
    here once.
    """

    def prefer(available_ids: list[str], size: int) -> list[str]:
        try:
            mem_used, core_held = state_fn()
        except Exception as e:  # noqa: BLE001 — preference only, never fail
            log.warning("preferred-allocation state read failed: %s", e)
            mem_used, core_held = {}, set()

        def rank(cid: str):
            idx = inventory.index_of(cid)
            return (idx in core_held, mem_used.get(idx, 0), idx)

        return sorted(available_ids, key=rank)[:size]

    return prefer
