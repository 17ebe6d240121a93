"""Config-driven mock discovery backend.

Counterpart of ``gpushare_device_plugin_tpu/discovery/mock.py``, copied:
the plugin's whole cycle on a host with no card. Chip count / memory /
topology come from constructor args or the ``TPUSHARE_MOCK_*`` env family,
and health can be driven from a control file for fault-injection tests.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator, Sequence

from .base import ChipHealth, HealthEvent, TpuChip, TpuTopology

ENV_NUM_CHIPS = "TPUSHARE_MOCK_CHIPS"
ENV_HBM_GIB = "TPUSHARE_MOCK_HBM_GIB"
ENV_HEALTH_FILE = "TPUSHARE_MOCK_HEALTH_FILE"


def _int_env(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, default))
    except ValueError:
        return default


class MockBackend:
    def __init__(
        self,
        num_chips: int | None = None,
        hbm_bytes: int | None = None,
        generation: str = "v4",
        host_index: int = 0,
        num_hosts: int = 1,
        health_file: str | None = None,
        poll_interval_s: float = 0.05,
    ):
        if num_chips is None:
            num_chips = _int_env(ENV_NUM_CHIPS, 4)
        if hbm_bytes is None:
            hbm_bytes = _int_env(ENV_HBM_GIB, 32) << 30
        self._num_chips = num_chips
        self._hbm_bytes = hbm_bytes
        self._generation = generation
        self._host_index = host_index
        self._num_hosts = num_hosts
        self._health_file = health_file or os.environ.get(ENV_HEALTH_FILE)
        self._poll_interval_s = poll_interval_s

    def probe(self) -> bool:
        return True

    def chips(self) -> Sequence[TpuChip]:
        return [
            TpuChip(
                id=f"tpu-{self._generation}-host{self._host_index}-chip{i}",
                index=i,
                device_path=f"/dev/accel{i}",
                hbm_bytes=self._hbm_bytes,
            )
            for i in range(self._num_chips)
        ]

    def topology(self) -> TpuTopology:
        return TpuTopology(
            generation=self._generation,
            chips_per_host=self._num_chips,
            host_index=self._host_index,
            num_hosts=self._num_hosts,
        )

    def watch_health(self, stop: Callable[[], bool]) -> Iterator[HealthEvent]:
        """Poll the health control file for ``{"chip_id"|null: "Unhealthy"}``.

        The control file holds a JSON object mapping chip id (or "*") to
        "Healthy"/"Unhealthy"; transitions are emitted as events.
        """
        from ..utils.faults import FAULTS

        last: dict[str, str] = {}
        while not stop():
            # chaos hook: lets tests kill the stream mid-flight (the
            # supervised HealthWatcher must revive it)
            FAULTS.fire("discovery.watch_health")
            if self._health_file and os.path.exists(self._health_file):
                try:
                    with open(self._health_file) as f:
                        cur = json.load(f)
                    if not isinstance(cur, dict):
                        raise ValueError("health file must hold a JSON object")
                    events = []
                    # removed keys are implicit recoveries to Healthy
                    for chip_id in set(last) | set(cur):
                        state = cur.get(chip_id, ChipHealth.HEALTHY.value)
                        if last.get(chip_id, ChipHealth.HEALTHY.value) != state:
                            events.append(
                                HealthEvent(
                                    chip_id=None if chip_id == "*" else chip_id,
                                    health=ChipHealth(state),
                                    reason="mock-health-file",
                                )
                            )
                except (OSError, ValueError, AttributeError):
                    # unreadable/garbled control file: keep the watcher alive
                    events, cur = [], last
                yield from events
                last = dict(cur)
            time.sleep(self._poll_interval_s)
