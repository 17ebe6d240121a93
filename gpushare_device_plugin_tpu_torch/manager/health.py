"""Health watcher thread: discovery backend events -> plugin streams.

Counterpart of ``gpushare_device_plugin_tpu/manager/health.py``, copied.
Upstream runs the ``watchXIDs`` goroutine feeding the unhealthy channel
(``nvidia.go:102-154`` -> ``server.go:207-225``), opt-in via
``--health-check``. Here transitions flow in both directions (recovery
supported) and also update the allocator's unhealthy-chip set so binpack
stops targeting sick chips (upstream's TODO at ``server.go:267``).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

from ..discovery.base import ChipHealth, DiscoveryBackend, HealthEvent
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metric_catalog import (
    HEALTH_EVENTS_TOTAL,
    HEALTH_WATCHER_RESTARTS_TOTAL,
    UNHEALTHY_CHIPS,
)
from ..utils.retry import Backoff

log = get_logger("manager.health")


class HealthWatcher:
    def __init__(
        self,
        backend: DiscoveryBackend,
        sinks: Iterable[Callable[[str | None, ChipHealth], None]],
        on_event: Callable[[HealthEvent], None] | None = None,
    ):
        """``sinks``: callables like ``plugin.set_chip_health`` invoked per
        hard event. ``on_event`` (optional) receives EVERY event including
        ``"app"``-severity ones (the daemon's hook for node events)."""
        self._backend = backend
        self._sinks = list(sinks)
        self._on_event = on_event
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._unhealthy_ids: set[str] = set()
        self._chip_ids: list[str] = []  # the backend's last answer
        self._lock = make_lock("manager.health")
        self._restarts = 0

    @property
    def restarts(self) -> int:
        """How many times the supervisor revived a dead watch loop."""
        return self._restarts

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def unhealthy_ids(self) -> set[str]:
        with self._lock:
            return set(self._unhealthy_ids)

    def _all_chip_ids(self) -> list[str]:
        """Every chip's id: the backend's answer, or the last one it gave.
        A whole-host fault is often the backend's own library failing
        (NVML no longer answering), so asking it again may raise; the
        chips it listed last are the ones that just went down."""
        try:
            self._chip_ids = [c.id for c in self._backend.chips()]
        except Exception as e:  # noqa: BLE001 — keep the last enumeration
            log.warning("health: chips() failed (%s); using the last %d ids",
                        e, len(self._chip_ids))
        return self._chip_ids

    def _handle(self, event: HealthEvent) -> None:
        log.info(
            "health: chip=%s -> %s (%s, %s)",
            event.chip_id or "ALL", event.health.value, event.reason,
            event.severity,
        )
        from ..utils.metrics import REGISTRY

        REGISTRY.counter_inc(
            HEALTH_EVENTS_TOTAL,
            "Classified health transitions",
            severity=event.severity, health=event.health.value,
        )
        if self._on_event is not None:
            try:
                self._on_event(event)
            except Exception as e:  # noqa: BLE001 — events are best-effort
                log.warning("health on_event hook failed: %s", e)
        if event.severity != "hard":
            # "app" (upstream skips XIDs 31/43/45, nvidia.go:133-137) and
            # "transient" (self-healed blip): visible, never de-advertise.
            return
        with self._lock:
            if event.chip_id is None:
                if event.health == ChipHealth.UNHEALTHY:
                    self._unhealthy_ids.update(self._all_chip_ids())
                else:
                    self._unhealthy_ids.clear()
            elif event.health == ChipHealth.UNHEALTHY:
                self._unhealthy_ids.add(event.chip_id)
            else:
                self._unhealthy_ids.discard(event.chip_id)
        REGISTRY.gauge_set(
            UNHEALTHY_CHIPS,
            len(self._unhealthy_ids),
            "Chips currently excluded from placement",
        )
        for sink in self._sinks:
            try:
                sink(event.chip_id, event.health)
            except Exception as e:  # a dead sink must not kill the watcher
                log.warning("health sink failed: %s", e)

    def start(self) -> None:
        """Run the watch loop under a supervisor: a backend that raises (a
        wedged driver poll) gets restarted with jittered backoff instead of
        silently ending health monitoring for the life of the daemon."""
        self._all_chip_ids()  # while the backend still answers

        def run():
            from ..utils.metrics import REGISTRY

            backoff = Backoff(base_s=0.1, max_s=5.0)
            while not self._stop.is_set():
                try:
                    FAULTS.fire("discovery.watch_health")
                    for event in self._backend.watch_health(self._stop.is_set):
                        if self._stop.is_set():
                            return
                        backoff.reset()
                        self._handle(event)
                    if self._stop.is_set():
                        return
                    # Generator exhausted without stop: the backend gave up
                    # on its own — treat it exactly like a crash.
                    raise RuntimeError("watch_health stream ended early")
                except Exception as e:  # noqa: BLE001 — supervised
                    if self._stop.is_set():
                        return
                    self._restarts += 1
                    REGISTRY.counter_inc(
                        HEALTH_WATCHER_RESTARTS_TOTAL,
                        "Health watch loop crashes revived by the supervisor",
                    )
                    delay = backoff.next()
                    log.error(
                        "health watcher died (%s); restart #%d in %.2fs",
                        e, self._restarts, delay,
                    )
                    self._stop.wait(delay)

        self._thread = threading.Thread(target=run, daemon=True, name="health-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
