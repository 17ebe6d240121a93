"""Kubernetes Event emission for allocation/bind failures.

Counterpart of ``gpushare_device_plugin_tpu/cluster/events.py``, copied
whole.

The reference's RBAC grants ``create events`` (``device-plugin-rbac.yaml:
8-37``) but its code never uses it — failures are glog-only and operators
must read node logs to learn why admission failed. Surfacing them as
Warning events on the pod makes ``kubectl describe pod`` show the cause.
Best-effort by design: an event that cannot be posted must never turn a
clean failure path into a crash.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any

from ..utils.log import get_logger

log = get_logger("cluster.events")

COMPONENT = "tpushare-device-plugin"
REASON_ALLOC_FAILED = "TpuShareAllocationFailed"
REASON_BIND_FAILED = "TpuShareBindFailed"
REASON_CHIP_UNHEALTHY = "TpuChipUnhealthy"
REASON_CHIP_RECOVERED = "TpuChipRecovered"
REASON_CHIP_APP_FAULT = "TpuChipAppLevelFault"
REASON_CHIP_TRANSIENT = "TpuChipTransientBlip"


def _post_event(
    api,
    namespace: str,
    involved: dict,
    reason: str,
    message: str,
    component: str,
    host: str,
    event_type: str,
) -> bool:
    """Shared best-effort Event POST (one schema for pod + node events).
    Returns False when the post failed (callers that count drops care;
    fire-and-forget callers ignore it)."""
    name = involved.get("name", "")
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "generateName": f"{name}.tpushare-" if name else "tpushare-",
            "namespace": namespace,
        },
        "involvedObject": involved,
        "reason": reason,
        "message": message,
        "type": event_type,
        "source": {"component": component, "host": host},
        "firstTimestamp": now,
        "lastTimestamp": now,
        "count": 1,
    }
    try:
        api.create_event(namespace, event)
    except Exception as e:  # noqa: BLE001 — events are best-effort
        log.warning(
            "event emission failed for %s %s: %s",
            involved.get("kind", "?"), name, e,
        )
        return False
    return True


def emit_node_event(
    api: Any,
    node_name: str,
    reason: str,
    message: str,
    *,
    component: str = COMPONENT,
    event_type: str = "Warning",
) -> bool:
    """Warning/Normal event on the Node object so ``kubectl describe node``
    shows chip health transitions with their classified reason (the
    reference's XID events were glog-only)."""
    return _post_event(
        api, "default",
        {"apiVersion": "v1", "kind": "Node", "name": node_name, "uid": node_name},
        reason, message, component, node_name, event_type,
    )


def emit_pod_event(
    api: Any,
    pod: dict,
    reason: str,
    message: str,
    *,
    component: str = COMPONENT,
    host: str = "",
    event_type: str = "Warning",
) -> None:
    meta = pod.get("metadata", {}) if pod else {}
    ns = meta.get("namespace", "default")
    _post_event(
        api, ns,
        {
            "apiVersion": "v1",
            "kind": "Pod",
            "namespace": ns,
            "name": meta.get("name", ""),
            "uid": meta.get("uid", ""),
        },
        reason, message, component, host, event_type,
    )


class NodeEventEmitter:
    """One worker + one bounded queue for node health events.

    Replaces the thread-per-event emission (a 5 s health poll against an
    unreachable apiserver used to spawn a fresh daemon thread per event,
    each parked on a connect timeout — unbounded thread growth for the
    whole outage). The queue bounds memory; a full queue drops the oldest
    behavior by refusing the newest and counting it — during an outage the
    event's value decays fast anyway, and the health state itself lives in
    ListAndWatch/allocator, not in Events.
    """

    def __init__(self, api: Any, node_name: str, maxsize: int = 64) -> None:
        self._api = api
        self._node = node_name
        self._q: "queue.Queue[tuple[str, str, str] | None]" = queue.Queue(maxsize)
        self._thread: threading.Thread | None = None

    def start(self) -> "NodeEventEmitter":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="node-events"
        )
        self._thread.start()
        return self

    def _count_drop(self, why: str) -> None:
        from ..utils.metric_catalog import NODE_EVENTS_DROPPED_TOTAL
        from ..utils.metrics import REGISTRY

        REGISTRY.counter_inc(
            NODE_EVENTS_DROPPED_TOTAL,
            "Node events dropped (full queue or failed send)",
            reason=why,
        )

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            reason, message, event_type = item
            if not emit_node_event(
                self._api, self._node, reason, message, event_type=event_type
            ):
                self._count_drop("send_failed")

    def emit(self, reason: str, message: str, event_type: str = "Warning") -> None:
        """Non-blocking enqueue; never stalls the health watcher."""
        try:
            self._q.put_nowait((reason, message, event_type))
        except queue.Full:
            self._count_drop("queue_full")

    def stop(self) -> None:
        if self._thread is None:
            return
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # worker is behind; it is a daemon thread, let it go
        self._thread.join(timeout=2.0)
        self._thread = None
