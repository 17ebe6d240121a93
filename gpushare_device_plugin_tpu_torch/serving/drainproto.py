"""The engine drain handshake, as a standalone protocol object.

Counterpart of ``gpushare_device_plugin_tpu/serving/drainproto.py``. A
mover thread asks the serving thread to quiesce at its next iteration
boundary; the serving thread captures its unfinished requests into a
JSON-safe snapshot; the mover collects it for restore on another engine.
Three flips under one lock:

- **arm** (:meth:`DrainHandshake.request`): reset any prior cycle's
  answer, then raise the request flag. Only arming (and the
  everything-retired answer) may discard an uncollected capture.
- **capture** (:meth:`DrainHandshake.publish`): the serving thread stores
  the snapshot, lowers the request flag and wakes the waiter.
- **consume** (:meth:`DrainHandshake.wait`): the mover blocks for the
  capture. A timed-out wait disarms the drain before raising, so the next
  unrelated run is not quiesced into a snapshot nobody collects.
- **run end** (:meth:`DrainHandshake.finish_run`): a run that retired
  everything answers a concurrent drain with None and disarms; an earlier
  cycle's uncollected capture is left for its waiter.
"""

from __future__ import annotations

import threading


class DrainHandshake:
    """Arm/capture/consume state machine between one serving thread and
    one mover thread. The lock is held around flag flips only."""

    def __init__(self) -> None:
        self._request_evt = threading.Event()
        self._drained_evt = threading.Event()
        self._lock = threading.Lock()
        self._snapshot: dict | None = None

    # --- mover side -------------------------------------------------------

    def request(self) -> None:
        """Arm: ask the run in progress (or the next one) to quiesce at its
        next iteration boundary, after clearing a prior run's answer."""
        with self._lock:
            self._drained_evt.clear()
            self._snapshot = None
            self._request_evt.set()

    def wait(self, timeout: float | None = None) -> dict | None:
        """Block until the serving thread quiesced after :meth:`request`
        and return :meth:`snapshot` (None when the run retired everything).
        Raises ``TimeoutError`` when ``timeout`` seconds pass with no run
        at a boundary, after disarming; a capture that landed in the
        instant between the expiry and the disarm is returned instead."""
        if not self._drained_evt.wait(timeout):
            with self._lock:
                if not self._drained_evt.is_set():
                    self._request_evt.clear()
                    raise TimeoutError(
                        "engine did not quiesce after request_drain()"
                        + (f" within {timeout}s" if timeout is not None else "")
                    )
        return self.snapshot()

    def snapshot(self) -> dict | None:
        """The snapshot captured by the last drained run (None when the
        last quiesce retired everything)."""
        return self._snapshot

    # --- serving side -----------------------------------------------------

    def armed(self) -> bool:
        """Whether a drain is requested (one flag read, no lock)."""
        return self._request_evt.is_set()

    def publish(self, captured: dict) -> None:
        """Capture: store the quiesced run's snapshot, disarm, and wake
        :meth:`wait`."""
        with self._lock:
            self._snapshot = captured
            self._request_evt.clear()
            self._drained_evt.set()

    def finish_run(self) -> None:
        """The run completed: a drain requested after its last boundary is
        answered with None and disarmed; a pending uncollected capture
        from an earlier run is left for its waiter."""
        with self._lock:
            if not self._drained_evt.is_set():
                self._snapshot = None
                self._request_evt.clear()
                self._drained_evt.set()

    # --- introspection ----------------------------------------------------

    def doc(self) -> dict:
        """The flags and whether a snapshot waits (debugging, invariant
        checks)."""
        with self._lock:
            return {
                "armed": self._request_evt.is_set(),
                "drained": self._drained_evt.is_set(),
                "has_snapshot": self._snapshot is not None,
            }
