"""Fault-injection layer: named injection points with error/latency/flap/crash.

Counterpart of ``gpushare_device_plugin_tpu/utils/faults.py``, cut to the
points the port fires: each site calls ``FAULTS.fire("<point>")``, which
with nothing armed is one dict read and a return; a test (or
``TPUSHARE_FAULTS``) arms a point and the next call through it fails,
stalls, flaps or "crashes" exactly there.

======================  =====================================================
``discovery.probe``     inventory (re)build at plugin (re)start
``discovery.watch_health``  health-event stream (supervised loop entry +
                        every mock-backend poll)
``plugin.allocate``     Allocate RPC entry (kubelet-facing)
``checkpoint.begin``    after the WAL begin record is durably on disk
``checkpoint.commit``   after the WAL commit record is durably on disk
``checkpoint.abort``    after the WAL abort record is durably on disk
``checkpoint.wal_queue``  after a record is queued for group commit,
                        BEFORE its durability wait
``checkpoint.batch_fsync``  in the group-commit writer, after a batch
                        became durable
``handoff.export``      after the KV handoff's "export" phase record is
                        durable, before the wire payload materializes
``handoff.transfer``    after the "transfer" record is durable, before
                        destination pages stage / page bytes ship
``handoff.import``      after the "import" record is durable, before the
                        decode tier adopts (the roll-forward boundary)
``handoff.commit``      after the "commit" record is durable, before the
                        entry resolves
``scale.cordon``        after the fleet scale-down's "cordon" record is
                        durable, before the replica closes to routes
``scale.drain``         after the "drain" record (the frozen rows) is
                        durable, before the engine drains
``scale.migrate``       after the "migrate" record (the snapshot) is
                        durable, before a survivor adopts (the
                        roll-forward boundary)
``scale.release``       after the "release" record is durable, before the
                        replica leaves the membership
==========================================================================

Each point sits immediately *after* a journal step takes durable effect,
so arming it with the ``crash`` mode leaves the files exactly as a
SIGKILL at that instruction would (and, through the crash hook, dumps a
flight record first).

Modes:

- ``error``:   raise (``FaultError`` by default, or a supplied exception
               factory) on each affected call.
- ``latency``: sleep ``latency_s`` before letting the call proceed.
- ``flap``:    cyclically fail ``fail_n`` calls then pass ``pass_n``.
- ``crash``:   raise ``SimulatedCrash`` — a ``BaseException``, so no
               ``except Exception`` handler (journal abort, claim release)
               can observe it, exactly like a process kill.

``times`` bounds how many *firings* a fault affects (then it disarms
itself); ``None`` means until cleared.

Env activation::

    TPUSHARE_FAULTS="handoff.transfer=error:5,checkpoint.begin=latency:0.2"

grammar: ``point=mode[:arg]`` comma-separated, where ``arg`` is ``times``
for error and crash, seconds for latency, and ``fail_n/pass_n`` for flap
(``flap:2/3`` = fail 2, pass 3, repeat).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator

from .log import get_logger
from .lockrank import make_lock

log = get_logger("utils.faults")

ENV_FAULTS = "TPUSHARE_FAULTS"

POINTS = (
    "discovery.probe",
    "discovery.watch_health",
    "plugin.allocate",
    "checkpoint.begin",
    "checkpoint.commit",
    "checkpoint.abort",
    "checkpoint.wal_queue",
    "checkpoint.batch_fsync",
    "handoff.export",
    "handoff.transfer",
    "handoff.import",
    "handoff.commit",
    "scale.cordon",
    "scale.drain",
    "scale.migrate",
    "scale.release",
)


class FaultError(ConnectionError):
    """The injected failure. A ``ConnectionError`` so call sites exercise
    the handling a severed peer socket would: the peer client's retry and
    circuit-breaker accounting."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault at {point}")
        self.point = point


class SimulatedCrash(BaseException):
    """Process death, simulated. Deliberately NOT an ``Exception``: every
    handler on the handoff path (journal abort, claim release, the
    fallback ladder) catches ``Exception`` and would otherwise run cleanup
    a SIGKILL never runs — which is precisely what restart recovery must
    be tested *without*. Only the test harness catches it."""

    def __init__(self, point: str) -> None:
        super().__init__(f"simulated crash at {point}")
        self.point = point


class _Fault:
    def __init__(
        self,
        point: str,
        mode: str,
        *,
        times: int | None,
        error: Callable[[], Exception] | None,
        latency_s: float,
        fail_n: int,
        pass_n: int,
    ):
        if mode not in ("error", "latency", "flap", "crash"):
            raise ValueError(f"unknown fault mode: {mode}")
        self.point = point
        self.mode = mode
        self.times = times
        if error is not None:
            self.error = error
        elif mode == "crash":
            self.error = lambda: SimulatedCrash(point)
        else:
            self.error = lambda: FaultError(point)
        self.latency_s = latency_s
        self.fail_n = max(1, fail_n)
        self.pass_n = max(1, pass_n)
        self.fired = 0  # calls this fault affected
        self._cycle = 0  # flap position

    def apply(self) -> None:
        """Raise per mode (``fire`` sleeps the latency mode itself).
        Returns normally when the fault passes this call through (flap
        pass phase, or budget exhausted)."""
        if self.times is not None and self.fired >= self.times:
            return
        if self.mode == "flap":
            pos = self._cycle
            self._cycle = (self._cycle + 1) % (self.fail_n + self.pass_n)
            if pos >= self.fail_n:
                return  # pass phase
            self.fired += 1
            raise self.error()
        self.fired += 1
        raise self.error()


class FaultRegistry:
    """Process-wide named injection points. Thread-safe; ``fire`` on an
    unarmed point is one dict read."""

    def __init__(self) -> None:
        self._lock = make_lock("faults.registry")
        self._faults: dict[str, _Fault] = {}
        # Flight-recorder hook: called (outside the registry lock, the
        # dump does file I/O) with the point name just before a crash-
        # mode fault raises SimulatedCrash — so injected kills leave the
        # same postmortem a production SIGKILL site would.
        self._crash_hook: Callable[[str], Any] | None = None

    def set_crash_hook(self, hook: Callable[[str], Any] | None) -> None:
        with self._lock:
            self._crash_hook = hook

    def inject(
        self,
        point: str,
        mode: str = "error",
        *,
        times: int | None = None,
        error: Callable[[], Exception] | None = None,
        latency_s: float = 0.0,
        fail_n: int = 1,
        pass_n: int = 1,
    ) -> None:
        fault = _Fault(
            point, mode, times=times, error=error,
            latency_s=latency_s, fail_n=fail_n, pass_n=pass_n,
        )
        with self._lock:
            self._faults[point] = fault
        log.info("fault armed: %s mode=%s times=%s", point, mode, times)

    def clear(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._faults.clear()
            else:
                self._faults.pop(point, None)

    def active(self) -> list[str]:
        with self._lock:
            return sorted(self._faults)

    def fired(self, point: str) -> int:
        with self._lock:
            f = self._faults.get(point)
            return f.fired if f is not None else 0

    def fire(self, point: str) -> None:
        """Called at the injection site. No-op unless the point is armed."""
        if not self._faults:  # fast path: nothing armed anywhere
            return
        crash: SimulatedCrash | None = None
        with self._lock:
            fault = self._faults.get(point)
            if fault is None:
                return
            # counters/cycle mutate under the lock; the latency sleep and
            # the crash hook's dump I/O must not hold it (they would
            # serialize unrelated points)
            if fault.mode == "latency":
                if fault.times is not None and fault.fired >= fault.times:
                    return
                fault.fired += 1
                delay = fault.latency_s
            else:
                try:
                    fault.apply()  # raises or passes through
                    return
                except SimulatedCrash as e:
                    crash = e
            hook = self._crash_hook
        if crash is not None:
            if hook is not None:
                try:
                    hook(point)
                except Exception as e:  # noqa: BLE001 — crashing anyway
                    log.warning("crash hook failed at %s: %s", point, e)
            raise crash
        time.sleep(delay)

    @contextlib.contextmanager
    def injected(
        self, point: str, mode: str = "error", **kwargs: Any
    ) -> Iterator["FaultRegistry"]:
        """Scoped arming for tests: disarms the point on exit even when the
        body raises."""
        self.inject(point, mode, **kwargs)
        try:
            yield self
        finally:
            self.clear(point)

    def install_from_env(self, spec: str | None = None) -> int:
        """Arm faults from ``TPUSHARE_FAULTS`` (or an explicit spec string).
        Returns the number of faults armed; malformed clauses are logged
        and skipped (a typo in an e2e env must not crash the daemon)."""
        if spec is None:
            spec = os.environ.get(ENV_FAULTS, "")
        armed = 0
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            try:
                point, _, rhs = clause.partition("=")
                point = point.strip()
                if point not in POINTS:
                    # a typo'd point would arm silently and never fire —
                    # the e2e would then "pass" without injecting anything
                    log.warning(
                        "ignoring unknown fault point %r (known: %s)",
                        point, ", ".join(POINTS),
                    )
                    continue
                mode, _, arg = rhs.partition(":")
                kwargs: dict = {}
                if mode == "latency":
                    kwargs["latency_s"] = float(arg or 0.1)
                elif mode == "flap":
                    fail_s, _, pass_s = (arg or "1/1").partition("/")
                    kwargs["fail_n"] = int(fail_s or 1)
                    kwargs["pass_n"] = int(pass_s or 1)
                elif arg:
                    kwargs["times"] = int(arg)
                self.inject(point, mode or "error", **kwargs)
                armed += 1
            except (ValueError, TypeError) as e:
                log.warning("ignoring malformed fault clause %r: %s", clause, e)
        return armed


# Process-wide registry, mirroring utils.metrics.REGISTRY.
FAULTS = FaultRegistry()
