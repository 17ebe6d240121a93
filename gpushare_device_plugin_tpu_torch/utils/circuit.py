"""Circuit breaker for a peer that can go down.

Counterpart of ``gpushare_device_plugin_tpu/utils/circuit.py``. The KV
handoff's peer client wraps every transfer verb in one: after
``failure_threshold`` consecutive failures the circuit opens and callers
get ``CircuitOpenError`` immediately until a half-open probe after
``reset_timeout_s`` succeeds and closes it again, so a dead decode tier
fails fast instead of serializing full retry ladders per page.

Classic three-state machine:

    CLOSED --(N consecutive failures)--> OPEN
    OPEN   --(reset_timeout elapsed)---> HALF_OPEN (one probe admitted)
    HALF_OPEN --success--> CLOSED | --failure--> OPEN

State is exported as ``tpushare_circuit_state`` (0 closed / 1 half-open /
2 open) plus transition and fast-fail counters.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .log import get_logger
from .metric_catalog import (
    CIRCUIT_FASTFAIL_TOTAL,
    CIRCUIT_STATE,
    CIRCUIT_TRANSITIONS_TOTAL,
)
from .metrics import REGISTRY
from .lockrank import make_lock

log = get_logger("utils.circuit")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Fail-fast rejection while the circuit is open: a client-side
    refusal to dial a known-down endpoint, which retry loops must not
    retry."""

    def __init__(self, name: str, retry_after_s: float) -> None:
        super().__init__(
            f"circuit '{name}' open: peer unreachable, "
            f"failing fast (next probe in {retry_after_s:.1f}s)"
        )
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(
        self,
        name: str = "peer",
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self._threshold = failure_threshold
        self._reset_timeout = reset_timeout_s
        self._clock = clock
        self._lock = make_lock("circuit.breaker")
        self._state = CLOSED
        self._failures = 0  # consecutive
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._export()

    # ------------------------------------------------------------------

    def _export(self) -> None:
        REGISTRY.gauge_set(
            CIRCUIT_STATE,
            _STATE_VALUE[self._state],
            "Breaker state: 0 closed, 1 half-open, 2 open",
            breaker=self.name,
        )

    def _transition(self, state: str) -> None:
        """Caller must hold self._lock."""
        if state == self._state:
            return
        log.warning("circuit '%s': %s -> %s", self.name, self._state, state)
        self._state = state
        REGISTRY.counter_inc(
            CIRCUIT_TRANSITIONS_TOTAL,
            "Breaker state transitions",
            breaker=self.name, to=state,
        )
        self._export()

    @property
    def state(self) -> str:
        with self._lock:
            # surface OPEN->HALF_OPEN eligibility without requiring a call
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self._reset_timeout
            ):
                return HALF_OPEN
            return self._state

    # ------------------------------------------------------------------

    def before(self) -> None:
        """Gate one call. Raises ``CircuitOpenError`` when open; admits a
        single probe when the reset window has elapsed."""
        with self._lock:
            if self._state == CLOSED:
                return
            elapsed = self._clock() - self._opened_at
            if self._state == OPEN and elapsed >= self._reset_timeout:
                self._transition(HALF_OPEN)
                self._probe_in_flight = False
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True  # this caller is the probe
                return
            REGISTRY.counter_inc(
                CIRCUIT_FASTFAIL_TOTAL,
                "Calls rejected while the circuit was open",
                breaker=self.name,
            )
            raise CircuitOpenError(
                self.name, max(0.0, self._reset_timeout - elapsed)
            )

    def call(self, fn: Callable) -> Any:
        """:meth:`before` and the outcome's accounting around one callable
        (an exception is a failure, a return a success)."""
        self.before()
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_in_flight = False
            if self._state == HALF_OPEN or self._failures >= self._threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)
