"""Best-effort step-rate governor: the reaction half of the interference
plane.

Counterpart of ``gpushare_device_plugin_tpu/serving/governor.py``. A
best-effort tenant shares the card with a latency-critical one without
touching it: its engine paces its own dispatches while the critical
tenant is in danger (Tally, PAPERS.md 2410.07381). This is a **token
bucket on model dispatches**: the engine calls
:meth:`StepGovernor.before_step` before each dispatch; while engaged,
each dispatch takes a token refilled at ``throttled_steps_per_s`` and a
dry bucket sleeps the host loop until the next token accrues. While
released, ``before_step`` is a counter bump and a compare.

- **Engage** as soon as ``burn_fn()`` reports page severity (one poll
  per ``poll_interval_steps`` dispatches, since the signal takes a lock).
- **Release hysteretically**: only after ``release_after`` clean polls
  in a row, so a budget flapping at the threshold does not make the
  throttle oscillate.

Every transition shows: a ``governor.engage`` / ``governor.release``
span, the ``tpushare_governor_engagements_total`` counter, the
``tpushare_governor_engaged{pod}`` gauge, and
``tpushare_governor_throttled_steps_total`` /
``tpushare_governor_throttle_seconds_total`` for the imposed sleep.

The governor only delays dispatches: it never reorders, drops or alters
one, so tokens stay those of the ungoverned engine and the shape guard
stays put. Its state belongs to the engine's thread (no lock); only
``burn_fn`` crosses threads. On the card the sleep also releases
Python's GIL, which a co-resident engine in the same process then takes.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from ..utils.metric_catalog import (
    GOVERNOR_ENGAGED as ENGAGED_GAUGE,
    GOVERNOR_ENGAGEMENTS_TOTAL as ENGAGEMENTS_TOTAL,
    GOVERNOR_THROTTLE_SECONDS_TOTAL as THROTTLE_SECONDS_TOTAL,
    GOVERNOR_THROTTLED_STEPS_TOTAL as THROTTLED_STEPS_TOTAL,
)
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.tracing import TRACER

log = logging.getLogger(__name__)


class StepGovernor:
    """Token-bucket throttle on a best-effort engine's dispatches.

    ``burn_fn() -> str | None`` gives the co-resident critical tier's
    severity (``utils.slo.SloBudget.severity`` or any callable);
    ``"page"`` engages (``engage_on="warn"`` engages on warn too).
    ``clock`` and ``sleep`` are injectable so tests drive the bucket
    without waiting.
    """

    def __init__(
        self,
        burn_fn: Callable[[], str | None],
        *,
        throttled_steps_per_s: float = 20.0,
        burst: float = 2.0,
        poll_interval_steps: int = 8,
        release_after: int = 3,
        engage_on: str = "page",
        pod: str = "",
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if throttled_steps_per_s <= 0:
            raise ValueError(f"throttled_steps_per_s must be > 0, got {throttled_steps_per_s}")
        if burst <= 0:
            raise ValueError(f"burst must be > 0, got {burst}")
        if poll_interval_steps < 1:
            raise ValueError(f"poll_interval_steps must be >= 1, got {poll_interval_steps}")
        if release_after < 1:
            raise ValueError(f"release_after must be >= 1, got {release_after}")
        self._burn_fn = burn_fn
        self._rate = throttled_steps_per_s
        # burst is the bucket's cap: below 1.0 the bucket never holds a
        # whole token, so an engaged engine waits before every dispatch and
        # an idle gap cannot bank a free one
        self._burst = float(burst)
        self._poll_every = poll_interval_steps
        self._release_after = release_after
        self._engage_on = engage_on
        self._pod = pod
        self._reg = registry if registry is not None else REGISTRY
        self._clock = clock
        self._sleep = sleep
        self.engaged = False
        self.engagements = 0
        self.throttled_steps = 0
        self.throttle_seconds = 0.0
        self._steps_since_poll = 0
        self._clean_polls = 0
        self._tokens = self._burst
        self._last_refill = clock()
        self._engaged_at = 0.0
        self._last_severity: str | None = None

    def _severity_engages(self, severity: str | None) -> bool:
        if severity is None:
            return False
        if self._engage_on == "warn":
            return severity in ("warn", "page")
        return severity == "page"

    def _labels(self) -> dict[str, str]:
        return {"pod": self._pod} if self._pod else {}

    def _engage(self, severity: str) -> None:
        self.engaged = True
        self.engagements += 1
        self._clean_polls = 0
        # the bucket starts empty: the critical tier burns now, so the
        # first engaged dispatch already waits
        self._tokens = 0.0
        self._last_refill = self._clock()
        self._engaged_at = self._last_refill
        labels = self._labels()
        self._reg.counter_inc(
            ENGAGEMENTS_TOTAL, "Times the best-effort governor engaged its step throttle",
            **labels,
        )
        self._reg.gauge_set(
            ENGAGED_GAUGE, 1.0, "Whether the best-effort step throttle is currently engaged",
            **labels,
        )
        with TRACER.span("governor.engage", attributes={
            "severity": severity, "pod": self._pod, "throttled_steps_per_s": self._rate,
        }):
            pass
        log.info("governor engaged (severity=%s): best-effort dispatches throttled to "
                 "%.1f steps/s", severity, self._rate)

    def _release(self) -> None:
        engaged_s = self._clock() - self._engaged_at
        self.engaged = False
        self._reg.gauge_set(
            ENGAGED_GAUGE, 0.0, "Whether the best-effort step throttle is currently engaged",
            **self._labels(),
        )
        with TRACER.span("governor.release",
                         attributes={"pod": self._pod, "engaged_s": round(engaged_s, 3)}):
            pass
        log.info("governor released after %.2fs (%d clean polls)", engaged_s,
                 self._release_after)

    def poll(self) -> None:
        """Read the burn signal and update the engage state (also called
        every ``poll_interval_steps`` dispatches)."""
        severity = self._burn_fn()
        self._last_severity = severity
        if self._severity_engages(severity):
            self._clean_polls = 0
            if not self.engaged:
                self._engage(severity or "")
        elif self.engaged:
            self._clean_polls += 1
            if self._clean_polls >= self._release_after:
                self._release()

    def before_step(self) -> float:
        """Called by the engine before each dispatch. Returns the seconds
        slept (0.0 when released). Never raises and never skips the
        dispatch: it only delays it."""
        self._steps_since_poll += 1
        if self._steps_since_poll >= self._poll_every:
            self._steps_since_poll = 0
            self.poll()
        if not self.engaged:
            return 0.0
        now = self._clock()
        self._tokens = min(self._burst, self._tokens + (now - self._last_refill) * self._rate)
        self._last_refill = now
        slept = 0.0
        if self._tokens < 1.0:
            wait = (1.0 - self._tokens) / self._rate
            self._sleep(wait)
            slept = wait
            now = self._clock()
            self._tokens = min(self._burst, self._tokens + (now - self._last_refill) * self._rate)
            self._last_refill = now
            self.throttled_steps += 1
            self.throttle_seconds += slept
            labels = self._labels()
            self._reg.counter_inc(
                THROTTLED_STEPS_TOTAL, "Decode iterations delayed by the best-effort governor",
                **labels,
            )
            self._reg.counter_inc(
                THROTTLE_SECONDS_TOTAL, "Cumulative seconds of governor-imposed decode delay",
                value=slept, **labels,
            )
        self._tokens = max(0.0, self._tokens - 1.0)
        return slept

    def stats(self) -> dict[str, float | int | bool | None]:
        """A snapshot for a report row."""
        return {
            "engaged": self.engaged,
            "engagements": self.engagements,
            "throttled_steps": self.throttled_steps,
            "throttle_seconds": round(self.throttle_seconds, 4),
            "last_severity": self._last_severity,
        }
