"""Bounded-retry helper with exponential backoff, full jitter, deadlines.

Counterpart of ``gpushare_device_plugin_tpu/utils/retry.py``: :func:`retry`,
and :class:`Backoff` for supervised loops (the health watcher's).
Each call site of :func:`retry` states its budget declaratively:

- exponential backoff (``backoff`` multiplier per attempt, capped at
  ``max_delay_s``),
- full jitter (sleep ``uniform(0, current_delay)``),
- a per-call ``deadline_s`` so a caller with an SLA gets an error while
  the answer still matters, instead of a success that arrives after it
  gave up.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

T = TypeVar("T")


class RetryError(RuntimeError):
    def __init__(self, attempts: int, last: Exception, deadline: bool = False) -> None:
        why = "deadline exceeded after" if deadline else "all"
        super().__init__(f"{why} {attempts} attempts failed: {last}")
        self.attempts = attempts
        self.last = last
        self.deadline_exceeded = deadline


class Backoff:
    """Full-jitter exponential delays for supervised loops.

    ``next()`` returns ``uniform(0, min(max_s, base_s * factor**n))`` and
    advances; ``reset()`` on success snaps back to the base so a recovered
    dependency is re-engaged promptly.
    """

    def __init__(
        self,
        base_s: float = 0.1,
        max_s: float = 5.0,
        factor: float = 2.0,
        rng: random.Random | None = None,
    ) -> None:
        self._base = base_s
        self._max = max_s
        self._factor = factor
        self._rng = rng or random.Random()
        self._n = 0

    def next(self) -> float:
        # exponent clamped: an hours-long outage must not walk the power
        # into float overflow and kill the supervised loop it paces
        cap = min(self._max, self._base * (self._factor ** min(self._n, 63)))
        self._n += 1
        return self._rng.uniform(0, cap)

    def reset(self) -> None:
        self._n = 0


def retry(
    fn: Callable[[], T],
    *,
    attempts: int,
    delay_s: float,
    backoff: float = 1.0,
    max_delay_s: float | None = None,
    jitter: bool = False,
    deadline_s: float | None = None,
    retryable: Callable[[Exception], bool] = lambda e: True,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    clock: Callable[[], float] = time.monotonic,
) -> T:
    """Call ``fn`` up to ``attempts`` times.

    Defaults preserve the fixed-delay behavior (``delay_s`` between
    tries). ``backoff > 1`` multiplies the delay per attempt, capped at
    ``max_delay_s``; ``jitter=True`` sleeps ``uniform(0, delay)`` instead
    of the full delay; ``deadline_s`` bounds total wall clock — when the
    budget is spent (or the next sleep would overrun it), the last error
    is raised as a ``RetryError`` with ``deadline_exceeded=True``.

    Only ``Exception`` is caught — KeyboardInterrupt/SystemExit propagate so
    signal handling in the daemon stays intact.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = rng or random.Random()
    start = clock()
    delay = delay_s
    last: Exception | None = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - wrapped in RetryError below
            last = e
            if not retryable(e) or i == attempts - 1:
                break
            pause = rng.uniform(0, delay) if jitter else delay
            if deadline_s is not None and (
                clock() - start + pause >= deadline_s
            ):
                raise RetryError(i + 1, last, deadline=True) from last
            sleep(pause)
            delay *= backoff
            if max_delay_s is not None:
                delay = min(delay, max_delay_s)
    assert last is not None
    raise RetryError(attempts, last) from last
