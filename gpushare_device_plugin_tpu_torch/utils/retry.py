"""Bounded-retry helper with exponential backoff, full jitter, deadlines.

Counterpart of ``gpushare_device_plugin_tpu/utils/retry.py`` (its
:func:`retry`; the loop-shaped ``Backoff`` has no caller in the port).
Each call site states its budget declaratively:

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
