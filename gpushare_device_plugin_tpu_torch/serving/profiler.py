"""Per-decode-step wall-time profiler of the serving engine.

Counterpart of ``gpushare_device_plugin_tpu/serving/profiler.py``: the
ceil-rank quantile convention, and the bounded ring with rolling
quantiles and each step's tokens per row (1 for a plain decode step,
the batch mean for a speculative round). The ``/metrics`` export is not
ported yet.
"""

from __future__ import annotations

import math
import threading


def ceil_rank_quantile(vals: list[float], q: float) -> float:
    """Ceil-rank quantile over an unsorted sample list (nan when empty)."""
    s = sorted(vals)
    if not s:
        return float("nan")
    return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]


class StepProfiler:
    """Bounded ring of per-decode-step wall times with rolling quantiles
    over the newest ``capacity`` steps. One writer (the engine's host
    loop), any number of readers."""

    def __init__(self, capacity: int = 1024) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._ring: list[float] = [0.0] * capacity
        self._tokens: list[float] = [1.0] * capacity
        self._cap = capacity
        self._count = 0

    def record(self, seconds: float, tokens: float = 1.0) -> None:
        """One step's wall time and the tokens it emitted per row (more
        than 1 when a speculative verify accepted a run)."""
        with self._lock:
            self._ring[self._count % self._cap] = seconds
            self._tokens[self._count % self._cap] = tokens
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def window(self) -> list[float]:
        """The rolling window's samples, unordered."""
        with self._lock:
            return self._ring[: min(self._count, self._cap)]

    def tokens_per_step(self) -> float:
        """Mean tokens per row per step over the window: 1.0 for a plain
        engine, the mean emitted run when speculative rounds dominate;
        nan with no samples."""
        with self._lock:
            n = min(self._count, self._cap)
            return sum(self._tokens[:n]) / n if n else float("nan")

    def quantile(self, q: float) -> float:
        return ceil_rank_quantile(self.window(), q)

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    def reset(self) -> None:
        """Forget all samples (after the engine's warmup)."""
        with self._lock:
            self._count = 0
