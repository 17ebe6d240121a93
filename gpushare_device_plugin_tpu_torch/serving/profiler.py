"""Per-decode-step wall-time profiler of the serving engine.

Counterpart of ``gpushare_device_plugin_tpu/serving/profiler.py``: the
ceil-rank quantile convention, and the bounded ring with rolling
quantiles and each step's tokens per row (1 for a plain decode step,
the batch mean for a speculative round), and :meth:`StepProfiler.flush`,
which exports the samples since the last flush to ``/metrics`` as the
``tpushare_engine_step_seconds`` histogram and the rolling p50/p99
gauges; the engine flushes once per run, never per step.
"""

from __future__ import annotations

import math

from ..utils.lockrank import make_lock
from ..utils.metric_catalog import ENGINE_STEP_P50_SECONDS as P50_GAUGE
from ..utils.metric_catalog import ENGINE_STEP_P99_SECONDS as P99_GAUGE
from ..utils.metric_catalog import ENGINE_STEP_SECONDS as STEP_METRIC
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.tracing import TRACER

STEP_HELP = (
    "Wall seconds per pool-wide decode step (one model dispatch advancing "
    "every occupied slot)"
)
# Log-spaced from 0.1 ms to 1 s.
STEP_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0,
)


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
        self._lock = make_lock("serving.profiler")
        self._ring: list[float] = [0.0] * capacity
        self._tokens: list[float] = [1.0] * capacity
        self._cap = capacity
        self._count = 0  # steps ever recorded
        self._flushed = 0  # steps already exported

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
            self._flushed = 0

    def flush(self, registry: MetricsRegistry | None = None, pod: str = "") -> int:
        """Export every sample recorded since the last flush into the
        ``tpushare_engine_step_seconds`` histogram, and the rolling p50 and
        p99 gauges; returns the samples exported. The writes run inside a
        ``serve.step_flush`` span, so the buckets carry a trace-id
        exemplar. Samples that fell off the ring between flushes are
        skipped and counted in the span's ``dropped``. Without a ``pod``
        label nothing is exported (the samples are consumed all the
        same): an unlabeled series would merge every label-less engine of
        the process."""
        reg = registry if registry is not None else REGISTRY
        with self._lock:
            count = self._count
            start = max(self._flushed, count - self._cap)
            dropped = start - self._flushed
            samples = [self._ring[i % self._cap] for i in range(start, count)]
            self._flushed = count
        if not pod:
            return 0
        if samples:
            with TRACER.span("serve.step_flush",
                             attributes={"steps": len(samples), "dropped": dropped}):
                for s in samples:
                    reg.observe(STEP_METRIC, s, STEP_HELP, buckets=STEP_BUCKETS, pod=pod)
        p50, p99 = self.p50(), self.p99()
        if p50 == p50:  # not nan
            reg.gauge_set(P50_GAUGE, p50,
                          "Rolling p50 decode-step wall seconds (profiler window)", pod=pod)
        if p99 == p99:
            reg.gauge_set(P99_GAUGE, p99,
                          "Rolling p99 decode-step wall seconds (profiler window)", pod=pod)
        return len(samples)
