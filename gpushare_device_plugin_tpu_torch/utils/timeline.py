"""Cluster-state timeline: a compact time-bucketed ring of control-plane
health samples, exported on ``/timeline`` and embedded in flight-recorder
dumps.

Counterpart of ``gpushare_device_plugin_tpu/utils/timeline.py``, copied.
A postmortem that only captures the instant of death explains the crash;
one that carries the minutes *before* it explains the cause. The
:class:`ClusterTimeline` folds periodic samples (utilization %,
fragmentation, pending depth, SLO burn) into fixed-width time buckets
(last write per bucket wins), so an hour of history is a few hundred
floats whatever the sample rate. The ring is hard-bounded by
construction: a storm of samples can only overwrite buckets, and the
field table is capped so a storm of distinct field names cannot grow it
either.

:class:`TimelineLoop` is the daemon-side sampler: a background thread
calling injected zero-argument sources each tick, all read-only and
best-effort (a failing source skips its field, never the tick). The
port's daemon runs standalone, where nothing starts the loop (its
sources are cluster mode's); the flight recorder embeds
:meth:`ClusterTimeline.to_doc` in every dump all the same.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping

from .lockrank import make_lock
from .log import get_logger

log = get_logger("utils.timeline")

# Field-table hard bound: the sampler wires a handful of well-known
# fields; this exists so a misbehaving caller streaming unique field
# names cannot grow the ring's memory.
MAX_FIELDS = 32


class ClusterTimeline:
    """Fixed-bucket ring of named float series.

    ``bucket_s`` is the fold granularity, ``buckets`` the ring length
    (defaults: 10 s x 360 = one hour of history). Buckets between the
    last sample and ``now`` read as gaps (None), so a stalled sampler is
    visible as missing data, not as a frozen flat line."""

    def __init__(
        self,
        bucket_s: float = 10.0,
        buckets: int = 360,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {bucket_s}")
        if buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        self._lock = make_lock("timeline.ring")
        self._bucket_s = bucket_s
        self._n = buckets
        self._clock = clock
        # field -> ring of values (None = no sample landed in the bucket)
        self._fields: dict[str, list[float | None]] = {}
        self._newest: int | None = None  # absolute bucket index
        self._dropped_fields = 0

    @property
    def bucket_s(self) -> float:
        return self._bucket_s

    @property
    def span_s(self) -> float:
        return self._bucket_s * self._n

    def _advance(self, bucket: int) -> None:
        """Blank the ring positions between the newest seen bucket and
        ``bucket`` (lock held) — time that passed without samples must
        read as gaps."""
        if self._newest is None:
            self._newest = bucket
            return
        gap = bucket - self._newest
        if gap <= 0:
            return
        for ring in self._fields.values():
            for i in range(1, min(gap, self._n) + 1):
                ring[(self._newest + i) % self._n] = None
        self._newest = bucket

    def sample(self, now: float | None = None, **fields: float) -> None:
        """Fold one sample set into the current bucket (last write per
        bucket wins — the series records state, not throughput)."""
        t = self._clock() if now is None else now
        bucket = int(t / self._bucket_s)
        with self._lock:
            self._advance(bucket)
            pos = bucket % self._n
            for name, value in fields.items():
                ring = self._fields.get(name)
                if ring is None:
                    if len(self._fields) >= MAX_FIELDS:
                        self._dropped_fields += 1
                        continue
                    ring = [None] * self._n
                    self._fields[name] = ring
                ring[pos] = float(value)

    def series(self, field: str) -> list[tuple[float, float]]:
        """(bucket start unix time, value) pairs for ``field``, oldest
        first, gaps omitted."""
        with self._lock:
            ring = self._fields.get(field)
            if ring is None or self._newest is None:
                return []
            out: list[tuple[float, float]] = []
            for age in range(self._n - 1, -1, -1):
                bucket = self._newest - age
                if bucket < 0:
                    continue
                value = ring[bucket % self._n]
                if value is None:
                    continue
                out.append((bucket * self._bucket_s, value))
            return out

    def fields(self) -> list[str]:
        with self._lock:
            return sorted(self._fields)

    def to_doc(self) -> dict[str, Any]:
        """The ``/timeline`` endpoint body (also embedded in flight-
        recorder dumps): bucket geometry plus every series as
        ``[[t, v], ...]``."""
        names = self.fields()
        return {
            "bucket_s": self._bucket_s,
            "span_s": self.span_s,
            "series": {
                name: [[t, v] for t, v in self.series(name)]
                for name in names
            },
        }

    def clear(self) -> None:
        with self._lock:
            self._fields.clear()
            self._newest = None
            self._dropped_fields = 0


class TimelineLoop:
    """Background sampler feeding a :class:`ClusterTimeline` from
    injected read-only sources.

    ``sources`` maps a label -> zero-arg callable returning either a
    float (single field, named by the label), None (skip this tick), or
    a mapping of field name -> float (a MULTI-FIELD source: one
    underlying read feeds several series — e.g. one pending-pod list
    yields both the total and the gang-queue depth, instead of two
    identical LISTs per tick). Sources are best-effort: one raising or
    returning garbage skips its fields, the rest of the tick proceeds —
    a sick apiserver must not blind the whole timeline."""

    def __init__(
        self,
        timeline: ClusterTimeline,
        sources: Mapping[str, Callable[[], "float | Mapping | None"]],
        interval_s: float = 10.0,
    ) -> None:
        self._timeline = timeline
        self._sources = dict(sources)
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run_once(self) -> dict[str, float]:
        """One sampling pass (the loop body; tests drive it directly)."""
        fields: dict[str, float] = {}
        for name, fn in self._sources.items():
            try:
                value = fn()
            except Exception as e:  # noqa: BLE001 — best-effort source
                log.v(4, "timeline source %s failed: %s", name, e)
                continue
            if value is None:
                continue
            items = (
                value.items() if isinstance(value, Mapping)
                else [(name, value)]
            )
            for field, v in items:
                try:
                    fields[str(field)] = float(v)
                except (TypeError, ValueError):
                    continue
        if fields:
            self._timeline.sample(**fields)
        return fields

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.run_once()

    def start(self) -> "TimelineLoop":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="timeline-sampler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# Process-wide default timeline, mirroring metrics.REGISTRY /
# tracing.STORE / decisions.DECISIONS.
TIMELINE = ClusterTimeline()
