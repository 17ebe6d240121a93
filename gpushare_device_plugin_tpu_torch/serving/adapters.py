"""Refcounted LRU cache of paged LoRA adapters for the serving engine.

Counterpart of ``gpushare_device_plugin_tpu/serving/adapters.py``
(:class:`AdapterCache`, with :meth:`AdapterCache.publish` of its
residency gauges to ``/metrics``).
Many tenants' fine-tunes share one base model: each adapter is one flat
f32 vector (``workloads/lora.py::flatten_lora``) striped across
``pages_per_adapter`` pages of the same refcounted
:class:`~.pages.PageAllocator` that holds the KV pages, and every
dispatch gathers each row's adapter through a page table
(``workloads/generate.py::lora_bgmv_views``).

This module is the host's residency ledger; the engine owns the device
slab and writes its rows.

- **Pinned while used, LRU when idle.** :meth:`AdapterCache.acquire`
  pins an adapter for one row, loading it on a miss; :meth:`release`
  unpins it on retire, preemption or drain. An unpinned adapter stays
  resident (the next request for it is a hit) until page pressure evicts
  it, least recently acquired first.
- **The first rung of the eviction ladder.** An adapter load may evict
  other idle adapters, never radix pages or rows. KV allocation reclaims
  idle adapters before radix pages (the engine's ``try_pages``): an
  adapter is one reload from the store away, a cached prefix a
  re-prefill. A best-effort requester cannot evict an adapter a
  latency-critical request used last (the tier shield).

Pins are the cache's own: the allocator holds exactly one reference per
resident adapter page, held by this cache, and a pinned adapter is left
out of :meth:`evictable` and :meth:`evict`. Everything sits behind one
lock, because a metrics scrape may read occupancy from another thread.
"""

from __future__ import annotations

import dataclasses
import threading

from ..const import WORKLOAD_LATENCY_CRITICAL
from ..utils.metric_catalog import (
    ENGINE_ADAPTER_CACHE_PAGES,
    ENGINE_ADAPTER_EVICTIONS_TOTAL,
    ENGINE_ADAPTER_HITS_TOTAL,
    ENGINE_ADAPTER_MISSES_TOTAL,
    ENGINE_ADAPTER_RESIDENT,
)
from ..utils.metrics import REGISTRY, MetricsRegistry
from .pages import PageAllocator


@dataclasses.dataclass
class _Entry:
    """One resident adapter: its slab pages in stripe order, how many rows
    pin it, when it was last acquired, and whether a latency-critical
    request used it last (the shield best-effort eviction respects)."""

    pages: list[int]
    pins: int = 0
    last_use: int = 0
    critical: bool = False


class AdapterCache:
    """Residency table: adapter id -> slab pages and pins.

    ``acquire`` returns ``(pages, loaded)``; ``loaded=True`` means the
    pages are fresh and the caller must write the adapter's flat vector
    into those slab rows (in list order) before any row runs against it.
    ``None`` means the pool cannot hold the adapter even after evicting
    everything this requester's tier may touch: the engine leaves the
    request queued and retries."""

    def __init__(self, allocator: PageAllocator, pages_per_adapter: int) -> None:
        if pages_per_adapter < 1:
            raise ValueError(f"pages_per_adapter must be >= 1, got {pages_per_adapter}")
        self._lock = threading.Lock()
        self._alloc = allocator
        self.pages_per_adapter = pages_per_adapter
        self._entries: dict[str, _Entry] = {}
        self._clock = 0
        # telemetry (cumulative; reset_stats zeroes it after warmup)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- residency ------------------------------------------------------------

    @property
    def resident_count(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def cached_pages(self) -> int:
        with self._lock:
            return len(self._entries) * self.pages_per_adapter

    def resident(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._entries

    def pins(self, adapter_id: str) -> int:
        with self._lock:
            e = self._entries.get(adapter_id)
            return 0 if e is None else e.pins

    def pages_of(self, adapter_id: str) -> list[int] | None:
        """The adapter's slab pages in stripe order (None if absent)."""
        with self._lock:
            e = self._entries.get(adapter_id)
            return None if e is None else list(e.pages)

    def pages(self) -> list[int]:
        """Every page the cache holds, pinned or not."""
        with self._lock:
            return [p for e in self._entries.values() for p in e.pages]

    # -- pins -----------------------------------------------------------------

    def acquire(
        self, adapter_id: str, *, tier: str = WORKLOAD_LATENCY_CRITICAL
    ) -> tuple[list[int], bool] | None:
        """Pin ``adapter_id`` for one row, loading it if absent.

        Hit: one more pin, the LRU clock bumped, ``(pages, False)``. Miss:
        ``pages_per_adapter`` fresh pages, evicting idle LRU adapters this
        ``tier`` may claim while the free list is short, and ``(pages,
        True)`` with the pin taken. ``None``: no room; nothing is counted,
        so a stalled head retrying every turn does not inflate the miss
        count (the miss counts once, when the load lands)."""
        if not adapter_id:
            raise ValueError("adapter_id must be non-empty")
        critical = tier == WORKLOAD_LATENCY_CRITICAL
        with self._lock:
            self._clock += 1
            e = self._entries.get(adapter_id)
            if e is not None:
                e.pins += 1
                e.last_use = self._clock
                e.critical = e.critical or critical
                self.hits += 1
                return list(e.pages), False
            got = self._alloc.alloc(self.pages_per_adapter)
            while got is None:
                if not self._evict_one_locked(critical):
                    return None
                got = self._alloc.alloc(self.pages_per_adapter)
            self._entries[adapter_id] = _Entry(
                pages=got, pins=1, last_use=self._clock, critical=critical
            )
            self.misses += 1
            return list(got), True

    def release(self, adapter_id: str) -> None:
        """Drop one row's pin. The adapter stays resident, evictable at
        zero pins."""
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None or e.pins < 1:
                raise ValueError(f"release of unpinned adapter {adapter_id!r}")
            e.pins -= 1

    # -- eviction -------------------------------------------------------------

    def _victims_locked(self, critical: bool) -> list[tuple[str, _Entry]]:
        """Unpinned entries this requester tier may evict, LRU first."""
        out = [
            (aid, e) for aid, e in self._entries.items()
            if e.pins == 0 and (critical or not e.critical)
        ]
        out.sort(key=lambda kv: kv[1].last_use)
        return out

    def _evict_one_locked(self, critical: bool) -> bool:
        victims = self._victims_locked(critical)
        if not victims:
            return False
        aid, e = victims[0]
        del self._entries[aid]
        self._alloc.release(e.pages)
        self.evictions += 1
        return True

    def evictable(self, *, tier: str = WORKLOAD_LATENCY_CRITICAL) -> list[list[int]]:
        """Page groups, one per adapter a ``tier`` requester could evict:
        the input of the allocator's ``freeable`` gate."""
        critical = tier == WORKLOAD_LATENCY_CRITICAL
        with self._lock:
            return [list(e.pages) for _, e in self._victims_locked(critical)]

    def evict(self, n_pages: int, *, tier: str = WORKLOAD_LATENCY_CRITICAL) -> int:
        """Evict idle LRU adapters, whole ones only, until at least
        ``n_pages`` pages went back or nothing ``tier`` may touch is left.
        Returns the pages released."""
        if n_pages <= 0:
            return 0
        critical = tier == WORKLOAD_LATENCY_CRITICAL
        released = 0
        with self._lock:
            while released < n_pages:
                if not self._evict_one_locked(critical):
                    break
                released += self.pages_per_adapter
        return released

    def clear(self) -> int:
        """Release every unpinned adapter (the engine's warmup flush);
        pinned ones stay. Returns the pages released."""
        with self._lock:
            victims = [(aid, e) for aid, e in self._entries.items() if e.pins == 0]
            for aid, e in victims:
                del self._entries[aid]
                self._alloc.release(e.pages)
            return len(victims) * self.pages_per_adapter

    # -- telemetry ------------------------------------------------------------

    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        """Zero hits, misses and evictions (engine warmup); residency is
        untouched."""
        with self._lock:
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "resident": len(self._entries),
                "cached_pages": len(self._entries) * self.pages_per_adapter,
                "pinned": sum(1 for e in self._entries.values() if e.pins),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_ratio": self.hits / total if total else 0.0,
            }

    def publish(self, registry: MetricsRegistry = REGISTRY, pod: str = "") -> None:
        """Export the residency gauges (read under the lock, written to the
        registry outside it). The engine publishes the hit, miss and
        eviction counters and the miss-stall histogram itself."""
        with self._lock:
            resident = len(self._entries)
        labels = {"pod": pod} if pod else {}
        registry.gauge_set(ENGINE_ADAPTER_RESIDENT, resident,
                           "LoRA adapters resident in the paged slab", **labels)
        registry.gauge_set(ENGINE_ADAPTER_CACHE_PAGES, resident * self.pages_per_adapter,
                           "Pool pages holding resident LoRA adapters", **labels)


# The counter families the engine publishes for this cache
# (``PagedSlotEngine._publish_adapters``), for callers that parse them
# without importing the engine.
ADAPTER_COUNTER_FAMILIES = (
    ENGINE_ADAPTER_HITS_TOTAL,
    ENGINE_ADAPTER_MISSES_TOTAL,
    ENGINE_ADAPTER_EVICTIONS_TOTAL,
)
