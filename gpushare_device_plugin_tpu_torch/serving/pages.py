"""Paged KV-cache page allocator and slice-aware paged-pool sizing.

Counterpart of ``gpushare_device_plugin_tpu/serving/pages.py``:

- :class:`PageAllocator`: fixed-size KV pages handed out O(1) from a
  free-list stack and returned O(1) on release. Pages are reference
  counted, so the radix prefix cache (``radix.py``) can share one
  physical page between requests whose prompts agree on its tokens; a
  page returns to the free list when its last reference drops.
- :class:`PagedPlan` / :func:`paged_plan_for_slice`: the sizing math that
  turns a byte slice into (dispatch slots, page count), with the page
  tables, the free list, a speculative engine's draft KV pool and a
  multi-LoRA engine's adapter slab charged against the same budget.

On the device the cache is ``[L, pages, page_size, Hkv, Dh]``; page id
:data:`SCRATCH` (0) is the write sink of idle rows, never allocated and
never read (``workloads/generate.py``). The allocator hands out ids
``1..total_pages``.

The counters sit behind a lock (rank ``serving.pages``) because a metrics
scrape may read them from another thread and the KV handoff's staging
ledger allocates under its own lock; :meth:`PageAllocator.publish`
exports occupancy to ``/metrics``.
"""

from __future__ import annotations

import dataclasses

from ..utils.lockrank import make_lock
from ..utils.metric_catalog import (
    ENGINE_KV_PAGES_FREE,
    ENGINE_KV_PAGES_TOTAL,
    ENGINE_KV_PAGES_USED,
)
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..workloads.generate import SCRATCH  # noqa: F401  (re-exported)

# Host bookkeeping bytes charged per page against the slice budget: a
# free-list slot plus a refcount entry.
FREELIST_BYTES_PER_PAGE = 8


class PageAllocator:
    """O(1) free-list allocator over ``total_pages`` KV pages with
    per-page reference counts. ``alloc`` is all-or-nothing; ``share`` adds
    a reference; ``release`` drops one and recycles the page at zero."""

    def __init__(self, total_pages: int) -> None:
        if total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got {total_pages}")
        self._lock = make_lock("serving.pages")
        self.total = total_pages
        # Stack of free ids (1..total; SCRATCH is never handed out).
        self._free: list[int] = list(range(total_pages, 0, -1))
        self._refs: dict[int, int] = {}
        self.alloc_count = 0
        self.free_count_total = 0
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self.total - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages (refcount 1 each), or None when the free list
        cannot cover all of them."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        with self._lock:
            if n > len(self._free):
                return None
            got = [self._free.pop() for _ in range(n)]
            for p in got:
                self._refs[p] = 1
            self.alloc_count += n
            self.high_water = max(self.high_water, self.total - len(self._free))
            return got

    def share(self, pages: list[int] | tuple[int, ...]) -> None:
        """Add one reference to each page (a prefix-cache hit, or the
        radix tree adopting a retiring request's prompt pages)."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"share of unallocated page {p}")
                self._refs[p] += 1

    def release(self, pages: list[int] | tuple[int, ...]) -> None:
        """Drop one reference from each page; a page whose count reaches
        zero returns to the free list."""
        with self._lock:
            for p in pages:
                refs = self._refs.get(p)
                if refs is None:
                    raise ValueError(f"release of unallocated page {p}")
                if refs == 1:
                    del self._refs[p]
                    self._free.append(p)
                    self.free_count_total += 1
                else:
                    self._refs[p] = refs - 1

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def freeable(self, groups: list[list[int]]) -> int:
        """How many pages would return to the free list if every listed
        reference were released: each inner list is one holder's pages (a
        preemption victim's row, the radix tree's cached set); a page
        frees only when the groups cover all its references. The paged
        engine gates eviction and preemption on this, so it never destroys
        a cache or a victim's progress for a grant that would still fail."""
        counts: dict[int, int] = {}
        for group in groups:
            for p in group:
                counts[p] = counts.get(p, 0) + 1
        with self._lock:
            return sum(1 for p, c in counts.items() if self._refs.get(p, 0) <= c)

    def reset_stats(self) -> None:
        """Zero the cumulative counters and restart the high-water mark
        from the current use (engine warmup); the free list and live
        refcounts are untouched."""
        with self._lock:
            self.alloc_count = 0
            self.free_count_total = 0
            self.high_water = self.total - len(self._free)

    def publish(self, registry: MetricsRegistry = REGISTRY, pod: str = "") -> None:
        """Export the occupancy gauges (read under the lock, written to
        the registry outside it)."""
        with self._lock:
            free = len(self._free)
        labels = {"pod": pod} if pod else {}
        registry.gauge_set(ENGINE_KV_PAGES_TOTAL, self.total, "KV page-pool capacity (pages)",
                           **labels)
        registry.gauge_set(ENGINE_KV_PAGES_FREE, free, "KV pages on the free list", **labels)
        registry.gauge_set(ENGINE_KV_PAGES_USED, self.total - free,
                           "KV pages referenced by live requests or the prefix cache", **labels)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """A paged pool sized to a byte budget: ``slots`` dispatch rows over
    ``total_pages`` KV pages of ``page_size`` positions. Weights +
    ``kv_bytes`` (pages incl. the scratch page) + ``table_bytes`` (int32
    page tables + per-row len) + ``freelist_bytes`` never exceed the slice
    at the chosen headroom. ``draft_*`` is a speculative engine's draft
    KV pool (``draft_cfg``), indexed by the same page ids: every page then
    costs ``page_bytes + draft_page_bytes``, and ``draft_bytes`` is the
    whole draft pool with its scratch page. ``adapter_*`` is the
    multi-LoRA slab (``lora=True``), one row per page. Both are 0 for plans
    sized without them."""

    slots: int
    total_pages: int
    page_size: int
    page_bytes: int
    kv_bytes: int
    table_bytes: int
    freelist_bytes: int
    draft_page_bytes: int = 0
    draft_bytes: int = 0
    adapter_page_bytes: int = 0
    adapter_bytes: int = 0

    @property
    def max_pages_per_row(self) -> int:
        """The page-table width the planner gave each row (``table_bytes``
        is ``slots * (max_pages * 4 + 4)``); 0 without slots."""
        if self.slots == 0:
            return 0
        return (self.table_bytes // self.slots - 4) // 4

    @property
    def pool_bytes(self) -> int:
        """Everything the paged pool itself pins against the slice."""
        return (
            self.kv_bytes + self.table_bytes + self.freelist_bytes
            + self.draft_bytes + self.adapter_bytes
        )


def pages_for(length: int, page_size: int) -> int:
    """Pages covering ``length`` positions (ceil)."""
    return -(-length // page_size)


def row_span_for(max_len: int, prefill_chunk: int) -> int:
    """Logical positions one request's page table spans: ``max_len``
    rounded up to a prefill-chunk multiple, so a final chunk's pad tail
    maps to SCRATCH entries. The engine and the sizing math both call
    here, so they charge the same width."""
    return -(-max_len // prefill_chunk) * prefill_chunk


def paged_plan_for_slice(
    slice_bytes: int,
    cfg,
    max_len: int,
    *,
    page_size: int,
    weight_bytes: int,
    prefill_chunk: int = 1,
    kv_dtype: str | None = None,
    headroom: float = 0.90,
    slots: int | None = None,
    n_chips: int = 1,
    draft_cfg=None,
    draft_weight_bytes: int = 0,
    lora: bool = False,
) -> PagedPlan:
    """Size a paged pool for a ``slice_bytes`` device-memory slice, with
    the reference's arithmetic: weights come off the top, ``headroom``
    covers activations and workspace, the rest buys KV pages (plus one
    scratch page) with page tables and free list charged against it.
    ``slots`` defaults to 4x what the contiguous slot math would grant,
    capped at the page count. ``n_chips > 1`` sizes over a gang's
    per-chip share: page bytes and weights divide by the gang size when
    the kv heads do (as :func:`~.engine.slots_for_gang`). ``draft_cfg``
    sizes a speculative engine's draft pool too: the draft's weights
    (``draft_weight_bytes``) come off the top with the target's, and every
    page (the scratch page included) also pays the draft's KV bytes for
    its ``page_size`` positions; over a gang those bytes and the draft's
    weights divide by its size only when ``draft_cfg.kv_heads`` does.
    ``lora=True``
    sizes the multi-LoRA adapter slab too: every page (the scratch page
    included) also pays for ``page_size * d_model`` f32 slab floats, the
    same page-id space as the KV pool; over a gang those bytes divide by
    its size only when ``d_model`` does.
    ``total_pages == 0`` means the slice cannot hold one page."""
    # Late import: engine imports this module; the per-page byte math
    # lives there (kv_slot_bytes).
    from .engine import kv_slot_bytes

    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if max_len < page_size:
        raise ValueError(f"max_len {max_len} smaller than page_size {page_size}")
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom must be in (0, 1], got {headroom}")
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    page_b = kv_slot_bytes(cfg, page_size, kv_dtype)
    row_b = kv_slot_bytes(cfg, max_len, kv_dtype)
    if n_chips > 1 and cfg.kv_heads % n_chips == 0:
        page_b = -(-page_b // n_chips)
        row_b = -(-row_b // n_chips)
        weight_bytes = -(-weight_bytes // n_chips)
    dpage_b = 0
    if draft_cfg is not None:
        if draft_weight_bytes < 0:
            raise ValueError(f"draft_weight_bytes must be >= 0, got {draft_weight_bytes}")
        dpage_b = kv_slot_bytes(draft_cfg, page_size, kv_dtype)
        if n_chips > 1 and draft_cfg.kv_heads % n_chips == 0:
            dpage_b = -(-dpage_b // n_chips)
            draft_weight_bytes = -(-draft_weight_bytes // n_chips)
        weight_bytes += draft_weight_bytes
    apage_b = 0
    if lora:
        apage_b = page_size * cfg.d_model * 4  # f32 slab floats per page
        if n_chips > 1 and cfg.d_model % n_chips == 0:
            apage_b = -(-apage_b // n_chips)
    max_pages = pages_for(row_span_for(max_len, prefill_chunk), page_size)

    def zero() -> PagedPlan:
        return PagedPlan(0, 0, page_size, page_b, 0, 0, 0, draft_page_bytes=dpage_b,
                         adapter_page_bytes=apage_b)

    usable = int(slice_bytes * headroom) - weight_bytes
    if usable <= 0:
        return zero()

    def pages_at(n_slots: int) -> int:
        table = n_slots * (max_pages * 4 + 4)
        # the scratch page off the top (target and draft KV, slab row),
        # then each page costs its bytes in every pool plus its free-list
        # share
        left = usable - table - (page_b + dpage_b + apage_b)
        if left <= 0:
            return 0
        return left // (page_b + dpage_b + apage_b + FREELIST_BYTES_PER_PAGE)

    if slots is None:
        contiguous = max(usable // row_b, 1)
        slots = max(1, min(pages_at(1), 4 * contiguous))
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    pages = pages_at(slots)
    # More rows than pages is dead weight; shrinking slots only grows
    # pages, so one clamp and recompute converges.
    if pages and slots > pages:
        slots = pages
        pages = pages_at(slots)
    if pages < 1:
        return zero()
    return PagedPlan(
        slots=int(slots),
        total_pages=int(pages),
        page_size=page_size,
        page_bytes=page_b,
        kv_bytes=(int(pages) + 1) * page_b,
        table_bytes=int(slots) * (max_pages * 4 + 4),
        freelist_bytes=int(pages) * FREELIST_BYTES_PER_PAGE,
        draft_page_bytes=dpage_b,
        draft_bytes=(int(pages) + 1) * dpage_b,
        adapter_page_bytes=apage_b,
        adapter_bytes=(int(pages) + 1) * apage_b,
    )
