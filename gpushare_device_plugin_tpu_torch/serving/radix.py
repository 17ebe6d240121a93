"""Radix-tree shared-prefix cache over KV pages.

Counterpart of ``gpushare_device_plugin_tpu/serving/radix.py``. The tree
maps prompt-token sequences to the physical pages holding their KV:

- **Edges are one page wide.** Every node owns one page and the
  ``page_size`` tokens it caches; a path from the root spells a prompt
  prefix in full pages.
- **Reference counting, not copying.** :meth:`RadixCache.match` returns
  the matched pages and takes one allocator reference per page for the
  requesting row; the tree holds its own reference from
  :meth:`RadixCache.insert`. A page is recycled only when the tree evicts
  it and no live request still reads it.
- **LRU leaf eviction.** :meth:`RadixCache.evict` releases the least
  recently matched leaves first, so every cached path stays contiguous
  from the root.
- **One tree per adapter.** A page's K/V depend on the weights that
  computed it as well as on its tokens, so the cache keeps a root per
  LoRA adapter id (``""``, the default, is the base model): a page that
  one adapter's prefill wrote is matched only by requests of the same
  adapter. The roots share one ledger: :meth:`RadixCache.pages`,
  :meth:`~RadixCache.evict`, :meth:`~RadixCache.clear`, ``cached_pages``
  and the hit counters span every tree.

Sharing is then exact: a page caches positions ``[i*ps, (i+1)*ps)`` of a
prompt, and a position's K/V depend only on the weights and the tokens
at or before it, so two prompts of one adapter that agree on a page's
tokens compute the same page. (The reference keys its tree by tokens
alone, so one tenant reads pages another tenant's adapter, or the base
model, computed: ``ROADMAP.md`` §3 fault 4.)

The fleet router's affinity signal rides on the same pages:
:func:`prefix_fingerprints` chains a CRC32 over a prompt's full pages,
and :meth:`RadixCache.fingerprints` exports the same chained values for
every cached path, in every adapter's tree.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import zlib
from typing import Iterator

from .pages import PageAllocator


def prefix_fingerprints(tokens: tuple[int, ...], page_size: int) -> list[int]:
    """Chained CRC32 fingerprint of each full-page prefix of ``tokens``.

    ``fp[i]`` hashes pages ``0..i``: each page's CRC is seeded with its
    parent's, so a fingerprint commits to the whole path from the root.
    This is the request-side half of the fleet router's affinity signal;
    an engine exports the same chained values for its cached paths
    (:meth:`RadixCache.fingerprints`), and the overlap length is the
    number of pages a candidate engine would serve from cache. Tokens
    hash as 4-byte little-endian."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    out: list[int] = []
    crc = 0
    for i in range(0, len(tokens) - len(tokens) % page_size, page_size):
        chunk = tokens[i : i + page_size]
        crc = zlib.crc32(struct.pack(f"<{len(chunk)}i", *chunk), crc)
        out.append(crc)
    return out


@dataclasses.dataclass
class _Node:
    """One cached page: ``tokens`` (exactly ``page_size`` of them) keyed
    under the parent, holding physical page ``page``."""

    tokens: tuple[int, ...]
    page: int
    parent: "_Node | None"
    children: dict[tuple[int, ...], "_Node"] = dataclasses.field(default_factory=dict)
    last_use: int = 0
    adapter_id: str = ""  # the tree (root) this node hangs under


class RadixCache:
    """Page-granular radix tree over prompt-token sequences. The tree owns
    one allocator reference per cached page; ``match`` takes one more per
    matched page for the caller, who releases it on retire or eviction."""

    def __init__(self, page_size: int, allocator: PageAllocator) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._lock = threading.Lock()
        self.page_size = page_size
        self._alloc = allocator
        # adapter id -> that adapter's tree of first pages
        self._roots: dict[str, dict[tuple[int, ...], _Node]] = {}
        self._clock = 0
        self._cached = 0
        # telemetry, in tokens (a 3-page hit counts 3*ps) and requests
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.hit_requests = 0
        self.lookup_requests = 0
        self.evicted_pages = 0

    @property
    def cached_pages(self) -> int:
        with self._lock:
            return self._cached

    def reset_stats(self) -> None:
        """Zero the hit/lookup/eviction telemetry (engine warmup); the tree
        is untouched."""
        with self._lock:
            self.hit_tokens = 0
            self.lookup_tokens = 0
            self.hit_requests = 0
            self.lookup_requests = 0
            self.evicted_pages = 0

    def hit_ratio(self) -> float:
        """Cumulative fraction of looked-up prompt tokens served from the
        cache (0.0 before any lookup)."""
        with self._lock:
            if self.lookup_tokens == 0:
                return 0.0
            return self.hit_tokens / self.lookup_tokens

    def _chunks(self, tokens: tuple[int, ...]) -> Iterator[tuple[int, ...]]:
        ps = self.page_size
        for i in range(0, len(tokens) - len(tokens) % ps, ps):
            yield tokens[i : i + ps]

    def match(self, tokens: tuple[int, ...], *, count: bool = True,
              adapter_id: str = "") -> tuple[int, list[int]]:
        """Longest cached full-page prefix of ``tokens`` in adapter
        ``adapter_id``'s tree: ``(matched token count, page ids)``, with
        one allocator reference taken per page. Capped at
        ``len(tokens) - 1`` so at least one token still prefills (the
        engine samples the first generated token from its logits).
        ``count=False`` skips the hit/lookup telemetry (the LRU clock still
        advances): the engine re-matches a page-starved head every turn
        and records the lookup once, with :meth:`record_lookup`, when the
        admission lands."""
        ps = self.page_size
        cap = (len(tokens) - 1) // ps
        pages: list[int] = []
        with self._lock:
            self._clock += 1
            if count:
                self.lookup_requests += 1
                self.lookup_tokens += len(tokens)
            level = self._roots.get(adapter_id, {})
            for chunk in self._chunks(tokens):
                if len(pages) >= cap:
                    break
                node = level.get(chunk)
                if node is None:
                    break
                node.last_use = self._clock
                pages.append(node.page)
                level = node.children
            if pages and count:
                self.hit_requests += 1
                self.hit_tokens += len(pages) * ps
        if pages:
            self._alloc.share(pages)
        return len(pages) * ps, pages

    def record_lookup(self, looked_tokens: int, hit_tokens: int) -> None:
        """Telemetry of a ``match(count=False)`` whose admission landed."""
        with self._lock:
            self.lookup_requests += 1
            self.lookup_tokens += looked_tokens
            if hit_tokens:
                self.hit_requests += 1
                self.hit_tokens += hit_tokens

    def pages(self) -> list[int]:
        """Every page id the tree holds a reference on."""
        with self._lock:
            return [n.page for n in self._walk_all()]

    def insert(self, tokens: tuple[int, ...], pages: list[int], *,
               adapter_id: str = "") -> int:
        """Cache the full pages of ``tokens`` (a retiring request's
        prompt, prefilled under adapter ``adapter_id``) in that adapter's
        tree, ``pages[i]`` holding tokens ``[i*ps, (i+1)*ps)``. Nodes
        already present are refreshed and keep their page; new nodes take
        one allocator reference each. Returns how many pages were adopted."""
        adopted: list[int] = []
        with self._lock:
            self._clock += 1
            level = self._roots.setdefault(adapter_id, {})
            parent: _Node | None = None
            for i, chunk in enumerate(self._chunks(tokens)):
                if i >= len(pages):
                    break
                node = level.get(chunk)
                if node is None:
                    node = _Node(tokens=chunk, page=pages[i], parent=parent,
                                 adapter_id=adapter_id)
                    level[chunk] = node
                    adopted.append(pages[i])
                    self._cached += 1
                node.last_use = self._clock
                parent = node
                level = node.children
        if adopted:
            self._alloc.share(adopted)
        return len(adopted)

    def _leaves(self) -> list[_Node]:
        return [n for n in self._walk_all() if not n.children]

    def evict(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` least recently used leaf pages, releasing
        the tree's reference on each. Evicting a leaf can expose its
        parent for the next round. Returns the pages released."""
        if n_pages <= 0:
            return 0
        released: list[int] = []
        with self._lock:
            while len(released) < n_pages:
                leaves = self._leaves()
                if not leaves:
                    break
                leaves.sort(key=lambda n: n.last_use)
                for node in leaves:
                    if len(released) >= n_pages:
                        break
                    if node.parent is None:
                        root = self._roots[node.adapter_id]
                        root.pop(node.tokens, None)
                        if not root:
                            del self._roots[node.adapter_id]
                    else:
                        node.parent.children.pop(node.tokens, None)
                    released.append(node.page)
                    self._cached -= 1
            self.evicted_pages += len(released)
        if released:
            self._alloc.release(released)
        return len(released)

    def clear(self) -> int:
        """Release every cached page (engine warmup)."""
        with self._lock:
            pages = [n.page for n in self._walk_all()]
            self._roots = {}
            self._cached = 0
        if pages:
            self._alloc.release(pages)
        return len(pages)

    def fingerprints(self) -> list[int]:
        """Chained CRC32 fingerprints of every cached page path (the
        engine-side half of :func:`prefix_fingerprints`), sorted: the union
        over every adapter's tree, each path once. A path cached under two
        adapters is one value, so the set is the one a single tree keyed by
        tokens alone would export; a route to an engine whose pages another
        adapter computed costs a cache miss there, never a wrong token."""
        out: set[int] = set()
        with self._lock:
            stack: list[tuple[_Node, int]] = [
                (n, 0) for root in self._roots.values() for n in root.values()
            ]
            while stack:
                node, parent_crc = stack.pop()
                crc = zlib.crc32(struct.pack(f"<{len(node.tokens)}i", *node.tokens), parent_crc)
                out.add(crc)
                stack.extend((c, crc) for c in node.children.values())
        return sorted(out)

    def _walk_all(self) -> list[_Node]:
        out: list[_Node] = []
        stack = [n for root in self._roots.values() for n in root.values()]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out
