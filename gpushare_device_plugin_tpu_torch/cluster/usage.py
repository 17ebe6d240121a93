"""Incremental chip-usage accounting over an informer cache.

Counterpart of ``gpushare_device_plugin_tpu/cluster/usage.py``, copied
whole.

The reference recomputes usage by scanning every labeled pod on each
Allocate (``getPodUsedGPUMemory``, ``podmanager.go:102-115`` — a LIST plus
an O(pods) walk per admission). Round 2 moved the LIST into the watch cache
but kept the O(pods) walk; this module removes the walk too: a
``NodeChipUsage`` index subscribes to cache mutations and maintains the two
aggregates the Allocate path reads — fractional HBM units used per chip and
the set of exclusively-held chips — so each admission reads O(chips), not
O(pods).

Correctness contract: a pod's contribution is a pure function of its JSON
(``_mem_contribution`` / ``_core_contribution``, built on the same
``cluster.pods`` predicates the batch helpers use), so applying
``on_change(old, new)`` as subtract-then-add keeps the aggregates exactly
equal to ``P.used_units_by_chip(cache)`` / ``P.used_chips(cache)`` at every
point. Exclusive holds are reference-counted: two pods claiming one chip is
an anomaly the allocator rejects, but the index must not forget the
surviving hold when one of them dies.
"""

from __future__ import annotations


from .. import const
from . import pods as P
from ..utils.lockrank import make_lock


def _mem_contributions(pod: dict) -> list[tuple[int, int]]:
    """[(chip index, units)] this pod adds to fractional-HBM accounting
    ([] when none) — the per-pod form of ``P.used_units_by_chip``. A
    multi-chip gang contributes its per-chip share on EVERY member chip;
    a single-chip pod its total on its IDX chip."""
    if not P.is_active(pod):
        return []
    if P.labels(pod).get(const.LABEL_RESOURCE_KEY) != const.LABEL_RESOURCE_VALUE:
        return []
    if not P.is_assigned(pod):
        return []
    gang = P.gang_usage_by_chip(pod)
    if gang:
        return sorted(gang.items())
    idx = P.chip_idx_from_annotation(pod)
    if idx < 0:
        return []
    return [(idx, P.mem_units_of_pod(pod))]


def _core_contribution(pod: dict) -> list[int]:
    """Chips this pod holds exclusively — the per-pod form of
    ``P.used_chips``."""
    if not P.is_active(pod):
        return []
    if not P.is_assigned(pod):
        return []
    return P.core_hold_chips(pod)


def pod_counts_toward_usage(pod: dict) -> bool:
    """True when this pod's JSON contributes to either aggregate — i.e. a
    cache holding this copy already accounts for it. The allocator's
    reservation overlay uses this to stop counting an in-flight pod the
    moment its PATCHed copy lands in the pod source."""
    return bool(_mem_contributions(pod)) or bool(_core_contribution(pod))


class NodeChipUsage:
    """Per-chip usage aggregates for one node's pods (the daemon's view)."""

    def __init__(self) -> None:
        self._lock = make_lock("cluster.usage")
        self._mem_used: dict[int, int] = {}
        self._core_refs: dict[int, int] = {}
        # per-chip resident share pods and their workload classes — the
        # interference detector's co-residency input (a gang pod resides
        # on every member chip). Keyed (namespace, name) -> class.
        self._residents: dict[int, dict[tuple[str, str], str]] = {}

    # --- informer index protocol -----------------------------------------

    def rebuild(self, pods: list[dict]) -> None:
        with self._lock:
            self._mem_used.clear()
            self._core_refs.clear()
            self._residents.clear()
            for pod in pods:
                self._add(pod)

    def on_change(self, old: dict | None, new: dict | None) -> None:
        with self._lock:
            if old is not None:
                self._remove(old)
            if new is not None:
                self._add(new)

    # --- internals (lock held) -------------------------------------------

    def _add(self, pod: dict) -> None:
        key = (P.namespace(pod), P.name(pod))
        cls = P.workload_class(pod)
        for idx, units in _mem_contributions(pod):
            self._mem_used[idx] = self._mem_used.get(idx, 0) + units
            self._residents.setdefault(idx, {})[key] = cls
        for idx in _core_contribution(pod):
            self._core_refs[idx] = self._core_refs.get(idx, 0) + 1

    def _remove(self, pod: dict) -> None:
        key = (P.namespace(pod), P.name(pod))
        for idx, units in _mem_contributions(pod):
            left = self._mem_used.get(idx, 0) - units
            if left > 0:
                self._mem_used[idx] = left
            else:
                self._mem_used.pop(idx, None)
            members = self._residents.get(idx)
            if members is not None:
                members.pop(key, None)
                if not members:
                    self._residents.pop(idx, None)
        for idx in _core_contribution(pod):
            left = self._core_refs.get(idx, 0) - 1
            if left > 0:
                self._core_refs[idx] = left
            else:
                self._core_refs.pop(idx, None)

    # --- reads ------------------------------------------------------------

    def snapshot(self) -> tuple[dict[int, int], set[int]]:
        """-> (mem units used per chip, exclusively-held chips)."""
        with self._lock:
            return dict(self._mem_used), set(self._core_refs)

    def residency(self) -> dict[int, dict[str, str]]:
        """Per-chip resident share pods and their workload classes:
        chip -> {"ns/name": class} — the interference detector's
        co-residency input (``cluster/interference.py``), maintained
        incrementally like the unit aggregates."""
        with self._lock:
            return {
                idx: {f"{ns}/{name}": cls for (ns, name), cls in members.items()}
                for idx, members in self._residents.items()
            }
