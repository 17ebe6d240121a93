"""Incremental per-node placement accounting for the scheduler extender.

Counterpart of ``gpushare_device_plugin_tpu/extender/index.py``, copied
whole: the same per-pod rules, so both packages' indexes agree with a full
scan and with each other on one informer cache.

With the informer a verb no longer LISTs, but without this index it still
walks every cached pod and rebuilds each node's view from scratch: O(pods)
pure-Python work per scheduling decision. This index subscribes to the cluster-wide ``PodInformer``'s cache mutations
(``PodInformer.add_index``) and maintains, per node:

- fractional units used per chip, per resource family (tpu-mem, gpu-mem) —
  counted for any active pod carrying the family's IDX annotation (assumed
  pods included), the same per-pod rule as ``logic.node_usage``;
- a refcount of exclusively-held chips (assigned tpu-core pods), the same
  per-pod rule as ``pods.used_chips``.

Webhook verbs then read O(nodes-under-consideration), not O(cluster pods).
The contribution of a pod is a pure function of its JSON, so
subtract-then-add on every mutation keeps the aggregates exactly equal to
a full recomputation over the cache.
"""

from __future__ import annotations


from .. import const
from ..cluster import pods as P
from .logic import RESOURCE_FAMILIES
from ..utils.lockrank import make_lock


def _contributions(pod: dict) -> tuple[list[tuple[str, int, int]], list[int]]:
    """-> ([(resource, chip idx, units)], [exclusively-held chip idx]).

    Mirrors ``logic.node_usage`` (fractional, gang pods spread per-chip)
    and ``P.used_chips`` (exclusive) for a single pod."""
    if not P.is_active(pod):
        return [], []
    ann = P.annotations(pod)
    frac: list[tuple[str, int, int]] = []
    gang = P.gang_usage_by_chip(pod)
    if gang:
        frac.extend(
            (const.RESOURCE_MEM, idx, per) for idx, per in sorted(gang.items())
        )
    for resource, family in RESOURCE_FAMILIES.items():
        if gang and resource == const.RESOURCE_MEM:
            continue  # the gang spread above IS this pod's tpu-mem usage
        raw = ann.get(family["idx"])
        if raw is None:
            continue
        try:
            idx = int(raw)
        except (TypeError, ValueError):
            continue
        if idx < 0:
            continue
        units = P.mem_units_of_pod(pod, resource=resource)
        if units > 0:
            frac.append((resource, idx, units))
    return frac, sorted(P.used_chips([pod]))


class ClusterUsageIndex:
    """Implements the PodInformer index protocol (rebuild/on_change)."""

    def __init__(self) -> None:
        self._lock = make_lock("extender.usageindex")
        # node -> {"frac": {resource: {chip: units}}, "core": {chip: refs}}
        self._nodes: dict[str, dict] = {}
        # change detection for the extender's NodeView cache: a per-node
        # counter bumped on every usage-affecting mutation, plus a global
        # epoch bumped on rebuild (which resets the per-node counters)
        self._gen: dict[str, int] = {}
        self._epoch = 0

    # --- informer index protocol -----------------------------------------

    def rebuild(self, pods: list[dict]) -> None:
        with self._lock:
            self._nodes.clear()
            self._gen.clear()
            self._epoch += 1
            for pod in pods:
                self._add(pod)

    def on_change(self, old: dict | None, new: dict | None) -> None:
        with self._lock:
            if old is not None:
                self._remove(old)
            if new is not None:
                self._add(new)

    # --- internals (lock held) -------------------------------------------

    def _agg(self, node: str) -> dict:
        agg = self._nodes.get(node)
        if agg is None:
            agg = self._nodes[node] = {"frac": {}, "core": {}, "classes": {}}
        return agg

    def _add(self, pod: dict) -> None:
        frac, cores = _contributions(pod)
        if not frac and not cores:
            return
        node = P.node_name(pod)
        self._gen[node] = self._gen.get(node, 0) + 1
        agg = self._agg(node)
        cls = P.workload_class(pod)
        for resource, idx, units in frac:
            used = agg["frac"].setdefault(resource, {})
            used[idx] = used.get(idx, 0) + units
            if resource == const.RESOURCE_MEM:
                per_chip = agg["classes"].setdefault(idx, {})
                per_chip[cls] = per_chip.get(cls, 0) + 1
        for idx in cores:
            agg["core"][idx] = agg["core"].get(idx, 0) + 1

    def _remove(self, pod: dict) -> None:
        frac, cores = _contributions(pod)
        if not frac and not cores:
            return
        node = P.node_name(pod)
        self._gen[node] = self._gen.get(node, 0) + 1
        agg = self._nodes.get(node)
        if agg is None:
            return
        cls = P.workload_class(pod)
        for resource, idx, units in frac:
            used = agg["frac"].get(resource, {})
            left = used.get(idx, 0) - units
            if left > 0:
                used[idx] = left
            else:
                used.pop(idx, None)
            if resource == const.RESOURCE_MEM:
                per_chip = agg["classes"].get(idx, {})
                refs = per_chip.get(cls, 0) - 1
                if refs > 0:
                    per_chip[cls] = refs
                else:
                    per_chip.pop(cls, None)
                    if not per_chip:
                        agg["classes"].pop(idx, None)
        for idx in cores:
            left = agg["core"].get(idx, 0) - 1
            if left > 0:
                agg["core"][idx] = left
            else:
                agg["core"].pop(idx, None)
        if not agg["core"] and not any(agg["frac"].values()):
            self._nodes.pop(node, None)

    # --- reads ------------------------------------------------------------

    def generation(self, node: str) -> tuple[int, int]:
        """Opaque change token for ``node``'s aggregates: equal tokens
        guarantee ``node_state(node, *)`` is unchanged. The extender's
        NodeView cache keys on it instead of re-reading per verb."""
        with self._lock:
            return (self._epoch, self._gen.get(node, 0))

    def node_state(self, node: str, resource: str) -> tuple[dict[int, int], set[int]]:
        """-> (units used per chip for ``resource``, exclusively-held
        chips) on ``node``; copies, safe to mutate (the extender overlays
        in-flight decisions on top)."""
        with self._lock:
            agg = self._nodes.get(node)
            if agg is None:
                return {}, set()
            return dict(agg["frac"].get(resource, {})), set(agg["core"])

    def chip_classes(self, node: str) -> dict[int, dict[str, int]]:
        """Per-chip workload-class residency counts for ``node``'s share
        pods (chip -> {class: pods}) — the class index the interference
        plane's future class-aware placement reads; maintained under the
        same generation tokens as the unit aggregates. Copies, safe to
        mutate."""
        with self._lock:
            agg = self._nodes.get(node)
            if agg is None:
                return {}
            return {
                idx: dict(per) for idx, per in agg["classes"].items()
            }
