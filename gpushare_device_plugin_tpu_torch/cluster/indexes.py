"""Secondary pod-set indexes maintained on informer cache mutations.

Counterpart of ``gpushare_device_plugin_tpu/cluster/indexes.py``, copied
whole.

Round 2 moved the Allocate path's reads into the watch cache, but every
``pending_pods()`` / ``labeled_pods()`` read still scanned the *entire*
cache — O(cache) pure-Python filtering per admission, which at fleet pod
counts dominates the in-memory half of the hot path. These indexes
subscribe to the informer's mutation stream (``PodInformer.add_index``)
and maintain the exact subsets the hot paths read, so each read is O(size
of the answer), not O(cache):

- ``PendingPodIndex``: pending pods, bucketed by which share resource they
  request (tpu-mem / tpu-core) — the allocator's match step reads only its
  own resource's bucket;
- ``LabeledPodIndex``: pods bearing the tpu/resource label, bucketed by
  label value — usage accounting and the running-share read.

The membership of a pod is a pure function of its JSON, so remove-old /
add-new on every mutation keeps each index exactly equal to the full-scan
filter at every point (tested property-style in
``tests/test_index_property.py``).
"""

from __future__ import annotations


from .. import const
from . import pods as P
from ..utils.lockrank import make_lock

_Key = tuple[str, str]


def _key(pod: dict) -> _Key:
    return P.namespace(pod), P.name(pod)


class _BucketedPodIndex:
    """Base: a keyed pod set partitioned into buckets by a pure function.

    Subclasses define ``_buckets_of(pod) -> tuple[str, ...]`` — the buckets
    a pod belongs to (empty tuple = not in the index at all).
    """

    def __init__(self):
        self._lock = make_lock("cluster.podindex")
        self._all: dict[_Key, dict] = {}
        self._buckets: dict[str, dict[_Key, dict]] = {}

    def _buckets_of(self, pod: dict) -> tuple[str, ...]:
        raise NotImplementedError

    # --- informer index protocol -----------------------------------------

    def rebuild(self, pods: list[dict]) -> None:
        with self._lock:
            self._all.clear()
            self._buckets.clear()
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
        buckets = self._buckets_of(pod)
        if not buckets:
            return
        key = _key(pod)
        self._all[key] = pod
        for b in buckets:
            self._buckets.setdefault(b, {})[key] = pod

    def _remove(self, pod: dict) -> None:
        key = _key(pod)
        if self._all.pop(key, None) is None:
            return
        for members in self._buckets.values():
            members.pop(key, None)

    # --- reads ------------------------------------------------------------

    def pods(self, bucket: str | None = None) -> list[dict]:
        """Members of ``bucket`` (all members when None). The list is a
        copy; the pod dicts are the live cache entries (read-only by
        convention, same as every informer read)."""
        with self._lock:
            if bucket is None:
                return list(self._all.values())
            return list(self._buckets.get(bucket, {}).values())


class PendingPodIndex(_BucketedPodIndex):
    """Pending pods, bucketed by requested share resource.

    ``pods()`` is the PodSource ``pending_pods()`` answer; ``pods(resource)``
    is the allocator's match universe for one resource — already pre-filtered
    so ``candidate_pods`` only sorts/screens actual candidates.
    """

    RESOURCES = (const.RESOURCE_MEM, const.RESOURCE_CORE)

    def _buckets_of(self, pod: dict) -> tuple[str, ...]:
        if P.phase(pod) != "Pending":
            return ()
        requested = tuple(
            r for r in self.RESOURCES if P.mem_units_of_pod(pod, resource=r) > 0
        )
        # pending pods requesting no share resource still belong to the
        # index (pending_pods() must return every pending pod) — they just
        # live in no resource bucket
        return requested or ("",)


class LabeledPodIndex(_BucketedPodIndex):
    """Pods bearing the tpu/resource label, bucketed by label value
    (tpu-mem / tpu-core) — the usage-accounting snapshot reads."""

    def _buckets_of(self, pod: dict) -> tuple[str, ...]:
        value = P.labels(pod).get(const.LABEL_RESOURCE_KEY)
        if value is None:
            return ()
        return (value,)


class WorkloadClassIndex(_BucketedPodIndex):
    """Active share pods bucketed by their declared workload class
    (``tpushare.aliyun.com/workload-class``, normalized — absent reads
    as latency-critical). The interference plane's class lookup: the
    detector and the inspect CLI ask "which best-effort pods are live on
    this node" without rescanning the cache."""

    def _buckets_of(self, pod: dict) -> tuple[str, ...]:
        if not P.is_active(pod):
            return ()
        if P.labels(pod).get(const.LABEL_RESOURCE_KEY) != const.LABEL_RESOURCE_VALUE:
            return ()
        return (P.workload_class(pod),)
