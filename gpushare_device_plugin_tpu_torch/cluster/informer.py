"""Watch-backed local pod cache — the client-go informer pattern, TPU-side.

The reference's Allocate() hot path LISTs the apiserver (or kubelet) on
every admission (``podmanager.go:141-190``): two HTTP round-trips per pod
(pending candidates + usage accounting) before the PATCH. This informer
replaces those reads with an in-memory cache maintained by a single
list+watch stream — the idiomatic Kubernetes controller design the
reference skipped — cutting Allocate() latency to roughly the cost of the
one unavoidable PATCH.

Consistency notes:
- The cache is eventually consistent. A pending pod that was *just* bound
  to this node may not have arrived on the watch when kubelet calls
  Allocate; ``refresh()`` (called by the allocator on a match miss) does a
  synchronous LIST to close that window, so the failure semantics are
  never worse than the reference's always-LIST behavior.
- After the allocator PATCHes annotations it feeds the response back via
  ``note_pod_update()`` so the next Allocate cannot re-match a pod whose
  MODIFIED event is still in flight.
- Restart safety is unchanged: the apiserver remains the only database
  (SURVEY.md section 5, checkpoint/resume); the cache is pure derivation.

Counterpart of ``gpushare_device_plugin_tpu/cluster/informer.py``; the
watch runs on ``http.client`` (``ApiServerClient.watch_pods_batched``),
so an idle watch's read timeout surfaces as ``TimeoutError``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable

from .. import const
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY
from ..utils.retry import Backoff
from . import pods as P
from .apiserver import ApiError, ApiServerClient
from ..utils.lockrank import make_lock
from ..utils.metric_catalog import (
    INFORMER_APPLY_BATCH_EVENTS as APPLY_BATCH,
    INFORMER_INDEX_REBUILDS_TOTAL as INDEX_REBUILDS,
    INFORMER_STALENESS_SECONDS as STALENESS_GAUGE,
)

log = get_logger("cluster.informer")

# Relist failures back off with full jitter (a fixed 1 s loop turns an
# apiserver outage into a fleet-synchronized relist storm at recovery).
RELIST_BACKOFF_BASE_S = 0.5
RELIST_BACKOFF_MAX_S = 5.0
REFRESH_RETRIES = 3
REFRESH_DELAY_S = 0.25
# refresh() runs inside the Allocate admission path: a per-attempt HTTP
# timeout plus an overall deadline bound its total cost, so a dead
# apiserver yields a fast admission error instead of a kubelet worker
# stalled on the client's default connect timeout.
REFRESH_ATTEMPT_TIMEOUT_S = 1.0
REFRESH_DEADLINE_S = 3.0

STALENESS_HELP = (
    "Seconds since the cache last heard from the apiserver (LIST or "
    "watch event); rises during an outage while reads serve last-good data"
)
# Tombstone rv recorded when the evicted pod had no parseable
# resourceVersion: blocks every store for the key until an authoritative
# LIST shows it again (_merge_list clears sentinels on presence).
TOMB_SENTINEL = 1 << 62
# Tombstones normally die on relist GC, but a long watch-stable period
# never relists — the map must also be bounded by size and age so a 404
# storm (mass pod deletion mid-allocate) cannot grow it forever. Age
# chosen >> any realistic watch-event lag; by then the lagging event the
# tombstone guards against has either arrived or never will.
TOMBSTONE_MAX = 1024
TOMBSTONE_MAX_AGE_S = 600.0
TOMBSTONE_SWEEP_EVERY_S = 60.0

INDEX_REBUILDS_HELP = (
    "Full index rebuilds (registration + post-relist revalidation); "
    "everything else is incremental on_change maintenance"
)

APPLY_BATCH_HELP = (
    "Watch events applied per cache-lock acquisition (one transport read "
    "= one batch; a PATCH burst coalesces instead of paying N lock "
    "round-trips)"
)
APPLY_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def _is_read_timeout(e: BaseException) -> bool:
    """True for an idle-watch read timeout: the socket's ``TimeoutError``
    (``socket.timeout`` is its alias), raised directly or as the cause of
    a wrapping error."""
    seen: BaseException | None = e
    for _ in range(5):
        if seen is None:
            return False
        if isinstance(seen, TimeoutError):
            return True
        args = getattr(seen, "args", ())
        seen = next(
            (a for a in args if isinstance(a, BaseException)),
            getattr(seen, "__cause__", None),
        )
    return False


def _parse_rv(rv) -> int | None:
    return int(rv) if isinstance(rv, str) and rv.isdigit() else None


def _rv_int(pod: dict) -> int | None:
    return _parse_rv(pod.get("metadata", {}).get("resourceVersion", ""))


class PodInformer:
    """List+watch cache of this node's pods, implementing the PodSource
    protocol (``pending_pods``/``running_share_pods``) plus the informer
    extras (``refresh``/``note_pod_update``)."""

    def __init__(self, client: ApiServerClient, node_name: str = "") -> None:
        """``node_name`` scopes the cache to one node's pods (the daemon's
        use); empty means cluster-wide (the scheduler extender's use —
        placement accounting needs every node's pods, including assumed
        pods that carry annotations but no label yet)."""
        from .indexes import LabeledPodIndex, PendingPodIndex, WorkloadClassIndex
        from .usage import NodeChipUsage

        self._c = client
        self._node = node_name
        self._field_selector = f"spec.nodeName={node_name}" if node_name else ""
        self._cache: dict[tuple[str, str], dict] = {}
        # key -> (rv at eviction, monotonic stamp): blocks lagging in-flight
        # watch events from resurrecting a pod the apiserver reported gone
        # (PATCH 404); the stamp drives the age/size sweep
        self._tombstones: dict[tuple[str, str], tuple[int, float]] = {}
        self._last_tomb_sweep = time.monotonic()
        self._lock = make_lock("informer.cache")
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._live_response = None  # in-flight watch, closed by stop()
        # Incremental aggregates maintained on every cache mutation so hot
        # paths read O(chips)/O(nodes) instead of rescanning the cache.
        # NodeChipUsage is node-scoped only: a cluster-wide cache would
        # merge chip 0 of every node into one bucket (consumers there
        # register their own per-node index via add_index). The pod-set
        # indexes (pending-by-resource, labeled-by-value) apply to both
        # scopes and make pending_pods()/labeled_pods() O(answer) instead
        # of O(cache).
        self._usage = NodeChipUsage() if node_name else None
        self._pending = PendingPodIndex()
        self._labeled = LabeledPodIndex()
        self._classes = WorkloadClassIndex()
        self._indexes: list = [self._pending, self._labeled, self._classes]
        if self._usage:
            self._indexes.append(self._usage)
        # monotonic timestamp of the last successful apiserver contact;
        # drives the staleness gauge while the cache serves degraded reads
        self._last_sync = time.monotonic()
        self._scope = node_name or "cluster"

    # --- lifecycle --------------------------------------------------------

    def start(self, sync_timeout_s: float = 10.0) -> "PodInformer":
        self._thread = threading.Thread(
            target=self._run, name="pod-informer", daemon=True
        )
        self._thread.start()
        if not self._synced.wait(sync_timeout_s):
            log.warning(
                "informer did not sync within %.1fs; reads fall back to "
                "refresh-on-miss until the first LIST lands", sync_timeout_s
            )
        return self

    def stop(self) -> None:
        self._stop.set()
        # The watch thread may be anywhere between issuing the GET and
        # blocking in recv; poll briefly until the live stream appears,
        # then close it: WatchStream.close() shuts the socket down, which
        # interrupts a blocked recv at once instead of waiting out the
        # whole read timeout.
        deadline = time.monotonic() + 2.0
        while self._thread is not None and self._thread.is_alive():
            resp = self._live_response
            if resp is not None:
                resp.close()
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def staleness_s(self) -> float:
        """Age of the newest apiserver data in the cache. Near zero while
        the watch is live; rises monotonically through an outage."""
        return time.monotonic() - self._last_sync

    def _mark_synced(self) -> None:
        self._last_sync = time.monotonic()
        REGISTRY.gauge_set(
            STALENESS_GAUGE, 0.0, STALENESS_HELP, scope=self._scope
        )

    def _mark_stale(self) -> None:
        REGISTRY.gauge_set(
            STALENESS_GAUGE, self.staleness_s(), STALENESS_HELP,
            scope=self._scope,
        )

    @property
    def synced(self) -> bool:
        """True once an authoritative LIST has seeded the cache. Consumers
        that cannot tolerate a cold cache (the extender would place pods
        onto chips it believes empty) must fall back to direct LISTs, or
        call ``refresh()``, while this is False."""
        return self._synced.is_set()

    # --- incremental indexes ----------------------------------------------

    def add_index(self, index: Any) -> "PodInformer":
        """Register an aggregate maintained on every cache mutation.

        ``index`` implements ``rebuild(pods)`` (called now, to fold in the
        current cache) and ``on_change(old, new)`` (called under the cache
        lock on every store/delete: ``old`` is the prior cached pod or
        None, ``new`` the replacement or None)."""
        with self._lock:
            self._indexes.append(index)
            index.rebuild(list(self._cache.values()))
        REGISTRY.counter_inc(
            INDEX_REBUILDS, INDEX_REBUILDS_HELP,
            scope=self._scope, reason="register",
        )
        return self

    def revalidate_indexes(self) -> None:
        """Escape hatch: rebuild every index from the cache in one atomic
        pass. Called after each relist — incremental maintenance is exact
        by construction, but a relist is the moment the cache itself was
        just re-anchored to an authoritative LIST, so re-deriving the
        aggregates there turns any would-be drift bug from a permanent
        corruption into a one-relist-cycle blip (and the rebuild counter
        makes the frequency observable)."""
        with self._lock:
            pods = list(self._cache.values())
            for ix in self._indexes:
                ix.rebuild(pods)
        REGISTRY.counter_inc(
            INDEX_REBUILDS, INDEX_REBUILDS_HELP,
            scope=self._scope, reason="revalidate",
        )

    def _cache_set(self, key: tuple[str, str], pod: dict) -> None:
        """Caller must hold self._lock."""
        old = self._cache.get(key)
        self._cache[key] = pod
        for ix in self._indexes:
            ix.on_change(old, pod)

    def _cache_pop(self, key: tuple[str, str]) -> dict | None:
        """Caller must hold self._lock."""
        old = self._cache.pop(key, None)
        if old is not None:
            for ix in self._indexes:
                ix.on_change(old, None)
        return old

    # --- list+watch loop --------------------------------------------------

    def _key(self, pod: dict) -> tuple[str, str]:
        return P.namespace(pod), P.name(pod)

    def _relist(self) -> str:
        items, rv = self._c.list_pods_with_rv(field_selector=self._field_selector)
        # rv-guarded merge, NOT a wholesale replace: a LIST served just
        # before a concurrent PATCH/evict landed must not revert the
        # note_pod_update/evict state (that would re-open the re-match
        # window on the Allocate path).
        self._merge_list(items, rv, gc_tombstones=True)
        self.revalidate_indexes()
        self._synced.set()
        self._mark_synced()
        log.v(4, "informer listed %d pods at rv=%s", len(items), rv)
        return rv

    def _merge_list(self, items: list[dict], rv: str, gc_tombstones: bool = False) -> None:
        """Fold an authoritative LIST into the cache: prune absences not
        provably newer than the LIST, keep newer cached entries.

        ``gc_tombstones`` drops tombstones older than the LIST rv — only
        valid from the watch thread itself (it re-watches from this rv, so
        no older event can arrive); refresh() callers race the live stream
        and must keep them.
        """
        list_rv = _parse_rv(rv)
        with self._lock:
            listed = {self._key(p) for p in items}
            for key in [k for k in self._cache if k not in listed]:
                cached_rv = _rv_int(self._cache[key])
                if list_rv is None or cached_rv is None or cached_rv <= list_rv:
                    self._cache_pop(key)
            for key, (tomb, _stamp) in list(self._tombstones.items()):
                if key in listed:
                    # Present in a LIST that provably postdates the
                    # eviction -> live now (a recreation). A LIST whose rv
                    # is unknown or older may have been served before the
                    # deletion landed; keeping the tombstone makes
                    # _store_if_newer drop that stale copy instead of
                    # resurrecting the ghost. Sentinel tombstones (no rv
                    # was parseable at evict time, stored as 1<<62) can
                    # never win an rv comparison — for them an
                    # authoritative LIST presence is the best evidence
                    # available and must clear the block, or the key would
                    # be uncacheable until restart.
                    if tomb >= TOMB_SENTINEL or (
                        list_rv is not None and list_rv >= tomb
                    ):
                        self._tombstones.pop(key)
                elif gc_tombstones and list_rv is not None and tomb <= list_rv:
                    self._tombstones.pop(key)
            for p in items:
                self._store_if_newer(self._key(p), p)

    def _store_if_newer(self, key: tuple[str, str], pod: dict) -> None:
        """Caller must hold self._lock. Drops updates whose resourceVersion
        is not newer than the cached entry's — an in-flight older watch
        event must not revert a pod fed in by note_pod_update()/refresh()
        (that would re-open the re-match window those hooks close)."""
        new_rv = _rv_int(pod)
        entry = self._tombstones.get(key)
        if entry is not None:
            # A lagging pre-deletion event must not resurrect an evicted
            # ghost; anything provably newer is a legitimate recreation.
            if new_rv is None or new_rv <= entry[0]:
                return
            self._tombstones.pop(key, None)
        cached = self._cache.get(key)
        if cached is not None:
            old_rv = _rv_int(cached)
            if old_rv is not None and new_rv is not None and new_rv <= old_rv:
                return
        self._cache_set(key, pod)

    def _apply_locked(self, etype: str, pod: dict) -> None:
        """One watch event against the cache. Caller must hold self._lock."""
        key = self._key(pod)
        if etype == "DELETED":
            # rv-guarded like stores: a lagging DELETED for an old
            # instance of the name must not evict a live recreation
            # that refresh() already cached at a higher rv.
            cached = self._cache.get(key)
            ev_rv, cached_rv = _rv_int(pod), (
                _rv_int(cached) if cached is not None else None
            )
            if (
                cached_rv is None
                or ev_rv is None
                or cached_rv <= ev_rv
            ):
                self._cache_pop(key)
            # the real deletion arrived; the tombstone has served its
            # purpose (a later recreation must not be blocked)
            entry = self._tombstones.get(key)
            if entry is not None and (ev_rv is None or ev_rv >= entry[0]):
                self._tombstones.pop(key)
        elif etype in ("ADDED", "MODIFIED"):
            self._store_if_newer(key, pod)
        # A pod moving OFF this node arrives as MODIFIED with a different
        # nodeName (field-selector watches emit it as DELETED on a real
        # apiserver; tolerate both shapes). Cluster-wide informers keep
        # every pod.
        if (
            self._node
            and etype != "DELETED"
            and P.node_name(pod) not in ("", self._node)
        ):
            self._cache_pop(key)

    def _apply(self, etype: str, pod: dict) -> None:
        self.apply_batch([(etype, pod)])

    def apply_batch(
        self, events: Iterable[tuple[str, dict]]
    ) -> tuple[str | None, dict | None]:
        """Apply a burst of watch events under ONE cache/index-lock
        acquisition — the watch thread hands every transport read here, so
        an N-event PATCH burst costs one lock round-trip, with the indexes
        maintained incrementally per event (no revalidate). Returns the
        last applied resourceVersion (None if none parsed) and the ERROR
        event's object when the stream signaled failure (events after it
        are dropped; the caller relists)."""
        rv: str | None = None
        error_obj: dict | None = None
        applied = 0
        with self._lock:
            for etype, pod in events:
                if etype == "ERROR":
                    error_obj = pod if isinstance(pod, dict) else {}
                    break
                self._apply_locked(etype, pod)
                applied += 1
                rv = pod.get("metadata", {}).get("resourceVersion", rv)
            now = time.monotonic()
            if (
                self._tombstones
                and now - self._last_tomb_sweep > TOMBSTONE_SWEEP_EVERY_S
            ):
                self._sweep_tombstones(now)
        if applied:
            REGISTRY.observe(
                APPLY_BATCH, float(applied), APPLY_BATCH_HELP,
                buckets=APPLY_BATCH_BUCKETS, scope=self._scope,
            )
        return rv, error_obj

    def _run(self) -> None:
        rv = "0"
        need_list = True
        backoff = Backoff(base_s=RELIST_BACKOFF_BASE_S, max_s=RELIST_BACKOFF_MAX_S)
        while not self._stop.is_set():
            try:
                if need_list:
                    rv = self._relist()
                    need_list = False
                    backoff.reset()
                batches = self._c.watch_pods_batched(
                    resource_version=rv,
                    field_selector=self._field_selector,
                    on_response=lambda r: setattr(self, "_live_response", r),
                )
                for batch in batches:
                    if self._stop.is_set():
                        return
                    backoff.reset()
                    self._mark_synced()
                    batch_rv, error_obj = self.apply_batch(batch)
                    if batch_rv is not None:
                        rv = batch_rv
                    if error_obj is not None:
                        # In-stream failure (a real apiserver reports an
                        # expired rv as HTTP 200 + one ERROR/Status event,
                        # code 410). Relist to re-seed.
                        log.v(
                            4, "watch ERROR event (code=%s); relisting",
                            error_obj.get("code"),
                        )
                        need_list = True
                        break
                # clean server close: re-watch from the last seen rv
            except ApiError as e:
                if e.status == 410:  # Gone: our rv fell out of history
                    log.v(4, "watch rv=%s gone; relisting", rv)
                else:
                    log.warning("watch failed (%s); relisting", e)
                need_list = True
                self._mark_stale()
                self._stop.wait(backoff.next())
            except Exception as e:  # noqa: BLE001 — timeouts, resets, closes
                if _is_read_timeout(e):
                    # Routine idle-watch read timeout: the cache is still
                    # good — re-watch from the last rv, no LIST, no backoff.
                    log.v(4, "idle watch timed out; re-watching from rv=%s", rv)
                else:
                    # Covers CircuitOpenError too: while the breaker is
                    # open each pass fails instantly, so the jittered
                    # backoff is what keeps this from being a hot loop.
                    log.v(4, "watch interrupted (%s); relisting", e)
                    need_list = True
                    self._mark_stale()
                    self._stop.wait(backoff.next())
            finally:
                self._live_response = None

    # --- PodSource protocol ----------------------------------------------

    def pending_pods(self) -> list[dict]:
        return self._pending.pods()

    def pending_share_pods(self, resource: str) -> list[dict]:
        """Pending pods requesting ``resource`` — the allocator's match
        universe, O(bucket) instead of O(cache) (the full-scan filter it
        replaces lives on in ``P.candidate_pods`` as the screen over this
        pre-filtered set)."""
        return self._pending.pods(resource)

    def running_share_pods(self) -> list[dict]:
        return self._labeled.pods(const.LABEL_RESOURCE_VALUE)

    def labeled_pods(self) -> list[dict]:
        """All pods bearing the tpu/resource label (mem or core) — one
        snapshot for cross-resource accounting on the Allocate path."""
        return self._labeled.pods()

    def share_pods_by_class(self, workload_class: str) -> list[dict]:
        """Active share pods of one declared workload class (normalized;
        ``cluster.indexes.WorkloadClassIndex``) — the interference
        plane's class lookup, O(answer)."""
        return self._classes.pods(workload_class)

    def chip_residency(self) -> dict[int, dict[str, str]]:
        """Per-chip resident share pods + workload classes (the
        interference detector's co-residency input), maintained
        incrementally; {} on a cluster-wide cache (residency is a
        node-scoped notion, like ``chip_state``)."""
        if self._usage is None:
            return {}
        return self._usage.residency()

    def all_pods(self) -> list[dict]:
        """Every cached pod (the extender's placement accounting reads
        annotated-but-unlabeled assumed pods too)."""
        with self._lock:
            return list(self._cache.values())

    def get_pod(self, namespace: str, name: str) -> dict | None:
        with self._lock:
            return self._cache.get((namespace, name))

    def chip_state(self) -> tuple[dict[int, int], set[int]]:
        """O(chips) usage read for the Allocate path: -> (mem units used
        per chip, exclusively-held chips), maintained incrementally instead
        of rescanning every labeled pod per admission. Falls back to a
        synchronous LIST when the cache has never synced (a cold cache
        reads as an empty node and would double-book every chip)."""
        if self._usage is None:
            raise RuntimeError(
                "chip_state() requires a node-scoped informer; a "
                "cluster-wide cache would merge chip indices across nodes"
            )
        if not self._synced.is_set():
            self.refresh()
        return self._usage.snapshot()

    # --- informer extras --------------------------------------------------

    def refresh(self) -> None:
        """Synchronous LIST — closes the just-scheduled-pod race on a match
        miss. Retried like the list-backed source's reads (the allocator
        calls this exactly when admission hangs on the answer, so it must
        not be weaker than the reference's always-LIST path). The watch
        keeps streaming independently.

        Deletions are reconciled too: a cached pod absent from the LIST
        whose resourceVersion predates the LIST's collection rv is gone on
        the server (its DELETED event is in flight or the watch is lagging)
        and must not stay matchable — a stale pending pod matched ahead of
        the real same-size pod turns into a 404 on PATCH and a terminal
        UnexpectedAdmissionError for the innocent pod."""
        from ..utils.retry import retry

        items, rv = retry(
            lambda: self._c.list_pods_with_rv(
                field_selector=self._field_selector,
                timeout_s=REFRESH_ATTEMPT_TIMEOUT_S,
            ),
            attempts=REFRESH_RETRIES,
            delay_s=REFRESH_DELAY_S,
            backoff=2.0,
            jitter=True,
            deadline_s=REFRESH_DEADLINE_S,
        )
        self._merge_list(items, rv)
        # an authoritative LIST seeds the cache as well as _relist does
        self._synced.set()
        self._mark_synced()

    def evict(self, pod: dict) -> None:
        """Drop a pod the apiserver reported gone (PATCH 404) so the next
        match cannot pick it again ahead of a live same-size pod. A
        tombstone at the evicted rv keeps lagging in-flight watch events
        from re-inserting the ghost behind our back."""
        key = self._key(pod)
        with self._lock:
            cached = self._cache_pop(key)
            rv = _rv_int(cached) if cached is not None else None
            if rv is None:
                rv = _rv_int(pod)
            now = time.monotonic()
            self._tombstones[key] = (
                rv if rv is not None else TOMB_SENTINEL, now
            )
            if len(self._tombstones) > TOMBSTONE_MAX:
                self._sweep_tombstones(now)

    def _sweep_tombstones(self, now: float) -> None:
        """Caller must hold self._lock. Age out expired tombstones; if the
        map still exceeds the size cap, drop oldest-first (a dropped
        tombstone only re-opens the brief lagging-event window the next
        relist would have closed anyway — an acceptable trade against an
        unbounded map)."""
        self._last_tomb_sweep = now
        for key, (_rv, stamp) in list(self._tombstones.items()):
            if now - stamp > TOMBSTONE_MAX_AGE_S:
                self._tombstones.pop(key)
        if len(self._tombstones) > TOMBSTONE_MAX:
            by_age = sorted(self._tombstones.items(), key=lambda kv: kv[1][1])
            for key, _entry in by_age[: len(self._tombstones) - TOMBSTONE_MAX]:
                self._tombstones.pop(key)

    def note_pod_update(self, pod: dict) -> None:
        """Feed a freshly-PATCHed pod straight into the cache so the next
        read sees it before its MODIFIED event arrives."""
        if pod:
            with self._lock:
                self._store_if_newer(self._key(pod), pod)
