"""HTTP scheduler-extender server.

Counterpart of ``gpushare_device_plugin_tpu/extender/server.py``, copied
whole: the same flags and defaults, wire formats, bind annotations, WAL
records and trace stitching, on the standard library's HTTP server. Like
the rest of the port's control plane it imports neither torch nor
``requests``, ``urllib3`` or ``yaml``: it never touches the card, and its
apiserver client is the port's ``cluster/apiserver.py`` on ``http.client``.
Run it as ``python -m gpushare_device_plugin_tpu_torch.extender.server`` or
``gpushare-scheduler-extender-cuda``. Two differences: on SIGTERM
``main`` stops its servers and informer and exits 0, where the reference's
process dies of the signal; and ``_views_from_index`` reads which in-flight
binds the usage index does not count yet before it reads the index, where
the reference reads them after, so a bind whose watch event lands between
the two reads is counted (the reference counts it nowhere, and a
concurrent bind can double-book its chip).

Speaks the kube-scheduler extender webhook protocol (the v1 JSON API the
scheduler's ``extenders`` policy config points at):

- ``POST /scheduler/filter``      ExtenderArgs -> ExtenderFilterResult
- ``POST /scheduler/prioritize``  ExtenderArgs -> HostPriorityList
- ``POST /scheduler/bind``        ExtenderBindingArgs -> ExtenderBindingResult

Bind both persists the chip decision (IDX/assume-time/per-container
allocation annotations — exactly what Allocate's branch A and the inspect
CLI read) and creates the v1 Binding. Serialized by a single lock so two
same-size pods cannot race a chip (the in-flight one is visible to the next
decision via its annotations-in-apiserver plus a short local cache).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import signal
import sys
import threading
import time
from typing import Any
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..allocator.binpack import AssignmentError
from ..cluster import pods as P
from ..cluster.apiserver import ApiError, ApiServerClient
from ..utils.decisions import DECISIONS, rank_scores
from ..utils.log import get_logger
from ..utils import log as logutil
from ..utils.tracing import ADMISSIONS, TRACER, SpanContext
from . import logic
from .index import ClusterUsageIndex
from ..utils.lockrank import make_rlock
from ..utils.metric_catalog import (
    EXTENDER_VERB_SECONDS,
    EXTENDER_VERB_TOTAL,
    EXTENDER_VIEW_TOTAL,
)

log = get_logger("extender")


@dataclasses.dataclass
class _Inflight:
    """A bind decision the apiserver watch may not reflect yet.

    Single-chip: ``chips`` is empty, ``units`` lands on ``idx``. Gang:
    ``chips`` holds every member and ``units`` is the PER-CHIP share —
    the overlay books all members together, mirroring the all-or-nothing
    ledger entry on the plugin side."""

    node: str
    resource: str
    idx: int
    units: int
    annotations: dict[str, str]
    stamp: float
    chips: tuple[int, ...] = ()
    # The journal sequence of this decision's begin record (None when the
    # begin was degraded/unjournaled). The deferred expired-entry abort
    # resolves ONLY this incarnation: a fresh same-key begin (pod deleted
    # and recreated under the same name mid-verb) must not be popped by a
    # stale entry's cleanup.
    seq: int | None = None


class ExtenderCore:
    def __init__(
        self,
        api: ApiServerClient,
        policy: "str | logic.PlacementPolicy" = "best-fit",
        informer: Any = None,
        checkpoint: Any = None,
        shard: str = "",
        usage_overlay_fn: Any = None,
    ) -> None:
        """``informer``: an optional cluster-wide ``PodInformer`` (no node
        field-selector). With it, filter/prioritize/bind read incremental
        per-node aggregates (``ClusterUsageIndex``) off the watch cache —
        O(nodes) per webhook verb — instead of LISTing and walking every
        pod in the cluster per scheduling decision.

        ``checkpoint``: an optional ``AllocationCheckpoint`` journaling
        each bind decision before its PATCH (same WAL as the device
        plugin's allocator). On construction the unresolved entries seed
        the in-flight overlay — serve-from-checkpoint warmup — so a
        restarted extender keeps honoring decisions whose PATCH/Binding
        may have landed but are not yet visible on the watch, instead of
        double-booking those chips during its cold-start window. Entries
        age out of the overlay on the normal in-flight TTL, by which time
        the watch has either confirmed them or they never happened.

        ``shard``: this core's shard id in a horizontally sharded
        deployment ("" when unsharded) — stamped on every decision
        record so a placement is attributable to the shard that made it.
        ``usage_overlay_fn(node, resource) -> {chip: units}``: extra
        in-flight usage folded into every node view (the shard layer's
        cross-shard gang2pc reservations, which the core's own in-flight
        overlay cannot know about)."""
        self._api = api
        self._policy = policy
        self._informer = informer
        self._ckpt = checkpoint
        self._shard = shard
        self._usage_overlay_fn = usage_overlay_fn
        self._index: ClusterUsageIndex | None = None
        if informer is not None:
            self._index = ClusterUsageIndex()
            informer.add_index(self._index)
        # RLock: bind() holds it across its whole decision and calls
        # _node_views(), which also touches the in-flight cache
        self._lock = make_rlock("extender.core")
        self._inflight: dict[tuple[str, str], _Inflight] = {}
        self._inflight_ttl_s = 60.0
        # Overlay entries that aged out but whose journal abort has not
        # run yet: ((ns, name), begin seq) pairs. The abort blocks on the
        # WAL writer's fsync ticket, and _live_inflight() runs under the
        # decision lock on the bind path — so expiry only *queues* here
        # and each webhook verb drains after its locked section (journaling
        # them inline under the lock would put an fsync under it).
        self._expired_unjournaled: list[
            tuple[tuple[str, str], int | None]
        ] = []
        # Incremental NodeView cache, keyed (node, resource) with a
        # (node resourceVersion, usage-index generation) change token: a
        # filter round over N unchanged nodes re-parses zero capacity
        # vectors and re-copies zero usage maps — pod add/remove deltas
        # land in the index, which bumps the generation and invalidates
        # exactly the touched node.
        self._view_cache: dict[
            tuple[str, str],
            tuple[
                str, tuple, dict[int, int], dict[int, int], set[int],
                "logic.ChipTopology | None",
            ],
        ] = {}
        self._view_cache_max = 8192
        if checkpoint is not None:
            self._warmup_from_checkpoint()

    def _warmup_from_checkpoint(self) -> None:
        now = time.monotonic()
        wall = time.time()
        seeded = 0
        for key, data in self._ckpt.pending().items():
            # Cross-shard two-phase gang records ride the same per-shard
            # WAL but are NOT bind decisions: their resolution belongs to
            # the shard reconciler (roll forward on a durable commit
            # decision, roll back otherwise — extender/shards.py). The
            # warmup must neither replay them as phantom single-chip
            # capacity nor abort them as malformed.
            if data.get("kind") == "gang2pc":
                continue
            # Entries older than the in-flight TTL are stale survivors of
            # an earlier crash cycle: by now the watch has either shown
            # their bind or it never landed — resolve them at load instead
            # of replaying phantom capacity on every restart forever.
            ts = data.get("ts")
            if isinstance(ts, (int, float)) and wall - ts > self._inflight_ttl_s:
                self._ckpt.abort(key, seq=data.get("_seq"))
                continue
            try:
                entry = _Inflight(
                    node=str(data["node"]),
                    resource=str(data["resource"]),
                    idx=int(data["idx"]),
                    units=int(data["units"]),
                    annotations=dict(data.get("annotations") or {}),
                    stamp=now,
                    chips=tuple(int(i) for i in (data.get("chips") or ())),
                    seq=data.get("_seq"),
                )
            except (KeyError, TypeError, ValueError):
                log.warning("checkpoint warmup: malformed bind entry for %s", key)
                self._ckpt.abort(key, seq=data.get("_seq"))
                continue
            self._inflight[(key[0], key[1])] = entry
            seeded += 1
        if seeded:
            log.info(
                "serve-from-checkpoint warmup: %d in-flight bind "
                "decision(s) restored", seeded,
            )

    # --- helpers ----------------------------------------------------------

    def ready(self) -> bool:
        """Readiness for the metrics server's ``/readyz``: the informer
        has synced (decisions serve from the incremental index instead
        of cold LISTs) — serve-from-checkpoint warmup already completed
        in the constructor, so a constructed core has replayed its WAL.
        List-mode cores (no informer) are ready immediately."""
        if self._informer is None:
            return True
        return bool(self._informer.synced)

    def _use_index(self) -> bool:
        """The index serves reads only once the informer has synced: before
        the first LIST lands the cache reads as an empty cluster and every
        chip looks free — placements would over-commit. Until then fall
        back to direct LISTs (never weaker than the reference extender)."""
        return (
            self._index is not None
            and self._informer is not None
            and self._informer.synced
        )

    def _live_inflight(self) -> dict[tuple[str, str], _Inflight]:
        now = time.monotonic()
        with self._lock:
            expired = [
                (k, v.seq) for k, v in self._inflight.items()
                if now - v.stamp >= self._inflight_ttl_s
            ]
            for k, _seq in expired:
                self._inflight.pop(k)
            live = dict(self._inflight)
            # An overlay entry aging out means the watch has caught up (or
            # the bind never landed) — the journal entry has served its
            # purpose and must not be replayed at the next restart. The
            # abort itself blocks on WAL durability, so it only gets
            # QUEUED here; _drain_expired_aborts runs it outside the lock.
            if self._ckpt is not None and expired:
                self._expired_unjournaled.extend(expired)
        return live

    def _drain_expired_aborts(self) -> None:
        """Journal aborts for aged-out overlay entries, called at the end
        of every webhook verb with no lock held: abort() waits on the
        group-commit writer's fsync ticket, and a disk wait under the
        decision lock would serialize every concurrent bind behind it.
        Each abort carries the expired entry's begin seq, so a FRESH
        same-key begin journaled in the deferral window (same pod name
        recreated and re-bound) is never popped by the stale cleanup.
        Unjournaled keys (including already-committed ones) are a no-op
        inside abort()."""
        if self._ckpt is None:
            return
        with self._lock:
            expired, self._expired_unjournaled = self._expired_unjournaled, []
        for k, seq in expired:
            if seq is None:
                # this incarnation's begin was degraded (never journaled):
                # there is nothing of ITS to abort, and an unconditional
                # abort would pop a fresh same-key begin journaled since
                continue
            self._ckpt.abort(k, seq=seq)

    def _view_for(self, node: dict, resource: str) -> logic.NodeView:
        """One node's placement view off the incremental index, memoized.

        Cache hit requires BOTH halves unchanged: the node object's
        resourceVersion (capacity side) and the usage index's per-node
        generation (pod side). Nodes without a resourceVersion (some
        callers pass bare name-only dicts) are never cached — correctness
        over speed. The returned view carries fresh copies of the mutable
        maps because the in-flight overlay writes into ``used``."""
        from ..utils.metrics import REGISTRY

        name = node.get("metadata", {}).get("name", "")
        rv = node.get("metadata", {}).get("resourceVersion")
        gen = self._index.generation(name)
        key = (name, resource)
        outcome = "rebuild"
        with self._lock:
            entry = self._view_cache.get(key)
            if entry is not None and rv is not None and entry[0] == rv and entry[1] == gen:
                _rv, _gen, capacity, used, core_held, topo = entry
                outcome = "hit"
        if outcome == "rebuild":
            capacity = logic.node_capacity(node, resource)
            used, core_held = self._index.node_state(name, resource)
            # The topology grid is a pure function of node labels +
            # capacity (both covered by the resourceVersion key), and
            # rebuilding it was the single hottest line of a 1k-node
            # scoring pass — cache it with the rest of the view.
            topo = (
                logic.node_topology(node, capacity)
                if resource == logic.const.RESOURCE_MEM
                else None
            )
            if rv is not None:
                with self._lock:
                    if len(self._view_cache) >= self._view_cache_max:
                        self._view_cache.clear()  # crude, but bounds memory
                    self._view_cache[key] = (
                        rv, gen, capacity, used, core_held, topo
                    )
        REGISTRY.counter_inc(
            EXTENDER_VIEW_TOTAL,
            "NodeView constructions by outcome (hit = served from the "
            "incremental cache; rebuild = capacity re-parsed / usage re-read)",
            outcome=outcome,
        )
        return logic.NodeView(
            name=name,
            resource=resource,
            capacity=capacity,
            used=dict(used),
            core_held=(
                set(core_held) if resource == logic.const.RESOURCE_MEM else set()
            ),
            topology=topo,
        )

    def _node_views(
        self, resource: str, nodes: list[dict]
    ) -> list[logic.NodeView]:
        """Build per-node placement views for ``resource``.

        Index path: O(len(nodes)) reads of the incremental aggregates.
        List path: one LIST (or the synced cache) plus a full scan,
        identical semantics. This convenience fetches; it is for the
        UNLOCKED verbs (filter/prioritize/batch) — bind prefetches the
        raw pods before its decision lock and calls the in-memory halves
        directly, so no network read ever runs under the lock."""
        if self._use_index():
            return self._views_from_index(resource, nodes)
        return self._views_from_pods(
            resource, nodes, self._fetch_cluster_pods()
        )

    def _views_from_index(
        self, resource: str, nodes: list[dict]
    ) -> list[logic.NodeView]:
        """Index path: incremental per-node aggregates, then overlay
        in-flight bind decisions whose annotations have not yet arrived
        on the watch (once the pod's cached copy carries the IDX
        annotation the index already counts it — skip to avoid double
        counting). Pure memory."""
        family = logic.RESOURCE_FAMILIES[resource]
        wanted = {n.get("metadata", {}).get("name", "") for n in nodes}
        # Which in-flight decisions the index does not count yet is read
        # BEFORE the index itself: the informer applies a pod's event to
        # its cache and to the index at once, so an entry seen caught up
        # here is in the index read below. Read after the index (the
        # reference's order), a bind landing between the two reads is
        # counted by neither, and a concurrent bind double-books its chip.
        overlay: list[_Inflight] = []
        for (ns, pname), entry in self._live_inflight().items():
            if entry.resource != resource or entry.node not in wanted:
                continue
            cached = self._informer.get_pod(ns, pname)
            # Not cached yet (reservation made before the pod's watch
            # event, or before its PATCH even landed): the index cannot
            # be counting it, so the overlay must — skipping here would
            # let a concurrent bind double-book the chip. Only a pod
            # provably finished stops counting early (TTL otherwise).
            if cached is not None:
                if not P.is_active(cached):
                    continue
                ann = P.annotations(cached)
                marker = (
                    logic.const.ENV_GANG_CHIPS if entry.chips
                    else family["idx"]
                )
                if marker in ann and P.node_name(cached) == entry.node:
                    continue  # watch caught up; the index counts it on node
            # Otherwise the index either misses the pod or files it
            # under the wrong node (annotation MODIFIED can precede the
            # bind MODIFIED, leaving nodeName empty): count it here.
            overlay.append(entry)
        views = []
        by_name: dict[str, logic.NodeView] = {}
        for node in nodes:
            view = self._view_for(node, resource)
            views.append(view)
            by_name[view.name] = view
        # Gang entries book their PER-CHIP share on every member — the
        # overlay mirror of the all-or-nothing ledger entry.
        for entry in overlay:
            view = by_name[entry.node]
            for member in entry.chips or (entry.idx,):
                view.used[member] = view.used.get(member, 0) + entry.units
        self._apply_usage_overlay(views, resource)
        return views

    def _views_from_pods(
        self, resource: str, nodes: list[dict], raw_pods: list[dict]
    ) -> list[logic.NodeView]:
        """List path from an already-fetched pod set: overlay + group +
        build, pure memory (safe under the decision lock)."""
        pods = self._overlay_pods(raw_pods)
        by_node = logic.group_pods_by_node(pods)
        views = [logic.build_node_view(n, by_node, resource) for n in nodes]
        self._apply_usage_overlay(views, resource)
        return views

    def _apply_usage_overlay(
        self, views: list[logic.NodeView], resource: str
    ) -> None:
        """Fold the shard layer's extra in-flight usage (cross-shard
        gang2pc reservations) into the views — pure memory, both the
        index and the list path run it so a prepared-but-undecided gang
        member is invisible to NO scoring read."""
        if self._usage_overlay_fn is None:
            return
        for view in views:
            extra = self._usage_overlay_fn(view.name, resource)
            if not extra:
                continue
            for idx, units in extra.items():
                view.used[idx] = view.used.get(idx, 0) + units

    def _fetch_cluster_pods(self) -> list[dict]:
        """The list-fallback's raw pod set: the synced cache, else one
        apiserver LIST. Network I/O — callers must not hold the decision
        lock (the lock-io rule pins this)."""
        if self._informer is not None and self._informer.synced:
            return self._informer.all_pods()
        return self._api.list_pods()

    def _overlay_pods(self, pods: list[dict]) -> list[dict]:
        out = []
        for pod in pods:
            if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
                continue
            out.append(pod)
        # overlay in-flight decisions not yet visible in the list
        inflight = self._live_inflight()
        by_key = {(p.get("metadata", {}).get("namespace", "default"),
                   p.get("metadata", {}).get("name", "")): i
                  for i, p in enumerate(out)}
        for (ns, name), entry in inflight.items():
            i = by_key.get((ns, name))
            if i is not None:
                # copy before overlay: with an informer these dicts ARE the
                # cache entries and must not be mutated
                pod = copy.deepcopy(out[i])
                meta = pod.setdefault("metadata", {})
                merged = dict(meta.get("annotations") or {})
                merged.update(entry.annotations)
                meta["annotations"] = merged
                pod.setdefault("spec", {}).setdefault("nodeName", entry.node)
                out[i] = pod
        return out

    def node_views(
        self, nodes: list[dict], resource: str
    ) -> list[logic.NodeView]:
        """CURRENT placement views with every overlay applied (in-flight
        binds, shard gang2pc reservations) — the public read the shard
        layer re-validates 2PC prepares, plans gang members, and builds
        routing summaries against. ONE in-flight overlay pass covers the
        whole node list (per-node calls would pay O(in-flight) each).
        Network I/O (the list-fallback LIST) runs before the decision
        lock, mirroring ``bind``."""
        resource = resource or logic.const.RESOURCE_MEM
        raw_pods = None if self._use_index() else self._fetch_cluster_pods()
        with self._lock:
            if raw_pods is None:
                return self._views_from_index(resource, nodes)
            return self._views_from_pods(resource, nodes, raw_pods)

    def node_view(self, node: dict, resource: str) -> logic.NodeView:
        """One node's :meth:`node_views`."""
        return self.node_views([node], resource)[0]

    def _nodes_from_args(self, args: dict) -> list[dict]:
        if args.get("nodes") and args["nodes"].get("items"):
            return args["nodes"]["items"]
        names = args.get("nodenames") or args.get("nodeNames") or []
        nodes = []
        for name in names:
            try:
                nodes.append(self._api.get_node(name))
            except ApiError:
                continue
        return nodes

    # --- webhook verbs ----------------------------------------------------

    def _admission_ctx(self, pod: dict) -> SpanContext | None:
        """The pod's admission-trace root context (created on first
        touch): what stitches the scheduler's separate filter/prioritize/
        bind webhook calls into ONE trace per admission. None for
        anonymous pods and unsampled traces — every verb span is
        ``child_only``, so None means the verb records nothing."""
        meta = pod.get("metadata", {}) if pod else {}
        name = meta.get("name", "")
        if not name:
            return None
        return ADMISSIONS.root(meta.get("namespace", "default"), name)

    @staticmethod
    def _pod_key_of(pod: dict) -> str:
        meta = pod.get("metadata", {}) if pod else {}
        name = meta.get("name", "")
        if not name:
            return ""
        return f"{meta.get('namespace', 'default')}/{name}"

    def filter(self, args: dict) -> dict:
        pod = args.get("pod") or {}
        nodes = self._nodes_from_args(args)
        ctx = self._admission_ctx(pod)
        try:
            with TRACER.span(
                "extender.filter", parent=ctx, child_only=True,
                attributes={"nodes": len(nodes)},
            ) as sp:
                fits, failed = logic.filter_with_views(
                    pod, nodes, self._node_views
                )
                sp.set_attribute("fits", len(fits))
                sp.set_attribute("failed", len(failed))
        finally:
            self._drain_expired_aborts()
        log.v(4, "filter %s: fits=%s failed=%s",
              pod.get("metadata", {}).get("name"), fits, list(failed))
        # Decision provenance: every rejected node with its reason, built
        # from the dicts the verb already computed (no copies).
        DECISIONS.emit(
            self._pod_key_of(pod), "filter",
            candidates=len(nodes), rejected=failed,
            trace_id=ctx.trace_id if ctx is not None else "",
            shard=self._shard,
        )
        fit_set = set(fits)
        return {
            "nodes": {"items": [n for n in nodes
                                if n.get("metadata", {}).get("name") in fit_set]},
            "nodenames": fits,
            "failedNodes": failed,
            "error": "",
        }

    def prioritize(self, args: dict) -> list[dict]:
        pod = args.get("pod") or {}
        nodes = self._nodes_from_args(args)
        ctx = self._admission_ctx(pod)
        try:
            with TRACER.span(
                "extender.prioritize", parent=ctx, child_only=True,
                attributes={"nodes": len(nodes)},
            ) as sp:
                scores = logic.prioritize_with_views(
                    pod, nodes, self._node_views, policy=self._policy
                )
                sp.set_attribute("scored", len(scores))
        finally:
            self._drain_expired_aborts()
        DECISIONS.emit(
            self._pod_key_of(pod), "prioritize",
            candidates=len(nodes), scores=scores,
            trace_id=ctx.trace_id if ctx is not None else "",
            shard=self._shard,
        )
        # The wire format stays the pinned 0-10 integer projection; the
        # decision record above keeps the full-resolution breakdown.
        return [
            {"host": host, "score": sv.projected}
            for host, sv in scores.items()
        ]

    def batch_scored(self, args: dict) -> dict:
        """The batch verb's rich (in-process) form: one view build per
        node serves both the fit check and the score, and the answer
        keeps the full-resolution :class:`ScoreVector` per fitting node
        — ``{"fits", "failed", "scores", "resource"}``. The shard router
        merges THESE across shards (projecting only at its own wire
        edge); :meth:`batch` is the wire projection for direct webhook
        callers. Emits this core's decision record (shard-tagged when
        the core is a shard)."""
        pod = args.get("pod") or {}
        nodes = self._nodes_from_args(args)
        resource = logic.pod_resource(pod)
        if resource is None:
            names = [n.get("metadata", {}).get("name", "") for n in nodes]
            DECISIONS.emit(
                self._pod_key_of(pod), "batch",
                candidates=len(nodes),
                reason="pod requests no share resource (all nodes pass)",
                shard=self._shard,
            )
            return {
                "fits": names, "failed": {}, "scores": {},
                "resource": None, "nodes": nodes,
            }
        request = P.mem_units_of_pod(pod, resource=resource)
        ctx = self._admission_ctx(pod)
        try:
            with TRACER.span(
                "extender.batch", parent=ctx, child_only=True,
                attributes={"nodes": len(nodes)},
            ) as sp:
                views = self._node_views(resource, nodes)
                fits, failed, scores = logic.evaluate_filter_and_scores(
                    request, views, policy=self._policy,
                    gang_shape=logic.pod_gang_shape(pod, resource),
                )
                sp.set_attribute("fits", len(fits))
        finally:
            self._drain_expired_aborts()
        DECISIONS.emit(
            self._pod_key_of(pod), "batch",
            candidates=len(nodes), rejected=failed, scores=scores,
            trace_id=ctx.trace_id if ctx is not None else "",
            shard=self._shard,
        )
        return {
            "fits": fits, "failed": failed, "scores": scores,
            "resource": resource, "nodes": nodes,
        }

    def batch(self, args: dict) -> dict:
        """Batched filter + prioritize in one verb: one view build and one
        free-vector computation per node serve both answers (the two-verb
        protocol builds views twice per scheduling cycle). Same args as
        filter; the response adds ``hostPriorityList`` for the fitting
        nodes. Not part of the upstream extender protocol — callers are
        our own tooling (bench, tests) and schedulers taught the route."""
        return batch_wire(self.batch_scored(args))

    def bind(self, args: dict) -> dict:
        """Persist the chip decision and create the v1 Binding.

        Concurrency design: the lock guards only the in-memory decision —
        build the node view, choose the chip, and *reserve* it by inserting
        the in-flight entry — never network I/O or a durability wait. The
        GET pod/node (and, in ``--pod-source list`` fallback mode, the
        cluster LIST) run *before* the lock; the PATCH + binding POST run
        after it — so binds to different nodes proceed in parallel instead
        of serializing the whole cluster's admission behind one apiserver
        round-trip or one WAL fsync (both the fallback LIST and the
        expired-entry journal abort run outside the lock for that). The
        reservation is visible to every concurrent decision through the
        in-flight overlay (``_node_views``), which is exactly how mid-PATCH
        decisions were already kept from double-booking; a failed PATCH or
        Binding rolls the reservation back.
        """
        ns = args.get("podNamespace", "default")
        name = args.get("podName", "")
        node_name = args.get("node", "")
        ctx = ADMISSIONS.root(ns, name) if name else None
        try:
            with TRACER.span(
                "extender.bind", parent=ctx, child_only=True,
                attributes={"node": node_name},
            ) as bsp:
                result = self._bind(args, ns, name, node_name, bsp)
                if result.get("error"):
                    bsp.set_attribute("bind_error", result["error"])
                    bsp.end("error")
        except BaseException:
            if name:
                ADMISSIONS.finish(ns, name, "error")
            raise
        else:
            if name:
                ADMISSIONS.finish(
                    ns, name, "error" if result.get("error") else "ok"
                )
            return result
        finally:
            # failure paths included: keys queued by _live_inflight()
            # during this verb must not wait for some later verb (an
            # idle-then-restarted extender would replay their journal
            # entries as stale reservations)
            self._drain_expired_aborts()

    def _bind(
        self, args: dict, ns: str, name: str, node_name: str, bsp: Any
    ) -> dict:
        try:
            # Callers that already hold the objects (the shard router,
            # schedulers speaking the full ExtenderArgs shape) pass them
            # along; the GETs are the fallback for name-only callers.
            pod = args.get("podObject") or self._api.get_pod(ns, name)
            node = args.get("nodeObject") or self._api.get_node(node_name)
            resource = logic.pod_resource(pod)
            if resource is None:
                raise AssignmentError("pod requests no share resource")
            gang_shape = logic.pod_gang_shape(pod, resource)
            # list-fallback prefetch: the LIST is network I/O and must not
            # run under the decision lock. The in-flight overlay is still
            # applied under the lock, so concurrent binds see each other;
            # the LIST data itself is no staler than it already was.
            raw_pods = (
                None if self._use_index() else self._fetch_cluster_pods()
            )
            with TRACER.span("extender.decide", child_only=True) as dsp:
                with self._lock:
                    if raw_pods is None:
                        view = self._views_from_index(resource, [node])[0]
                    else:
                        view = self._views_from_pods(
                            resource, [node], raw_pods
                        )[0]
                    if gang_shape:
                        # gang bind: ONE decision covering every member
                        # chip, reserved whole in the in-flight overlay
                        # before any network write — all-or-nothing from
                        # the first moment
                        _, chips, per_chip, annotations, score = (
                            logic.choose_gang_scored(
                                pod, view, policy=self._policy
                            )
                        )
                        idx, units = chips[0], per_chip
                    else:
                        chips = ()
                        _, idx, annotations, score = logic.choose_chip_scored(
                            pod, view, policy=self._policy
                        )
                        units = P.mem_units_of_pod(pod, resource=resource)
                    self._inflight[(ns, name)] = _Inflight(
                        node=node_name,
                        resource=resource,
                        idx=idx,
                        units=units,
                        annotations=annotations,
                        stamp=time.monotonic(),
                        chips=tuple(chips),
                    )
                dsp.set_attribute("chip", list(chips) if chips else idx)
            # The bind span's context rides the PATCH as the trace-id
            # annotation: the device plugin's allocator adopts it after
            # the pod match, stitching the two processes into one trace.
            if bsp.recording:
                annotations[logic.const.ANN_TRACE_ID] = bsp.context().encode()
            # WAL begin before the PATCH/Binding: a crash inside the next
            # block leaves an unresolved entry the restarted extender's
            # warmup serves from (and a journal-less crash would forget).
            seq = None
            if self._ckpt is not None:
                with TRACER.span("wal.begin", child_only=True):
                    seq = self._ckpt.begin((ns, name), {
                        "node": node_name,
                        "resource": resource,
                        "idx": idx,
                        "units": units,
                        "chips": list(chips),
                        "annotations": annotations,
                        "ts": time.time(),  # warmup ages stale entries out by this
                    })
                # stamp the overlay entry with its begin incarnation so a
                # later TTL expiry aborts exactly this record
                with self._lock:
                    entry = self._inflight.get((ns, name))
                    if entry is not None:
                        entry.seq = seq
            try:
                with TRACER.span("pod.patch", child_only=True):
                    self._api.patch_pod(
                        ns, name, {"metadata": {"annotations": annotations}}
                    )
                with TRACER.span("pod.bindv1", child_only=True):
                    self._api.bind_pod(ns, name, node_name)
            except Exception:
                with self._lock:
                    self._inflight.pop((ns, name), None)
                # resolve OUR begin incarnation only: a slow failing PATCH
                # can overlap a fresh same-key begin (pod recreated under
                # the same name), which an unguarded abort would pop. A
                # degraded begin (seq None) journaled nothing to resolve.
                if self._ckpt is not None and seq is not None:
                    with TRACER.span("wal.abort", child_only=True):
                        self._ckpt.abort((ns, name), seq=seq)
                raise
            if self._ckpt is not None and seq is not None:
                with TRACER.span("wal.commit", child_only=True):
                    self._ckpt.commit((ns, name), seq=seq)
        except (ApiError, AssignmentError) as e:
            log.warning("bind %s/%s -> %s failed: %s", ns, name, node_name, e)
            from ..cluster.events import REASON_BIND_FAILED, emit_pod_event

            emit_pod_event(
                self._api,
                {"metadata": {"namespace": ns, "name": name}},
                REASON_BIND_FAILED,
                f"bind to {node_name} failed: {e}",
                component="tpushare-scheduler-extender",
                host=node_name,
            )
            # a rejected bind deserves a "why" as much as a granted one
            DECISIONS.emit(
                f"{ns}/{name}", "bind", outcome="error",
                node=node_name, reason=str(e),
                trace_id=bsp.trace_id if bsp.recording else "",
                shard=self._shard,
            )
            return {"error": str(e)}
        if chips:
            placement = {
                "chips": list(chips),
                "per_chip": units,
                "shape": annotations.get(logic.const.ENV_GANG_SHAPE, ""),
            }
            log.info(
                "bound gang %s/%s -> %s chips %s (%d units/chip)",
                ns, name, node_name, list(chips), units,
            )
        else:
            placement = {"chip": idx, "units": units}
            log.info("bound %s/%s -> %s chip %d", ns, name, node_name, idx)
        DECISIONS.emit(
            f"{ns}/{name}", "bind",
            node=node_name, scores={node_name: score}, placement=placement,
            trace_id=bsp.trace_id if bsp.recording else "",
            seq=seq, shard=self._shard,
        )
        return {"error": ""}


def batch_wire(rich: dict) -> dict:
    """THE rich->wire projection for the batch verb, shared by the
    single core and the shard router so the two deployments' response
    shapes can never drift. ``rich`` is a ``batch_scored`` result (or
    the router's cross-shard merge of several): 0-10 projected scores,
    hostPriorityList ordered best-first by the RAW fractional score
    (deterministic tie-break — the integer scale ties most nodes at
    fleet scale; the wire VALUES are the pinned projection, only the
    list order is added)."""
    nodes = rich["nodes"]
    if rich["resource"] is None:
        names = rich["fits"]
        return {
            "nodes": {"items": nodes},
            "nodenames": names,
            "failedNodes": {},
            "hostPriorityList": [{"host": n, "score": 0} for n in names],
            "error": "",
        }
    fits, failed, scores = rich["fits"], rich["failed"], rich["scores"]
    fit_set = set(fits)
    return {
        "nodes": {"items": [n for n in nodes
                            if n.get("metadata", {}).get("name") in fit_set]},
        "nodenames": fits,
        "failedNodes": failed,
        "hostPriorityList": [
            {"host": name, "score": scores[name].projected}
            for name in rank_scores(scores)
        ],
        "error": "",
    }


class ExtenderHTTPServer:
    def __init__(self, core: ExtenderCore, host: str = "0.0.0.0", port: int = 32766) -> None:
        self._core = core
        self._host = host
        self._port = port
        self._server: ThreadingHTTPServer | None = None

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def start(self) -> None:
        core = self._core

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive matters twice over: the scheduler calls the webhook
            # per scheduling cycle, and each handler thread caches its own
            # persistent apiserver connection (ApiServerClient._connection
            # is thread-local) — HTTP/1.0's connection-per-request would
            # pay a fresh apiserver TCP/TLS handshake on every verb.
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: object) -> None:
                log.v(6, fmt, *args)

            def _send(self, code: int, body: object) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                if self.path in ("/version", "/healthz"):
                    return self._send(200, {"version": "v1", "ok": True})
                return self._send(404, {"error": "not found"})

            def do_POST(self) -> None:
                from ..utils.metrics import REGISTRY

                n = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._send(400, {"error": "bad json"})
                verbs = {
                    "/scheduler/filter": core.filter,
                    "/scheduler/prioritize": core.prioritize,
                    "/scheduler/batch": core.batch,
                    "/scheduler/bind": core.bind,
                }
                fn = verbs.get(self.path)
                if fn is None:
                    return self._send(404, {"error": f"unknown path {self.path}"})
                verb = self.path.rsplit("/", 1)[-1]
                t0 = time.perf_counter()
                try:
                    result = fn(body)
                except Exception as e:  # keep the webhook alive
                    log.error("extender verb %s failed: %s", self.path, e)
                    REGISTRY.counter_inc(
                        EXTENDER_VERB_TOTAL,
                        "Webhook verbs by outcome", verb=verb, outcome="error",
                    )
                    return self._send(200, {"error": str(e)})
                REGISTRY.observe(
                    EXTENDER_VERB_SECONDS,
                    time.perf_counter() - t0,
                    "Webhook verb latency", verb=verb,
                )
                REGISTRY.counter_inc(
                    EXTENDER_VERB_TOTAL,
                    "Webhook verbs by outcome", verb=verb, outcome="ok",
                )
                return self._send(200, result)

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        log.info("scheduler extender listening on %s:%d", self._host, self.port)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpushare-scheduler-extender")
    p.add_argument("--port", type=int, default=32766)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--policy", default="best-fit", choices=["first-fit", "best-fit", "spread"])
    p.add_argument("--placement-policy", default="",
                   help="pluggable placement policy from the registry "
                   "(greedy-binpack | multi-objective | learned | "
                   "anything register_policy()'d); overrides --policy. "
                   "Empty keeps the legacy chip-policy scorer")
    p.add_argument("--pod-source", default="informer", choices=["informer", "list"],
                   help="watch-backed cluster pod cache (default) or a full "
                   "LIST per webhook call")
    p.add_argument("--checkpoint-path", default="",
                   help="bind-decision WAL file; a restarted extender "
                   "warms its in-flight overlay from it instead of "
                   "double-booking chips whose bind is not yet on the "
                   "watch (empty disables)")
    p.add_argument("--wal-fsync", default="batch",
                   choices=["always", "batch"],
                   help="bind-WAL durability mode (same group-commit "
                   "writer as the device plugin's journal): 'batch' "
                   "amortizes one fsync across concurrent binds, 'always' "
                   "fsyncs per record")
    p.add_argument("--wal-batch-window-ms", type=float, default=2.0,
                   help="group-commit gather window in milliseconds")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve Prometheus /metrics (+ /traces OTLP-JSON) "
                   "on this port (0 = off)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="admission-trace sample ratio in [0,1]: each "
                   "pod's filter->bind trace is kept with this "
                   "probability (0 disables tracing; unsampled "
                   "admissions pay O(ns))")
    p.add_argument("--decisions-ring", type=int, default=512,
                   help="in-memory decision-provenance ring size (per-"
                   "verb 'why' records served on /decisions; 0 disables "
                   "emission)")
    p.add_argument("--decisions-log", default="",
                   help="optional on-disk decision segment log (JSON "
                   "lines, fsync-free, size-rotated); empty disables")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    args = p.parse_args(argv)
    logutil.setup(args.verbosity)
    TRACER.configure(sample_ratio=args.trace_sample)
    DECISIONS.configure(
        enabled=args.decisions_ring > 0,
        max_records=max(1, args.decisions_ring),
        segment_path=args.decisions_log,
    )
    # The metrics server (and its /healthz — the liveness probe) comes up
    # FIRST: informer sync, WAL load, and the core's serve-from-
    # checkpoint warmup can take long after a crash storm, and a
    # liveness probe that cannot reach /healthz during replay would
    # kubelet-kill the container into an eternal replay loop. /readyz is
    # late-bound: 503 until the core exists AND reports ready (informer
    # synced + warmup done in its constructor).
    core_ref: list[ExtenderCore] = []
    metrics_server = None
    if args.metrics_port:
        from ..utils.metrics import MetricsServer, publish_build_info

        publish_build_info(component="extender")
        metrics_server = MetricsServer(
            port=args.metrics_port,
            ready_fn=lambda: bool(core_ref) and core_ref[0].ready(),
        ).start()
        log.info("metrics on :%d/metrics", metrics_server.port)
    try:
        api = ApiServerClient.from_env(timeout_s=args.timeout)
    except Exception as e:
        log.fatal(f"apiserver config failed: {e}")
    informer = None
    if args.pod_source == "informer":
        from ..cluster.informer import PodInformer

        informer = PodInformer(api).start()
    checkpoint = None
    if args.checkpoint_path:
        from ..allocator.checkpoint import AllocationCheckpoint

        try:
            checkpoint = AllocationCheckpoint(
                args.checkpoint_path,
                fsync=args.wal_fsync,
                batch_window_s=args.wal_batch_window_ms / 1000.0,
            )
        except OSError as e:
            log.warning("bind checkpoint unavailable (%s); running without", e)
    policy: "str | logic.PlacementPolicy" = args.policy
    if args.placement_policy:
        from .policy import get_policy

        policy = get_policy(args.placement_policy)
    core = ExtenderCore(
        api, policy=policy, informer=informer, checkpoint=checkpoint
    )
    core_ref.append(core)
    server = ExtenderHTTPServer(core, host=args.host, port=args.port)
    server.start()
    try:
        wait_for_stop()
    except KeyboardInterrupt:
        pass
    server.stop()
    if informer is not None:
        informer.stop()
    if metrics_server is not None:
        metrics_server.stop()
    return 0


def wait_for_stop() -> None:
    """Park the main thread until SIGTERM (what the kubelet sends a pod it
    stops) or SIGINT; the caller then shuts down and exits 0."""
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()


if __name__ == "__main__":
    sys.exit(main())
