"""Periodic drift reconciler: annotations vs. ledger vs. checkpoint vs. kubelet.

Counterpart of ``gpushare_device_plugin_tpu/cluster/reconciler.py``.

Hot state now lives in four places — apiserver pod annotations (the
database), the AssumeCache reservation ledger (in-flight protection), the
allocation checkpoint (crash-surviving WAL), and kubelet's own notion of
which device IDs it granted. They are kept coherent by construction on the
happy path; this reconciler is the backstop for every path that isn't:
pods deleted mid-allocation, PATCHes that landed after their daemon died,
reservations whose owner hung, duplicate daemons racing a rollout.

One pass (``reconcile_once``):

1. **fence check** — verify this daemon's generation still owns the node
   annotation; a superseded instance latches fenced (allocation writes
   refuse) and skips repairs (the newer instance owns them).
2. **TTL expiry** — reap ledger entries older than the AssumeCache TTL
   (a crashed or hung PATCH can never permanently strand capacity).
3. **checkpoint resolution** — every replayed journal entry is resolved
   against the apiserver: pod assigned -> retro-commit (the crashed PATCH
   won); pod gone or unassigned -> retro-abort (nothing persisted).
   Either way its ledger reservation is released. Entries whose pod key
   is currently *claimed* belong to a live admission and are skipped.
   ``"handoff"`` and ``"scale"`` entries resolve by protocol phase
   through their hooks; ``"move"`` entries (live defragmentation,
   ``allocator/defrag.py``) resolve by phase too: roll forward past
   ``switch`` (re-issue the PATCH, restore the drained engine snapshot on
   the destination), roll back before it.
4. **ledger orphans** — unclaimed reservations whose pod is authoritatively
   gone (deleted mid-allocation) or already counted by annotations
   (redundant) are released.
5. **annotation audit** — assigned pods with garbled chip annotations and
   per-chip overcommit (annotations promising more than inventory) are
   counted as drift; they are observable, not auto-mutated — annotations
   are the database, and a reconciler that "fixes" the database on a
   hunch is how real outages start.
6. **kubelet diff** — when a grants feed is available (tests; the
   podresources API in production), pods assigned in annotations but
   unknown to kubelet — and vice versa — are counted as drift.

Everything emits ``tpushare_reconcile_drift_total{kind=...}`` /
``tpushare_reconcile_repairs_total{kind=...}`` so an operator can alert on
a node that keeps needing repair.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from .. import const
from ..allocator.assume import AssumeCache, PodKey
from ..allocator.checkpoint import AllocationCheckpoint
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY
from . import pods as P
from ..utils.metric_catalog import (
    RECONCILE_DRIFT_TOTAL as DRIFT_METRIC,
    RECONCILE_REPAIRS_TOTAL as REPAIR_METRIC,
    RECONCILE_RUNS_TOTAL as RUNS_METRIC,
    RECONCILE_SECONDS as DURATION_METRIC,
)

log = get_logger("cluster.reconciler")

DRIFT_HELP = (
    "State divergences observed between annotations, the reservation "
    "ledger, the checkpoint, and kubelet grants, by kind"
)
REPAIR_HELP = "Divergences repaired (released/resolved), by kind"
RUNS_HELP = "Reconcile passes by outcome"
DURATION_HELP = "Wall time of one reconcile pass"

DEFAULT_INTERVAL_S = 30.0


class DriftReconciler:
    def __init__(
        self,
        api: Any,
        pod_source: Any,
        assume: AssumeCache,
        checkpoint: AllocationCheckpoint | None = None,
        node_name: str = "",
        inventory: Any = None,
        kubelet_grants_fn: Callable[[], dict[PodKey, list[str]]] | None = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        on_fenced: Callable[[], None] | None = None,
        move_restore_fn: Callable[[PodKey, dict | None], None] | None = None,
        handoff_deliver_fn: Callable[[str, dict], str] | None = None,
        handoff_abort_fn: Callable[[str], Any] | None = None,
        scale_deliver_fn: Callable[[str, dict], Any] | None = None,
        scale_requeue_fn: Callable[[str, dict], Any] | None = None,
    ) -> None:
        """``kubelet_grants_fn() -> dict[PodKey, list[str]]`` supplies
        kubelet's granted device IDs per pod when a feed exists (the fake
        kubelet in tests; the podresources socket in production); None
        skips that diff. ``on_fenced()`` fires once when this instance
        discovers it was superseded. ``move_restore_fn(pod_key, snapshot)``
        re-admits a drained engine snapshot on the destination slice when
        a defragmentation move is rolled forward (allocator/defrag.py).
        ``handoff_deliver_fn(handoff_id, record)`` /
        ``handoff_abort_fn(handoff_id)`` are the decode tier's idempotent
        delivery sink and staging release for journaled KV handoffs found
        mid-protocol (serving/handoffproto.py); without a deliver hook a
        handoff entry stays pending — protective, never resolved blind.
        ``scale_deliver_fn(scale_id, record)`` /
        ``scale_requeue_fn(scale_id, record)`` are the fleet binding's
        survivor-restore and un-cordon/re-queue hooks for journaled
        scale-downs found mid-protocol (serving/router.py); same
        protective default without a deliver hook."""
        self._api = api
        self._pods = pod_source
        self._assume = assume
        self._ckpt = checkpoint
        self._node = node_name
        self._inv = inventory
        self._grants_fn = kubelet_grants_fn
        self._interval = interval_s
        self._on_fenced = on_fenced
        self._move_restore = move_restore_fn
        self._handoff_deliver = handoff_deliver_fn
        self._handoff_abort = handoff_abort_fn
        self._scale_deliver = scale_deliver_fn
        self._scale_requeue = scale_requeue_fn
        self._fenced_notified = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "DriftReconciler":
        self._thread = threading.Thread(
            target=self._run, name="drift-reconciler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        # first pass immediately: the post-restart replay set should be
        # resolved as soon as the control plane answers, not interval_s later
        while True:
            try:
                self.reconcile_once()
            except Exception as e:  # noqa: BLE001 — never kill the loop
                log.warning("reconcile pass failed: %s", e)
                REGISTRY.counter_inc(RUNS_METRIC, RUNS_HELP, outcome="error")
            if self._stop.wait(self._interval):
                return

    # --- the pass ---------------------------------------------------------

    def reconcile_once(self) -> dict[str, int]:
        """One full pass; -> counts by drift kind (for tests/logging)."""
        t0 = time.perf_counter()
        counts: dict[str, int] = {}

        def drift(kind: str, repaired: bool = False, n: int = 1) -> None:
            counts[kind] = counts.get(kind, 0) + n
            REGISTRY.counter_inc(DRIFT_METRIC, DRIFT_HELP, value=n, kind=kind)
            if repaired:
                REGISTRY.counter_inc(REPAIR_METRIC, REPAIR_HELP, value=n, kind=kind)

        # 1. fencing: a superseded daemon must stop writing AND stop
        # repairing — the newer instance owns both.
        if not self._check_fence(drift):
            REGISTRY.counter_inc(RUNS_METRIC, RUNS_HELP, outcome="fenced")
            return counts

        # 2. TTL expiry (the ledger's own lazy reaping, forced eagerly here
        # so a quiet node still unstrands within one reconcile interval)
        for key in self._assume.expire_stale():
            log.warning("reconcile: expired stale ledger entry for %s/%s", *key)
            drift("expired_reservation", repaired=True)

        # one refresh so "absent from the source" below means absent from
        # the apiserver now, not absent from a stale cache
        authoritative = True
        try:
            self._pods.refresh()
        except Exception as e:  # noqa: BLE001 — outage: observe, don't repair
            log.v(4, "reconcile: refresh failed (%s); repairs deferred", e)
            authoritative = False

        # 3. checkpoint resolution
        if self._ckpt is not None:
            self._resolve_checkpoint(drift)

        # 4. ledger orphans
        if authoritative:
            self._release_orphan_reservations(drift)

        # 5. annotation audit (observability only)
        self._audit_annotations(drift)

        # 6. kubelet grants diff
        if self._grants_fn is not None:
            self._diff_kubelet_grants(drift)

        REGISTRY.counter_inc(RUNS_METRIC, RUNS_HELP, outcome="ok")
        REGISTRY.observe(
            DURATION_METRIC, time.perf_counter() - t0, DURATION_HELP
        )
        if counts:
            log.info("reconcile pass repaired/observed drift: %s", counts)
        return counts

    # --- steps ------------------------------------------------------------

    def _check_fence(self, drift) -> bool:
        if self._ckpt is None or self._api is None or not self._node:
            return True
        try:
            ok = self._ckpt.verify_fence(self._api, self._node)
        except Exception as e:  # noqa: BLE001 — can't read the node: assume ok
            log.v(4, "reconcile: fence verify failed (%s); assuming owned", e)
            return True
        if not ok:
            drift("fenced")
            if not self._fenced_notified:
                self._fenced_notified = True
                if self._on_fenced is not None:
                    try:
                        self._on_fenced()
                    except Exception as e:  # noqa: BLE001 — notify hook
                        # a dead hook must not stop fencing, but eating it
                        # silently hid real wiring bugs (found by tpulint's
                        # hygiene rule; docs/analysis.md defects table)
                        log.warning("fenced-notification hook failed: %s", e)
        return ok

    def _fetch_pod(self, key: PodKey) -> tuple[dict | None, bool]:
        """-> (pod or None, authoritative). The apiserver GET is the truth;
        a cached source read is good enough only for presence, never for
        a deletion verdict."""
        if self._api is not None:
            from .apiserver import ApiError

            try:
                return self._api.get_pod(*key), True
            except ApiError as e:
                if e.status == 404:
                    return None, True
                return None, False
            except Exception:  # noqa: BLE001 — outage
                return None, False
        get_pod = getattr(self._pods, "get_pod", None)
        if get_pod is not None:
            return get_pod(*key), False
        return None, False

    def _resolve_checkpoint(self, drift) -> None:
        for key, data in self._ckpt.pending().items():
            if self._assume.is_claimed(key):
                continue  # a live admission owns this entry
            if data.get("kind") == "move":
                # a defragmentation move found mid-protocol: resolved by
                # phase — roll forward past "switch" (re-issue the PATCH,
                # restore the drained snapshot on the destination), roll
                # back before it (allocator/defrag.py owns the rules)
                if self._api is None:
                    continue  # no authoritative read: stay protective
                from ..allocator import defrag

                outcome = defrag.resolve_move(
                    self._ckpt, self._assume, self._api, key, data,
                    restore_fn=self._move_restore,
                )
                if outcome is not None:
                    drift(f"move_{outcome}", repaired=True)
                continue
            if data.get("kind") == "handoff":
                # a prefill->decode KV handoff found mid-protocol:
                # resolved by phase — roll forward (re-deliver,
                # idempotent by handoff id) at or past "import", roll
                # back to a local re-prefill before it. BOTH directions
                # end in a delivery through the decode tier's sink, so
                # the request is served exactly once whatever step the
                # crash hit (serving/handoffproto.py owns the rules).
                if self._handoff_deliver is None:
                    continue  # no decode tier wired: stay protective
                from ..serving import handoffproto

                outcome = handoffproto.resolve_handoff(
                    self._ckpt, self._assume, key, data,
                    deliver_fn=self._handoff_deliver,
                    abort_fn=self._handoff_abort,
                )
                if outcome is not None:
                    drift(f"handoff_{outcome}", repaired=True)
                continue
            if data.get("kind") == "scale":
                # a fleet scale-down found mid-protocol: resolved by
                # phase — roll forward (re-deliver the journaled drain
                # snapshot to a survivor, idempotent by snapshot_id) at
                # or past "migrate", roll back (un-cordon the replica
                # or re-queue the journaled rows on survivors) before
                # it. BOTH directions end with every in-flight request
                # scheduled exactly once (serving/router.py owns the
                # rules).
                if self._scale_deliver is None:
                    continue  # no fleet wired: stay protective
                from ..serving import router as fleet_router

                outcome = fleet_router.resolve_scale(
                    self._ckpt, self._assume, key, data,
                    deliver_fn=self._scale_deliver,
                    requeue_fn=self._scale_requeue,
                )
                if outcome is not None:
                    drift(f"scale_{outcome}", repaired=True)
                continue
            pod, authoritative = self._fetch_pod(key)
            if not authoritative:
                continue  # resolve next pass, reservation stays protective
            # The claim check above predates the slow GET: a kubelet retry
            # may have claimed the key and journaled a NEW begin since.
            # Resolution is therefore conditional on both the entry's seq
            # (only the incarnation we inspected resolves) and the claim
            # state at release time (a live worker keeps its reservation).
            seq = data.get("_seq")
            if pod is not None and P.is_assigned(pod):
                # the crashed PATCH won: the annotation is the record now
                if self._ckpt.commit(key, seq=seq):
                    self._assume.release_if_unclaimed(key)
                    log.info(
                        "reconcile: journal entry for %s/%s committed "
                        "(PATCH had landed before the crash)", *key
                    )
                    drift("replayed_commit", repaired=True)
            else:
                # pod gone, or still pending unassigned: nothing persisted
                if self._ckpt.abort(key, seq=seq):
                    self._assume.release_if_unclaimed(key)
                    log.info(
                        "reconcile: journal entry for %s/%s aborted "
                        "(no assignment persisted)", *key
                    )
                    drift("replayed_abort", repaired=True)

    def _release_orphan_reservations(self, drift) -> None:
        claims, mem, core = self._assume.snapshot()
        # Gang reservations are one atomic entry per pod: releasing an
        # orphaned gang frees EVERY member chip in this same pass — the
        # ledger cannot represent (and this loop cannot create) a
        # single-chip sliver of a partially-released gang.
        gang = self._assume.gang_snapshot()
        for key in list(mem) + list(core) + list(gang):
            if key in claims:
                continue  # live admission mid-PATCH: not drift
            if self._ckpt is not None and key in self._ckpt.pending():
                continue  # checkpoint resolution owns this one
            pod, authoritative = self._fetch_pod(key)
            if not authoritative:
                continue
            # release_if_unclaimed: the claim state is re-checked under
            # the ledger lock — a worker that claimed during the GET
            # keeps its reservation (see _resolve_checkpoint).
            if pod is None:
                if self._assume.release_if_unclaimed(key):
                    log.warning(
                        "reconcile: released reservation for deleted pod "
                        "%s/%s", *key,
                    )
                    drift("orphan_reservation", repaired=True)
            elif P.is_assigned(pod):
                # annotations count the pod; the reservation is redundant
                if self._assume.release_if_unclaimed(key):
                    drift("redundant_reservation", repaired=True)

    def _audit_annotations(self, drift) -> None:
        try:
            labeled = self._pods.labeled_pods()
        except Exception:  # noqa: BLE001
            return
        units_by_index = (
            self._inv.units_by_index() if self._inv is not None else None
        )
        used: dict[int, int] = {}
        for pod in labeled:
            if not P.is_active(pod) or not P.is_assigned(pod):
                continue
            if P.core_chips_of_pod(pod) > 0:
                if not P.core_hold_chips(pod):
                    drift("garbled_annotation")
                continue
            # Key on the GRANT annotation only (matching
            # gang_usage_by_chip): a pod that merely REQUESTS a gang
            # shape but was admitted single-chip (pre-gang daemon, or a
            # fallback path) is accounted by its IDX like every layer
            # accounts it — classing it garbled would drop its real
            # units from the overcommit sums.
            if const.ENV_GANG_CHIPS in P.annotations(pod):
                gang = P.gang_usage_by_chip(pod)
                if not gang:
                    # assigned gang with no usable member set / per-chip
                    # share: the grant is unaccountable
                    drift("garbled_annotation")
                    continue
                bad = [
                    i for i in gang
                    if units_by_index is not None and i not in units_by_index
                ]
                if bad:
                    drift("unknown_chip", n=len(bad))
                for i, per in gang.items():
                    if i in bad:
                        continue  # already reported; counting an off-
                        # inventory chip would re-fire as overcommit too
                    used[i] = used.get(i, 0) + per
                continue
            idx = P.chip_idx_from_annotation(pod)
            if idx < 0:
                drift("garbled_annotation")
                continue
            if units_by_index is not None and idx not in units_by_index:
                drift("unknown_chip")
                continue
            used[idx] = used.get(idx, 0) + P.mem_units_of_pod(pod)
        if units_by_index is not None:
            for idx, n in used.items():
                if n > units_by_index.get(idx, 0):
                    log.error(
                        "reconcile: chip %d overcommitted by annotations "
                        "(%d > %d units)", idx, n, units_by_index.get(idx, 0),
                    )
                    drift("overcommit")

    def _diff_kubelet_grants(self, drift) -> None:
        try:
            grants = self._grants_fn() or {}
        except Exception as e:  # noqa: BLE001
            log.v(4, "reconcile: kubelet grants read failed: %s", e)
            return
        try:
            labeled = self._pods.labeled_pods()
        except Exception:  # noqa: BLE001
            return
        assigned = {
            (P.namespace(p), P.name(p))
            for p in labeled
            if P.is_active(p) and P.is_assigned(p)
        }
        grant_keys = {tuple(k) for k in grants}
        for key in sorted(assigned - grant_keys):
            log.v(
                4, "reconcile: pod %s/%s assigned in annotations but "
                "unknown to kubelet", *key,
            )
            drift("kubelet_unknown")
        for key in sorted(grant_keys - assigned):
            log.v(
                4, "reconcile: kubelet granted devices to %s/%s which has "
                "no assignment annotation", *key,
            )
            drift("kubelet_orphan")
