"""The production Allocate() flow: kubelet grant -> pod match -> chip pick
-> apiserver persistence -> env/device payload.

Counterpart of ``gpushare_device_plugin_tpu/allocator/cluster.py``,
copied whole: the same annotations, envs, journal records and refusals,
so a node's state written by either package's daemon is read by the
other's.

Faithful to the reference's critical path (``allocate.go:27-134``, traced in
SURVEY.md section 3.2) with its failure semantics:

1. The granted fake-ID lists are only *counted* (which IDs kubelet picked is
   meaningless by design).
2. The pending pod being admitted is identified by matching the request
   total against candidate pods' summed limits, oldest first. Two
   same-size pods admitted concurrently can swap allocations — a design
   hazard inherited from the reference (``allocate.go:51-61``); harmless
   for fungible HBM slices since both pods get *a* valid placement, and
   the annotation write is what the rest of the system trusts.
3. Placement: the scheduler-extender's annotation wins if the pod was
   assumed (branch A, ``allocate.go:75-84``); otherwise first-fit binpack
   over apiserver-derived usage (branch B, ``allocate.go:85-98``).
4. The decision is persisted as pod annotations + the tpushare label via
   strategic-merge patch, retried once on optimistic-lock conflicts
   (``allocate.go:136-150``). The apiserver is the only database; restart
   re-derives everything.

Concurrency design (replaces the reference's single mutex,
``allocate.go:42-43``): the flow is sharded so concurrent kubelet
admission workers for different pods proceed in parallel —

- *match* is serialized per request size only (striped locks): two
  same-size pods admitted concurrently keep the documented oldest-first
  semantics because the first worker *claims* its match in the shared
  ``AssumeCache`` and the second matches the next oldest candidate;
- *placement* is one atomic in-memory transaction against the ledger:
  usage snapshot + in-flight reservation overlay + chip decision +
  reservation, so two in-flight placements cannot double-book a chip;
- *persist* (the apiserver PATCH — the dominant wall-clock cost) runs
  under no lock at all; the reservation covers the pod until its PATCHed
  copy is visible in the pod source.

The same-size-pod match hazard documented above (point 2) is unchanged:
two same-size pods can still swap allocations — each still gets *a*
valid placement, never the same one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Sequence

from .. import const
from ..cluster import pods as P
from ..cluster.apiserver import ApiError, ApiServerClient
from ..cluster.events import REASON_ALLOC_FAILED, emit_pod_event
from ..cluster.podsource import PodSource
from ..cluster.usage import pod_counts_toward_usage
from ..device.fanout import DeviceInventory
from ..topology import ChipTopology, format_shape, pad3, parse_shape, shape_size
from ..utils.decisions import DECISIONS, chip_breakdown
from ..utils.faults import FAULTS
from ..utils.log import get_logger
from ..utils.metrics import timed_acquire
from ..utils.tracing import TRACER, parse_context
from .assume import LOCK_WAIT_HELP, LOCK_WAIT_METRIC, AssumeCache, PodKey
from .checkpoint import AllocationCheckpoint, StaleDaemonError
from .binpack import assign_chip
from ..utils.lockrank import make_lock
from .env import (
    ContainerAllocation,
    build_core_allocation,
    build_gang_allocation,
    build_mem_allocation,
)

log = get_logger("allocator.cluster")

# Match stripes: same-size matches must serialize (they compete for the
# same oldest candidate); different sizes never do. 8 stripes is plenty —
# the stripe is held only for the in-memory match, not the PATCH.
NUM_MATCH_STRIPES = 8


def _pod_key(pod) -> PodKey:
    return P.namespace(pod), P.name(pod)


def _adopt_pod_trace(pod) -> None:
    """Stitch this Allocate into the extender's admission trace: the pod
    identity is only known after the match, so the open span stack is
    re-parented under the bind-span context the extender recorded in the
    ``tpushare.aliyun.com/trace-id`` annotation (no-op for branch-B pods
    the extender never touched, and for garbled annotations)."""
    TRACER.adopt_current_trace(
        parse_context(P.annotations(pod).get(const.ANN_TRACE_ID))
    )


def _current_trace_id() -> str:
    """The stitched admission trace id for decision records (after
    ``_adopt_pod_trace`` this is the SAME trace the extender's bind
    record carries — the join key between the two processes' "why"s)."""
    ctx = TRACER.current_context()
    return ctx.trace_id if ctx is not None else ""


def _counted_by_source(pod_source, key: PodKey) -> bool:
    """True when the pod source's own accounting already covers the
    reserved pod (its PATCHed copy landed in the cache) — the reservation
    overlay skips it to avoid double-counting. List-backed sources expose
    no ``get_pod``; their reservations count until released, which is
    conservative (over-counts briefly, never double-books)."""
    get_pod = getattr(pod_source, "get_pod", None)
    if get_pod is None:
        return False
    pod = get_pod(*key)
    return pod is not None and pod_counts_toward_usage(pod)


def _live_candidate(pod_source, pod, node: str, units: int, resource: str):
    """Re-evaluate a matched candidate against the source's *current*
    state. The match snapshot can predate a concurrent worker's
    note_pod_update: its claim is released only after the PATCHed copy is
    in the cache, so a candidate that is (a) unclaimed and (b) still a
    candidate in the live copy is genuinely unowned. Returns the live pod
    (the copy to place/persist) or None. Sources without ``get_pod`` run
    fully serialized (``_serial_guard``) and skip this check."""
    get_pod = getattr(pod_source, "get_pod", None)
    if get_pod is None:
        return pod
    live = get_pod(P.namespace(pod), P.name(pod))
    if live is None:
        return None
    if P.phase(live) != "Pending" or P.node_name(live) != node:
        return None
    if P.mem_units_of_pod(live, resource=resource) != units:
        return None
    if P.is_assumed(live) and P.is_assigned(live):
        return None
    return live


def _journal_begin(ckpt, key: PodKey, data: dict) -> None:
    """WAL begin before the PATCH. Fencing refusal is a hard admission
    failure (two writers double-book); journal I/O trouble is handled
    inside the checkpoint (degrade to unjournaled, never block admission).
    """
    if ckpt is None:
        return
    try:
        ckpt.begin(key, data)
    except StaleDaemonError as e:
        raise AllocationFailure(
            f"stale daemon instance refuses to allocate: {e}"
        ) from e


def _journal_resolve(ckpt, key: PodKey, op: str) -> None:
    if ckpt is None:
        return
    (ckpt.commit if op == "commit" else ckpt.abort)(key)


def _serial_guard(pod_source, assume: AssumeCache):
    """The sharded flow is safe only when a matcher can re-verify a stale
    candidate against live state (``get_pod``). List-backed sources can't
    offer that — a LIST snapshot taken before a concurrent PATCH would
    happily re-match the just-assigned pod — so they keep the reference's
    one-admission-at-a-time lock; the informer path returns a no-op
    guard and admissions overlap."""
    if getattr(pod_source, "get_pod", None) is None:
        return timed_acquire(
            assume.serial_lock, LOCK_WAIT_METRIC, LOCK_WAIT_HELP, lock="serial"
        )
    return contextlib.nullcontext()


class AllocationFailure(RuntimeError):
    """Raised to fail pod admission (gRPC error -> UnexpectedAdmissionError)."""


@dataclasses.dataclass(frozen=True)
class GangPlacement:
    """One gang decision: the member chips, the realized grid shape, and
    the HBM units claimed on EACH member (``_place`` returns this instead
    of a bare chip index for gang pods)."""

    chips: tuple[int, ...]
    shape: tuple[int, int, int]
    per_chip: int


class _PodGone(RuntimeError):
    """The matched pod 404ed on PATCH: deleted while its cache entry or
    DELETED watch event was in flight. Internal signal — the allocator
    evicts the stale entry and re-matches once."""


def persist_pod_assignment(
    api: ApiServerClient,
    pod_source: PodSource,
    pod: dict,
    annotations: dict[str, str],
    label_value: str,
    patch_fn: Callable[[str, str, dict], dict] | None = None,
) -> None:
    """Label + annotation strategic-merge patch with one conflict retry
    (``allocate.go:126,136-150``); feeds the result back into the pod
    source so the next Allocate cannot re-match this pod.

    ``patch_fn(ns, name, patch) -> pod`` overrides the write transport —
    the manager passes the coalesced ``PodPatchPipeline.patch_pod`` so
    concurrently-committed admissions batch their PATCHes; semantics
    (response, ApiError statuses, conflict retry) are identical."""
    patch_fn = patch_fn or api.patch_pod
    patch = {
        "metadata": {
            "annotations": annotations,
            "labels": {const.LABEL_RESOURCE_KEY: label_value},
        }
    }
    ns, name = P.namespace(pod), P.name(pod)
    try:
        updated = patch_fn(ns, name, patch)
    except ApiError as e:
        if e.status == 404:
            raise _PodGone(f"{ns}/{name}") from e
        if const.OPTIMISTIC_LOCK_ERROR_MSG not in e.body and e.status != 409:
            raise AllocationFailure(f"pod patch failed: {e}") from e
        log.warning("patch conflict for %s/%s; retrying once", ns, name)
        try:
            updated = patch_fn(ns, name, patch)
        except ApiError as e2:
            if e2.status == 404:
                raise _PodGone(f"{ns}/{name}") from e2
            raise AllocationFailure(f"pod patch failed twice: {e2}") from e2
    pod_source.note_pod_update(updated)


class ClusterAllocator:
    def __init__(
        self,
        inventory: DeviceInventory,
        api: ApiServerClient,
        pod_source: PodSource,
        node_name: str,
        policy: str = "first-fit",
        disable_isolation: bool = False,
        unhealthy_chips_fn: Callable[[], list[int]] | None = None,
        assume: AssumeCache | None = None,
        checkpoint: AllocationCheckpoint | None = None,
        patcher: Callable[[str, str, dict], dict] | None = None,
        chip_topology: ChipTopology | None = None,
    ) -> None:
        self._inv = inventory
        self._api = api
        self._pods = pod_source
        self._node = node_name
        self._policy = policy
        self._disable_isolation = disable_isolation
        self._unhealthy_fn = unhealthy_chips_fn or (lambda: [])
        # This node's chip grid for gang placement; defaults to the
        # standard grid for the inventory's chip count (the same rule the
        # extender applies from the node's topology label).
        self._chip_topo = chip_topology or ChipTopology.default_for(
            max(1, len(inventory.units_by_index()))
        )
        # Optional coalesced PATCH transport (PodPatchPipeline.patch_pod):
        # concurrently-committed admissions batch their apiserver writes.
        self._patcher = patcher
        # Write-ahead journal (allocator.checkpoint): the decision is made
        # durable before the PATCH leaves the node, so a daemon killed
        # mid-persist replays the reservation instead of double-assigning.
        self._ckpt = checkpoint
        # The in-flight claim/reservation ledger (see allocator.assume).
        # MUST be shared with the node's ClusterCoreAllocator: the two
        # resources share one physical-chip ledger, and independent
        # ledgers would let concurrent mem/core Allocates each read a
        # snapshot before the other persists — double-booking the chip.
        self._assume = assume if assume is not None else AssumeCache()
        self._match_locks = [make_lock("allocator.match") for _ in range(NUM_MATCH_STRIPES)]

    # ------------------------------------------------------------------

    def allocate(self, granted: Sequence[Sequence[str]]) -> list[ContainerAllocation]:
        pod_units = sum(len(ids) for ids in granted)
        container_units = [len(ids) for ids in granted]
        log.v(4, "Allocate: pod_units=%d per-container=%s", pod_units, container_units)
        # The allocator's admission span: match through env injection.
        # Nests under the plugin server's gRPC-entry span when driven by
        # kubelet; once the pod is matched, _admit adopts the extender's
        # trace context off the pod annotation and the whole open stack
        # re-parents under the bind span — one stitched trace across the
        # two processes.
        with TRACER.span(
            "allocator.admit",
            attributes={"resource": const.RESOURCE_MEM, "pod_units": pod_units},
        ) as asp:
            with _serial_guard(self._pods, self._assume):
                placement, pod = self._admit(pod_units)
            asp.set_attribute("pod", f"{P.namespace(pod)}/{P.name(pod)}")
            workload_class = P.workload_class(pod)
            asp.set_attribute("workload_class", workload_class)
            lora_adapter = P.lora_adapter(pod)
            if lora_adapter:
                asp.set_attribute("lora_adapter", lora_adapter)
            with TRACER.span("allocator.env", child_only=True):
                if isinstance(placement, GangPlacement):
                    asp.set_attribute("chips", list(placement.chips))
                    chips_by_id = {c.id: c for c in self._inv.chips()}
                    members = [
                        chips_by_id[self._inv.id_of_index(i)]
                        for i in placement.chips
                    ]
                    log.info(
                        "allocated gang pod %s/%s: %d units/chip on chips %s (shape %s)",
                        P.namespace(pod), P.name(pod), placement.per_chip,
                        list(placement.chips), placement.shape,
                    )
                    return [
                        build_gang_allocation(
                            chips=members,
                            shape=placement.shape,
                            per_chip_units=placement.per_chip,
                            chip_total_units=self._chip_total(placement.chips[0]),
                            pod_units=pod_units,
                            container_units=n,
                            disable_isolation=self._disable_isolation,
                            workload_class=workload_class,
                            lora_adapter=lora_adapter,
                        )
                        for n in container_units
                    ]
                idx = placement
                asp.set_attribute("chip", idx)
                chip = self._inv.chip_by_id(self._inv.id_of_index(idx))
                total = self._chip_total(idx)
                log.info(
                    "allocated pod %s/%s: %d units on chip %d (%s)",
                    P.namespace(pod), P.name(pod), pod_units, idx, chip.id,
                )
                return [
                    build_mem_allocation(
                        chip=chip,
                        chip_total_units=total,
                        pod_units=pod_units,
                        container_units=n,
                        disable_isolation=self._disable_isolation,
                        workload_class=workload_class,
                        lora_adapter=lora_adapter,
                    )
                    for n in container_units
                ]

    def _admit(self, pod_units: int):
        """Match, place, journal, persist; -> (chip index, the matched pod).

        WAL ordering per attempt: the chip decision is journaled durable
        (``begin``) before the PATCH goes out, ``commit`` lands only after
        the PATCHed copy is back in the pod source, and every failure path
        that provably persisted nothing journals ``abort``. A crash at any
        instruction leaves either no entry (nothing happened), or an
        unresolved entry the restarted daemon replays as a reservation and
        the reconciler resolves against the apiserver.
        """
        pod = self._claim_pod(pod_units)
        _adopt_pod_trace(pod)
        try:
            try:
                for attempt in (0, 1):
                    with TRACER.span("allocator.place", child_only=True):
                        placement, annotations = self._place(pod, pod_units)
                    key = _pod_key(pod)
                    if isinstance(placement, GangPlacement):
                        journal = {
                            "kind": "gang",
                            "chips": list(placement.chips),
                            "shape": list(placement.shape),
                            "per_chip": placement.per_chip,
                            "annotations": annotations,
                        }
                    else:
                        journal = {
                            "kind": "mem",
                            "idx": placement,
                            "units": pod_units,
                            "annotations": annotations,
                        }
                    with TRACER.span("wal.begin", child_only=True):
                        _journal_begin(self._ckpt, key, journal)
                    try:
                        with TRACER.span("pod.patch", child_only=True):
                            self._persist(pod, annotations)
                        FAULTS.fire("allocator.post_persist")
                        with TRACER.span("wal.commit", child_only=True):
                            _journal_resolve(self._ckpt, key, "commit")
                        break
                    except _PodGone:
                        # The matched pod was deleted with its cache entry
                        # still live — evict it and re-match so a live
                        # same-size pod is not failed for a ghost's sake.
                        with TRACER.span("wal.abort", child_only=True):
                            _journal_resolve(self._ckpt, key, "abort")
                        log.warning(
                            "pod %s/%s vanished during persist; re-matching",
                            P.namespace(pod), P.name(pod),
                        )
                        self._pods.evict(pod)
                        self._assume.release(_pod_key(pod))
                        pod = None
                        if attempt:
                            raise AllocationFailure(
                                f"no live pending pod on {self._node} "
                                f"requesting {pod_units} {const.RESOURCE_MEM}"
                            ) from None
                        pod = self._claim_pod(pod_units, refresh_first=True)
                        _adopt_pod_trace(pod)
                    except AllocationFailure:
                        # the PATCH conclusively failed — nothing persisted
                        with TRACER.span("wal.abort", child_only=True):
                            _journal_resolve(self._ckpt, key, "abort")
                        raise
            except AllocationFailure as e:
                # kubelet only logs the gRPC error; a Warning event on the
                # pod makes `kubectl describe pod` show why admission failed
                if pod is not None:
                    emit_pod_event(
                        self._api, pod, REASON_ALLOC_FAILED, str(e), host=self._node
                    )
                raise
        finally:
            # Success: the PATCHed copy is in the pod source (counted by
            # its own accounting, and ``note_pod_update`` landed before
            # this release — matchers re-verify candidates against the
            # live copy, so the released claim cannot re-open a re-match).
            # Failure: nothing was placed. Either way the claim must not
            # outlive this admission.
            if pod is not None:
                self._assume.release(_pod_key(pod))
        return placement, pod

    # ------------------------------------------------------------------

    def _chip_total(self, idx: int) -> int:
        return self._inv.units_of(self._inv.id_of_index(idx))

    def _claim_pod(self, pod_units: int, refresh_first: bool = False):
        """Match + claim the oldest unclaimed same-size pending pod, under
        this size's stripe lock (two same-size admissions serialize their
        match; different sizes proceed in parallel). Raises when nothing
        matches even after a refresh."""
        stripe = self._match_locks[pod_units % NUM_MATCH_STRIPES]
        with timed_acquire(
            stripe, LOCK_WAIT_METRIC, LOCK_WAIT_HELP, lock="match"
        ):
            refreshed = refresh_first
            if refresh_first:
                self._pods.refresh()
            while True:
                pod = self._match_pending_pod(pod_units)
                if pod is None and not refreshed:
                    # Cached sources may lag the scheduler's bind by a
                    # watch event; one synchronous refresh closes the
                    # window before we fail the admission.
                    refreshed = True
                    self._pods.refresh()
                    pod = self._match_pending_pod(pod_units)
                if pod is None:
                    raise AllocationFailure(
                        f"invalid allocation request: no pending pod on "
                        f"{self._node} requesting {pod_units} {const.RESOURCE_MEM}"
                    )
                # The stripe serializes same-size matches within this
                # allocator, but another instance sharing the ledger (the
                # core allocator on a dual-labeled ghost, or a rebuilt
                # plugin's allocator) can win the claim between our match
                # and here — losing means rescan, never proceed unowned.
                if self._assume.claim(_pod_key(pod)):
                    return pod

    def _match_pending_pod(self, pod_units: int):
        """Oldest pending share pod whose total limits equal the request
        (``allocate.go:51-61``), skipping pods another worker has claimed
        mid-admission. Candidates that pass the claim check are re-verified
        against the live cache copy (see ``_live_candidate``) — the
        snapshot may predate a concurrent worker's just-persisted
        assignment."""
        candidates = P.candidate_pods(
            self._pods.pending_share_pods(const.RESOURCE_MEM), self._node
        )
        log.v(4, "candidates: %s", [P.name(p) for p in candidates])
        for pod in candidates:
            if P.mem_units_of_pod(pod) == pod_units and not self._assume.is_claimed(
                _pod_key(pod)
            ):
                live = _live_candidate(
                    self._pods, pod, self._node, pod_units, const.RESOURCE_MEM
                )
                if live is not None:
                    return live
        return None

    def _place(self, pod, pod_units: int) -> tuple[int, dict[str, str]]:
        """Decide the chip (or gang slice) and the annotations to persist
        for one pod — dispatch only; the emitting verbs are
        :meth:`_place_mem` and :meth:`_place_gang`, each of which records
        a decision-provenance "why" on every outcome path."""
        if P.gang_shape_request(pod):
            return self._place_gang(pod, pod_units)
        return self._place_mem(pod, pod_units)

    def _dual_resource_guard(self, pod) -> None:
        if P.core_chips_of_pod(pod) > 0:
            raise AllocationFailure(
                f"pod {P.name(pod)} requests both {const.RESOURCE_MEM} and "
                f"{const.RESOURCE_CORE}; dual-resource pods are unsupported "
                "(the two allocators would race each other's assigned flag)"
            )

    def _place_mem(self, pod, pod_units: int) -> tuple[int, dict[str, str]]:
        """Single-chip placement.

        One ``chip_state()`` read serves both the usage accounting and the
        core-hold exclusion — O(chips) per placement with the informer's
        incremental index (the reference rescans every labeled pod per
        admission, ``podmanager.go:102-115``). Snapshot, overlay of
        in-flight reservations, decision, and this pod's own reservation
        are one ledger transaction, so the chip is protected the moment it
        is chosen — before the PATCH leaves the building."""
        pod_key = f"{P.namespace(pod)}/{P.name(pod)}"
        try:
            self._dual_resource_guard(pod)
            with self._assume.transaction():
                mem_used, core_held = self._assume.overlaid_state(
                    self._pods.chip_state,
                    visible_fn=lambda key: _counted_by_source(self._pods, key),
                )
                if P.is_assumed(pod) and not P.is_assigned(pod):
                    idx = self._assumed_chip(pod, core_held)
                    annotations = {const.ENV_ASSIGNED_FLAG: "true"}
                    assumed = True
                else:
                    idx = self._binpack_chip(pod_units, mem_used, core_held)
                    annotations = {
                        const.ENV_MEM_IDX: str(idx),
                        const.ENV_MEM_POD: str(pod_units),
                        const.ENV_MEM_DEV: str(self._chip_total(idx)),
                        const.ENV_ASSIGNED_FLAG: "true",
                    }
                    assumed = False
                self._assume.reserve_mem(_pod_key(pod), idx, pod_units)
        except AllocationFailure as e:
            # a refused admission deserves a "why" as much as a grant
            DECISIONS.emit(
                pod_key, "allocate", outcome="error",
                node=self._node, reason=str(e),
                trace_id=_current_trace_id(),
            )
            raise
        annotations[const.ENV_ASSUME_TIME] = str(time.time_ns())
        # Persist the NORMALIZED workload class with the decision: every
        # downstream reader (informer indexes, interference detector,
        # inspect CLI) then sees one canonical value even when the pod
        # declared nothing or garbage.
        annotations[const.ANN_WORKLOAD_CLASS] = P.workload_class(pod)
        if P.lora_adapter(pod):
            # Persist the stripped adapter id alongside the class so the
            # same PATCH carries the full serving identity of the pod.
            annotations[const.ANN_LORA_ADAPTER] = P.lora_adapter(pod)
        # Decision provenance: built from values the placement already
        # computed (the ledger snapshot and the chosen chip) — the
        # breakdown re-derives one chip's slack from numbers in hand.
        total = self._chip_total(idx)
        DECISIONS.emit(
            pod_key, "allocate",
            node=self._node,
            scores={f"chip{idx}": chip_breakdown(
                total - mem_used.get(idx, 0), total, idx, pod_units,
                self._policy,
            )},
            placement={
                "chip": idx, "units": pod_units,
                "source": "extender-assumed" if assumed else "binpack",
            },
            trace_id=_current_trace_id(),
        )
        return idx, annotations

    def _place_gang(self, pod, pod_units: int) -> tuple[GangPlacement, dict[str, str]]:
        """Gang placement: decide (or honor) the member chip set for a
        multi-chip pod and reserve EVERY member atomically.

        Branch A trusts the extender's persisted gang annotations (like
        the single-chip assumed path) after re-validating them against
        the live overlay — a core pod may have grabbed a member chip in
        the window. Branch B re-runs the topology scorer over the
        overlaid free vector. Either way the decision enters the ledger
        as one gang entry inside one transaction: a concurrent placement
        sees all member chips claimed or none, never a partial gang.
        """
        pod_key = f"{P.namespace(pod)}/{P.name(pod)}"
        slice_score = None
        free = {}
        try:
            self._dual_resource_guard(pod)
            shape_raw = P.gang_shape_request(pod)
            try:
                size = shape_size(shape_raw)
            except ValueError as e:
                raise AllocationFailure(
                    f"pod {P.name(pod)} has invalid gang shape "
                    f"{shape_raw!r}: {e}"
                ) from e
            if size < 1 or pod_units % size != 0:
                raise AllocationFailure(
                    f"pod {P.name(pod)}: {pod_units} {const.RESOURCE_MEM} units "
                    f"do not divide evenly over gang shape {shape_raw!r} "
                    f"({size} chips)"
                )
            per_chip = pod_units // size
            units_by_index = self._inv.units_by_index()
            with self._assume.transaction():
                mem_used, core_held = self._assume.overlaid_state(
                    self._pods.chip_state,
                    visible_fn=lambda key: _counted_by_source(self._pods, key),
                )
                excluded = set(self._unhealthy_fn()) | core_held
                assumed_chips = (
                    P.gang_chips_from_annotation(pod)
                    if P.is_assumed(pod) and not P.is_assigned(pod)
                    else []
                )
                if assumed_chips:
                    placement = self._assumed_gang(
                        pod, assumed_chips, per_chip, units_by_index,
                        mem_used, excluded,
                    )
                    annotations = {const.ENV_ASSIGNED_FLAG: "true"}
                else:
                    free = {
                        i: cap - mem_used.get(i, 0)
                        for i, cap in units_by_index.items()
                    }
                    scored = self._chip_topo.best_slice_scored(
                        shape_raw, free, per_chip,
                        capacity=units_by_index, excluded=excluded,
                    )
                    if scored is None:
                        raise AllocationFailure(
                            f"no {shape_raw} sub-slice with {per_chip} free "
                            f"units per chip on {self._node} "
                            f"(free: {free}, excluded: {sorted(excluded)})"
                        )
                    cand, slice_score = scored
                    placement = GangPlacement(
                        chips=cand.chips, shape=cand.shape, per_chip=per_chip
                    )
                    annotations = {
                        const.ENV_GANG_CHIPS: ",".join(str(i) for i in cand.chips),
                        const.ENV_GANG_SHAPE: format_shape(cand.shape),
                        const.ENV_GANG_PER_CHIP: str(per_chip),
                        const.ENV_MEM_POD: str(pod_units),
                        const.ENV_MEM_DEV: str(self._chip_total(cand.chips[0])),
                        const.ENV_ASSIGNED_FLAG: "true",
                    }
                self._assume.reserve_gang(
                    _pod_key(pod), [(i, per_chip) for i in placement.chips]
                )
        except AllocationFailure as e:
            DECISIONS.emit(
                pod_key, "allocate_gang", outcome="error",
                node=self._node, reason=str(e),
                trace_id=_current_trace_id(),
            )
            raise
        annotations[const.ENV_ASSUME_TIME] = str(time.time_ns())
        annotations[const.ANN_WORKLOAD_CLASS] = P.workload_class(pod)
        if P.lora_adapter(pod):
            annotations[const.ANN_LORA_ADAPTER] = P.lora_adapter(pod)
        # Decision provenance: branch B carries the winning slice's full
        # multi-objective breakdown (ICI hops, stranded slivers, broken
        # chips); branch A honors the extender's persisted decision, so
        # the slice score lives in the extender's own bind record.
        scores = {}
        if slice_score is not None:
            base = chip_breakdown(
                min(free[i] for i in placement.chips),
                max(units_by_index.values(), default=0),
                placement.chips[0], per_chip, "topology",
            )
            scores["slice"] = dataclasses.replace(
                base,
                ici_hops=slice_score.hops,
                stranded=slice_score.stranded,
                broken=slice_score.broken,
                tie_break=slice_score.tie_break,
            )
        DECISIONS.emit(
            pod_key, "allocate_gang",
            node=self._node,
            scores=scores,
            placement={
                "chips": list(placement.chips),
                "shape": format_shape(placement.shape),
                "per_chip": placement.per_chip,
                "source": "binpack" if slice_score is not None
                else "extender-assumed",
            },
            trace_id=_current_trace_id(),
        )
        return placement, annotations

    def _assumed_gang(
        self, pod, chips, per_chip, units_by_index, mem_used, excluded
    ) -> GangPlacement:
        """Branch A for gangs: honor the extender's member set, but
        re-validate every chip against the live overlay — all-or-nothing,
        so ONE bad member fails the whole gang (the kubelet retry re-runs
        placement from scratch)."""
        size = P.mem_units_of_pod(pod) // per_chip if per_chip else 0
        if len(chips) != size or len(set(chips)) != len(chips):
            # The annotation is user-writable: a truncated or duplicated
            # member list would book per_chip over the WRONG set (under-
            # reserving the claim, or stacking one chip twice) — reject
            # the whole gang rather than trust a garbled grant.
            raise AllocationFailure(
                f"pod {P.name(pod)} gang annotation lists chips {chips} "
                f"but the {P.mem_units_of_pod(pod)}-unit request at "
                f"{per_chip} units/chip needs {size} distinct members"
            )
        for idx in chips:
            if idx not in units_by_index:
                raise AllocationFailure(
                    f"pod {P.name(pod)} assumed onto unknown gang chip {idx}"
                )
            if idx in excluded:
                raise AllocationFailure(
                    f"pod {P.name(pod)} assumed onto gang chip {idx}, which "
                    "is core-held or unhealthy"
                )
            if mem_used.get(idx, 0) + per_chip > units_by_index[idx]:
                raise AllocationFailure(
                    f"pod {P.name(pod)} assumed onto gang chip {idx}, which "
                    f"no longer has {per_chip} free units"
                )
        try:
            shape = parse_shape(
                P.annotations(pod).get(const.ENV_GANG_SHAPE, "")
            )
            size_of_shape = 1
            for d in shape:
                size_of_shape *= d
            if size_of_shape != len(chips):
                # stale/tampered shape annotation: a carve-out that does
                # not match the member count would misconfigure libtpu at
                # container startup — degrade to a line over the members
                shape = (len(chips),)
        except ValueError:
            shape = (len(chips),)
        shape3 = pad3(shape)
        log.v(4, "extender gang placement for %s: chips %s", P.name(pod), chips)
        return GangPlacement(
            chips=tuple(sorted(chips)), shape=shape3, per_chip=per_chip
        )

    def _assumed_chip(self, pod, core_held: set[int]) -> int:
        """Branch A: trust the scheduler extender's placement."""
        idx = P.chip_idx_from_annotation(pod)
        if idx < 0 or idx not in self._inv.units_by_index():
            raise AllocationFailure(
                f"pod {P.name(pod)} assumed by extender but its "
                f"{const.ENV_MEM_IDX} annotation is invalid: {idx}"
            )
        if idx in core_held:
            raise AllocationFailure(
                f"pod {P.name(pod)} assumed onto chip {idx}, but that chip "
                f"is exclusively held by a {const.RESOURCE_CORE} pod"
            )
        log.v(4, "extender placement for %s: chip %d", P.name(pod), idx)
        return idx

    def _binpack_chip(
        self, pod_units: int, used: dict[int, int], core_held: set[int]
    ) -> int:
        """Branch B: first-fit over capacity minus apiserver-declared usage.

        Chips exclusively held by assigned tpu-core pods are excluded along
        with unhealthy ones — the two resources share one physical chip
        accounting (the reference's single-resource model, server.go:268-289,
        extended across both).
        """
        excluded = sorted(set(self._unhealthy_fn()) | core_held)
        try:
            return assign_chip(
                pod_units,
                self._inv.units_by_index(),
                used,
                unhealthy=excluded,
                policy=self._policy,
            )
        except Exception as e:
            raise AllocationFailure(str(e)) from e

    def _persist(self, pod, annotations: dict[str, str]) -> None:
        persist_pod_assignment(
            self._api, self._pods, pod, annotations,
            const.LABEL_RESOURCE_VALUE, patch_fn=self._patcher,
        )


class ClusterCoreAllocator:
    """Allocate() flow for the whole-chip ``tpu-core`` resource.

    Unlike tpu-mem, the granted device IDs *are* real chip ids (kubelet
    picks which chips, steered by GetPreferredAllocation), so placement is
    validation rather than binpack: every granted chip must be healthy,
    free of fractional-HBM usage, and not already core-held. The decision
    is persisted as the ``ENV_CORE_IDS`` annotation + the tpu-core label so
    restart re-derives exclusive holds from the apiserver and the mem
    binpack can exclude these chips (accounting model: ``server.go:268-289``
    extended across both resources).
    """

    def __init__(
        self,
        inventory: DeviceInventory,
        api: ApiServerClient,
        pod_source: PodSource,
        node_name: str,
        topology: Any = None,
        unhealthy_chips_fn: Callable[[], list[int]] | None = None,
        assume: AssumeCache | None = None,
        checkpoint: AllocationCheckpoint | None = None,
        patcher: Callable[[str, str, dict], dict] | None = None,
    ) -> None:
        self._inv = inventory
        self._api = api
        self._pods = pod_source
        self._node = node_name
        self._topo = topology
        self._unhealthy_fn = unhealthy_chips_fn or (lambda: [])
        # shared coalesced PATCH transport — see ClusterAllocator.__init__
        self._patcher = patcher
        # shared WAL with the mem allocator — see ClusterAllocator.__init__
        self._ckpt = checkpoint
        # shared with the mem allocator — see ClusterAllocator.__init__
        self._assume = assume if assume is not None else AssumeCache()
        self._match_locks = [make_lock("allocator.match") for _ in range(NUM_MATCH_STRIPES)]

    def allocate(self, granted: Sequence[Sequence[str]]) -> list[ContainerAllocation]:
        total = sum(len(ids) for ids in granted)
        try:
            per_container = [
                sorted(self._inv.index_of(cid) for cid in ids) for ids in granted
            ]
        except KeyError as e:
            raise AllocationFailure(f"granted unknown chip id: {e}") from e
        indices = sorted(i for ids in per_container for i in ids)
        log.v(4, "core Allocate: chips %s", indices)
        with TRACER.span(
            "allocator.admit",
            attributes={"resource": const.RESOURCE_CORE, "chips": indices},
        ) as asp:
            with _serial_guard(self._pods, self._assume):
                pod = self._admit(total, indices)
            asp.set_attribute("pod", f"{P.namespace(pod)}/{P.name(pod)}")
            log.info(
                "allocated core pod %s/%s: chips %s",
                P.namespace(pod), P.name(pod), indices,
            )
            with TRACER.span("allocator.env", child_only=True):
                chips_by_id = {c.id: c for c in self._inv.chips()}
                return [
                    build_core_allocation(
                        chips=[chips_by_id[self._inv.id_of_index(i)] for i in ids],
                        process_bounds=getattr(self._topo, "process_bounds", ""),
                        chips_per_process_bounds=getattr(
                            self._topo, "chips_per_process_bounds", ""
                        ),
                    )
                    for ids in per_container
                ]

    def _admit(self, total: int, indices: list[int]):
        """Match, validate+reserve, persist; -> the matched pod."""
        pod = self._claim_pod(total)
        _adopt_pod_trace(pod)
        try:
            try:
                # Validation runs per attempt: a pod re-matched after
                # _PodGone is a different pod and must clear the
                # dual-resource guard and the chip-conflict check itself
                # (mirrors the mem path re-running _place per attempt).
                for attempt in (0, 1):
                    if P.mem_units_of_pod(pod) > 0:
                        raise AllocationFailure(
                            f"pod {P.name(pod)} requests both "
                            f"{const.RESOURCE_MEM} and {const.RESOURCE_CORE}; "
                            "dual-resource pods are unsupported"
                        )
                    self._check_and_reserve(pod, indices)
                    annotations = {
                        const.ENV_CORE_IDS: ",".join(str(i) for i in indices),
                        const.ENV_CORE_POD: str(total),
                        const.ENV_ASSIGNED_FLAG: "true",
                        const.ENV_ASSUME_TIME: str(time.time_ns()),
                    }
                    key = _pod_key(pod)
                    with TRACER.span("wal.begin", child_only=True):
                        _journal_begin(self._ckpt, key, {
                            "kind": "core",
                            "ids": list(indices),
                            "units": total,
                            "annotations": annotations,
                        })
                    try:
                        with TRACER.span("pod.patch", child_only=True):
                            persist_pod_assignment(
                                self._api, self._pods, pod, annotations,
                                const.LABEL_CORE_VALUE, patch_fn=self._patcher,
                            )
                        FAULTS.fire("allocator.post_persist")
                        with TRACER.span("wal.commit", child_only=True):
                            _journal_resolve(self._ckpt, key, "commit")
                        break
                    except AllocationFailure:
                        with TRACER.span("wal.abort", child_only=True):
                            _journal_resolve(self._ckpt, key, "abort")
                        raise
                    except _PodGone:
                        with TRACER.span("wal.abort", child_only=True):
                            _journal_resolve(self._ckpt, key, "abort")
                        log.warning(
                            "core pod %s/%s vanished during persist; re-matching",
                            P.namespace(pod), P.name(pod),
                        )
                        self._pods.evict(pod)
                        self._assume.release(_pod_key(pod))
                        pod = None
                        if attempt:
                            # final attempt: no point refreshing a result
                            # we would discard (mirrors the mem path)
                            raise AllocationFailure(
                                f"no live pending pod on {self._node} requesting "
                                f"{total} {const.RESOURCE_CORE}"
                            ) from None
                        pod = self._claim_pod(total, refresh_first=True)
                        _adopt_pod_trace(pod)
            except AllocationFailure as e:
                if pod is not None:
                    emit_pod_event(
                        self._api, pod, REASON_ALLOC_FAILED, str(e), host=self._node
                    )
                raise
        finally:
            if pod is not None:
                self._assume.release(_pod_key(pod))
        return pod

    def _claim_pod(self, total: int, refresh_first: bool = False):
        """Match + claim under the size stripe (see ClusterAllocator)."""
        stripe = self._match_locks[total % NUM_MATCH_STRIPES]
        with timed_acquire(
            stripe, LOCK_WAIT_METRIC, LOCK_WAIT_HELP, lock="match"
        ):
            refreshed = refresh_first
            if refresh_first:
                self._pods.refresh()
            while True:
                pod = self._match_pending_pod(total)
                if pod is None and not refreshed:
                    refreshed = True
                    self._pods.refresh()
                    pod = self._match_pending_pod(total)
                if pod is None:
                    raise AllocationFailure(
                        f"invalid allocation request: no pending pod on "
                        f"{self._node} requesting {total} {const.RESOURCE_CORE}"
                    )
                # lost claim race to another instance -> rescan, see
                # ClusterAllocator._claim_pod
                if self._assume.claim(_pod_key(pod)):
                    return pod

    def _match_pending_pod(self, total: int):
        candidates = P.candidate_pods(
            self._pods.pending_share_pods(const.RESOURCE_CORE),
            self._node,
            resource=const.RESOURCE_CORE,
        )
        for pod in candidates:
            if P.core_chips_of_pod(pod) == total and not self._assume.is_claimed(
                _pod_key(pod)
            ):
                live = _live_candidate(
                    self._pods, pod, self._node, total, const.RESOURCE_CORE
                )
                if live is not None:
                    return live
        return None

    def _check_and_reserve(self, pod, indices: list[int]) -> None:
        """Every granted chip must be free of other holds (in-flight
        reservations included) and healthy; passing chips are reserved in
        the same ledger transaction so a concurrent mem binpack excludes
        them before this pod's PATCH lands."""
        with self._assume.transaction():
            mem_used, core_held = self._assume.overlaid_state(
                self._pods.chip_state,
                visible_fn=lambda key: _counted_by_source(self._pods, key),
            )
            unhealthy = set(self._unhealthy_fn())
            for idx in indices:
                if idx in core_held:
                    raise AllocationFailure(
                        f"chip {idx} is already exclusively held by another "
                        f"{const.RESOURCE_CORE} pod"
                    )
                if mem_used.get(idx, 0) > 0:
                    raise AllocationFailure(
                        f"chip {idx} has {mem_used[idx]} {const.RESOURCE_MEM} units "
                        "in use by fractional pods; cannot grant exclusively"
                    )
                if idx in unhealthy:
                    raise AllocationFailure(f"chip {idx} is unhealthy")
            self._assume.reserve_core(_pod_key(pod), indices)


def cluster_chip_state(
    pod_source: PodSource, assume: AssumeCache | None = None
) -> Callable[[], tuple[dict[int, int], set[int]]]:
    """() -> (mem_used_by_chip, core_held_chips) from one source read,
    with in-flight reservations folded in when the allocators' shared
    ledger is supplied (GetPreferredAllocation should steer kubelet away
    from chips a concurrent Allocate is mid-claiming, too)."""
    if assume is None:
        return pod_source.chip_state

    def state():
        return assume.overlaid_state(
            pod_source.chip_state,
            visible_fn=lambda key: _counted_by_source(pod_source, key),
        )

    return state


def preferred_core_chips(
    inventory: DeviceInventory,
    state_fn: Callable[[], tuple[dict[int, int], set[int]]],
) -> Callable[[list[str], int], list[str]]:
    """GetPreferredAllocation hook for the core plugin: steer kubelet toward
    chips with no fractional-HBM usage and no existing exclusive hold, so
    core grants rarely conflict with the mem binpack.

    ``state_fn() -> (mem_used_by_chip, core_held_chips)`` — cluster mode
    passes ``cluster_chip_state(pod_source)``, standalone mode the
    LocalAllocator's in-process view; the ranking policy lives here once.
    """

    def prefer(available_ids: list[str], size: int) -> list[str]:
        try:
            mem_used, core_held = state_fn()
        except Exception as e:  # noqa: BLE001 — preference only, never fail
            log.warning("preferred-allocation state read failed: %s", e)
            mem_used, core_held = {}, set()

        def rank(cid: str):
            idx = inventory.index_of(cid)
            return (idx in core_held, mem_used.get(idx, 0), idx)

        return sorted(available_ids, key=rank)[:size]

    return prefer
