"""Live slice defragmentation: the stranded-memory planner and the
crash-safe move protocol.

Counterpart of ``gpushare_device_plugin_tpu/allocator/defrag.py``: the
same planner, the same journaled phases and WAL records, the same
defrag-status annotation.

After churn, cards hold free-memory *slivers* no pending pod fits, and the
allocator can only refuse admission though total free memory is ample.
This module repacks one node's single-card fractional pods over the WAL,
the reservation ledger and the fence:

- **Stranded accounting** (:func:`stranded_units` / :func:`stranded_pct`):
  free units on a partially-used card that cannot host a ``quantum``-sized
  request are stranded. A wholly-free card is never stranded.
- **Planner** (:func:`plan_moves` / :class:`DefragPlanner`): greedy
  repacking, lexicographically minimizing (total stranded units after the
  move, whole cards broken open, destination index), accepting only
  strictly-improving moves, so a plan terminates and never regresses.
  Gangs stay whole; core-held and unhealthy cards are excluded.
- **Mover** (:class:`SliceMover`): one move is the journaled state machine
  ``plan -> drain -> copy -> switch -> resume``, riding the allocation WAL
  as record kind ``"move"``. Each phase's record is durable *before* that
  phase's side effect; the destination units are reserved in the shared
  :class:`~.assume.AssumeCache` ledger for the whole move; ``switch`` is
  the commit point. A daemon killed at any instruction leaves an entry the
  next incarnation replays and the drift reconciler resolves: **roll
  forward** from ``switch`` on (re-issue the PATCH, restore the drained
  engine snapshot on the destination), **roll back** before it (release
  the reservation and abort; the workload never stopped). A stale daemon's
  next phase journal raises :class:`~.checkpoint.StaleDaemonError`.

Engine hand-off: ``drain_fn(pod_key) -> snapshot`` quiesces the pod's
serving engine and checkpoints its in-flight requests
(``serving.engine.PagedSlotEngine.drain_snapshot``); the snapshot is
journaled with the ``copy`` record, so a crash after the drain still
delivers it to the destination (``restore_fn(pod_key, snapshot)``) during
roll forward. Its ``snapshot_id`` lets the destination engine refuse a
second delivery.

Stdlib only: the daemon runs it, and it imports no torch.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Mapping

from .. import const
from ..cluster import pods as P
from ..utils.decisions import DECISIONS
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER
from .assume import AssumeCache, PodKey
from .checkpoint import AllocationCheckpoint, StaleDaemonError
from ..utils.metric_catalog import (
    DEFRAG_MOVES_TOTAL as MOVES_METRIC,
    DEFRAG_MOVE_SECONDS as MOVE_SECONDS,
    DEFRAG_STRANDED_PCT as STRANDED_PCT_GAUGE,
    DEFRAG_STRANDED_UNITS as STRANDED_GAUGE,
)

log = get_logger("allocator.defrag")

# The journaled move state machine, in order. Each phase's WAL record is
# durable BEFORE its side effect; "switch" is the roll-forward boundary.
MOVE_PHASES = ("plan", "drain", "copy", "switch", "resume")
MOVE_KIND = "move"

# Synthetic namespace for move journal/ledger keys: a move protects the
# DESTINATION chip under a key no real pod owns, so the reservation
# overlay counts it unconditionally (the moving pod's own annotation
# keeps counting the source until the switch PATCH lands).
DEFRAG_NS = "tpushare-defrag"

MOVES_HELP = "Defragmentation moves by outcome (completed/aborted/failed)"
MOVE_SECONDS_HELP = "Wall time of one completed slice move, all phases"
STRANDED_GAUGE_HELP = (
    "HBM units stranded on partially-used chips (free slivers smaller "
    "than the defrag quantum) at the last planner scan"
)
STRANDED_PCT_GAUGE_HELP = "Stranded HBM as a percentage of node capacity"


class MoveError(RuntimeError):
    """A move could not proceed (planning raced reality, PATCH refused)."""


def move_key(pod: PodKey) -> PodKey:
    """The journal/ledger key for one pod's move: a synthetic namespace
    so the reservation is never mistaken for (or hidden by) the real
    pod's own accounting."""
    return (DEFRAG_NS, f"{pod[0]}.{pod[1]}")


def pod_of_move(data: Mapping[str, Any]) -> PodKey | None:
    """The real pod a journaled move record concerns, or None when the
    record is garbled."""
    ref = data.get("pod") or []
    if isinstance(ref, (list, tuple)) and len(ref) == 2:
        return (str(ref[0]), str(ref[1]))
    return None


# ---------------------------------------------------------------------------
# stranded accounting
# ---------------------------------------------------------------------------


def stranded_units(
    capacity: Mapping[int, int],
    used: Mapping[int, int],
    quantum: int,
) -> dict[int, int]:
    """Free units per chip that are stranded: the chip is partially used
    and its free sliver is smaller than ``quantum`` (the request size the
    node should stay able to admit). Wholly-free chips are never
    stranded; full chips have nothing free."""
    if quantum < 1:
        return {}
    out: dict[int, int] = {}
    for idx, cap in capacity.items():
        u = used.get(idx, 0)
        free = cap - u
        if u > 0 and 0 < free < quantum:
            out[idx] = free
    return out


def stranded_pct(
    capacity: Mapping[int, int],
    used: Mapping[int, int],
    quantum: int,
) -> float:
    """Stranded HBM as a percentage of total node capacity."""
    total = sum(capacity.values())
    if total <= 0:
        return 0.0
    return 100.0 * sum(stranded_units(capacity, used, quantum).values()) / total


def movable_placements(pods: list[dict]) -> dict[PodKey, tuple[int, int]]:
    """``{pod key: (chip index, units)}`` for every pod a repack may move:
    assigned, active, fractional tpu-mem, single-chip. Gangs are skipped
    whole (moving one is a topology re-grant, not a repack) and core
    holds are exclusive by definition."""
    out: dict[PodKey, tuple[int, int]] = {}
    for pod in pods:
        if not P.is_active(pod) or not P.is_assigned(pod):
            continue
        if P.labels(pod).get(const.LABEL_RESOURCE_KEY) != const.LABEL_RESOURCE_VALUE:
            continue
        if P.gang_usage_by_chip(pod):
            continue  # keep gangs whole
        idx = P.chip_idx_from_annotation(pod)
        units = P.mem_units_of_pod(pod)
        if idx < 0 or units <= 0:
            continue
        out[(P.namespace(pod), P.name(pod))] = (idx, units)
    return out


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MovePlan:
    """One planned repacking move: relocate ``pod``'s ``units`` from chip
    ``src`` to chip ``dst``."""

    pod: PodKey
    src: int
    dst: int
    units: int


@dataclasses.dataclass(frozen=True)
class DefragReport:
    """One planner scan: the stranded picture and the moves that improve it."""

    quantum: int
    stranded_by_chip: dict[int, int]
    stranded_pct: float
    moves: tuple[MovePlan, ...]


def plan_moves(
    capacity: Mapping[int, int],
    placements: Mapping[PodKey, tuple[int, int]],
    quantum: int,
    *,
    excluded: Mapping[int, Any] | set[int] | tuple[int, ...] = (),
    max_moves: int = 8,  # matches ManagerConfig.defrag_max_moves
    used: Mapping[int, int] | None = None,
) -> list[MovePlan]:
    """Greedy strictly-improving repack plan over single-chip placements.

    Each step considers every (pod, destination chip) pair and picks the
    move whose simulated result lexicographically minimizes — the same
    objective order ``topology.best_slice`` uses for gang placement —

    1. total stranded units after the move (the repack objective);
    2. whole chips broken open (a move into an untouched chip fragments
       the node it is meant to heal);
    3. destination index, then pod key (determinism).

    Only strictly-improving moves are accepted, so the plan terminates
    and applying it can never make the stranded picture worse. Chips in
    ``excluded`` (core-held, unhealthy, mid-move) are neither drained
    nor filled. ``used`` is the AUTHORITATIVE per-chip usage the
    simulation starts from — it must include pods the repack may not
    move (gang members, anything non-fractional), or the planner sees
    their chips as free and plans moves the execute-time capacity check
    can only abort; it defaults to the placements' own sum for callers
    with no other usage.
    """
    banned = set(excluded)
    if used is None:
        base: dict[int, int] = {}
        for _key, (idx, units) in placements.items():
            base[idx] = base.get(idx, 0) + units
        used = base
    else:
        used = {idx: int(n) for idx, n in used.items() if n}
    work = dict(placements)
    moves: list[MovePlan] = []
    while len(moves) < max_moves:
        current = sum(stranded_units(capacity, used, quantum).values())
        if current == 0:
            break
        best_score: tuple | None = None
        best: tuple[MovePlan, dict[int, int]] | None = None
        for key, (src, units) in sorted(work.items()):
            if src in banned:
                continue
            for dst in sorted(capacity):
                if dst == src or dst in banned:
                    continue
                if capacity[dst] - used.get(dst, 0) < units:
                    continue
                trial = dict(used)
                trial[src] = trial.get(src, 0) - units
                if trial[src] <= 0:
                    trial.pop(src, None)
                trial[dst] = trial.get(dst, 0) + units
                after = sum(stranded_units(capacity, trial, quantum).values())
                broken = 1 if used.get(dst, 0) == 0 else 0
                score = (after, broken, dst, key)
                if best_score is None or score < best_score:
                    best_score = score
                    best = (MovePlan(pod=key, src=src, dst=dst, units=units), trial)
        if best is None or best_score is None or best_score[0] >= current:
            break  # nothing strictly improves: done
        plan, used = best
        moves.append(plan)
        work[plan.pod] = (plan.dst, plan.units)
    return moves


class DefragPlanner:
    """Scans a node's usage (``NodeChipUsage`` snapshot semantics: the
    pod source's chip state) for stranded HBM and plans repacking moves.

    ``quantum=0`` auto-derives the sliver threshold from the workload:
    the largest single-chip fractional request currently on the node —
    a sliver is free HBM that cannot host the biggest pod class the
    node actually serves.
    """

    def __init__(
        self,
        units_by_index: Callable[[], dict[int, int]],
        pod_source: Any,
        *,
        quantum: int = 0,
        excluded_fn: Callable[[], set[int]] | None = None,
        max_moves: int = 8,  # matches ManagerConfig.defrag_max_moves
        node: str = "",  # decision-record attribution only
    ) -> None:
        self._units_by_index = units_by_index
        self._pods = pod_source
        self._quantum = quantum
        self._excluded_fn = excluded_fn or (lambda: set())
        self._max_moves = max_moves
        self._node = node
        # guards the cached last-scan report (read by the CLI/status
        # publisher while the loop thread scans)
        self._lock = make_lock("defrag.planner")
        self._last: DefragReport | None = None

    def _auto_quantum(self, pods: list[dict]) -> int:
        sizes = [
            P.mem_units_of_pod(p)
            for p in pods
            if P.is_active(p) and P.mem_units_of_pod(p) > 0
            and not P.gang_usage_by_chip(p)
        ]
        return max(sizes) if sizes else 0

    def scan(self) -> DefragReport:
        """One planning pass; publishes the stranded gauges and caches
        the report (:meth:`last_report`)."""
        capacity = self._units_by_index()
        pods_readable = True
        try:
            pods = list(self._pods.labeled_pods())
        except Exception as e:  # noqa: BLE001 — outage: plan nothing
            log.v(4, "defrag scan: pod read failed (%s)", e)
            pods = []
            pods_readable = False
        quantum = self._quantum or self._auto_quantum(pods)
        placements = movable_placements(pods)
        # authoritative per-chip usage — includes what the repack may NOT
        # move (gang members, non-fractional pods): without it the
        # planner sees gang-hosting chips as free, under-reports their
        # stranded slivers, and plans moves the execute-time capacity
        # check can only abort, forever. Core holds + unhealthy chips
        # never participate at all.
        try:
            mem_used, core_held = self._pods.chip_state()
            used = {idx: int(n) for idx, n in mem_used.items()}
        except Exception:  # noqa: BLE001 — outage: fall back to the
            # movable placements' own sum (plan conservatively rather
            # than not at all; placements came from the same read)
            core_held = set()
            used = {}
            for _key, (idx, units) in placements.items():
                used[idx] = used.get(idx, 0) + units
        excluded = set(core_held) | self._excluded_fn()
        by_chip = stranded_units(capacity, used, quantum)
        pct = stranded_pct(capacity, used, quantum)
        moves = plan_moves(
            capacity, placements, quantum,
            excluded=excluded, max_moves=self._max_moves, used=used,
        )
        report = DefragReport(
            quantum=quantum,
            stranded_by_chip=by_chip,
            stranded_pct=pct,
            moves=tuple(moves),
        )
        if pods_readable:
            # an outage pass computed stranded=0 from an EMPTY pod list —
            # publishing that would paint a fragmented node as healed for
            # the outage's duration; keep the last honest value instead
            # (the documented signal is "the gauge stops updating")
            REGISTRY.gauge_set(
                STRANDED_GAUGE, float(sum(by_chip.values())), STRANDED_GAUGE_HELP
            )
            REGISTRY.gauge_set(STRANDED_PCT_GAUGE, pct, STRANDED_PCT_GAUGE_HELP)
        with self._lock:
            self._last = report
        # Decision provenance: one record per planning pass — what the
        # planner saw (stranded picture) and what it decided to move,
        # queryable by any affected pod (``inspect why`` matches records
        # whose moves touch the pod). Values all computed above.
        DECISIONS.emit(
            "", "defrag_plan",
            outcome="ok" if pods_readable else "error",
            node=self._node,
            reason="" if pods_readable else "pod source unreadable; planned nothing",
            candidates=len(capacity),
            placement={
                "quantum": quantum,
                "stranded_units": sum(by_chip.values()),
                "stranded_pct": round(pct, 2),
                "planned_moves": [
                    {
                        "pod": f"{m.pod[0]}/{m.pod[1]}",
                        "src": m.src, "dst": m.dst, "units": m.units,
                    }
                    for m in moves
                ],
            },
            moves=[f"{m.pod[0]}/{m.pod[1]}" for m in moves],
        )
        return report

    def last_report(self) -> DefragReport | None:
        with self._lock:
            return self._last


# ---------------------------------------------------------------------------
# the journaled mover
# ---------------------------------------------------------------------------


def _journal_phase(
    ckpt: AllocationCheckpoint | None, key: PodKey, data: dict
) -> int | None:
    """Journal one move phase durable (a fresh ``begin`` for the move key
    — the loader keeps the newest record per key, so the entry always
    names the furthest phase reached). ``StaleDaemonError`` propagates:
    a fenced daemon must not advance a move the newer incarnation owns.
    ``None`` = journal degraded (sick disk): the move continues
    unjournaled, exactly like admissions do. Every call site is followed
    by :func:`_journal_resolve` on its handled paths."""
    if ckpt is None:
        return None
    return ckpt.begin(key, data)


def _journal_resolve(
    ckpt: AllocationCheckpoint | None,
    op: str,
    key: PodKey,
    seq: int | None,
) -> bool:
    """Resolve the move's journal entry (``op`` = ``"commit"`` roll the
    move in, ``"abort"`` roll it back). False = degraded/unjournaled or
    a newer begin owns the key."""
    if ckpt is None:
        return False
    if op == "commit":
        return ckpt.commit(key, seq=seq)
    return ckpt.abort(key, seq=seq)


@dataclasses.dataclass
class MoveStats:
    """Cumulative move counters for one mover (CLI/status surface)."""

    planned: int = 0
    active: int = 0
    completed: int = 0
    failed: int = 0
    last_move_ms: float = 0.0


class SliceMover:
    """Executes one :class:`MovePlan` through the journaled move protocol.

    ``drain_fn(pod_key) -> dict | None`` quiesces the pod's engine and
    returns its JSON-safe in-flight snapshot (journaled with the ``copy``
    record); ``restore_fn(pod_key, snapshot)`` re-admits it on the
    destination. Both default to None for workloads that checkpoint
    themselves (the move is then just the annotation flip plus the
    double-booking protection).
    """

    def __init__(
        self,
        api: Any,
        pod_source: Any,
        assume: AssumeCache,
        checkpoint: AllocationCheckpoint | None,
        node_name: str,
        units_by_index: Callable[[], dict[int, int]],
        *,
        drain_fn: Callable[[PodKey], dict | None] | None = None,
        restore_fn: Callable[[PodKey, dict | None], None] | None = None,
        patch_fn: Callable[[str, str, dict], dict] | None = None,
    ) -> None:
        self._api = api
        self._pods = pod_source
        self._assume = assume
        self._ckpt = checkpoint
        self._node = node_name
        self._units_by_index = units_by_index
        self._drain_fn = drain_fn
        self._restore_fn = restore_fn
        self._patch_fn = patch_fn
        # guards the move counters only — never held across journal
        # fsyncs or the switch PATCH (io_ok=False by declaration)
        self._stats_lock = make_lock("defrag.moves")
        self._stats = MoveStats()

    # --- introspection ----------------------------------------------------

    def stats(self) -> MoveStats:
        with self._stats_lock:
            return dataclasses.replace(self._stats)

    def note_failed(self) -> None:
        """Count a move that died with a propagating exception — the
        loop's accounting hook. Clean aborts and fenced moves count
        themselves inside :meth:`execute`."""
        self._note(failed=1)

    def _note(self, **delta: float) -> None:
        with self._stats_lock:
            for name, value in delta.items():
                if name == "last_move_ms":
                    self._stats.last_move_ms = float(value)
                else:
                    setattr(
                        self._stats, name,
                        getattr(self._stats, name) + int(value),
                    )

    # --- the protocol -----------------------------------------------------

    def _dst_fits(self, plan: MovePlan) -> bool:
        """Execute-time re-validation of the destination: with every
        in-flight reservation (this move's included) overlaid on the pod
        source's usage, the destination chip must not exceed capacity. A
        plan is computed against a scan snapshot — a concurrent admission
        can land on the destination between scan and reserve, and an
        earlier move in the same pass may have aborted without freeing
        the capacity the simulation assumed. Because this move's own
        reservation is already in the ledger, and admissions decide+
        reserve atomically under the same ledger lock, any conflicting
        booking is visible to exactly one of the two sides — so failing
        this check aborts the move instead of over-booking. Conservative
        on purpose: no visibility filter, so a reservation whose PATCH
        already landed may double-count — that can only abort a move
        spuriously (the planner re-plans next pass), never double-book."""
        capacity = self._units_by_index().get(plan.dst, 0)
        with self._assume.transaction():
            mem_used, core_held = self._assume.overlaid_state(self._pods.chip_state)
        if plan.dst in core_held:
            # a tpu-core pod took an exclusive hold on the destination
            # since the scan: an exclusively held chip has mem_used 0,
            # so the capacity check alone would happily flip a
            # fractional pod onto it — the same skip the mem admission
            # path applies to core-held chips
            return False
        return mem_used.get(plan.dst, 0) <= capacity

    def _live_pod(self, plan: MovePlan) -> dict | None:
        """The pod as the apiserver sees it now, still matching the plan
        (on ``src`` with ``units``); None when planning raced reality."""
        from ..cluster.apiserver import ApiError

        try:
            pod = self._api.get_pod(*plan.pod)
        except ApiError as e:
            if e.status == 404:
                return None
            raise
        if pod is None or not P.is_active(pod) or not P.is_assigned(pod):
            return None
        if P.gang_usage_by_chip(pod):
            return None
        if P.chip_idx_from_annotation(pod) != plan.src:
            return None
        if P.mem_units_of_pod(pod) != plan.units:
            return None
        return pod

    def _switch_annotations(self, plan: MovePlan, pod: dict) -> dict[str, str]:
        total = self._units_by_index().get(plan.dst, 0)
        ann = {
            const.ENV_MEM_IDX: str(plan.dst),
            const.ENV_MEM_POD: str(plan.units),
            const.ENV_MEM_DEV: str(total),
            const.ENV_ASSIGNED_FLAG: "true",
            const.ENV_ASSUME_TIME: str(time.time_ns()),
        }
        # An extender-bound pod also carries the per-container allocation
        # map, and the inspect CLI PREFERS it for per-chip attribution —
        # left untouched it would pin the pod to src forever, and the
        # post-move stranded gauges built from it would report the node
        # as still fragmented after a successful repack. Movable
        # placements are single-chip, so every container's units land on
        # dst.
        raw = P.annotations(pod).get(const.ANN_EXTENDER_ALLOCATION)
        if raw:
            try:
                per_container = json.loads(raw)
                moved = {
                    name: {str(plan.dst): sum(int(u) for u in chips.values())}
                    for name, chips in per_container.items()
                }
                ann[const.ANN_EXTENDER_ALLOCATION] = json.dumps(moved)
            except (ValueError, AttributeError, TypeError):
                pass  # garbled map: the CLI already falls back to MEM_IDX
        return ann

    def _patch_switch(self, plan: MovePlan, annotations: dict[str, str]) -> None:
        """The authoritative flip: one strategic-merge PATCH moves the
        pod's accounting from src to dst. 404 = pod deleted mid-move
        (raised as MoveError for the abort path); other transport
        failures propagate — the entry stays pending and the reconciler
        rolls the move forward once the apiserver answers."""
        from ..cluster.apiserver import ApiError

        patch_fn = self._patch_fn or self._api.patch_pod
        try:
            updated = patch_fn(
                plan.pod[0], plan.pod[1], {"metadata": {"annotations": annotations}}
            )
        except ApiError as e:
            if e.status == 404:
                raise MoveError(f"pod {plan.pod} deleted mid-move") from e
            raise
        note = getattr(self._pods, "note_pod_update", None)
        if note is not None:
            note(updated)

    def execute(self, plan: MovePlan) -> bool:
        """Run one move end to end. True = the pod now lives on ``dst``;
        False = the move was aborted cleanly (planning raced reality,
        pod deleted). Exceptions leave the journal entry pending for the
        reconciler — deliberately, that IS the crash-safety story — and
        ``StaleDaemonError`` additionally means a newer daemon owns the
        node (this instance must stop moving)."""
        self._note(planned=1, active=1)
        try:
            return self._execute(plan)
        finally:
            self._note(active=-1)

    def _execute(self, plan: MovePlan) -> bool:
        t0 = time.perf_counter()
        pod = self._live_pod(plan)
        if pod is None:
            log.v(4, "defrag: plan for %s/%s raced reality; skipped", *plan.pod)
            self._note(failed=1)
            REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
            return False
        key = move_key(plan.pod)
        # Claim the move key for the whole protocol, exactly like an
        # admission claims its pod key: the reconciler skips claimed
        # entries, so a concurrent reconcile pass can never resolve (and
        # release the destination reservation of) a move this thread is
        # still executing. An abandoned move (a propagating transport
        # error below) keeps claim + reservation until the ledger TTL,
        # then the reconciler resolves the pending entry — identical to
        # a hung admission's backstop.
        if not self._assume.claim(key):
            log.v(4, "defrag: move for %s/%s already in flight; skipped", *plan.pod)
            self._note(failed=1)
            REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
            return False
        annotations = self._switch_annotations(plan, pod)
        base = {
            "kind": MOVE_KIND,
            "pod": list(plan.pod),
            "src": plan.src,
            "dst": plan.dst,
            "units": plan.units,
            "node": self._node,
            "annotations": annotations,
        }
        with TRACER.span(
            "defrag.move",
            attributes={
                "pod": f"{plan.pod[0]}/{plan.pod[1]}",
                "src": plan.src, "dst": plan.dst, "units": plan.units,
            },
        ):
            # plan: the decision is durable, then the destination is
            # reserved — from here no concurrent admission can book dst
            # past capacity even though the PATCH is minutes away.
            seq = _journal_phase(self._ckpt, key, {**base, "phase": "plan"})
            FAULTS.fire("defrag.plan")
            self._assume.reserve_mem(key, plan.dst, plan.units)
            try:
                if not self._dst_fits(plan):
                    # the destination filled up since the scan: abort
                    # cleanly before anything drains or flips
                    _journal_resolve(self._ckpt, "abort", key, seq)
                    self._assume.release(key)
                    log.v(
                        4, "defrag: destination chip %d filled since "
                        "planning; move for %s/%s aborted",
                        plan.dst, *plan.pod,
                    )
                    self._note(failed=1)
                    REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
                    return False
                # drain: quiesce the engine, checkpoint its in-flight
                # requests (prompt + generated tokens + tier/SLO; radix
                # prefixes re-resolve on restore).
                seq = _journal_phase(self._ckpt, key, {**base, "phase": "drain"})
                FAULTS.fire("defrag.drain")
                snapshot: dict | None = None
                if self._drain_fn is not None:
                    with TRACER.span("move.drain", child_only=True):
                        snapshot = self._drain_fn(plan.pod)
                if snapshot is not None:
                    # Stamped identity, unique to this move attempt (the
                    # drain-phase WAL seq): the destination engine dedups
                    # restore deliveries on it, so the at-least-once
                    # re-delivery across the resume/commit crash window
                    # can never serve the drained requests twice. With
                    # the journal degraded (seq None) there is no record
                    # to re-deliver FROM, so no stamp — a constant
                    # `#None` id would wrongly dedup a later legitimate
                    # move of the same pod.
                    if seq is not None:
                        snapshot = {
                            **snapshot,
                            "snapshot_id": f"{self._node}/{key[1]}#{seq}",
                        }
                    base = {**base, "snapshot": snapshot}
                # copy: the snapshot travels inside the journal record —
                # durable before anything depends on it, so a crash from
                # here on can still deliver it to the destination.
                seq = _journal_phase(self._ckpt, key, {**base, "phase": "copy"})
                FAULTS.fire("defrag.copy")
                # Last clean-abort gate before the commit point: a drain
                # can outlast the ledger TTL (300 s), expiring the
                # destination reservation — a concurrent admission could
                # then book dst to capacity unseen. RENEW the claim
                # (re-stamp its TTL clock — is_claimed alone would leave
                # a near-TTL stamp to expire in the switch window, and
                # an EXPIRED claim reaps the whole key, fresh
                # reservation included, on the next overlay read), then
                # re-stamp the reservation and re-verify; after the
                # switch record is durable a crash rolls FORWARD, so
                # this must happen before it.
                if not (self._assume.renew(key) or self._assume.claim(key)):
                    # defensive: the reaped key was re-claimed by someone
                    # else in the gap — this incarnation's move is over
                    _journal_resolve(self._ckpt, "abort", key, seq)
                    self._assume.release(key)
                    log.warning(
                        "defrag: move claim for %s/%s lost mid-drain; "
                        "move aborted", *plan.pod,
                    )
                    self._note(failed=1)
                    REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
                    return False
                self._assume.reserve_mem(key, plan.dst, plan.units)
                if not self._dst_fits(plan):
                    _journal_resolve(self._ckpt, "abort", key, seq)
                    self._assume.release(key)
                    log.v(
                        4, "defrag: destination chip %d filled while the "
                        "drain ran; move for %s/%s aborted",
                        plan.dst, *plan.pod,
                    )
                    self._note(failed=1)
                    REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
                    return False
                # switch: the commit point. The record is durable before
                # the PATCH is on the wire (begin-before-PATCH, as ever);
                # a crash between the two rolls FORWARD — the reconciler
                # re-issues the PATCH from the journaled annotations.
                seq = _journal_phase(self._ckpt, key, {**base, "phase": "switch"})
                FAULTS.fire("defrag.switch")
                try:
                    with TRACER.span("move.switch", child_only=True):
                        self._patch_switch(plan, annotations)
                except MoveError:
                    # pod deleted mid-move: nothing persisted, nothing to
                    # finish — roll the whole move back cleanly.
                    _journal_resolve(self._ckpt, "abort", key, seq)
                    self._assume.release(key)
                    self._note(failed=1)
                    REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
                    return False
                seq = _journal_phase(self._ckpt, key, {**base, "phase": "resume"})
                FAULTS.fire("defrag.resume")
                if self._restore_fn is not None:
                    with TRACER.span("move.resume", child_only=True):
                        self._restore_fn(plan.pod, snapshot)
                _journal_resolve(self._ckpt, "commit", key, seq)
                self._assume.release(key)
            except StaleDaemonError:
                # A newer daemon fenced us mid-move: the journal entry
                # stays for the owner's reconciler; only our in-memory
                # reservation is dropped (the entry's replay re-creates
                # it in the owning process).
                self._assume.release(key)
                log.error(
                    "defrag: fenced mid-move for %s/%s; move left for the "
                    "owning daemon", *plan.pod,
                )
                self._note(failed=1)
                REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="failed")
                raise
        wall_ms = (time.perf_counter() - t0) * 1e3
        self._note(completed=1, last_move_ms=round(wall_ms, 3))
        REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="completed")
        REGISTRY.observe(MOVE_SECONDS, wall_ms / 1e3, MOVE_SECONDS_HELP)
        log.info(
            "defrag: moved %s/%s chip %d -> %d (%d units, %.1f ms)",
            plan.pod[0], plan.pod[1], plan.src, plan.dst, plan.units, wall_ms,
        )
        return True


# ---------------------------------------------------------------------------
# restart resolution (called by cluster.reconciler)
# ---------------------------------------------------------------------------


def resolve_move(
    ckpt: AllocationCheckpoint,
    assume: AssumeCache,
    api: Any,
    key: PodKey,
    data: Mapping[str, Any],
    *,
    restore_fn: Callable[[PodKey, dict | None], None] | None = None,
) -> str | None:
    """Resolve one journaled move found after a restart (any phase).

    Roll **forward** when the entry reached ``switch``: the decision was
    committed — re-issue the switch PATCH if it never landed, hand the
    journaled engine snapshot to ``restore_fn`` (the destination slice),
    then commit and release. Roll **back** before ``switch``: nothing
    authoritative changed — abort and release; the workload never
    stopped (drain's side effect, if it ran, is re-delivered to the
    SOURCE by the workload's own supervisor). A deleted pod aborts in
    any phase — both reservations (the synthetic destination key and
    whatever the annotation counted) end released.

    Returns ``"rollforward"`` / ``"rollback"`` when resolved this pass,
    None when the apiserver would not answer authoritatively or a
    roll-forward side effect (the re-PATCH, the engine restore) failed —
    the entry and its destination reservation stay protective until the
    next pass.
    """
    from ..cluster.apiserver import ApiError

    pod_key = pod_of_move(data)
    seq = data.get("_seq")
    phase = str(data.get("phase") or "plan")
    if pod_key is None:
        log.warning("defrag resolve: garbled move record for %s", key)
        if ckpt.abort(key, seq=seq):
            assume.release_if_unclaimed(key)
            return "rollback"
        return None
    try:
        pod = api.get_pod(*pod_key)
    except ApiError as e:
        if e.status != 404:
            return None  # not authoritative; resolve next pass
        pod = None
    except Exception:  # noqa: BLE001 — outage
        return None
    if pod is None or not P.is_active(pod):
        if ckpt.abort(key, seq=seq):
            assume.release_if_unclaimed(key)
            REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
            log.info(
                "defrag resolve: move for deleted pod %s/%s aborted", *pod_key
            )
            return "rollback"
        return None
    if phase not in ("switch", "resume"):
        # before the commit point: nothing authoritative changed
        if ckpt.abort(key, seq=seq):
            assume.release_if_unclaimed(key)
            REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="aborted")
            log.info(
                "defrag resolve: move for %s/%s rolled back (died in %s)",
                pod_key[0], pod_key[1], phase,
            )
            return "rollback"
        return None
    # at or past switch: roll forward
    annotations = dict(data.get("annotations") or {})
    try:
        dst = int(data["dst"])
    except (KeyError, TypeError, ValueError):
        dst = -1
    if dst >= 0 and P.chip_idx_from_annotation(pod) != dst and annotations:
        # the switch PATCH never landed (or lost a race): re-issue it
        try:
            api.patch_pod(
                pod_key[0], pod_key[1], {"metadata": {"annotations": annotations}}
            )
        except Exception as e:  # noqa: BLE001 — transient: next pass retries
            log.v(4, "defrag resolve: switch re-PATCH failed (%s)", e)
            return None
    snapshot = data.get("snapshot")
    if restore_fn is None and isinstance(snapshot, dict):
        # the record carries a drained engine snapshot but no restore
        # hook is registered (yet): committing would delete the only
        # copy and lose every request it holds — stay pending until the
        # serving integration (re)registers its hooks
        log.warning(
            "defrag resolve: move for %s/%s carries a drained snapshot "
            "but no restore hook is registered; left pending", *pod_key,
        )
        return None
    if restore_fn is not None:
        try:
            restore_fn(pod_key, snapshot if isinstance(snapshot, dict) else None)
        except Exception as e:  # noqa: BLE001 — leave pending, like a
            # failed re-PATCH: committing here would delete the journal's
            # only copy of the drained snapshot and silently lose every
            # request it carries. The entry (and its protective
            # destination reservation) stays for the next pass — the
            # destination engine may simply not be rebuilt yet after the
            # restart that got us here.
            log.warning(
                "defrag resolve: engine restore for %s/%s failed (%s); "
                "move left pending for retry", pod_key[0], pod_key[1], e,
            )
            return None
    if ckpt.commit(key, seq=seq):
        assume.release_if_unclaimed(key)
        REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="completed")
        log.info(
            "defrag resolve: move for %s/%s rolled forward (died in %s)",
            pod_key[0], pod_key[1], phase,
        )
        return "rollforward"
    return None


# ---------------------------------------------------------------------------
# the loop: scan -> move -> publish (owned by the manager)
# ---------------------------------------------------------------------------


# The numeric surface of the defrag-status annotation, coerced on read so
# a half-garbled annotation (a null counter, a stringly duration) degrades
# to zeros instead of crashing every CLI invocation against that node.
_STATUS_INT_FIELDS = (
    "planned", "active", "completed", "failed", "quantum", "stranded_units",
)
_STATUS_FLOAT_FIELDS = ("last_move_ms", "stranded_pct")


def status_from_node(node: Mapping[str, Any] | None) -> dict[str, Any] | None:
    """Parse the daemon's defrag-status node annotation
    (:data:`~..const.ANN_DEFRAG_STATUS`), or None when absent/garbled —
    the inspect CLI's read side of :meth:`DefragLoop.publish_status`.
    Numeric fields are coerced (garbled values read as 0), so callers can
    format them without re-validating."""
    if not node:
        return None
    raw = ((node.get("metadata") or {}).get("annotations") or {}).get(
        const.ANN_DEFRAG_STATUS
    )
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    out: dict[str, Any] = {}
    for k, v in doc.items():
        try:
            if k in _STATUS_INT_FIELDS:
                out[k] = int(v)
            elif k in _STATUS_FLOAT_FIELDS:
                out[k] = float(v)
            else:
                out[k] = v
        except (TypeError, ValueError):
            out[k] = 0.0 if k in _STATUS_FLOAT_FIELDS else 0
    return out


class DefragLoop:
    """The daemon's defragmentation loop: every ``interval_s`` it scans
    (:class:`DefragPlanner`), executes the planned moves one at a time
    (:class:`SliceMover` — serial on purpose: each move re-validates
    against the live apiserver, and one in-flight move's destination
    reservation already routes concurrent admissions around it), and
    publishes the node's defrag-status annotation for the inspect CLI.

    The first pass runs one full interval after :meth:`start`, never at
    startup — the reconciler's first pass must resolve any move the
    previous incarnation died holding before this instance plans new
    ones. A :class:`~.checkpoint.StaleDaemonError` stops the loop for
    good: a superseded daemon must not move pods the newer one owns.
    """

    def __init__(
        self,
        planner: DefragPlanner,
        mover: SliceMover,
        api: Any,
        node_name: str,
        *,
        interval_s: float = 300.0,
    ) -> None:
        self._planner = planner
        self._mover = mover
        self._api = api
        self._node = node_name
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "DefragLoop":
        self._thread = threading.Thread(
            target=self._run, name="defrag-loop", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.run_once()
            except StaleDaemonError:
                log.error(
                    "defrag: fenced mid-pass; loop stopping (a newer "
                    "daemon owns this node's moves)"
                )
                return
            except Exception as e:  # noqa: BLE001 — never kill the loop
                log.warning("defrag pass failed: %s", e)

    def run_once(self) -> DefragReport:
        """One scan-move-publish pass (the loop body, callable directly
        in tests/benches). ``StaleDaemonError`` propagates — the caller
        must stop driving moves."""
        report = self._planner.scan()
        for plan in report.moves:
            if self._stop.is_set():
                break
            try:
                self._mover.execute(plan)
            except StaleDaemonError:
                # fenced: a newer daemon owns this node's moves — do NOT
                # publish status (an unfenced node PATCH would overwrite
                # the owner's published counters with this superseded
                # incarnation's stale picture)
                raise
            except Exception as e:  # noqa: BLE001 — entry stays pending
                # for the reconciler (that IS the crash-safety story);
                # later moves may still apply
                log.warning(
                    "defrag: move for %s/%s failed (%s); journal entry "
                    "left for the reconciler", plan.pod[0], plan.pod[1], e,
                )
                # keep the published annotation's failed counter in step
                # with the metric — the mover's own accounting runs only
                # on its clean-abort/fenced paths, not when the
                # exception propagates out of execute()
                self._mover.note_failed()
                REGISTRY.counter_inc(MOVES_METRIC, MOVES_HELP, outcome="failed")
        self.publish_status(report)
        return report

    def publish_status(self, report: DefragReport | None) -> None:
        """Write the defrag-status node annotation (best effort — the
        apiserver is the database, so the CLI needs no extra endpoint)."""
        stats = self._mover.stats()
        doc: dict[str, Any] = {
            "planned": stats.planned,
            "active": stats.active,
            "completed": stats.completed,
            "failed": stats.failed,
            "last_move_ms": stats.last_move_ms,
        }
        if report is not None:
            doc.update(
                quantum=report.quantum,
                stranded_units=sum(report.stranded_by_chip.values()),
                stranded_pct=round(report.stranded_pct, 2),
            )
        try:
            self._api.patch_node(
                self._node,
                {"metadata": {"annotations": {
                    const.ANN_DEFRAG_STATUS: json.dumps(doc, sort_keys=True)
                }}},
            )
        except Exception as e:  # noqa: BLE001 — status is observability
            log.v(4, "defrag: status annotation publish failed (%s)", e)
