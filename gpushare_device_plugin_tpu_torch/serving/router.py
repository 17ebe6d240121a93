"""Fleet front door: routing, membership, and journaled scale-down.

Counterpart of ``gpushare_device_plugin_tpu/serving/router.py``, copied
whole: the same WAL records, decision records and metric families. One
engine serves one slice; a pool of engines sits behind a router that
survives engine crashes, stale telemetry and capacity swings without
dropping a request. This module is the half with no engine in it (like
``handoffproto.py``): the routing table, the failure detector and the
journaled scale-down protocol. The binding to real engines lives in
``serving/fleet.py``.

Four pieces:

- :class:`FleetRouter`: scores every ready replica through the placement
  policy registry (``extender/policy.py``; default ``prefix-affinity``:
  radix-fingerprint overlap tempered by headroom) and emits one
  :class:`~..utils.decisions.DecisionRecord` per route or shed. Prefix
  affinity degrades to load balancing when fingerprints are stale or a
  scrape failed: affinity is a performance signal, never a correctness
  dependency.
- :class:`FleetMembership`: the health-checked replica table. Each
  member is scraped through an :class:`EngineScrapeClient`
  (``utils/retry.py`` backoff over a ``utils/circuit.py`` breaker);
  consecutive misses evict, and the prefix fingerprints ride the same
  scrape.
- SLO-aware shedding: the router reads the SLO budget's burn-rate
  severity and the queue depths and degrades BEST-EFFORT traffic first;
  critical requests are routed (or queued on the least-loaded replica) as
  long as one replica lives.
- The **scale** protocol: scale-down is WAL record kind ``"scale"``
  journaled through ``cordon -> drain -> migrate -> release``, each
  record durable *before* its side effect:

  - **cordon**: intent durable, then the replica closes to new routes;
    its in-flight row set is frozen from here.
  - **drain**: the frozen request rows are durable (from here a crash
    can re-serve every in-flight request from the journal alone), then
    the engine drains to a snapshot.
  - **migrate**: the **commit point**. The drained snapshot is durable,
    then a survivor adopts it (idempotent by ``snapshot_id``). At or past
    this phase a crash rolls FORWARD (re-deliver); before it, a crash
    rolls BACK (re-queue the journaled rows on survivors, a full
    re-prefill; greedy tokens are the same).
  - **release**: decommission intent durable, then the replica leaves
    the membership; the WAL entry resolves.

  :func:`resolve_scale` is the reconciler's roll-forward/roll-back hook,
  the same shape as ``resolve_handoff``: a kill at any phase loses
  latency, never a request.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping

from ..allocator.checkpoint import AllocationCheckpoint, StaleDaemonError
from ..const import (
    FLEET_REPLICA_CORDONED,
    FLEET_REPLICA_DEAD,
    FLEET_REPLICA_READY,
    FLEET_REPLICA_STATES,
    SLO_TIER_BEST_EFFORT,
    SLO_TIER_CRITICAL,
)
from ..extender.policy import PlacementPolicy, PolicyView
from ..extender.policy import resolve as resolve_policy
from ..utils.circuit import CircuitBreaker, CircuitOpenError
from ..utils.decisions import DECISIONS, DecisionLog, rank_scores
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metric_catalog import (
    FLEET_DRAIN_MIGRATED_REQUESTS_TOTAL,
    FLEET_REPLICAS,
    FLEET_SCALE_OPS_TOTAL,
    ROUTER_PREFIX_AFFINITY_HITS_TOTAL,
    ROUTER_ROUTED_TOTAL,
    ROUTER_SHED_TOTAL,
)
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.retry import retry
from ..utils.slo import SEVERITY_PAGE, SloBudget
from .radix import prefix_fingerprints

log = get_logger("serving.router")

# The journaled scale-down state machine, in order. Each phase's WAL
# record is durable BEFORE its side effect; "migrate" is the
# roll-forward boundary (the analogue of handoff's "import").
SCALE_PHASES = ("cordon", "drain", "migrate", "release")
SCALE_KIND = "scale"
SCALE_ROLL_FORWARD_PHASES = ("migrate", "release")

# Synthetic namespace for scale journal keys, like HANDOFF_NS: the
# entry is keyed by scale-op id, never mistaken for a real pod's own
# accounting.
SCALE_NS = "tpushare-scale"

ROUTED_HELP = "Requests routed by the fleet router, by engine and outcome"
AFFINITY_HELP = (
    "Routes landing on an engine already holding the prompt prefix"
)
SHED_HELP = (
    "Requests shed at admission by SLO tier (best-effort degrades first)"
)
REPLICAS_HELP = "Fleet replicas by lifecycle state"
MIGRATED_HELP = (
    "In-flight requests migrated to a survivor by scale-down drains"
)
SCALE_OPS_HELP = "Journaled scale-down protocol executions by outcome"


def scale_key(scale_id: str) -> tuple[str, str]:
    """The journal key for one scale-down operation (synthetic ns)."""
    return (SCALE_NS, scale_id)


def _journal_scale(
    ckpt: AllocationCheckpoint | None, key: tuple[str, str], data: dict
) -> int | None:
    """Journal one scale phase durable (a fresh ``begin`` for the scale
    key — the loader keeps the newest record per key, so the entry
    always names the furthest phase reached, exactly like
    ``_journal_handoff``). ``StaleDaemonError`` propagates: a fenced
    daemon must not advance a scale-down the newer incarnation owns.
    ``None`` = journal degraded (sick disk): the scale-down continues
    unjournaled, like admissions do. Every call site is followed by
    :func:`_journal_resolve` on its handled paths."""
    if ckpt is None:
        return None
    return ckpt.begin(key, data)


def _journal_resolve(
    ckpt: AllocationCheckpoint | None,
    op: str,
    key: tuple[str, str],
    seq: int | None,
) -> bool:
    """Resolve the scale entry (``op`` = ``"commit"`` the replica was
    drained/migrated/released, ``"abort"`` the scale-down rolled back);
    False = degraded/unjournaled or a newer begin owns the key."""
    if ckpt is None:
        return False
    if op == "commit":
        return ckpt.commit(key, seq=seq)
    return ckpt.abort(key, seq=seq)


# ---------------------------------------------------------------------------
# health-checked membership
# ---------------------------------------------------------------------------


class EngineScrapeClient:
    """One replica's heartbeat path: ``scrape_fn() -> doc`` retried with
    exponential backoff under a per-call deadline, behind a circuit
    breaker so a dead replica fails fast instead of serializing full
    retry ladders into every membership pass. Stateless apart from the
    breaker — miss counting lives in :class:`FleetMembership` (one
    owner for eviction state), so this class needs no lock of its own.

    The doc contract (what ``serving/fleet.py`` exports per engine and
    the /fleet endpoint re-serves): ``free_slots``, ``capacity``,
    ``queue_depth``, and ``fingerprints`` — the radix cache's chained
    page-path CRCs (:meth:`~.radix.RadixCache.fingerprints`)."""

    def __init__(
        self,
        scrape_fn: Callable[[], Mapping[str, Any]],
        *,
        attempts: int = 2,
        delay_s: float = 0.01,
        backoff: float = 2.0,
        deadline_s: float = 1.0,
        breaker: CircuitBreaker | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._fn = scrape_fn
        self._attempts = attempts
        self._delay = delay_s
        self._backoff = backoff
        self._deadline = deadline_s
        self._breaker = breaker or CircuitBreaker(
            "fleet-scrape", failure_threshold=5, reset_timeout_s=1.0,
            clock=clock,
        )
        self._sleep = sleep
        self._clock = clock

    def scrape(self) -> dict[str, Any]:
        def once() -> dict[str, Any]:
            self._breaker.before()
            try:
                out = dict(self._fn())
            except Exception:
                self._breaker.record_failure()
                raise
            self._breaker.record_success()
            return out

        return retry(
            once,
            attempts=self._attempts,
            delay_s=self._delay,
            backoff=self._backoff,
            deadline_s=self._deadline,
            # an OPEN breaker is a fail-fast verdict, not a blip
            retryable=lambda e: not isinstance(e, CircuitOpenError),
            sleep=self._sleep,
            clock=self._clock,
        )


@dataclasses.dataclass(frozen=True)
class MemberView:
    """One replica as the router sees it (an immutable snapshot — the
    route decision never reads the live table twice)."""

    name: str
    state: str
    fingerprints: frozenset[int]
    free_slots: int
    capacity: int
    queue_depth: int


@dataclasses.dataclass
class _Member:
    client: EngineScrapeClient | None
    state: str = FLEET_REPLICA_READY
    misses: int = 0
    fingerprints: set[int] = dataclasses.field(default_factory=set)
    free_slots: int = 0
    capacity: int = 0
    queue_depth: int = 0


class FleetMembership:
    """The fleet's replica table: health, cordon flags, scraped load and
    prefix fingerprints. Failure detection is consecutive-miss eviction:
    a replica whose scrape fails ``miss_threshold`` times in a row is
    marked dead (the router stops considering it; the fleet binding
    re-queues its in-flight requests on survivors).

    Thread-safe under rank ``fleet.membership`` — held around table
    flips only, never across a scrape transport call or its breaker.
    """

    def __init__(
        self,
        *,
        miss_threshold: int = 3,
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}"
            )
        self._lock = make_lock("fleet.membership")
        self._members: dict[str, _Member] = {}
        self._miss_threshold = miss_threshold
        self._registry = registry
        self._pod = pod

    def add(
        self,
        name: str,
        client: EngineScrapeClient | None = None,
        *,
        capacity: int = 0,
        free_slots: int | None = None,
    ) -> None:
        """Register a replica (scale-up / bootstrap). Capacity seeds the
        router until the first scrape refreshes it."""
        with self._lock:
            self._members[name] = _Member(
                client=client,
                capacity=capacity,
                free_slots=capacity if free_slots is None else free_slots,
            )

    def remove(self, name: str) -> None:
        with self._lock:
            self._members.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    def set_state(self, name: str, state: str) -> None:
        if state not in FLEET_REPLICA_STATES:
            raise ValueError(
                f"state {state!r} not in {FLEET_REPLICA_STATES}"
            )
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.state = state

    def cordon(self, name: str) -> None:
        """Close a replica to new routes (scale-down's first durable
        step, or an operator's manual drain)."""
        self.set_state(name, FLEET_REPLICA_CORDONED)

    def uncordon(self, name: str) -> None:
        """Re-open a cordoned replica (scale-down rollback)."""
        self.set_state(name, FLEET_REPLICA_READY)

    def mark_dead(self, name: str) -> None:
        self.set_state(name, FLEET_REPLICA_DEAD)

    def note_routed(self, name: str, fingerprints: list[int]) -> None:
        """Optimistically credit a replica with the prefix pages it is
        ABOUT to cache for a request just routed there: affinity then
        works within one scrape interval (the next scrape replaces the
        estimate with the engine's exported truth)."""
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.fingerprints.update(fingerprints)

    def scrape_once(self) -> dict[str, bool]:
        """One heartbeat pass: scrape every replica that has a client,
        transport OUTSIDE the lock, table flips under it. Returns
        name -> scrape-succeeded; a replica reaching the consecutive-
        miss threshold flips to dead (eviction)."""
        with self._lock:
            targets = [
                (name, m.client)
                for name, m in self._members.items()
                if m.client is not None
                and m.state != FLEET_REPLICA_DEAD
            ]
        outcomes: dict[str, bool] = {}
        for name, client in targets:
            doc: dict[str, Any] | None
            try:
                doc = client.scrape()
            except Exception as e:  # noqa: BLE001 — a miss, not a bug
                doc = None
                log.v(4, "fleet scrape of %s failed: %s", name, e)
            with self._lock:
                m = self._members.get(name)
                if m is None:
                    continue
                if doc is None:
                    m.misses += 1
                    outcomes[name] = False
                    if (
                        m.misses >= self._miss_threshold
                        and m.state != FLEET_REPLICA_DEAD
                    ):
                        m.state = FLEET_REPLICA_DEAD
                        log.warning(
                            "fleet replica %s evicted after %d "
                            "consecutive scrape misses", name, m.misses,
                        )
                else:
                    m.misses = 0
                    m.free_slots = int(doc.get("free_slots", m.free_slots))
                    m.capacity = int(doc.get("capacity", m.capacity))
                    m.queue_depth = int(
                        doc.get("queue_depth", m.queue_depth)
                    )
                    fps = doc.get("fingerprints")
                    if fps is not None:
                        m.fingerprints = {int(f) for f in fps}
                    outcomes[name] = True
        return outcomes

    def snapshot(self) -> list[MemberView]:
        with self._lock:
            return [
                MemberView(
                    name=name,
                    state=m.state,
                    fingerprints=frozenset(m.fingerprints),
                    free_slots=m.free_slots,
                    capacity=m.capacity,
                    queue_depth=m.queue_depth,
                )
                for name, m in sorted(self._members.items())
            ]

    def publish(self) -> None:
        with self._lock:
            counts = {state: 0 for state in FLEET_REPLICA_STATES}
            for m in self._members.values():
                counts[m.state] = counts.get(m.state, 0) + 1
        labels = {"pod": self._pod} if self._pod else {}
        for state, n in counts.items():
            self._registry.gauge_set(
                FLEET_REPLICAS, float(n), REPLICAS_HELP, state=state,
                **labels,
            )

    def doc(self) -> dict[str, Any]:
        with self._lock:
            return {
                "replicas": {
                    name: {
                        "state": m.state,
                        "misses": m.misses,
                        "free_slots": m.free_slots,
                        "capacity": m.capacity,
                        "queue_depth": m.queue_depth,
                        "fingerprints": len(m.fingerprints),
                    }
                    for name, m in sorted(self._members.items())
                },
            }


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One admission verdict. ``engine`` is None when the request was
    shed (best-effort under SLO pressure) or no replica is ready; the
    caller queues or rejects accordingly — the router never silently
    drops."""

    rid: str
    engine: str | None
    outcome: str
    reason: str
    affinity_pages: int = 0

    @property
    def shed(self) -> bool:
        return self.outcome == "shed"


class FleetRouter:
    """Scores ready replicas per request and owns the in-flight
    routing table (rid -> engine), so an engine death can re-queue
    exactly its in-flight set on survivors.

    Lock discipline (rank ``fleet.router``): the SLO severity read
    (rank 64) and the membership snapshot (rank 77... taken while NOT
    holding this lock) happen before acquisition; DecisionRecord
    emission (rank 65) and metric counters happen after release. The
    lock guards only the assignment table and counters."""

    def __init__(
        self,
        membership: FleetMembership,
        *,
        page_size: int,
        policy: "str | PlacementPolicy" = "prefix-affinity",
        slo_budget: SloBudget | None = None,
        shed_queue_depth: int = 64,
        decisions: DecisionLog = DECISIONS,
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._membership = membership
        self._page_size = page_size
        self._policy = resolve_policy(policy)
        self._slo = slo_budget
        self._shed_queue_depth = shed_queue_depth
        self._decisions = decisions
        self._registry = registry
        self._pod = pod
        self._lock = make_lock("fleet.router")
        self._inflight: dict[str, str] = {}
        self._assigned: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self._affinity_hits = 0

    @staticmethod
    def _affinity(fps: list[int], member: frozenset[int]) -> int:
        """Consecutive prefix pages the member already caches. The
        fingerprints are CRC-chained (each commits to the whole path),
        so membership of ``fps[i]`` implies the engine holds pages
        ``0..i`` of THIS prompt — overlap is counted from the front and
        stops at the first miss."""
        pages = 0
        for fp in fps:
            if fp not in member:
                break
            pages += 1
        return pages

    def route(
        self,
        rid: str,
        prompt: tuple[int, ...],
        tier: str = SLO_TIER_CRITICAL,
    ) -> RouteDecision:
        """Admit one request: pick an engine (affinity- and headroom-
        scored through the policy registry), shed it (best-effort under
        SLO pressure), or report no replica is ready. Exactly one
        DecisionRecord is emitted per call, whatever the outcome."""
        # Down-rank reads FIRST: slo.budget (64) sits below fleet.router.
        severity = (
            self._slo.severity(SLO_TIER_CRITICAL)
            if self._slo is not None
            else None
        )
        members = self._membership.snapshot()
        ready = [m for m in members if m.state == FLEET_REPLICA_READY]
        fps = prefix_fingerprints(tuple(prompt), self._page_size)
        engine: str | None = None
        pages = 0
        scores: dict[str, Any] | None = None
        with self._lock:
            load = {
                m.name: self._assigned.get(m.name, 0) for m in ready
            }
            if not ready:
                outcome, reason = "no_replicas", "no ready replicas"
            elif (
                tier == SLO_TIER_BEST_EFFORT
                and severity == SEVERITY_PAGE
            ):
                outcome = "shed"
                reason = (
                    "critical-tier burn rate at page severity; "
                    "best-effort degrades first"
                )
            elif tier == SLO_TIER_BEST_EFFORT and all(
                m.queue_depth + load[m.name] >= self._shed_queue_depth
                for m in ready
            ):
                outcome = "shed"
                reason = (
                    f"every replica queue >= {self._shed_queue_depth}; "
                    "best-effort degrades first"
                )
            else:
                scores = {}
                affinity = {}
                for m in ready:
                    affinity[m.name] = self._affinity(
                        fps, m.fingerprints
                    )
                    scores[m.name] = self._policy.score(
                        PolicyView(
                            free_units=max(
                                0, m.free_slots - load[m.name]
                            ),
                            capacity=max(1, m.capacity),
                            request_units=1,
                            affinity_pages=affinity[m.name],
                        )
                    )
                best = rank_scores(scores)[0]
                if scores[best].raw <= 0.0:
                    # every replica is saturated: queue on the least
                    # loaded one rather than drop — queue-depth
                    # balancing is the floor, shedding is tier-gated
                    best = min(
                        ready,
                        key=lambda m: (
                            m.queue_depth + load[m.name], m.name
                        ),
                    ).name
                    outcome = "overflow"
                    reason = "no headroom anywhere; queued least-loaded"
                elif affinity[best] > 0:
                    outcome = "affinity"
                    reason = (
                        f"{affinity[best]} prefix pages warm on {best}"
                    )
                else:
                    outcome = "balanced"
                    reason = f"load-balanced onto {best}"
                engine = best
                pages = affinity.get(best, 0)
                self._inflight[rid] = engine
                self._assigned[engine] = load.get(engine, 0) + 1
                if pages > 0:
                    self._affinity_hits += 1
            self._counts[outcome] = self._counts.get(outcome, 0) + 1
        # Down-rank side effects AFTER release: decisions.ring (65).
        verb = "fleet_shed" if outcome == "shed" else "fleet_route"
        self._decisions.emit(
            rid, verb, outcome=outcome, node=engine or "",
            reason=reason, candidates=len(ready), scores=scores,
        )
        labels = {"pod": self._pod} if self._pod else {}
        if outcome == "shed":
            self._registry.counter_inc(
                ROUTER_SHED_TOTAL, SHED_HELP, tier=tier, **labels
            )
        else:
            self._registry.counter_inc(
                ROUTER_ROUTED_TOTAL, ROUTED_HELP,
                engine=engine or "none", outcome=outcome, **labels,
            )
        if pages > 0:
            self._registry.counter_inc(
                ROUTER_PREFIX_AFFINITY_HITS_TOTAL, AFFINITY_HELP,
                **labels,
            )
        if engine is not None and fps:
            self._membership.note_routed(engine, fps)
        return RouteDecision(
            rid=rid, engine=engine, outcome=outcome, reason=reason,
            affinity_pages=pages,
        )

    def complete(self, rid: str) -> None:
        """A routed request finished (served, or re-queued elsewhere)."""
        with self._lock:
            engine = self._inflight.pop(rid, None)
            if engine is not None:
                n = self._assigned.get(engine, 0) - 1
                if n > 0:
                    self._assigned[engine] = n
                else:
                    self._assigned.pop(engine, None)

    def inflight_on(self, engine: str) -> list[str]:
        with self._lock:
            return sorted(
                rid for rid, e in self._inflight.items() if e == engine
            )

    def forget_engine(self, engine: str) -> list[str]:
        """Drop an engine's whole in-flight set (it died, or its drain
        snapshot migrated) and return the rids — the fleet binding
        re-queues them on survivors."""
        with self._lock:
            rids = sorted(
                rid for rid, e in self._inflight.items() if e == engine
            )
            for rid in rids:
                del self._inflight[rid]
            self._assigned.pop(engine, None)
            return rids

    def least_loaded(
        self, exclude: "frozenset[str] | set[str]" = frozenset()
    ) -> str | None:
        """The ready replica with the shallowest queue (scraped depth +
        this router's live assignments) — the migrate hook's survivor
        pick and the overflow floor share this definition. None when no
        ready replica remains."""
        ready = [
            m for m in self._membership.snapshot()
            if m.state == FLEET_REPLICA_READY and m.name not in exclude
        ]
        if not ready:
            return None
        with self._lock:
            return min(
                ready,
                key=lambda m: (
                    m.queue_depth + self._assigned.get(m.name, 0),
                    m.name,
                ),
            ).name

    def seed_inflight(self, assignments: Mapping[str, str]) -> None:
        """Rebuild the routing table after a router restart from the
        engines' own in-flight docs (the engines are the ground truth —
        the router's table is a cache of it)."""
        with self._lock:
            for rid, engine in assignments.items():
                if rid not in self._inflight:
                    self._inflight[rid] = engine
                    self._assigned[engine] = (
                        self._assigned.get(engine, 0) + 1
                    )

    def doc(self) -> dict[str, Any]:
        with self._lock:
            routed = sum(
                n for o, n in self._counts.items() if o != "shed"
            )
            return {
                "policy": self._policy.name,
                "outcomes": dict(sorted(self._counts.items())),
                "inflight": len(self._inflight),
                "affinity_hits": self._affinity_hits,
                "affinity_hit_ratio": (
                    self._affinity_hits / routed if routed else 0.0
                ),
            }


# ---------------------------------------------------------------------------
# the journaled scale-down executor
# ---------------------------------------------------------------------------


class ScaleExecutor:
    """Executes one scale-down through the journaled protocol.

    The side effects are bindings the fleet provides: ``cordon_fn``
    closes the replica to new routes, ``rows_fn`` reads its frozen
    in-flight request rows (JSON-safe, post-cordon), ``drain_fn`` runs
    the engine to its drain snapshot, ``migrate_fn(snapshot, record)``
    delivers the snapshot to a survivor (idempotent by snapshot_id)
    and returns how many requests moved, ``release_fn`` decommissions
    the replica. Exceptions out of :meth:`execute` leave the journal
    entry pending for the reconciler — deliberately: that IS the
    crash-safety story, same as the defrag and handoff movers.

    Lock discipline (rank ``fleet.scale``): held for counter flips
    only — never across a journal write (rank 40) or an engine call
    (rank 89)."""

    def __init__(
        self,
        checkpoint: AllocationCheckpoint | None,
        assume: Any,
        *,
        cordon_fn: Callable[[str], None],
        rows_fn: Callable[[str], list[dict]],
        drain_fn: Callable[[str], dict],
        migrate_fn: Callable[[dict, dict], int],
        release_fn: Callable[[str], None],
        node: str = "",
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        self._ckpt = checkpoint
        self._assume = assume
        self._cordon = cordon_fn
        self._rows = rows_fn
        self._drain = drain_fn
        self._migrate = migrate_fn
        self._release = release_fn
        self._node = node
        self._registry = registry
        self._pod = pod
        self._lock = make_lock("fleet.scale")
        self.migrated_requests = 0
        self.completed_ops = 0

    def _count(self, outcome: str) -> None:
        labels = {"pod": self._pod} if self._pod else {}
        self._registry.counter_inc(
            FLEET_SCALE_OPS_TOTAL, SCALE_OPS_HELP, outcome=outcome,
            **labels,
        )

    def execute(self, scale_id: str, engine: str) -> str:
        """Scale one replica down end to end: ``"scaled"`` (drained,
        migrated, released) or ``"skipped"`` (a concurrent executor owns
        the op). Raises when a side effect fails: the entry stays
        pending and the reconciler rolls it forward or back — the
        in-flight requests are delayed, never lost."""
        key = scale_key(scale_id)
        if self._assume is not None and not self._assume.claim(key):
            log.v(4, "scale %s already in flight; skipped", scale_id)
            return "skipped"
        base = {
            "kind": SCALE_KIND,
            "scale_id": scale_id,
            "engine": engine,
            "node": self._node,
        }
        try:
            # cordon: intent durable, then the replica closes to new
            # routes — the in-flight row set is frozen from here.
            seq = _journal_scale(self._ckpt, key, {**base, "phase": "cordon"})
            FAULTS.fire("scale.cordon")
            self._cordon(engine)
            # drain: the frozen rows are durable BEFORE the engine
            # drains — from here a crash can re-serve every in-flight
            # request from the journal alone (full re-prefill on a
            # survivor, tokens bit-identical by greedy determinism).
            rows = [dict(r) for r in self._rows(engine)]
            seq = _journal_scale(
                self._ckpt, key, {**base, "phase": "drain", "rows": rows}
            )
            FAULTS.fire("scale.drain")
            snapshot = self._drain(engine)
            # migrate: the commit point — the drained snapshot is
            # durable, then a survivor adopts it (idempotent by
            # snapshot_id). At or past this record a crash rolls
            # forward.
            seq = _journal_scale(
                self._ckpt, key,
                {**base, "phase": "migrate", "rows": rows,
                 "snapshot": snapshot},
            )
            FAULTS.fire("scale.migrate")
            moved = int(self._migrate(snapshot, dict(base)))
            # release: decommission intent durable, then the replica
            # leaves the membership; the entry resolves.
            seq = _journal_scale(
                self._ckpt, key, {**base, "phase": "release"}
            )
            FAULTS.fire("scale.release")
            self._release(engine)
            _journal_resolve(self._ckpt, "commit", key, seq)
            self._release_claim(key)
        except StaleDaemonError:
            # a newer daemon fenced us mid-scale: the entry stays for
            # the owner's reconciler; only our claim is dropped.
            self._release_claim(key)
            self._count("failed")
            raise
        with self._lock:
            self.migrated_requests += moved
            self.completed_ops += 1
        labels = {"pod": self._pod} if self._pod else {}
        if moved:
            self._registry.counter_inc(
                FLEET_DRAIN_MIGRATED_REQUESTS_TOTAL, MIGRATED_HELP,
                value=float(moved), **labels,
            )
        self._count("scaled")
        log.info(
            "scale %s: replica %s drained, %d in-flight requests "
            "migrated, released", scale_id, engine, moved,
        )
        return "scaled"

    def _release_claim(self, key: tuple[str, str]) -> None:
        if self._assume is not None:
            self._assume.release(key)


# ---------------------------------------------------------------------------
# restart resolution (a reconciler calls this on each pending scale entry)
# ---------------------------------------------------------------------------


def resolve_scale(
    ckpt: AllocationCheckpoint,
    assume: Any,
    key: tuple[str, str],
    data: Mapping[str, Any],
    *,
    deliver_fn: Callable[[str, dict], Any],
    requeue_fn: Callable[[str, dict], Any] | None = None,
) -> str | None:
    """Resolve one journaled scale-down found after a crash (any phase).

    Roll **forward** at or past ``migrate``: the commit point passed —
    the drained snapshot is in the record; re-deliver it through
    ``deliver_fn`` (the fleet binding's survivor restore — idempotent
    by snapshot_id — plus the release the dead executor never reached),
    then commit. Roll **back** before it: ``requeue_fn`` re-opens the
    replica if it still lives, or re-queues the journaled rows on
    survivors (rid-deduped, full re-prefill), then abort. BOTH
    directions end with every in-flight request scheduled to be served
    exactly once — a scale entry, whatever phase it died in, never
    costs a request.

    Returns ``"rollforward"`` / ``"rollback"`` when resolved this pass,
    None when a side effect failed — the entry stays pending
    (protective) for the next pass, exactly like move and handoff."""
    seq = data.get("_seq")
    phase = str(data.get("phase") or "cordon")
    scale_id = str(data.get("scale_id") or key[1])
    if phase in SCALE_ROLL_FORWARD_PHASES:
        try:
            deliver_fn(scale_id, dict(data))
        except Exception as e:  # noqa: BLE001 — survivor not ready:
            # committing would delete the journal's only copy of the
            # drained snapshot; stay pending for the next pass
            log.warning(
                "scale resolve: re-delivery of %s failed (%s); left "
                "pending", scale_id, e,
            )
            return None
        if _journal_resolve(ckpt, "commit", key, seq):
            if assume is not None:
                assume.release_if_unclaimed(key)
            log.info(
                "scale resolve: %s rolled forward (died in %s)",
                scale_id, phase,
            )
            return "rollforward"
        return None
    # before the commit point: un-cordon the replica if it still lives,
    # or re-queue the journaled rows on survivors (the degradation
    # ladder's floor — a full re-prefill, tokens bit-identical)
    try:
        if requeue_fn is not None:
            requeue_fn(scale_id, dict(data))
    except Exception as e:  # noqa: BLE001 — stay pending
        log.warning(
            "scale resolve: rollback of %s failed (%s); left pending",
            scale_id, e,
        )
        return None
    if _journal_resolve(ckpt, "abort", key, seq):
        if assume is not None:
            assume.release_if_unclaimed(key)
        log.info(
            "scale resolve: %s rolled back (died in %s)",
            scale_id, phase,
        )
        return "rollback"
    return None
