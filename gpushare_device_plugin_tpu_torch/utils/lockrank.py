"""Declared lock ranking, the ranked-lock factory, the runtime
lock-order witness and the model checker's seam.

Counterpart of ``gpushare_device_plugin_tpu/utils/lockrank.py``, with
every lock the reference ranks: the node agent's (the allocators' serial
and match locks, the defragmenter's planner report and move counters, the
interference detector's baselines, the pod informer and its indexes, the
node-PATCH coalescer), the WAL, its group-commit writer, the assume cache,
the SLO budget, the decision log, the fleet's router, membership and scale
executor, the KV handoff's ledger and peer client, the serving engine's
adapter cache, radix tree, page allocator, drain handshake and step
profiler, the circuit breaker, the fault table, the device plugin's stream
condition, health watcher and standalone allocator, the node agent's
timeline ring and flight recorder, the scheduler extender's decision lock,
usage index, shard router, coordinator lease, 2PC side-state, churn
simulator and admission-trace registry, and the trace store and metrics
registry. Each entry is the reference's: same name, rank, kind, I/O rule
and reason.

- :data:`RANKS`: a total order. A thread may only acquire a lock whose
  rank is strictly greater than every lock it already holds (re-entering
  the same RLock is fine), so two code paths that respect it can never
  deadlock.
- :func:`make_lock` / :func:`make_rlock` / :func:`make_condition` /
  :func:`make_event`: every ranked lock, and every event a protocol waits
  on, is created here, naming its rank. By default they return plain
  ``threading`` primitives.
- The witness: with ``TPUSHARE_LOCK_WITNESS=1`` or ``TPUSHARE_TEST_CHAOS=1``
  in the environment, or after :func:`set_witness` ``(True)``, locks
  created from then on check each acquire against the ranking on their
  thread and record a :class:`Violation` (with both acquisition stacks)
  for any down-rank acquire (raised at once under
  ``TPUSHARE_LOCK_WITNESS_RAISE=1``); :func:`assert_clean` raises on any
  recorded one.
- The model checker's seam (:func:`set_mc_factory`): while a factory is
  installed, the four ``make_*`` functions hand out its primitives (after
  the rank check), so every acquire, release, wait and set becomes a
  yield point of a deterministic scheduler. With
  ``FaultRegistry.set_yield_hook`` it is what the reference's
  ``tools/tpumc`` checker drives, and it drives the port's protocols
  through it unchanged (``tests/torch_mc_mirror.py``).

Stdlib only: every other module imports this one to create its locks.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class LockRank:
    """One declared lock level: ``rank`` is the total order (acquire
    strictly upward only), ``kind`` what the factory returns ("lock",
    "rlock" or "condition"), ``io_ok`` whether blocking I/O may run while
    it is held."""

    name: str
    rank: int
    kind: str
    io_ok: bool
    doc: str


def _r(name: str, rank: int, kind: str, io_ok: bool, doc: str) -> tuple[str, LockRank]:
    return name, LockRank(name, rank, kind, io_ok, doc)


RANKS: dict[str, LockRank] = dict((
    _r("allocator.serial", 10, "rlock", True,
       "Legacy full-serialization guard for list-backed pod sources "
       "(AssumeCache.serial_lock): wraps an entire admission, PATCH "
       "included, so it outranks everything and is the one lock "
       "allowed to cover the full I/O flow."),
    _r("extender.lease", 16, "lock", False,
       "LeaderLease's per-gang-group coordinator epochs (the 2PC "
       "fencing tokens). Pure memory, acquired before any shard "
       "verb runs — outermost of the shard-layer locks."),
    _r("extender.router", 17, "lock", False,
       "ShardRouter's cached shard summaries + degraded-shard "
       "bookkeeping. Never held across a shard verb call (those "
       "acquire extender.core and the ledger further down-rank)."),
    _r("extender.simchurn", 19, "lock", False,
       "ChurnDriver's stats/death-heap guard (the scale bench's "
       "simulated-cluster worker pool). Held around counter and "
       "heap flips only — admissions, apiserver calls, and shard "
       "verbs all run with it released."),
    _r("extender.core", 20, "rlock", False,
       "ExtenderCore's decision lock: guards the in-flight overlay "
       "and the view cache while a bind decision is made. In-memory "
       "only by design — a network or fsync wait here serializes "
       "every bind in the cluster behind one I/O."),
    _r("extender.twopc", 21, "lock", False,
       "ShardExtender's 2PC side-state (gang2pc reservation key -> "
       "node map, seen coordinator epochs). Read by the shard's "
       "usage-overlay hook while the core's decision lock (rank 20) "
       "is held, so it sits just above extender.core; the journal "
       "write and the ledger reserve run outside it, strictly "
       "up-rank."),
    _r("allocator.match", 22, "lock", True,
       "Per-size match stripes (ClusterAllocator/_CoreAllocator): "
       "serialize same-size matches. May refresh() the pod source "
       "(one synchronous LIST) on a match miss — the documented "
       "close-the-bind-window exception, so I/O is allowed."),
    _r("defrag.planner", 24, "lock", False,
       "DefragPlanner's cached last-scan report: the defrag loop "
       "writes it, the CLI/status publisher reads it. In-memory "
       "only; the scan's pod reads run before the lock is taken."),
    _r("defrag.moves", 26, "lock", False,
       "SliceMover's move-state counters (planned/active/completed/"
       "last duration). Never held across a journal fsync or the "
       "switch PATCH — the move protocol's I/O runs between, not "
       "under, counter updates."),
    _r("allocator.ledger", 30, "rlock", False,
       "AssumeCache's claim/reservation ledger: one atomic "
       "snapshot-overlay-decide-reserve step. Pure memory; the "
       "lock-wait histogram exists to catch I/O creeping back in."),
    _r("checkpoint.journal", 40, "rlock", True,
       "AllocationCheckpoint's entry/sequence state. In `always` "
       "mode the record append+fsync runs under it by design "
       "(durability before the caller proceeds), so I/O is allowed."),
    _r("informer.cache", 50, "lock", False,
       "PodInformer's cache/tombstone map and index fan-out. Watch "
       "apply, merge, and reads are in-memory; the LIST that feeds "
       "refresh()/relist runs before the lock is taken."),
    _r("cluster.usage", 60, "lock", False,
       "NodeChipUsage per-chip aggregates (maintained under "
       "informer.cache via the index protocol)."),
    _r("cluster.podindex", 61, "lock", False,
       "Bucketed pod-set indexes (pending-by-resource, "
       "labeled-by-value); same nesting as cluster.usage."),
    _r("extender.usageindex", 62, "lock", False,
       "ClusterUsageIndex per-node aggregates + generations; "
       "maintained under informer.cache, read under extender.core."),
    _r("cluster.interference", 63, "lock", False,
       "InterferenceDetector's baseline/report state: per-victim "
       "solo-window step-p99 baselines and the last pass's verdicts. "
       "Inputs (chip residency, step p99s) are gathered BEFORE the "
       "lock is taken; gauges publish after it is dropped."),
    _r("slo.budget", 64, "lock", False,
       "SloBudget's time-bucketed good/bad event counters and "
       "burn-rate state. record() runs at engine retire (no other "
       "lock held); evaluate() snapshots under it and fires the "
       "page hook (flight-recorder dump) outside."),
    _r("decisions.ring", 65, "lock", False,
       "DecisionLog's bounded ring of admission decision records: "
       "verbs append AFTER their locked decision sections (no other "
       "lock held), the /decisions endpoint snapshots under it and "
       "serializes outside. Pure memory — the segment write runs "
       "under decisions.segment, never here."),
    _r("decisions.segment", 66, "lock", True,
       "DecisionLog's on-disk segment appender: one JSON line per "
       "record, flushed to the OS buffer but never fsynced "
       "(provenance is observability, not durability — the WAL owns "
       "that). I/O by definition; taken only after decisions.ring "
       "is released."),
    _r("timeline.ring", 67, "lock", False,
       "ClusterTimeline's time-bucketed sample ring: the sampler "
       "loop writes one bucket per tick, /timeline and the flight "
       "recorder snapshot under it and serialize outside. Pure "
       "memory, fixed-size by construction."),
    _r("wal.batcher", 70, "condition", False,
       "GroupBatcher's queue condition: submit() runs under "
       "checkpoint.journal; the flush itself happens with the "
       "condition released (the worker drains, then writes)."),
    _r("checkpoint.io", 75, "lock", True,
       "The journal's file-handle discipline: open/write/fsync/"
       "rename. Never held while waiting for checkpoint.journal "
       "(that ordering is the point of the two-lock split)."),
    _r("fleet.router", 76, "lock", False,
       "FleetRouter's routing table (rid -> engine assignment, "
       "round-robin cursor, per-path counters). Pure memory: SLO "
       "severity reads (slo.budget, rank 64) and decision-record "
       "emission (decisions.ring, rank 65) both run BEFORE the lock "
       "is taken / after it is dropped — they sit down-rank by "
       "design. Membership snapshots (fleet.membership, rank 77) "
       "nest strictly up-rank."),
    _r("fleet.membership", 77, "lock", False,
       "FleetMembership's replica table (health, consecutive "
       "scrape misses, cordon flags, prefix fingerprints, load "
       "estimates). Held around table flips only — never across a "
       "scrape transport call or its circuit breaker (rank 88); "
       "replica-state gauges publish (metrics.registry, rank 95) "
       "under it, strictly up-rank."),
    _r("fleet.scale", 78, "lock", False,
       "ScaleExecutor's in-flight scale-op state (scale_id -> "
       "phase, migrated-request counters). Counter/state flips "
       "only: the journal write (checkpoint.journal, rank 40) and "
       "the engine drain handshake (serving.drain, rank 89) both "
       "run with this lock released — the protocol's I/O and "
       "engine calls are never under it, mirroring defrag.moves."),
    _r("serving.adapters", 79, "lock", False,
       "AdapterCache's residency table (adapter id -> slab pages, "
       "pin counts, LRU clock, hit/miss/eviction/stall telemetry). "
       "Loads and evictions allocate/release through the page "
       "allocator (serving.pages, rank 87) while held — strictly "
       "up-rank, the serving.handoff precedent. Device slab writes "
       "happen in the engine loop with this lock released."),
    _r("apiserver.coalescer", 80, "lock", False,
       "Lazy construction of the node-PATCH coalescer; the merged "
       "PATCH itself runs outside it."),
    _r("handoff.peer", 81, "lock", False,
       "HandoffPeerClient's transfer counters (calls, retries, "
       "pages/bytes shipped). Never held across a transport call "
       "or the circuit breaker (rank 88) — counter flips only."),
    _r("plugin.stream", 82, "condition", False,
       "TpuSharePlugin's ListAndWatch/drain condition: health map, "
       "version counter, in-flight Allocate count. Allocate "
       "releases it before delegating to the allocator."),
    _r("serving.handoff", 83, "lock", False,
       "HandoffImportLedger's staging table (destination pages "
       "reserved per in-flight KV handoff, received page bytes, "
       "delivered-id dedup window). Staging allocates through the "
       "page allocator (serving.pages, rank 87) while held — "
       "strictly up-rank."),
    _r("manager.health", 84, "lock", False,
       "HealthWatcher's unhealthy-chip set."),
    _r("serving.radix", 85, "lock", False,
       "RadixCache's shared-prefix tree (nodes, LRU clock, hit "
       "telemetry). Page reference updates (serving.pages, rank "
       "87) run after the tree lock is dropped; any unavoidable "
       "nesting goes radix -> pages, strictly up-rank."),
    _r("allocator.local", 86, "lock", False,
       "LocalAllocator's standalone usage table (never nests over "
       "cluster locks; ranked near the leaves)."),
    _r("serving.pages", 87, "lock", False,
       "PageAllocator's free list + refcounts: the serving "
       "engine's host loop and the /metrics scrape thread both "
       "read occupancy. Pure memory, near-leaf; publish() snapshots "
       "under it and writes gauges (metrics.registry, rank 95) "
       "outside."),
    _r("circuit.breaker", 88, "lock", False,
       "CircuitBreaker state counters; the guarded call runs with "
       "the lock released."),
    _r("serving.drain", 89, "lock", False,
       "PagedSlotEngine's drain-handshake state (arm / capture / "
       "consume transitions of the _drain/_drained events and the "
       "captured snapshot). Near-leaf: held around Event/dict "
       "flips a few times per run — never per tick, never over "
       "another lock."),
    _r("faults.registry", 90, "lock", False,
       "Fault-injection rule table; fire() sites run everywhere, "
       "so this must be a near-leaf."),
    _r("serving.profiler", 91, "lock", False,
       "StepProfiler's preallocated per-decode-step ring + "
       "counters: the engine's host loop writes one float per "
       "decode dispatch, the /metrics publisher and the "
       "interference detector read rolling quantiles. Near-leaf "
       "pure memory; flush() snapshots under it and feeds the "
       "metrics registry (rank 95) outside."),
    _r("tracing.admissions", 92, "lock", False,
       "AdmissionTraces' per-pod root-span registry: correlates the "
       "extender's separate webhook verbs into one trace. Ends "
       "spans (which append to tracing.store, rank 93) under it, "
       "so it sits just below the store."),
    _r("tracing.store", 93, "lock", False,
       "TraceStore's finished-span ring: spans end under almost "
       "any other lock (a traced section can close inside a locked "
       "region), so the store is a near-leaf like the metrics "
       "registry. Pure memory — export snapshots, then serializes "
       "outside the lock."),
    _r("flightrec.ring", 94, "lock", False,
       "FlightRecorder's bounded log-record ring: fed from a "
       "logging handler, which can run under any lock that logs. "
       "dump() snapshots under it and writes the file outside."),
    _r("metrics.registry", 95, "lock", False,
       "MetricsRegistry: the innermost leaf — counters and "
       "histograms are recorded under every other lock."),
))


def rank_of(name: str) -> LockRank:
    try:
        return RANKS[name]
    except KeyError:
        raise ValueError(
            f"unknown lock rank {name!r}; declare it in "
            "gpushare_device_plugin_tpu_torch/utils/lockrank.py RANKS"
        ) from None


class LockOrderError(RuntimeError):
    """A thread acquired locks against the declared ranking."""


@dataclasses.dataclass(frozen=True)
class Violation:
    """``acquiring`` was requested while ``holding`` (same or higher rank,
    another lock) was held."""

    thread: str
    acquiring: str
    acquiring_rank: int
    holding: str
    holding_rank: int
    acquire_stack: str
    held_stack: str

    def brief(self) -> str:
        return (f"[{self.thread}] acquiring {self.acquiring!r} (rank "
                f"{self.acquiring_rank}) while holding {self.holding!r} "
                f"(rank {self.holding_rank})")

    def report(self) -> str:
        return (f"{self.brief()}\n--- held lock acquired at ---\n{self.held_stack}"
                f"--- violating acquire at ---\n{self.acquire_stack}")


_state_lock = threading.Lock()  # raw on purpose: the witness never recurses
_violations: list[Violation] = []
_forced: bool | None = None
_acquired: set[str] = set()  # names of witnessed locks taken (set.add is atomic)
_TRUTHY = ("1", "true", "yes", "on")


def witness_enabled() -> bool:
    """Whether locks created now are witnessed."""
    if _forced is not None:
        return _forced
    return any(os.environ.get(var, "").lower() in _TRUTHY
               for var in ("TPUSHARE_LOCK_WITNESS", "TPUSHARE_TEST_CHAOS"))


def set_witness(enabled: bool | None) -> None:
    """Force the witness on or off for locks created from now on (None:
    the environment decides again), and forget the ranks acquired."""
    global _forced
    _forced = enabled
    _acquired.clear()


def acquired_ranks() -> list[str]:
    """The names of the witnessed locks acquired on any thread since the
    last :func:`set_witness`, outermost rank first."""
    return [r.name for r in ordered(list(_acquired.copy()))]


def violations() -> list[Violation]:
    with _state_lock:
        return list(_violations)


def reset_violations() -> None:
    with _state_lock:
        _violations.clear()


def assert_clean(context: str = "") -> None:
    """Raise listing every recorded inversion."""
    found = violations()
    if found:
        where = f" during {context}" if context else ""
        raise LockOrderError(f"{len(found)} lock-order violation(s) observed{where}:\n"
                             + "\n".join(v.report() for v in found))


def _record(violation: Violation) -> None:
    with _state_lock:
        _violations.append(violation)
    if os.environ.get("TPUSHARE_LOCK_WITNESS_RAISE", "").lower() in _TRUTHY:
        raise LockOrderError(violation.report())


class _HeldStack(threading.local):
    def __init__(self) -> None:
        self.entries: list[list[Any]] = []  # [lock id, name, rank, count, stack]


_held = _HeldStack()

# A plain Lock may be released by another thread than its holder. Then the
# holder's entry is found here (id(lock) -> the holder's entries list and
# entry) and removed, so it does not turn into false violations for the
# rest of the holder's life. Guarded by _state_lock; non-reentrant only.
_handoff: dict[int, tuple[list[list[Any]], list[Any]]] = {}


def held_locks() -> list[tuple[str, int]]:
    """(name, count) for every witnessed lock this thread holds."""
    return [(e[1], e[3]) for e in _held.entries]


def _stack() -> str:
    frames = []
    f = sys._getframe(2)
    for _ in range(10):
        if f is None:
            break
        frames.append(f"  {f.f_code.co_filename}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
    return "\n".join(reversed(frames)) + "\n"


class _WitnessedLock:
    """Order-checking wrapper over a threading Lock or RLock, with the
    pieces ``threading.Condition`` probes for, so a Condition over it
    releases and re-acquires through the witness in ``wait()``."""

    __slots__ = ("_name", "_rank", "_inner", "_reentrant")

    def __init__(self, name: str, inner: Any, reentrant: bool) -> None:
        self._name = name
        self._rank = RANKS[name].rank
        self._inner = inner
        self._reentrant = reentrant

    def _entry(self) -> list[Any] | None:
        me = id(self)
        return next((e for e in _held.entries if e[0] == me), None)

    def _violation(self, holding: str, rank: int, held_stack: str) -> Violation:
        v = Violation(threading.current_thread().name, self._name, self._rank, holding,
                      rank, _stack(), held_stack)
        _record(v)
        return v

    def _check_order(self) -> None:
        mine = self._entry()
        if mine is not None:
            if self._reentrant:
                return
            # re-acquiring a held non-reentrant lock deadlocks for sure
            v = self._violation(self._name, self._rank, mine[4])
            raise LockOrderError("self-deadlock: non-reentrant lock re-acquired by its "
                                 "holder\n" + v.report())
        for e in _held.entries:
            if e[2] >= self._rank:
                self._violation(e[1], e[2], e[4])

    def _push(self, n: int = 1) -> None:
        mine = self._entry()
        if mine is not None and self._reentrant:
            mine[3] += n
            return
        entry = [id(self), self._name, self._rank, n, _stack()]
        _held.entries.append(entry)
        _acquired.add(self._name)
        if not self._reentrant:
            with _state_lock:
                _handoff[id(self)] = (_held.entries, entry)

    def _pop(self, n: int = 1) -> None:
        mine = self._entry()
        if mine is None:
            # released by a thread that never acquired it: drop the holder's entry
            with _state_lock:
                owner = _handoff.pop(id(self), None)
            if owner is not None and owner[1] in owner[0]:
                owner[0].remove(owner[1])
            return
        mine[3] -= n
        if mine[3] <= 0:
            _held.entries.remove(mine)
            if not self._reentrant:
                with _state_lock:
                    _handoff.pop(id(self), None)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._push()
        return got

    def release(self) -> None:
        self._inner.release()
        self._pop()

    def __enter__(self) -> "_WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __getattr__(self, name: str) -> Any:
        # the rest of the inner primitive's surface (Lock.locked, ...)
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self) -> Any:
        state = self._inner._release_save()
        mine = self._entry()
        depth = mine[3] if mine is not None else 1
        self._pop(depth)
        return (state, depth)

    def _acquire_restore(self, saved: Any) -> None:
        state, depth = saved
        self._inner._acquire_restore(state)
        self._push(depth)


# The model checker's factory: while set, the make_* functions below hand
# out its primitives after the rank check. None in production: one global
# read when a primitive is made, nothing on the acquire path.
_mc_factory: Any | None = None


def set_mc_factory(factory: Any | None) -> None:
    """Install (or clear, with None) the model checker's primitive factory:
    an object with ``lock(name)``, ``rlock(name)``, ``condition(name)`` and
    ``event(name)``. Affects primitives made from now on, so a checker
    installs it before it builds a model's objects; module-level singletons
    made at import (the metrics registry, the fault table, the trace store)
    stay plain, and so atomic to the checker."""
    global _mc_factory
    _mc_factory = factory


def mc_active() -> bool:
    """Whether primitives made now are the model checker's."""
    return _mc_factory is not None


def _check_kind(name: str, kind: str) -> None:
    rank = rank_of(name)
    if rank.kind != kind:
        raise ValueError(f"{name} is declared {rank.kind}; use make_{rank.kind}")


def make_lock(name: str) -> Any:
    """A non-reentrant mutex at the declared rank ``name``."""
    _check_kind(name, "lock")
    if _mc_factory is not None:
        return _mc_factory.lock(name)
    if witness_enabled():
        return _WitnessedLock(name, threading.Lock(), reentrant=False)
    return threading.Lock()


def make_rlock(name: str) -> Any:
    """A reentrant mutex at the declared rank ``name``."""
    _check_kind(name, "rlock")
    if _mc_factory is not None:
        return _mc_factory.rlock(name)
    if witness_enabled():
        return _WitnessedLock(name, threading.RLock(), reentrant=True)
    return threading.RLock()


def make_condition(name: str) -> threading.Condition:
    """A condition variable whose mutex carries rank ``name``."""
    _check_kind(name, "condition")
    if _mc_factory is not None:
        return _mc_factory.condition(name)
    if witness_enabled():
        return threading.Condition(_WitnessedLock(name, threading.RLock(), reentrant=True))
    return threading.Condition()


def make_event(name: str) -> Any:
    """An event flag named for diagnostics. Events carry no rank (they are
    not mutual exclusion), but a wait parks a thread and a set releases it,
    so a protocol's events are made here too and the model checker
    schedules them."""
    if _mc_factory is not None:
        return _mc_factory.event(name)
    return threading.Event()


def ordered(names: list[str]) -> Iterator[LockRank]:
    """The declared ranks of ``names``, outermost first."""
    return iter(sorted((rank_of(n) for n in names), key=lambda r: r.rank))
