"""Declared lock ranking, the ranked-lock factory and the runtime
lock-order witness.

Counterpart of ``gpushare_device_plugin_tpu/utils/lockrank.py``, cut to
the locks the port's protocol modules take (the WAL, its group-commit
writer, the assume cache, the SLO budget, the decision log, the fleet's
router, membership and scale executor, the KV handoff's ledger and peer
client, the circuit breaker, the fault table, the page allocator, the
device plugin's stream condition, health watcher and standalone allocator,
and the node agent's timeline ring and flight recorder).
Each entry is the reference's: same name, rank, kind, I/O rule and reason.

- :data:`RANKS`: a total order. A thread may only acquire a lock whose
  rank is strictly greater than every lock it already holds (re-entering
  the same RLock is fine), so two code paths that respect it can never
  deadlock.
- :func:`make_lock` / :func:`make_rlock` / :func:`make_condition`: every
  ranked lock is created here, naming its rank. By default they return
  plain ``threading`` primitives.
- The witness: with ``TPUSHARE_LOCK_WITNESS=1`` in the environment, or
  after :func:`set_witness` ``(True)``, locks created from then on check
  each acquire against the ranking on their thread and record a
  :class:`Violation` (with both acquisition stacks) for any down-rank
  acquire; :func:`assert_clean` raises on any recorded one.

The reference's model-checker seam (``set_mc_factory``, ``make_event``)
is not carried: its checker is not part of the port.

Stdlib only: every other module imports this one to create its locks.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Any


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
    _r("allocator.ledger", 30, "rlock", False,
       "AssumeCache's claim/reservation ledger: one atomic "
       "snapshot-overlay-decide-reserve step. Pure memory; the "
       "lock-wait histogram exists to catch I/O creeping back in."),
    _r("checkpoint.journal", 40, "rlock", True,
       "AllocationCheckpoint's entry/sequence state. In `always` "
       "mode the record append+fsync runs under it by design "
       "(durability before the caller proceeds), so I/O is allowed."),
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
    _r("faults.registry", 90, "lock", False,
       "Fault-injection rule table; fire() sites run everywhere, "
       "so this must be a near-leaf."),
    _r("flightrec.ring", 94, "lock", False,
       "FlightRecorder's bounded log-record ring: fed from a "
       "logging handler, which can run under any lock that logs. "
       "dump() snapshots under it and writes the file outside."),
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
_TRUTHY = ("1", "true", "yes", "on")


def witness_enabled() -> bool:
    """Whether locks created now are witnessed."""
    if _forced is not None:
        return _forced
    return os.environ.get("TPUSHARE_LOCK_WITNESS", "").lower() in _TRUTHY


def set_witness(enabled: bool | None) -> None:
    """Force the witness on or off for locks created from now on (None:
    the environment decides again)."""
    global _forced
    _forced = enabled


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


class _HeldStack(threading.local):
    def __init__(self) -> None:
        self.entries: list[list[Any]] = []  # [lock id, name, rank, count, stack]


_held = _HeldStack()


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
        with _state_lock:
            _violations.append(v)
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
        _held.entries.append([id(self), self._name, self._rank, n, _stack()])

    def _pop(self, n: int = 1) -> None:
        mine = self._entry()
        if mine is None:
            return
        mine[3] -= n
        if mine[3] <= 0:
            _held.entries.remove(mine)

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


def _check_kind(name: str, kind: str) -> None:
    rank = rank_of(name)
    if rank.kind != kind:
        raise ValueError(f"{name} is declared {rank.kind}; use make_{rank.kind}")


def make_lock(name: str) -> Any:
    """A non-reentrant mutex at the declared rank ``name``."""
    _check_kind(name, "lock")
    if witness_enabled():
        return _WitnessedLock(name, threading.Lock(), reentrant=False)
    return threading.Lock()


def make_rlock(name: str) -> Any:
    """A reentrant mutex at the declared rank ``name``."""
    _check_kind(name, "rlock")
    if witness_enabled():
        return _WitnessedLock(name, threading.RLock(), reentrant=True)
    return threading.RLock()


def make_condition(name: str) -> threading.Condition:
    """A condition variable whose mutex carries rank ``name``."""
    _check_kind(name, "condition")
    if witness_enabled():
        return threading.Condition(_WitnessedLock(name, threading.RLock(), reentrant=True))
    return threading.Condition()
