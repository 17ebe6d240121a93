"""In-flight reservation ledger for the node's allocators (the assume-cache).

Counterpart of ``gpushare_device_plugin_tpu/allocator/assume.py``,
copied whole: one ledger shared by the mem and core allocators, the KV
handoff's mover and the fleet's scale executor.

The reference serializes the *entire* Allocate flow — match, placement,
and the apiserver PATCH — behind one mutex (``allocate.go:42-43``), so N
concurrent kubelet admission workers pay N sequential apiserver
round-trips. This ledger is what lets the lock be sharded away: the only
state that truly needs cross-worker atomicity is "which pods are mid-
admission and what did we promise them", and that is pure memory.

Design (mirrors the scheduler extender's bind reservation, which solved
the same problem one layer up):

- **claim**: a pod matched by one worker is claimed by key, so a
  concurrent same-size Allocate matches the *next* oldest candidate
  instead of racing for the same pod. Claims are what keep the documented
  oldest-first same-size match semantics intact under concurrency.
- **reserve**: the chip decision is recorded (mem units on a chip index /
  exclusively-held chip set) *before* the PATCH goes out. Every other
  worker's placement overlays these reservations on top of the pod
  source's usage snapshot, so two in-flight placements cannot double-book
  a chip even though neither is visible in the apiserver yet.
- **transaction**: snapshot-overlay-decide-reserve must be one atomic
  step against other reservations; ``transaction()`` scopes it. The lock
  is an RLock held only for in-memory work — network I/O (PATCH, LIST)
  never runs under it on the warm informer path (the one cold exception:
  a never-synced cache refreshes inside ``chip_state()``) — and the wait
  for it is exported as a histogram so contention regressions are
  observable.
- **release**: after the PATCH persists (and ``note_pod_update`` has fed
  the result back into the pod source), the reservation is redundant —
  the source itself now counts the pod — and is dropped. The overlay
  skips reservations the source already counts (``visible_fn``), so the
  persist→release window cannot double-count either.

Failure semantics: any error path releases the claim and reservations, so
a failed admission never leaks phantom usage.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Sequence

from ..utils.metrics import REGISTRY, timed_acquire
from ..utils.lockrank import make_rlock
from ..utils.metric_catalog import (
    ALLOCATOR_LOCK_WAIT_SECONDS as LOCK_WAIT_METRIC,
    ASSUME_EXPIRED_TOTAL as EXPIRED_METRIC,
)

PodKey = tuple[str, str]  # (namespace, name)

LOCK_WAIT_HELP = (
    "Time Allocate workers spend waiting for allocator locks "
    "(match stripes and the reservation ledger); mass above ~1ms means "
    "I/O crept back under a lock"
)

EXPIRED_HELP = (
    "Claims/reservations released by TTL expiry — an owner (a hung PATCH, "
    "a crashed worker) held them past the deadline; capacity was unstranded"
)

# An admission that has not finished inside this window is dead or wedged
# far beyond every retry deadline on the persist path (PATCH retries top
# out in single-digit seconds); releasing then can free capacity the owner
# still thinks it holds only if that owner later persists *without*
# re-checking — and both allocators re-place from a fresh transaction on
# every attempt, so expiry is safe and strictly better than stranding.
DEFAULT_TTL_S = 300.0


class AssumeCache:
    """Shared between the node's mem and core allocators: the two
    resources share one physical-chip ledger, and reservations from one
    must exclude chips from the other (the same reason they used to share
    one mutex).

    Every claim/reservation carries a monotonic stamp and a TTL
    (``ttl_s``): an entry whose owner died mid-admission — crashed worker
    thread, PATCH hung past all deadlines — is released by
    ``expire_stale`` (run lazily on every overlay read and by the drift
    reconciler) instead of stranding capacity forever. Entries are
    re-stamped on re-reservation, so a live retry loop never expires.
    """

    def __init__(
        self,
        ttl_s: float = DEFAULT_TTL_S,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = make_rlock("allocator.ledger")
        self._ttl = ttl_s
        self._clock = clock
        self._claimed: dict[PodKey, float] = {}  # key -> stamp
        self._mem: dict[PodKey, tuple[int, int]] = {}  # key -> (chip, units)
        self._core: dict[PodKey, tuple[int, ...]] = {}  # key -> chip indices
        # key -> ((chip, units), ...): one multi-chip gang reservation.
        # A gang is ONE ledger entry by construction — reserve, release,
        # and TTL expiry are atomic over every member chip, so no code
        # path can ever observe (or leave behind) a partial gang.
        self._gang: dict[PodKey, tuple[tuple[int, int], ...]] = {}
        self._stamps: dict[PodKey, float] = {}  # reservation stamps
        # Legacy full-serialization lock for list-backed pod sources: they
        # expose no get_pod, so a worker cannot re-verify a candidate
        # against live state at claim time — without that check the
        # sharded flow could re-match a pod whose PATCH landed after the
        # matcher's LIST snapshot. Those sources keep the reference's
        # one-admission-at-a-time semantics; the informer (the default)
        # takes the sharded path. Shared mem/core like everything here.
        self.serial_lock = make_rlock("allocator.serial")

    # --- claims -----------------------------------------------------------

    def claim(self, key: PodKey) -> bool:
        """Mark ``key`` as mid-admission; False if already claimed (by a
        live owner — an expired claim is reaped and re-claimable)."""
        with self._lock:
            now = self._clock()
            stamp = self._claimed.get(key)
            if stamp is not None:
                if now - stamp <= self._ttl:
                    return False
                self._release_expired(key, "claim")
            self._claimed[key] = now
            return True

    def renew(self, key: PodKey) -> bool:
        """Re-stamp a held claim's TTL clock; False when the claim is
        gone (expired and reaped, or never taken). A long-running
        protocol (a defrag move whose drain outlasts the TTL) renews
        before its commit point — an expired claim reaps the key's
        reservations with it, dropping the protocol's capacity
        protection mid-flight."""
        with self._lock:
            if key in self._claimed:
                self._claimed[key] = self._clock()
                return True
            return False

    def is_claimed(self, key: PodKey) -> bool:
        with self._lock:
            stamp = self._claimed.get(key)
            return stamp is not None and self._clock() - stamp <= self._ttl

    def release(self, key: PodKey) -> None:
        """Drop the claim and any reservations for ``key`` (success — the
        pod source counts the pod now — or failure — nothing was placed)."""
        with self._lock:
            self._claimed.pop(key, None)
            self._mem.pop(key, None)
            self._core.pop(key, None)
            self._gang.pop(key, None)
            self._stamps.pop(key, None)

    def release_if_unclaimed(self, key: PodKey) -> bool:
        """Atomic check-and-release for the reconciler: a claimed key is a
        live admission mid-flow and must keep its reservation — releasing
        on a stale pre-network-round-trip claim check would strip a live
        worker's protection. True when released."""
        with self._lock:
            if self.is_claimed(key):
                return False
            self.release(key)
            return True

    def _release_expired(self, key: PodKey, kind: str) -> None:
        """Caller must hold self._lock. A gang entry drops ALL member
        chips here in one pass — expiry can never strand a single-chip
        sliver of a partially-admitted gang."""
        self._claimed.pop(key, None)
        self._mem.pop(key, None)
        self._core.pop(key, None)
        self._gang.pop(key, None)
        self._stamps.pop(key, None)
        REGISTRY.counter_inc(EXPIRED_METRIC, EXPIRED_HELP, kind=kind)

    def expire_stale(self, now: float | None = None) -> list[PodKey]:
        """Release every claim/reservation older than the TTL; -> released
        keys. O(in-flight entries) — a handful at worst."""
        released: list[PodKey] = []
        with self._lock:
            if now is None:
                now = self._clock()
            for key, stamp in list(self._claimed.items()):
                if now - stamp > self._ttl:
                    self._release_expired(key, "claim")
                    released.append(key)
            for key, stamp in list(self._stamps.items()):
                if now - stamp > self._ttl:
                    if key in self._mem:
                        kind = "mem"
                    elif key in self._gang:
                        kind = "gang"
                    else:
                        kind = "core"
                    self._release_expired(key, kind)
                    released.append(key)
        return released

    def snapshot(self) -> tuple[dict[PodKey, float], dict, dict]:
        """Introspection for the drift reconciler: (claims with stamps,
        mem reservations, core reservations) — copies. Gang reservations
        are a separate family; see :meth:`gang_snapshot`."""
        with self._lock:
            return dict(self._claimed), dict(self._mem), dict(self._core)

    def gang_snapshot(self) -> dict[PodKey, tuple[tuple[int, int], ...]]:
        """Copies of the in-flight gang reservations
        (key -> ((chip, units), ...)) for the reconciler/CLI."""
        with self._lock:
            return dict(self._gang)

    # --- reservations (call within transaction()) -------------------------

    @contextlib.contextmanager
    def transaction(self) -> Iterator["AssumeCache"]:
        """Scope one atomic snapshot-overlay-decide-reserve step. In-memory
        work only; the wait is recorded in the lock-wait histogram."""
        with timed_acquire(
            self._lock, LOCK_WAIT_METRIC, LOCK_WAIT_HELP, lock="ledger"
        ):
            yield self

    def reserve_mem(self, key: PodKey, chip_idx: int, units: int) -> None:
        with self._lock:
            self._mem[key] = (chip_idx, units)
            self._stamps[key] = self._clock()

    def reserve_core(self, key: PodKey, chip_indices: list[int]) -> None:
        with self._lock:
            self._core[key] = tuple(chip_indices)
            self._stamps[key] = self._clock()

    def reserve_gang(
        self, key: PodKey, members: Sequence[tuple[int, int]]
    ) -> None:
        """Reserve ``members`` ((chip, units) per gang member) as ONE
        atomic entry: a concurrent placement overlaying the ledger sees
        either every member chip claimed or none — the all-or-nothing
        half of the gang protocol that the PATCH (one write of all member
        annotations) completes on the persist side."""
        if not members:
            raise ValueError("gang reservation needs at least one member")
        with self._lock:
            self._gang[key] = tuple((int(c), int(u)) for c, u in members)
            self._stamps[key] = self._clock()

    def overlaid_state(
        self,
        state_fn: Callable[[], tuple[dict[int, int], set[int]]],
        visible_fn: Callable[[PodKey], bool] | None = None,
    ) -> tuple[dict[int, int], set[int]]:
        """One usage snapshot with in-flight reservations folded in:
        ``state_fn() -> (mem_used, core_held)`` caller-owned copies.

        ``visible_fn(key) -> bool`` reports whether the pod source already
        counts the pod (its PATCHed copy landed in the cache) — those
        reservations are skipped to avoid double-counting in the window
        between ``note_pod_update`` and ``release``. Ordering is the
        correctness core: visibility is decided BEFORE ``state_fn`` reads
        the snapshot. Visibility only ever flips invisible -> visible (a
        deleted pod stops being visible, but then holds nothing), so a
        reservation judged visible is provably in any snapshot read
        afterwards — every in-flight pod is counted at least once, never
        zero times. The reverse order would let a pod land in the cache
        between an older snapshot and the visibility check and be counted
        nowhere. Without ``visible_fn`` every reservation counts, which is
        conservative (can only over-count, never double-book).
        """
        with self._lock:
            self.expire_stale()  # lazy TTL reaping on every overlay read
            mem = list(self._mem.items())
            core = list(self._core.items())
            gang = list(self._gang.items())
        if visible_fn is not None:
            mem = [(k, v) for k, v in mem if not visible_fn(k)]
            core = [(k, v) for k, v in core if not visible_fn(k)]
            gang = [(k, v) for k, v in gang if not visible_fn(k)]
        mem_used, core_held = state_fn()
        for _key, (idx, units) in mem:
            mem_used[idx] = mem_used.get(idx, 0) + units
        for _key, members in gang:
            for idx, units in members:
                mem_used[idx] = mem_used.get(idx, 0) + units
        for _key, indices in core:
            core_held.update(indices)
        return mem_used, core_held
