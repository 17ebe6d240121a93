"""Write-ahead journal: the crash-safe record of in-flight protocol steps.

Counterpart of ``gpushare_device_plugin_tpu/allocator/checkpoint.py``, the
same file format and semantics, so a journal written by either package
loads in the other. In the port its user is the KV handoff
(``serving/handoffproto.py``), which journals each phase of a handoff as
a fresh ``begin`` under the handoff's key and resolves it with ``commit``
(delivered) or ``abort`` (rolled back to re-prefill).

1. **begin** — appended and fsync'd *before* the side effect it guards.
2. **commit** — appended once the side effect took hold.
3. **abort** — appended when the step was abandoned before it took hold.

File format: JSON lines (``{"op": "header"|"begin"|"commit"|"abort", ...}``),
append-only between compactions. A torn final line (crash mid-append) is
detected and ignored on load. Compaction rewrites the file to a header
plus the live ``begin`` records via atomic rename.

Fencing: the header carries a **generation**, bumped on every open. A
daemon stamps its generation into a node annotation (``acquire_fence``);
a stale duplicate observes a higher generation on the node
(``verify_fence``) and refuses further begins with
:class:`StaleDaemonError`. The newest instance always wins.

Durability modes (``fsync=``):

- ``always`` — every record is appended and fsync'd synchronously under
  the journal lock before the call returns.
- ``batch`` (default) — **group commit** (``utils/batch.py``): records go
  to a writer thread; one ``flush+fsync`` covers everything queued since
  the last sync, and each caller blocks until *its* bytes are durable.

Fault points ``checkpoint.begin|commit|abort`` fire immediately *after*
each record is durable; ``checkpoint.wal_queue`` after a record is queued
but *before* its durability wait, and ``checkpoint.batch_fsync`` in the
writer right after a batch became durable (see ``utils/faults.py``).

The reference's ``replay_checkpoint`` (re-installing chip reservations)
is not carried: a handoff entry reserves nothing in a chip ledger, and
its resolver reads :meth:`AllocationCheckpoint.pending` directly.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from .. import const
from ..utils.batch import GroupBatcher
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock, make_rlock
from ..utils.log import get_logger
from ..utils.metric_catalog import (
    CHECKPOINT_APPENDS_TOTAL as JOURNAL_APPENDS,
    CHECKPOINT_ERRORS_TOTAL as JOURNAL_ERRORS,
    CHECKPOINT_FENCED as FENCE_GAUGE,
    CHECKPOINT_FSYNC_SECONDS as FSYNC_SECONDS,
    CHECKPOINT_WAL_BATCH_RECORDS as BATCH_RECORDS,
)
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER
from .assume import PodKey

log = get_logger("allocator.checkpoint")

JOURNAL_APPENDS_HELP = "Checkpoint journal records appended, by op"
JOURNAL_ERRORS_HELP = (
    "Checkpoint journal I/O failures (the daemon degrades to unjournaled "
    "operation rather than refusing admissions on a sick disk)"
)
FENCE_GAUGE_HELP = (
    "1 when this daemon observed a newer generation on the node and "
    "refuses journal writes (a stale duplicate instance)"
)
FSYNC_SECONDS_HELP = (
    "WAL flush+fsync latency; the count is the fsync count — divide by "
    "admissions for fsyncs-per-admission (group commit drives it below 1)"
)
BATCH_RECORDS_HELP = (
    "Journal records made durable per fsync (group-commit batch-size "
    "distribution; always-mode fsyncs observe 1)"
)
# Batch-size buckets (records per fsync), not latencies.
BATCH_RECORDS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# Default group-commit gather window. Callers see at most this much added
# latency per record (typically window/4 — the writer drains early once
# arrivals go quiet); a 16-way admission storm fills it and amortizes one
# fsync across the whole batch.
DEFAULT_BATCH_WINDOW_S = 0.002
WAL_FSYNC_MODES = ("always", "batch")

# Resolved (committed/aborted) records tolerated in the file before the
# journal is rewritten down to header + live begins.
COMPACT_EVERY = 512


class StaleDaemonError(RuntimeError):
    """This daemon's fencing generation was superseded on the node: a newer
    instance owns allocation now. Writes must be refused — two writers
    journaling against one node double-book chips."""


class AllocationCheckpoint:
    def __init__(
        self,
        path: str,
        fsync: str = "batch",
        batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
    ) -> None:
        if fsync not in WAL_FSYNC_MODES:
            raise ValueError(f"unknown wal fsync mode: {fsync!r}")
        self._path = path
        self._fsync_mode = fsync
        self._lock = make_rlock("checkpoint.journal")
        # File-handle discipline: the group-commit writer thread appends
        # while callers mutate in-memory state under self._lock, and
        # compaction swaps the file out from under both — every open/
        # write/fsync/swap happens under this dedicated I/O lock (never
        # held while waiting for self._lock, so no ordering cycle).
        self._io_lock = make_lock("checkpoint.io")
        self._writer: GroupBatcher | None = None
        if fsync == "batch":
            self._writer = GroupBatcher(
                self._write_batch,
                window_s=batch_window_s,
                name="wal-writer",
                on_batch=self._note_batch,
            )
        self._entries: dict[PodKey, dict] = {}  # begun, unresolved
        self._generation = 0
        # Incarnation token: the fencing tie-breaker. Two daemons racing a
        # rollout can GET-then-PATCH the same generation onto the node
        # (the PATCH carries no resourceVersion precondition); with equal
        # generations neither would fence on the number alone. The token
        # makes the node annotation name one exact incarnation — last
        # writer wins, the other observes a foreign token and fences.
        self._token = os.urandom(6).hex()
        self._fenced = False
        self._resolved_since_compact = 0
        self._compactions = 0  # guards resolve-record-vs-compaction races
        self._seq = 0  # monotonically stamps each begin (see begin())
        self._f = None
        self._lockf = None
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._acquire_file_lock()
        self._load()
        # every open is a new incarnation: bump the generation and compact
        # so the header on disk names it before any new begin rides on it
        self._generation += 1
        self._compact()
        REGISTRY.gauge_set(FENCE_GAUGE, 0.0, FENCE_GAUGE_HELP)

    def _acquire_file_lock(self) -> None:
        """Best-effort flock on a sidecar: two live processes appending and
        compacting one WAL would corrupt it. Advisory only — the fencing
        token is the correctness mechanism for allocation writes; this
        just makes the shared-file mistake loud instead of silent."""
        try:
            import fcntl

            self._lockf = open(self._path + ".lock", "wb")
            fcntl.flock(self._lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            log.error(
                "checkpoint %s is locked by another live process — two "
                "daemon instances sharing one WAL file will corrupt it; "
                "continuing, relying on the fencing token", self._path,
            )
            if self._lockf is not None:
                try:
                    self._lockf.close()
                except OSError:
                    pass
                self._lockf = None
        except ImportError:
            self._lockf = None

    # --- introspection ----------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def fenced(self) -> bool:
        with self._lock:
            return self._fenced

    def pending(self) -> dict[PodKey, dict]:
        """Begun-but-unresolved entries (the replay set)."""
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    # --- load / persist ---------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self._path):
            return
        try:
            with open(self._path, "rb") as f:
                raw = f.read()
        except OSError as e:
            log.warning("checkpoint read failed (%s); starting empty", e)
            return
        lines = raw.split(b"\n")
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a torn final line is the expected crash artifact; a torn
                # middle line means external corruption — skip either way,
                # the WAL invariant (begin precedes PATCH) still holds for
                # every record that did land intact
                log.warning(
                    "checkpoint: dropping unparseable line %d%s",
                    i + 1,
                    " (torn tail)" if i == len(lines) - 1 else "",
                )
                continue
            op = rec.get("op")
            if op == "header":
                try:
                    self._generation = max(
                        self._generation, int(rec.get("generation", 0))
                    )
                except (TypeError, ValueError):
                    pass
            elif op == "begin":
                key = rec.get("key") or []
                if len(key) == 2:
                    data = dict(rec.get("data") or {})
                    try:
                        self._seq = max(self._seq, int(data.get("_seq", 0)))
                    except (TypeError, ValueError):
                        data.pop("_seq", None)
                    self._entries[(str(key[0]), str(key[1]))] = data
            elif op in ("commit", "abort"):
                key = rec.get("key") or []
                if len(key) == 2:
                    self._entries.pop((str(key[0]), str(key[1])), None)

    def _open_append(self):
        """Caller must hold self._io_lock."""
        if self._f is None:
            self._f = open(self._path, "ab")
        return self._f

    @staticmethod
    def _encode(rec: dict) -> bytes:
        return json.dumps(rec, separators=(",", ":")).encode() + b"\n"

    def _fsync_observe(self, seconds: float) -> None:
        REGISTRY.observe(
            FSYNC_SECONDS, seconds, FSYNC_SECONDS_HELP, mode=self._fsync_mode
        )

    def _note_batch(self, n: int) -> None:
        REGISTRY.observe(
            BATCH_RECORDS, float(n), BATCH_RECORDS_HELP,
            buckets=BATCH_RECORDS_BUCKETS, mode=self._fsync_mode,
        )

    def _write_batch(self, payloads: list[bytes]) -> None:
        """Group-commit flush (writer thread): one write + one fsync for
        every record queued since the last sync. Compaction may have
        swapped the file meanwhile — the append handle is (re)opened under
        the I/O lock, so the batch always lands in the live journal,
        *after* the compacted snapshot (a duplicate begin or an
        already-resolved commit replays as a no-op)."""
        with self._io_lock:
            f = self._open_append()
            t0 = time.perf_counter()
            f.write(b"".join(payloads))
            f.flush()
            os.fsync(f.fileno())
        self._fsync_observe(time.perf_counter() - t0)
        FAULTS.fire("checkpoint.batch_fsync")

    def _append_always(self, payload: bytes) -> None:
        """Synchronous per-record append (``always`` mode). Caller must
        hold self._lock; durable before return."""
        with self._io_lock:
            f = self._open_append()
            t0 = time.perf_counter()
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        self._fsync_observe(time.perf_counter() - t0)
        self._note_batch(1)

    def _compact(self) -> None:
        """Caller must hold self._lock (or be the constructor). Rewrite the
        journal to header + live begins via atomic rename, so a crash
        mid-compaction leaves the old file intact. Safe to run while the
        group-commit writer has a batch queued: the snapshot covers every
        entry the queued records would establish, and the writer appends
        them after the swap — harmless duplicates on replay."""
        tmp = self._path + ".tmp"
        with self._io_lock:
            with open(tmp, "wb") as f:
                f.write(
                    self._encode(
                        {"op": "header", "generation": self._generation}
                    )
                )
                for key, data in self._entries.items():
                    f.write(
                        self._encode(
                            {"op": "begin", "key": list(key), "data": data}
                        )
                    )
                f.flush()
                os.fsync(f.fileno())
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            os.replace(tmp, self._path)
        parent = os.path.dirname(self._path) or "."
        try:
            dirfd = os.open(parent, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass  # platform without dir fsync — rename is still atomic
        self._resolved_since_compact = 0
        self._compactions += 1

    def compact(self) -> None:
        """Rewrite the journal down to header + live begins now."""
        with self._lock:
            self._compact()

    # --- journal ops ------------------------------------------------------

    def begin(self, key: PodKey, data: dict) -> int | None:
        """Journal an in-flight decision; MUST precede the PATCH. Raises
        ``StaleDaemonError`` when fenced; I/O failures degrade to
        unjournaled operation (logged + counted, ``None`` returned) — a
        full disk must not take pod admission down with it.

        Each begin gets a monotonic ``_seq`` stamp (persisted with the
        record, returned to the caller): ``commit``/``abort`` with
        ``seq`` only resolve the exact incarnation of the entry the
        caller saw, so a resolver racing a fresh same-key begin — the
        reconciler, or the extender's deferred expired-overlay aborts —
        cannot pop the new entry."""
        ticket = None
        with self._lock:
            if self._fenced:
                raise StaleDaemonError(
                    f"generation {self._generation} superseded on the node"
                )
            self._seq += 1
            seq = self._seq
            data = dict(data)
            data["_seq"] = seq
            payload = self._encode({"op": "begin", "key": list(key), "data": data})
            if self._writer is None:
                try:
                    self._append_always(payload)
                except OSError as e:
                    log.warning("checkpoint begin append failed: %s", e)
                    REGISTRY.counter_inc(
                        JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op="begin"
                    )
                    return None
                self._entries[key] = data
            else:
                try:
                    ticket = self._writer.submit(payload)
                except RuntimeError as e:  # writer stopped (shutdown race)
                    log.warning("checkpoint begin submit failed: %s", e)
                    REGISTRY.counter_inc(
                        JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op="begin"
                    )
                    return None
                self._entries[key] = data
        if ticket is not None:
            # crash site: the record is queued but NOT yet durable — a
            # death here must replay as if begin never happened
            FAULTS.fire("checkpoint.wal_queue")
            try:
                # The group-commit gather window as a child span of the
                # admission's wal.begin: a trace shows exactly how much
                # of an admission's latency was spent waiting for its
                # batch's fsync (no-op outside a sampled trace).
                with TRACER.span("wal.batch_wait", child_only=True):
                    ticket.wait()
            except (OSError, RuntimeError) as e:
                # the batch fsync failed (sick disk): degrade to
                # unjournaled operation like the always path does
                log.warning("checkpoint begin group-commit failed: %s", e)
                REGISTRY.counter_inc(
                    JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op="begin"
                )
                with self._lock:
                    if self._entries.get(key) is data:
                        self._entries.pop(key, None)
                return None
        REGISTRY.counter_inc(JOURNAL_APPENDS, JOURNAL_APPENDS_HELP, op="begin")
        FAULTS.fire("checkpoint.begin")
        return seq

    def commit(self, key: PodKey, seq: int | None = None) -> bool:
        resolved = self._resolve("commit", key, seq)
        FAULTS.fire("checkpoint.commit")
        return resolved

    def abort(self, key: PodKey, seq: int | None = None) -> bool:
        resolved = self._resolve("abort", key, seq)
        FAULTS.fire("checkpoint.abort")
        return resolved

    def _resolve(self, op: str, key: PodKey, seq: int | None = None) -> bool:
        """The entry leaves ``pending()`` only once its resolve record is
        durable — exactly the ``always``-mode ordering — so a reader that
        observes the entry gone can rely on the record surviving a crash."""
        ticket = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False  # unjournaled admission (degraded mode)
            if seq is not None and entry.get("_seq") != seq:
                return False  # a newer begin owns this key now
            payload = self._encode({"op": op, "key": list(key)})
            if self._writer is None:
                try:
                    self._append_always(payload)
                except OSError as e:
                    log.warning("checkpoint %s append failed: %s", op, e)
                    REGISTRY.counter_inc(JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op=op)
                    return False
                self._entries.pop(key, None)
                self._resolved_since_compact += 1
                if self._resolved_since_compact >= COMPACT_EVERY:
                    try:
                        self._compact()
                    except OSError as e:
                        log.warning("checkpoint compaction failed: %s", e)
            else:
                try:
                    ticket = self._writer.submit(payload)
                except RuntimeError as e:
                    log.warning("checkpoint %s submit failed: %s", op, e)
                    REGISTRY.counter_inc(JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op=op)
                    return False
                compactions_at_submit = self._compactions
        if ticket is not None:
            while True:
                try:
                    with TRACER.span("wal.batch_wait", child_only=True):
                        ticket.wait()
                except (OSError, RuntimeError) as e:
                    # The resolve record may never hit disk: the entry
                    # stays pending, replays as unresolved at restart, and
                    # the reconciler re-resolves it — conservative, never
                    # lossy.
                    log.warning("checkpoint %s group-commit failed: %s", op, e)
                    REGISTRY.counter_inc(JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op=op)
                    return False
                with self._lock:
                    if self._entries.get(key) is entry:
                        self._entries.pop(key, None)
                    if self._compactions == compactions_at_submit:
                        self._resolved_since_compact += 1
                        compact_due = (
                            self._resolved_since_compact >= COMPACT_EVERY
                        )
                        break
                    # A compaction ran while our durable resolve record was
                    # in flight: its snapshot still carried the entry (the
                    # pop above is what excludes it from future snapshots)
                    # and os.replace dropped the record with the old file.
                    # Re-append it after the compacted snapshot so "gone
                    # from pending()" keeps implying "resolve survives a
                    # crash". The entry is popped now, so one more pass
                    # converges.
                    compactions_at_submit = self._compactions
                    try:
                        ticket = self._writer.submit(payload)
                    except RuntimeError as e:
                        log.warning(
                            "checkpoint %s re-append failed: %s", op, e
                        )
                        REGISTRY.counter_inc(
                            JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op=op
                        )
                        return False
            if compact_due:
                try:
                    self.compact()
                except OSError as e:
                    log.warning("checkpoint compaction failed: %s", e)
        REGISTRY.counter_inc(JOURNAL_APPENDS, JOURNAL_APPENDS_HELP, op=op)
        return True

    def flush(self, timeout_s: float | None = 5.0) -> bool:
        """Durability barrier: every record handed to the journal so far is
        on disk when this returns True. One path for both modes —
        ``always`` already fsyncs per record (nothing to do), ``batch``
        drains the group-commit writer. This is the writer's own flush;
        there is no side-channel file flush for callers to bypass its
        locking with. False (logged + counted) when the writer could not
        drain within ``timeout_s`` — a wedged disk at shutdown must not
        masquerade as a clean flush."""
        if self._writer is None:
            return True
        drained = self._writer.flush(timeout=timeout_s)
        if not drained:
            log.error(
                "checkpoint flush did not drain within %.1fs — queued "
                "records may not be durable", timeout_s or 0.0,
            )
            REGISTRY.counter_inc(
                JOURNAL_ERRORS, JOURNAL_ERRORS_HELP, op="flush"
            )
        return drained

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._writer.stop()
        with self._lock:
            with self._io_lock:
                if self._f is not None:
                    try:
                        self._f.close()
                    except OSError:
                        pass
                    self._f = None
            if self._lockf is not None:
                try:
                    self._lockf.close()  # releases the flock
                except OSError:
                    pass
                self._lockf = None

    def abandon(self) -> None:
        """Test hook: simulate SIGKILL. Queued-but-unfsynced records are
        discarded (exactly what process death does to them) and the file
        handles drop without any flush."""
        if self._writer is not None:
            self._writer.kill()
        with self._lock, self._io_lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            if self._lockf is not None:
                try:
                    self._lockf.close()
                except OSError:
                    pass
                self._lockf = None

    # --- fencing ----------------------------------------------------------

    def acquire_fence(self, api: Any, node_name: str) -> int:
        """Claim allocation ownership of the node: ensure our generation
        exceeds whatever the node annotation records, then stamp
        ``<generation>:<incarnation token>``. Called at every (re)build;
        any instance that acquires later gets a generation at least as
        high and — PATCH order being the tie-breaker via the token — the
        last writer owns the node and everyone else fences."""
        node = api.get_node(node_name)
        node_gen, _tok = _node_fence(node)
        with self._lock:
            if node_gen >= self._generation:
                self._generation = node_gen + 1
                self._compact()  # the header must name the new generation
            gen = self._generation
            self._fenced = False
        # coalesced node PATCH when the client offers it: two plugins
        # (mem + core) re-acquiring on one rebuild merge into one request
        patch_node = getattr(api, "patch_node_merged", None) or api.patch_node
        patch_node(
            node_name,
            {"metadata": {"annotations": {
                const.ANN_FENCE_GENERATION: f"{gen}:{self._token}"
            }}},
        )
        REGISTRY.gauge_set(FENCE_GAUGE, 0.0, FENCE_GAUGE_HELP)
        log.info(
            "fence acquired: node %s generation=%d token=%s",
            node_name, gen, self._token,
        )
        return gen

    def verify_fence(self, api: Any, node_name: str) -> bool:
        """True while this daemon still owns the node. Fences on a newer
        generation OR an equal generation under a foreign token (two
        instances raced the non-CAS acquire to the same number; the last
        PATCH writer owns it) — run by the reconciler every pass."""
        node = api.get_node(node_name)
        node_gen, node_tok = _node_fence(node)
        with self._lock:
            superseded = node_gen > self._generation or (
                node_gen == self._generation
                and node_tok not in ("", self._token)
            )
            if superseded:
                if not self._fenced:
                    log.error(
                        "FENCED: node fence %d:%s vs ours %d:%s — another "
                        "daemon instance owns allocation; refusing writes",
                        node_gen, node_tok, self._generation, self._token,
                    )
                self._fenced = True
            ok = not self._fenced
        REGISTRY.gauge_set(
            FENCE_GAUGE, 0.0 if ok else 1.0, FENCE_GAUGE_HELP
        )
        return ok


def _node_fence(node: dict) -> tuple[int, str]:
    """Parse the ``<generation>[:<token>]`` node annotation."""
    ann = node.get("metadata", {}).get("annotations") or {}
    raw = str(ann.get(const.ANN_FENCE_GENERATION, "0"))
    gen_s, _, token = raw.partition(":")
    try:
        return int(gen_s), token
    except (TypeError, ValueError):
        return 0, token
