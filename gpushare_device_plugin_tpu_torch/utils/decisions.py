"""Decision provenance: structured "why" records for every admission
verb.

Counterpart of ``gpushare_device_plugin_tpu/utils/decisions.py``, copied
whole. In the port, the fleet router (``serving/router.py``) is the verb
that emits: one ``fleet_route`` or ``fleet_shed`` record per request,
with each candidate engine's score.

- :class:`ScoreVector`: one candidate's structured score breakdown: the
  raw fractional score (full resolution: the 0-10 integer wire
  projection ties most of a large fleet), the free-units / binpack terms
  behind it and, for gang slices, the topology objective components
  (ICI hops, stranded slivers, broken whole chips, tie-break).
- :class:`DecisionRecord`: one verb's full decision: pod (for the router,
  the request id), verb, candidate set size, per-node rejection reasons,
  per-node score breakdowns, the chosen placement, the trace id, and the
  WAL seq that made it durable.
- :class:`DecisionLog`: a hard-bounded in-memory ring of records plus an
  optional fsync-free on-disk segment log (JSON lines, size-rotated).

Emission is built for the hot path: records take the values the verb
already computed (dicts stored by reference, never deep-copied), the ring
append is one deque op under a near-leaf lock, and a disabled log returns
before touching the lock. The segment write runs under its own I/O-ranked
lock and never fsyncs: provenance is observability, not durability.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Iterable

from .lockrank import make_lock

# Ring default: enough for the storm bench's largest round plus slack;
# one record is a few hundred bytes of references.
DEFAULT_MAX_RECORDS = 512
# Segment rotation bound (bytes): the on-disk log is a ring too. Two
# files at most live on disk: the active segment and one rotated-out
# predecessor, so a postmortem always has at least SEGMENT_MAX_BYTES of
# history even right after a rotation.
DEFAULT_SEGMENT_MAX_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class ScoreVector:
    """One candidate's structured placement score.

    ``raw`` is the full-resolution fractional score on the 0-10 scale
    (ties broken deterministically by it — see :func:`rank_scores`);
    ``projected`` is the 0-10 integer the webhook wire format pins.
    Single-chip placements carry the binpack terms only; gang slices add
    the lexicographic topology objective (ICI hops, stranded slivers,
    broken whole chips, lowest-chip tie-break) from
    ``topology.best_slice_scored``.
    """

    policy: str
    raw: float
    free_units: int
    request_units: int
    binpack: float  # slack fraction on the decisive chip: (free-req)/cap
    ici_hops: int | None = None
    stranded: int | None = None
    broken: int | None = None
    tie_break: int | None = None

    @property
    def projected(self) -> int:
        """The 0-10 integer webhook score (round + clamp of ``raw``)."""
        return max(0, min(10, round(self.raw)))

    def to_dict(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "policy": self.policy,
            "raw": round(self.raw, 4),
            "projected": self.projected,
            "free_units": self.free_units,
            "request_units": self.request_units,
            "binpack": round(self.binpack, 4),
        }
        if self.ici_hops is not None:
            doc["ici_hops"] = self.ici_hops
        if self.stranded is not None:
            doc["stranded"] = self.stranded
        if self.broken is not None:
            doc["broken"] = self.broken
        if self.tie_break is not None:
            doc["tie_break"] = self.tie_break
        return doc


ZERO_SCORE = ScoreVector(
    policy="", raw=0.0, free_units=0, request_units=0, binpack=0.0
)


def rank_scores(scores: dict[str, "ScoreVector"]) -> list[str]:
    """Node names best-first: raw score descending (full resolution —
    the deterministic tie-break the 0-10 projection cannot provide),
    then name ascending so equal-raw fleets still order stably."""
    return sorted(scores, key=lambda n: (-scores[n].raw, n))


def chip_breakdown(
    free_units: int,
    cap: int,
    idx: int | None,
    request_units: int,
    policy: str,
) -> ScoreVector:
    """Breakdown for one decisive chip — THE policy scoring formula, in
    one place: the extender's node scores (``logic._score_free``
    delegates here), its bind records, and the allocator's placement
    records all describe a decision in the same terms, so ``inspect
    why`` can never show a margin the scheduler did not compute. ``idx``
    is the chip-index tie-break for concrete chip decisions (None when
    scoring a node's best case rather than a chosen chip)."""
    if cap <= 0 or free_units < request_units:
        return ScoreVector(
            policy=policy, raw=0.0, free_units=max(0, free_units),
            request_units=request_units, binpack=0.0, tie_break=idx,
        )
    binpack = (free_units - request_units) / cap
    raw = 10.0 * binpack if policy == "spread" else 10.0 * (1.0 - binpack)
    return ScoreVector(
        policy=policy, raw=raw, free_units=free_units,
        request_units=request_units, binpack=binpack, tie_break=idx,
    )


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One admission verb's decision, as emitted (immutable thereafter).

    ``scores`` maps candidate -> :class:`ScoreVector` (or an
    already-serialized dict of one); ``rejected`` maps candidate ->
    human-readable reason — both stored by reference from the emitting
    verb. ``placement`` is the chosen concrete placement (chip / member
    chips / shape / units), ``seq`` the WAL sequence that journaled it
    (None when unjournaled), ``trace_id`` the admission trace.
    """

    pod: str
    verb: str
    outcome: str  # "ok" | "error"
    id: int = 0  # per-process monotonic, stamped by the log
    time_unix: float = 0.0
    node: str = ""
    reason: str = ""  # outcome="error": why the verb failed
    candidates: int = 0
    rejected: dict[str, str] = dataclasses.field(default_factory=dict)
    scores: dict[str, Any] = dataclasses.field(default_factory=dict)
    placement: dict[str, Any] = dataclasses.field(default_factory=dict)
    moves: tuple[str, ...] = ()  # defrag plans: affected pod keys
    trace_id: str = ""
    seq: int | None = None
    # Sharded extender provenance: which shard made this decision, and —
    # for router-merged batch verbs — which shards were NEVER consulted
    # (unreachable / partitioned), so "rejected" and "not consulted" are
    # distinguishable in `inspect why`. A node owned by a degraded shard
    # was not scored at all; its absence from `rejected` is not a pass.
    shard: str = ""
    degraded_shards: tuple[str, ...] = ()

    def to_dict(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "id": self.id,
            "time_unix": self.time_unix,
            "pod": self.pod,
            "verb": self.verb,
            "outcome": self.outcome,
        }
        if self.node:
            doc["node"] = self.node
        if self.reason:
            doc["reason"] = self.reason
        if self.candidates:
            doc["candidates"] = self.candidates
        if self.rejected:
            doc["rejected"] = dict(self.rejected)
        if self.scores:
            doc["scores"] = {
                name: (sv.to_dict() if isinstance(sv, ScoreVector) else sv)
                for name, sv in self.scores.items()
            }
        if self.placement:
            doc["placement"] = dict(self.placement)
        if self.moves:
            doc["moves"] = list(self.moves)
        if self.trace_id:
            doc["trace_id"] = self.trace_id
        if self.seq is not None:
            doc["seq"] = self.seq
        if self.shard:
            doc["shard"] = self.shard
        if self.degraded_shards:
            doc["degraded_shards"] = list(self.degraded_shards)
        return doc


class DecisionLog:
    """Bounded ring of :class:`DecisionRecord` + optional segment log.

    The ring is a ``deque(maxlen=...)`` — hard-bounded by construction,
    a storm can only evict, never grow it. The segment log appends one
    JSON line per record with NO fsync and rotates by size (active file
    + one predecessor). Both sides live behind separate locks so the
    pure-memory append never waits on the disk."""

    def __init__(
        self,
        max_records: int = DEFAULT_MAX_RECORDS,
        segment_path: str = "",
        segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES,
    ) -> None:
        self._lock = make_lock("decisions.ring")
        self._io_lock = make_lock("decisions.segment")
        self._ring: deque[DecisionRecord] = deque(maxlen=max_records)
        self._enabled = True
        self._seq = 0
        self._dropped = 0
        self._segment_path = segment_path
        self._segment_max = segment_max_bytes
        self._segment_file: Any = None
        self._segment_bytes = 0

    # --- configuration ----------------------------------------------------

    def configure(
        self,
        enabled: bool | None = None,
        max_records: int | None = None,
        segment_path: str | None = None,
        segment_max_bytes: int | None = None,
    ) -> None:
        """Runtime reconfiguration (daemon/extender flags, the bench's
        decisions-off A/B half). Shrinking ``max_records`` keeps the
        newest records; ``segment_path=""`` closes the segment log."""
        close_file = None
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if max_records is not None and max_records != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, max_records))
        with self._io_lock:
            if segment_max_bytes is not None:
                self._segment_max = segment_max_bytes
            if segment_path is not None and segment_path != self._segment_path:
                close_file = self._segment_file
                self._segment_file = None
                self._segment_bytes = 0
                self._segment_path = segment_path
        if close_file is not None:
            try:
                close_file.close()
            except OSError:
                pass

    @property
    def enabled(self) -> bool:
        return self._enabled

    # --- emission ---------------------------------------------------------

    def emit(
        self,
        pod: str,
        verb: str,
        outcome: str = "ok",
        *,
        node: str = "",
        reason: str = "",
        candidates: int = 0,
        rejected: dict[str, str] | None = None,
        scores: dict[str, Any] | None = None,
        placement: dict[str, Any] | None = None,
        moves: Iterable[str] = (),
        trace_id: str = "",
        seq: int | None = None,
        shard: str = "",
        degraded_shards: Iterable[str] = (),
    ) -> DecisionRecord | None:
        """Record one decision; returns the stamped record (None when the
        log is disabled). The dict arguments are stored by reference —
        callers hand over dicts they built for this record and do not
        mutate afterwards (the verbs' reason/score maps are built fresh
        per request, so this is free)."""
        if not self._enabled:
            return None
        now = time.time()
        with self._lock:
            self._seq += 1
            record = DecisionRecord(
                pod=pod,
                verb=verb,
                outcome=outcome,
                id=self._seq,
                time_unix=now,
                node=node,
                reason=reason,
                candidates=candidates,
                rejected=rejected if rejected is not None else {},
                scores=scores if scores is not None else {},
                placement=placement if placement is not None else {},
                moves=tuple(moves),
                trace_id=trace_id,
                seq=seq,
                shard=shard,
                degraded_shards=tuple(degraded_shards),
            )
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(record)
            segment_on = bool(self._segment_path)
        if segment_on:
            self._segment_write(record)
        return record

    # --- segment log ------------------------------------------------------

    def _segment_write(self, record: DecisionRecord) -> None:
        """One JSON line, no fsync; size-rotate keeping one predecessor.
        Best-effort by design — a sick disk must not hurt admission."""
        line = json.dumps(record.to_dict(), separators=(",", ":")) + "\n"
        data = line.encode()
        with self._io_lock:
            try:
                if self._segment_file is None:
                    self._open_segment()
                if self._segment_bytes + len(data) > self._segment_max:
                    self._rotate_segment()
                self._segment_file.write(data)
                self._segment_file.flush()  # OS buffer, NOT fsync
                self._segment_bytes += len(data)
            except OSError:
                # drop the line; the in-memory ring still has the record.
                # Close (best-effort) before dropping the reference — a
                # sick disk must not also churn leaked descriptors.
                if self._segment_file is not None:
                    try:
                        self._segment_file.close()
                    except OSError:
                        pass
                self._segment_file = None

    def _open_segment(self) -> None:
        directory = os.path.dirname(self._segment_path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._segment_file = open(self._segment_path, "ab")  # noqa: SIM115
        self._segment_bytes = self._segment_file.tell()

    def _rotate_segment(self) -> None:
        self._segment_file.close()
        os.replace(self._segment_path, self._segment_path + ".1")
        self._segment_file = open(self._segment_path, "ab")  # noqa: SIM115
        self._segment_bytes = 0

    def close(self) -> None:
        with self._io_lock:
            if self._segment_file is not None:
                try:
                    self._segment_file.close()
                except OSError:
                    pass
                self._segment_file = None

    # --- readers ----------------------------------------------------------

    def records(
        self,
        pod: str | None = None,
        verb: str | None = None,
        limit: int | None = None,
    ) -> list[DecisionRecord]:
        """Matching records, oldest first. ``pod`` matches the record's
        pod key or (for defrag plans) any pod its moves touch."""
        with self._lock:
            snapshot = list(self._ring)
        out = [
            r for r in snapshot
            if (pod is None or r.pod == pod or pod in r.moves)
            and (verb is None or r.verb == verb)
        ]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def size(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def to_doc(
        self,
        pod: str | None = None,
        verb: str | None = None,
        limit: int | None = None,
    ) -> dict[str, Any]:
        """The ``/decisions`` endpoint body."""
        records = self.records(pod=pod, verb=verb, limit=limit)
        with self._lock:
            dropped, max_records = self._dropped, self._ring.maxlen
        return {
            "max_records": max_records,
            "dropped": dropped,
            "records": [r.to_dict() for r in records],
        }


# Process-wide default log, mirroring metrics.REGISTRY / tracing.STORE:
# one decision log per control-plane process.
DECISIONS = DecisionLog()
