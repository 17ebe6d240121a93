"""Journaled prefill→decode KV-handoff protocol, free of engine state.

Counterpart of ``gpushare_device_plugin_tpu/serving/handoffproto.py``,
copied whole: the same journal records, ledger docs, metric families and
outcomes, so a handoff journaled by either package resolves in the other.

Disaggregated serving splits one slice's engine into a **prefill tier**
(fills paged KV, produces the first token) and a **decode tier** (streams
the rest). The KV pages a prefill engine produced must MOVE to the decode
engine — across processes, across crashes — without ever losing a
request, serving one twice, or leaking a destination page. One handoff is
a WAL record of kind ``"handoff"`` journaled through the phases

    export -> transfer -> import -> commit

each durable *before* its side effect:

- **export**: the full request row (prompt, first token, SLO targets,
  adapter) is durable, then the wire payload (page bytes + CRC32
  checksums) is materialized. From here a crash can re-serve the request
  from the journal alone — the decode tier re-prefills it locally.
- **transfer**: record durable, then the peer stages destination pages
  through the decode tier's refcounted :class:`~.pages.PageAllocator`
  (all-or-nothing) and receives page bytes one page at a time, each
  checksum-verified on arrival.
- **import**: the **commit point**. Record durable, then the decode tier
  adopts the staged pages into a live row. At or past this phase a crash
  rolls FORWARD (re-deliver, idempotent by handoff id); before it, a
  crash rolls BACK (release staged pages, degrade to local re-prefill).
- **commit**: record durable, then the source drops its export buffer;
  the WAL entry resolves.

Every delivery — KV import, duplicate, or re-prefill fallback — funnels
through ONE idempotent sink (:class:`HandoffSink`) gated by
:meth:`HandoffImportLedger.first_delivery`, so at-least-once re-delivery
across any crash window can never serve a request twice, and a failed or
timed-out transfer degrades to re-prefill instead of losing the request.

Page transfer rides :class:`HandoffPeerClient` — ``utils/retry.py``
backoff with a per-transfer deadline over a ``utils/circuit.py`` breaker
— so a flapping decode tier costs bounded wall clock, never a wedged
prefill engine. :func:`resolve_handoff` is the restart half: a resolver
calls it on each ``kind == "handoff"`` entry of
:meth:`~..allocator.checkpoint.AllocationCheckpoint.pending`.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque
from typing import Any, Callable, Mapping

from ..allocator.checkpoint import AllocationCheckpoint, StaleDaemonError
from ..utils.circuit import CircuitBreaker, CircuitOpenError
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metric_catalog import (
    HANDOFF_BYTES,
    HANDOFF_FALLBACK_REPREFILL_TOTAL,
    HANDOFF_PAGES_IN_FLIGHT,
    HANDOFF_TRANSFER_SECONDS,
    HANDOFF_TRANSFERS_TOTAL,
)
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.retry import retry

log = get_logger("serving.handoff")

# The journaled handoff state machine, in order. Each phase's WAL record
# is durable BEFORE its side effect; "import" is the roll-forward
# boundary.
HANDOFF_PHASES = ("export", "transfer", "import", "commit")
HANDOFF_KIND = "handoff"
ROLL_FORWARD_PHASES = ("import", "commit")

# Synthetic namespace for handoff journal/ledger keys, like the defrag
# mover's DEFRAG_NS: the entry is keyed by handoff id, never mistaken
# for (or hidden by) a real pod's own accounting.
HANDOFF_NS = "tpushare-handoff"

TRANSFERS_HELP = (
    "Cross-engine KV handoffs by outcome "
    "(delivered/duplicate/fallback/failed)"
)
TRANSFER_SECONDS_HELP = "Wall time of one completed KV handoff, all phases"
BYTES_HELP = "KV page bytes shipped per completed handoff transfer"
FALLBACK_HELP = (
    "Handoffs degraded to local re-prefill on the decode tier, by reason"
)
PAGES_IN_FLIGHT_HELP = (
    "Destination pages reserved for handoffs still staging (not yet "
    "adopted or released)"
)


class ChecksumError(ValueError):
    """A transferred page's CRC32 did not match its payload."""


class HandoffError(RuntimeError):
    """A handoff could not proceed (transfer dead, staging refused)."""


def handoff_key(handoff_id: str) -> tuple[str, str]:
    """The journal/ledger key for one handoff (synthetic namespace)."""
    return (HANDOFF_NS, handoff_id)


def page_crc(blob: bytes) -> int:
    """CRC32 over one serialized page's wire bytes."""
    return zlib.crc32(blob) & 0xFFFFFFFF


def _journal_handoff(
    ckpt: AllocationCheckpoint | None, key: tuple[str, str], data: dict
) -> int | None:
    """Journal one handoff phase durable (a fresh ``begin`` for the
    handoff key — the loader keeps the newest record per key, so the
    entry always names the furthest phase reached, exactly like the move
    protocol's ``_journal_phase``). ``StaleDaemonError`` propagates: a
    fenced daemon must not advance a handoff the newer incarnation owns.
    ``None`` = journal degraded (sick disk): the handoff continues
    unjournaled, like admissions do."""
    if ckpt is None:
        return None
    return ckpt.begin(key, data)


def _journal_resolve(
    ckpt: AllocationCheckpoint | None,
    op: str,
    key: tuple[str, str],
    seq: int | None,
) -> bool:
    """Resolve the handoff's journal entry (``op`` = ``"commit"`` the
    pages were delivered, ``"abort"`` the handoff degraded/rolled back);
    the thin delegation form the wal-protocol rule recognizes. False =
    degraded/unjournaled or a newer begin owns the key."""
    if ckpt is None:
        return False
    if op == "commit":
        return ckpt.commit(key, seq=seq)
    return ckpt.abort(key, seq=seq)


# ---------------------------------------------------------------------------
# decode-tier import ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Staged:
    pages: list[int]
    blobs: list[bytes | None]
    meta: dict

    def sealed(self) -> bool:
        return all(b is not None for b in self.blobs)


class HandoffImportLedger:
    """The decode tier's staging table: destination pages reserved per
    in-flight handoff, page bytes accumulated as they arrive, and the
    delivered-id window that makes delivery idempotent.

    Thread-safe under rank ``serving.handoff`` (below ``serving.pages``,
    so staging may call the page allocator while holding it). Page
    ownership: :meth:`stage` reserves pages refcount-1 through the
    caller's allocator; :meth:`adopt` transfers them to the engine row
    (the row's release recycles them); :meth:`abort` releases them here.
    Exactly one of adopt/abort ends every staging: no destination page
    leaks.
    """

    def __init__(self, dedup_window: int = 64) -> None:
        self._lock = make_lock("serving.handoff")
        self._staged: dict[str, _Staged] = {}
        # handoff ids already delivered (served via KV import OR
        # re-prefill fallback): the at-least-once re-delivery across the
        # import/commit crash window dedups here, like snapshot_id dedup
        # in PagedSlotEngine.restore_snapshot.
        self._delivered: deque[str] = deque(maxlen=dedup_window)

    def stage(
        self,
        handoff_id: str,
        n_pages: int,
        meta: Mapping[str, Any],
        alloc: Callable[[int], list[int] | None],
    ) -> list[int] | None:
        """Reserve ``n_pages`` destination pages for a handoff
        (all-or-nothing through ``alloc``). Idempotent: a re-stage of a
        live staging returns its existing pages. None = nothing staged
        (pool cannot cover it, or the handoff was already delivered) —
        the mover degrades to re-prefill."""
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        with self._lock:
            if handoff_id in self._delivered:
                return None
            st = self._staged.get(handoff_id)
            if st is not None:
                return list(st.pages)
            got = alloc(n_pages)
            if got is None:
                return None
            self._staged[handoff_id] = _Staged(
                pages=got, blobs=[None] * n_pages, meta=dict(meta)
            )
            return list(got)

    def put_page(
        self, handoff_id: str, index: int, blob: bytes, crc: int
    ) -> None:
        """Store one transferred page's bytes, checksum-verified on
        arrival (:class:`ChecksumError` — the peer client retries the
        page). ``LookupError`` when nothing is staged under the id."""
        if page_crc(blob) != crc:
            raise ChecksumError(
                f"handoff {handoff_id} page {index}: checksum mismatch"
            )
        with self._lock:
            st = self._staged.get(handoff_id)
            if st is None:
                raise LookupError(f"handoff {handoff_id} is not staged")
            if not 0 <= index < len(st.blobs):
                raise IndexError(
                    f"handoff {handoff_id} page index {index} out of "
                    f"range (staged {len(st.blobs)})"
                )
            st.blobs[index] = blob

    def adopt(self, handoff_id: str) -> tuple[list[int], list[bytes], dict] | None:
        """Pop a SEALED staging (every page present) for engine import —
        page ownership transfers to the caller. None when absent or
        still partial (the delivery falls back to re-prefill)."""
        with self._lock:
            st = self._staged.get(handoff_id)
            if st is None or not st.sealed():
                return None
            del self._staged[handoff_id]
            return (st.pages, [b for b in st.blobs if b is not None], st.meta)

    def abort(
        self, handoff_id: str, release: Callable[[list[int]], None]
    ) -> bool:
        """Drop a staging and release its reserved pages (rollback, or
        leftover partial staging after a fallback delivery)."""
        with self._lock:
            st = self._staged.pop(handoff_id, None)
            if st is None:
                return False
            release(st.pages)
            return True

    def first_delivery(self, handoff_id: str) -> bool:
        """The idempotent-delivery gate: True exactly once per handoff
        id. Every serve path (KV import AND re-prefill fallback) passes
        here first, so duplicate re-deliveries are no-ops."""
        with self._lock:
            if handoff_id in self._delivered:
                return False
            self._delivered.append(handoff_id)
            return True

    def delivered(self, handoff_id: str) -> bool:
        with self._lock:
            return handoff_id in self._delivered

    @property
    def pages_in_flight(self) -> int:
        with self._lock:
            return sum(len(st.pages) for st in self._staged.values())

    def publish(
        self, registry: MetricsRegistry = REGISTRY, pod: str = ""
    ) -> None:
        labels = {"pod": pod} if pod else {}
        registry.gauge_set(
            HANDOFF_PAGES_IN_FLIGHT, float(self.pages_in_flight),
            PAGES_IN_FLIGHT_HELP, **labels,
        )

    def doc(self) -> dict[str, Any]:
        """Staging state for debugging and the model checker's checks."""
        with self._lock:
            return {
                "staged": {
                    hid: {
                        "pages": list(st.pages),
                        "received": sum(b is not None for b in st.blobs),
                        "total": len(st.blobs),
                    }
                    for hid, st in self._staged.items()
                },
                "delivered": list(self._delivered),
            }


# ---------------------------------------------------------------------------
# decode-tier delivery sink
# ---------------------------------------------------------------------------


class HandoffSink:
    """The decode tier's delivery endpoint: staging plus the ONE
    idempotent serve path every handoff ends in.

    ``import_cb(pages, blobs, meta, record)`` adopts sealed staged pages
    into the decode engine (ownership transfers — the engine releases
    them when the request retires); a raise falls back to re-prefill
    with the pages released here. ``reprefill_cb(record)`` queues the
    journaled request row for local re-prefill — it must not raise (it
    only stages host state; the request would otherwise be marked
    delivered but never served).
    """

    def __init__(
        self,
        ledger: HandoffImportLedger,
        alloc: Callable[[int], list[int] | None],
        release: Callable[[list[int]], None],
        import_cb: Callable[[list[int], list[bytes], dict, dict], None],
        reprefill_cb: Callable[[dict], None],
        *,
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        self.ledger = ledger
        self._alloc = alloc
        self._release = release
        self._import = import_cb
        self._reprefill = reprefill_cb
        self._registry = registry
        self._pod = pod

    # --- transfer side ----------------------------------------------------

    def stage(
        self, handoff_id: str, n_pages: int, meta: Mapping[str, Any]
    ) -> bool:
        return (
            self.ledger.stage(handoff_id, n_pages, meta, self._alloc)
            is not None
        )

    def put_page(
        self, handoff_id: str, index: int, blob: bytes, crc: int
    ) -> None:
        self.ledger.put_page(handoff_id, index, blob, crc)

    def abort(self, handoff_id: str) -> bool:
        return self.ledger.abort(handoff_id, self._release)

    # --- the idempotent serve path ----------------------------------------

    def deliver(self, handoff_id: str, record: Mapping[str, Any]) -> str:
        """Serve one handoff exactly once: ``"imported"`` (staged KV
        adopted), ``"reprefill"`` (no usable staging — the journaled
        request re-prefills locally), or ``"duplicate"`` (already
        served; leftover staging is released). Idempotent by handoff id
        — safe under the at-least-once re-delivery every crash window
        implies."""
        if not self.ledger.first_delivery(handoff_id):
            # duplicate re-delivery: the request was already served;
            # drop any staging a racing transfer left behind
            self.ledger.abort(handoff_id, self._release)
            log.warning(
                "handoff %s already delivered; duplicate ignored",
                handoff_id,
            )
            return "duplicate"
        got = self.ledger.adopt(handoff_id)
        if got is None:
            # nothing staged, or a partial transfer: release the partial
            # reservation and serve by local re-prefill — the request is
            # never lost, it just costs a prefill (tokens bit-identical
            # by greedy determinism)
            self.ledger.abort(handoff_id, self._release)
            self._reprefill(dict(record))
            self._count_fallback("no_staged_kv")
            return "reprefill"
        pages, blobs, meta = got
        try:
            self._import(pages, blobs, meta, dict(record))
        except Exception as e:  # noqa: BLE001 — geometry mismatch etc.:
            # the pages cannot serve here; degrade rather than lose
            self._release(pages)
            self._reprefill(dict(record))
            self._count_fallback("import_failed")
            log.warning(
                "handoff %s import failed (%s); degraded to re-prefill",
                handoff_id, e,
            )
            return "reprefill"
        return "imported"

    def _count_fallback(self, reason: str) -> None:
        labels = {"pod": self._pod} if self._pod else {}
        self._registry.counter_inc(
            HANDOFF_FALLBACK_REPREFILL_TOTAL, FALLBACK_HELP,
            reason=reason, **labels,
        )


# ---------------------------------------------------------------------------
# retrying peer client
# ---------------------------------------------------------------------------


class HandoffPeerClient:
    """Transfer-side client over a duck-typed transport (``stage`` /
    ``put_page`` / ``deliver`` / ``abort``): every verb retries with
    exponential backoff under a per-call deadline, behind a shared
    circuit breaker so a dead decode tier fails fast instead of
    serializing full retry ladders per page.

    The lock (rank ``handoff.peer``) guards the transfer counters only —
    never held across a transport call or the breaker."""

    def __init__(
        self,
        transport: Any,
        *,
        attempts: int = 3,
        delay_s: float = 0.02,
        backoff: float = 2.0,
        deadline_s: float = 2.0,
        breaker: CircuitBreaker | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._t = transport
        self._attempts = attempts
        self._delay = delay_s
        self._backoff = backoff
        self._deadline = deadline_s
        self._breaker = breaker or CircuitBreaker(
            "handoff-peer", failure_threshold=5, reset_timeout_s=1.0,
            clock=clock,
        )
        self._sleep = sleep
        self._clock = clock
        self._lock = make_lock("handoff.peer")
        self.calls = 0
        self.retries = 0
        self.sent_pages = 0
        self.sent_bytes = 0

    def _call(self, fn: Callable[[], Any]) -> Any:
        tried = 0

        def once() -> Any:
            nonlocal tried
            tried += 1
            self._breaker.before()
            try:
                out = fn()
            except Exception:
                self._breaker.record_failure()
                raise
            self._breaker.record_success()
            return out

        try:
            out = retry(
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
        finally:
            with self._lock:
                self.calls += 1
                self.retries += max(tried - 1, 0)
        return out

    def stage(
        self, handoff_id: str, n_pages: int, meta: Mapping[str, Any]
    ) -> bool:
        return bool(self._call(lambda: self._t.stage(handoff_id, n_pages, meta)))

    def put_page(
        self, handoff_id: str, index: int, blob: bytes, crc: int
    ) -> None:
        self._call(lambda: self._t.put_page(handoff_id, index, blob, crc))
        with self._lock:
            self.sent_pages += 1
            self.sent_bytes += len(blob)

    def deliver(self, handoff_id: str, record: Mapping[str, Any]) -> str:
        return str(self._call(lambda: self._t.deliver(handoff_id, record)))

    def abort(self, handoff_id: str) -> bool:
        return bool(self._call(lambda: self._t.abort(handoff_id)))

    def doc(self) -> dict[str, Any]:
        with self._lock:
            return {
                "calls": self.calls,
                "retries": self.retries,
                "sent_pages": self.sent_pages,
                "sent_bytes": self.sent_bytes,
            }


# ---------------------------------------------------------------------------
# the journaled mover
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HandoffPlan:
    """One prefill→decode handoff: the JSON-safe request row (everything
    the decode tier needs to serve it WITHOUT the KV — the re-prefill
    guarantee), engine geometry ``meta``, and the serialized page
    payloads. The row and meta travel inside every journal record; the
    page bytes never do (like the move protocol journaling the drained
    snapshot, not the cache)."""

    handoff_id: str
    request: dict
    meta: dict
    pages: tuple[bytes, ...]


class HandoffMover:
    """Executes one :class:`HandoffPlan` through the journaled protocol.

    ``peer`` is the transfer path to the decode tier (normally a
    :class:`HandoffPeerClient`); ``fallback_fn(handoff_id, record)``
    is the control-plane path that queues the journaled request for
    local re-prefill when the transfer degrades — it must reach the
    decode tier's :class:`HandoffSink` (dedup included), not the page
    transport that just failed. Exceptions out of :meth:`execute` leave
    the journal entry pending for the reconciler — deliberately: that IS
    the crash-safety story, same as the defrag mover."""

    def __init__(
        self,
        checkpoint: AllocationCheckpoint | None,
        assume: Any,
        peer: Any,
        *,
        fallback_fn: Callable[[str, dict], str],
        node: str = "",
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        self._ckpt = checkpoint
        self._assume = assume
        self._peer = peer
        self._fallback = fallback_fn
        self._node = node
        self._registry = registry
        self._pod = pod

    def _count(self, outcome: str) -> None:
        labels = {"pod": self._pod} if self._pod else {}
        self._registry.counter_inc(
            HANDOFF_TRANSFERS_TOTAL, TRANSFERS_HELP, outcome=outcome,
            **labels,
        )

    def execute(self, plan: HandoffPlan) -> str:
        """Run one handoff end to end: ``"delivered"`` (KV adopted on
        the decode tier), ``"duplicate"`` (the decode tier had already
        served it), or ``"fallback"`` (transfer degraded — the request
        re-prefills on the decode tier). Raises when even the fallback
        path is unreachable: the entry stays pending and the reconciler
        re-delivers — the request is delayed, never lost."""
        key = handoff_key(plan.handoff_id)
        if self._assume is not None and not self._assume.claim(key):
            # a concurrent mover owns this handoff (the reconciler's
            # claim gate protects it the same way)
            log.v(4, "handoff %s already in flight; skipped", plan.handoff_id)
            return "skipped"
        t0 = time.perf_counter()
        base = {
            "kind": HANDOFF_KIND,
            "handoff_id": plan.handoff_id,
            "request": plan.request,
            "meta": plan.meta,
            "n_pages": len(plan.pages),
            "node": self._node,
        }
        try:
            # export: the request row is durable before the wire payload
            # exists — any crash from here on can re-serve the request
            # from the journal alone.
            seq = _journal_handoff(self._ckpt, key, {**base, "phase": "export"})
            FAULTS.fire("handoff.export")
            blobs = list(plan.pages)
            crcs = [page_crc(b) for b in blobs]
            nbytes = sum(len(b) for b in blobs)
            # transfer: record durable, then pages ship one at a time —
            # destination pages reserved (all-or-nothing) first.
            seq = _journal_handoff(self._ckpt, key, {**base, "phase": "transfer"})
            FAULTS.fire("handoff.transfer")
            staged = False
            try:
                staged = bool(blobs) and self._peer.stage(
                    plan.handoff_id, len(blobs), plan.meta
                )
                if staged:
                    for i, (blob, crc) in enumerate(zip(blobs, crcs)):
                        self._peer.put_page(plan.handoff_id, i, blob, crc)
            except Exception as e:  # noqa: BLE001 — transfer dead after
                # retries/deadline/breaker: degrade. The staged partial
                # reservation is released best-effort here and
                # authoritatively by the fallback delivery's own abort.
                log.warning(
                    "handoff %s transfer failed (%s); degrading to "
                    "re-prefill", plan.handoff_id, e,
                )
                try:
                    self._peer.abort(plan.handoff_id)
                except Exception as abort_err:  # noqa: BLE001
                    # same dead transport; the fallback delivery's own
                    # abort is the authoritative release
                    log.v(
                        4, "handoff %s staging abort also failed: %s",
                        plan.handoff_id, abort_err,
                    )
                self._fallback(plan.handoff_id, dict(base))
                _journal_resolve(self._ckpt, "abort", key, seq)
                self._release_claim(key)
                self._count("fallback")
                return "fallback"
            if not staged:
                # the decode pool cannot reserve the pages (or the
                # handoff was already served): no transfer — the
                # fallback delivery settles which, idempotently.
                self._fallback(plan.handoff_id, dict(base))
                _journal_resolve(self._ckpt, "abort", key, seq)
                self._release_claim(key)
                self._count("fallback")
                return "fallback"
            # import: the commit point — at or past this record a crash
            # rolls forward (re-deliver by handoff id).
            seq = _journal_handoff(self._ckpt, key, {**base, "phase": "import"})
            FAULTS.fire("handoff.import")
            outcome = self._peer.deliver(plan.handoff_id, base)
            # commit: source-side cleanup (the export buffer dies with
            # this frame), then the entry resolves.
            seq = _journal_handoff(self._ckpt, key, {**base, "phase": "commit"})
            FAULTS.fire("handoff.commit")
            del blobs
            _journal_resolve(self._ckpt, "commit", key, seq)
            self._release_claim(key)
        except StaleDaemonError:
            # a newer daemon fenced us mid-handoff: the entry stays for
            # the owner's reconciler; only our claim is dropped.
            self._release_claim(key)
            self._count("failed")
            raise
        wall = time.perf_counter() - t0
        labels = {"pod": self._pod} if self._pod else {}
        if outcome == "duplicate":
            self._count("duplicate")
            return "duplicate"
        self._count("delivered")
        self._registry.observe(
            HANDOFF_TRANSFER_SECONDS, wall, TRANSFER_SECONDS_HELP, **labels
        )
        self._registry.observe(
            HANDOFF_BYTES, float(nbytes), BYTES_HELP,
            buckets=(4096.0, 65536.0, 1048576.0, 16777216.0, 268435456.0),
            **labels,
        )
        return "delivered"

    def _release_claim(self, key: tuple[str, str]) -> None:
        if self._assume is not None:
            self._assume.release(key)


# ---------------------------------------------------------------------------
# restart resolution (called on each pending handoff entry)
# ---------------------------------------------------------------------------


def resolve_handoff(
    ckpt: AllocationCheckpoint,
    assume: Any,
    key: tuple[str, str],
    data: Mapping[str, Any],
    *,
    deliver_fn: Callable[[str, dict], str],
    abort_fn: Callable[[str], Any] | None = None,
) -> str | None:
    """Resolve one journaled handoff found after a crash (any phase).

    Roll **forward** at or past ``import``: the commit point passed —
    re-deliver through ``deliver_fn`` (the decode tier's
    :meth:`HandoffSink.deliver`: staged KV adopts if it survived,
    otherwise the journaled request re-prefills; either way idempotent
    by handoff id), then commit. Roll **back** before it: release any
    staged destination pages (``abort_fn``), deliver the journaled
    request for local re-prefill, then abort. BOTH directions end in a
    delivery — a handoff entry, whatever phase it died in, always serves
    its request exactly once.

    Returns ``"rollforward"`` / ``"rollback"`` when resolved this pass,
    None when a delivery side effect failed — the entry stays pending
    (protective) for the next pass, exactly like an unreachable
    apiserver leaves a move pending."""
    seq = data.get("_seq")
    phase = str(data.get("phase") or "export")
    handoff_id = str(data.get("handoff_id") or key[1])
    if phase in ROLL_FORWARD_PHASES:
        try:
            deliver_fn(handoff_id, dict(data))
        except Exception as e:  # noqa: BLE001 — decode tier not ready:
            # committing would delete the journal's only copy of the
            # request row; stay pending for the next pass
            log.warning(
                "handoff resolve: re-delivery of %s failed (%s); left "
                "pending", handoff_id, e,
            )
            return None
        if _journal_resolve(ckpt, "commit", key, seq):
            if assume is not None:
                assume.release_if_unclaimed(key)
            log.info(
                "handoff resolve: %s rolled forward (died in %s)",
                handoff_id, phase,
            )
            return "rollforward"
        return None
    # before the commit point: release staged pages, then serve the
    # journaled request by local re-prefill (degradation ladder's floor)
    try:
        if abort_fn is not None:
            abort_fn(handoff_id)
        deliver_fn(handoff_id, dict(data))
    except Exception as e:  # noqa: BLE001 — stay pending
        log.warning(
            "handoff resolve: rollback delivery of %s failed (%s); left "
            "pending", handoff_id, e,
        )
        return None
    if _journal_resolve(ckpt, "abort", key, seq):
        if assume is not None:
            assume.release_if_unclaimed(key)
        log.info(
            "handoff resolve: %s rolled back to re-prefill (died in %s)",
            handoff_id, phase,
        )
        return "rollback"
    return None
