"""Group-commit batching primitive of the WAL writer.

Counterpart of ``gpushare_device_plugin_tpu/utils/batch.py``, copied
whole.

The pattern (databases call it group commit): many callers each need one
expensive flush-like operation — an ``fsync``, an HTTP PATCH round-trip —
and the operation's cost is dominated by fixed overhead, not payload. A
dedicated worker drains everything submitted since the last flush and pays
the overhead ONCE for the whole batch; each caller blocks on a per-batch
ticket until *its* item has been processed, so the blocking semantics are
exactly those of doing the work inline — only the per-call overhead is
amortized.

Gather dynamics: the worker wakes on the first submission and gathers up
to ``window_s`` before flushing — but only while the batcher is *busy*
(another flush ran within the last few windows). From idle, a lone
submission drains as soon as arrivals go quiet for ``window_s / 4``: a
sporadic sequential caller pays ~window/4 of added latency, while a
16-way admission storm — where arrivals keep coming but may be smeared
by CPU scheduling — gets the full window and batches deeply. The flush
duration itself is a second, free batching window: submissions during a
flush queue up for the next one.

Failure semantics: ``flush_fn`` may return per-item results (an
``Exception`` instance fails just that ticket) or raise to fail the whole
batch. A ``BaseException`` (``SimulatedCrash`` from the fault layer) is
propagated to every waiting ticket AND re-raised in the worker — exactly
like a process dying mid-flush; the worker is restarted lazily on the
next submit, so a ``times=1`` injected crash doesn't wedge the batcher
for the rest of the process lifetime.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

from .lockrank import make_condition
from .log import get_logger

log = get_logger("utils.batch")


class Ticket:
    """One submitted item's handle: ``wait()`` blocks until the batch that
    carried the item was flushed, then returns its per-item result or
    raises its per-item (or whole-batch) error."""

    __slots__ = ("_done", "_result", "_error")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

    def _resolve(self, result: Any = None) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("batched operation did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result


class GroupBatcher:
    """``submit(item) -> Ticket``; a worker thread drains queued items and
    calls ``flush_fn(items)`` once per batch.

    ``flush_fn(items)`` returns either ``None`` (every ticket resolves to
    ``None``) or a sequence of per-item results aligned with ``items``
    (an ``Exception`` element fails that one ticket). ``on_batch``, if
    given, observes ``len(items)`` after each successful flush (metrics
    hook — kept out of flush_fn so failures aren't counted as batches).
    """

    def __init__(
        self,
        flush_fn: Callable[[list], Sequence | None],
        window_s: float = 0.002,
        name: str = "batcher",
        on_batch: Callable[[int], None] | None = None,
        idle_exit_s: float = 30.0,
    ) -> None:
        self._flush_fn = flush_fn
        self._window = max(0.0, window_s)
        self._name = name
        self._on_batch = on_batch
        # A worker with nothing to do for this long exits; the next
        # submit restarts it. Batchers live as long as their owners
        # (clients, checkpoints) and owners are created freely in tests —
        # without the idle exit every one would pin a thread forever.
        self._idle_exit_s = idle_exit_s
        self._cond = make_condition("wal.batcher")
        self._queue: list[tuple[Any, Ticket]] = []
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._killed = False
        self._force = False  # flush(): drain now, skip the gather window
        # barrier bookkeeping: submit seq vs highest seq fully flushed
        self._submitted = 0
        self._completed = 0
        self._last_flush = float("-inf")  # monotonic stamp of last drain

    # --- caller side ------------------------------------------------------

    def submit(self, item: Any) -> Ticket:
        ticket = Ticket()
        with self._cond:
            if self._killed or self._stopping:
                raise RuntimeError(f"{self._name}: batcher is stopped")
            self._queue.append((item, ticket))
            self._submitted += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._cond.notify_all()
        return ticket

    def flush(self, timeout: float | None = None) -> bool:
        """Barrier: returns once everything submitted before this call has
        been flushed (durable / responded). False on timeout."""
        with self._cond:
            target = self._submitted
            self._force = True
            self._cond.notify_all()
            return self._cond.wait_for(
                lambda: self._completed >= target
                or (self._thread is None or not self._thread.is_alive())
                and not self._queue,
                timeout=timeout,
            )

    def stop(self) -> None:
        """Graceful: flush whatever is queued, then stop the worker."""
        with self._cond:
            self._stopping = True
            self._force = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)

    def kill(self) -> None:
        """Test hook simulating process death: discard the queue without
        flushing (a SIGKILL'd daemon's batched-but-unfsynced records are
        exactly this — gone). Tickets are failed, not left hanging."""
        with self._cond:
            self._killed = True
            self._stopping = True
            dropped = self._queue
            self._queue = []
            for _item, ticket in dropped:
                ticket._fail(RuntimeError(f"{self._name}: killed, batch dropped"))
            self._completed = self._submitted
            self._cond.notify_all()

    # --- worker side ------------------------------------------------------

    def _gather(self) -> list[tuple[Any, Ticket]]:
        """Caller must hold self._cond. Blocks for the first item, then
        applies the window/quiet gather policy; returns the drained batch
        (empty only when stopping with nothing queued)."""
        import time

        idle_deadline = time.monotonic() + self._idle_exit_s
        while not self._queue:
            if self._stopping:
                return []
            remaining = idle_deadline - time.monotonic()
            if remaining <= 0:
                return []  # idle exit: the next submit restarts the worker
            self._cond.wait(remaining)
        if self._window > 0 and not self._force and not self._stopping:
            now = time.monotonic()
            # busy = a flush ran recently: more work is very likely in
            # flight even if arrivals are smeared — hold the full window.
            busy = now - self._last_flush < 4.0 * self._window
            deadline = now + self._window
            quiet = self._window / 4.0
            seen = len(self._queue)
            while not self._force and not self._stopping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining if busy else min(quiet, remaining))
                if not busy and len(self._queue) == seen:
                    break  # idle-mode: arrivals went quiet, drain early
                seen = len(self._queue)
        self._force = False
        self._last_flush = time.monotonic()
        batch = self._queue
        self._queue = []
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                batch = self._gather()
                if not batch:
                    # Hand the restart duty off BEFORE dying: a submit()
                    # racing the idle exit would otherwise see a
                    # still-is_alive() thread that has already made its
                    # final queue check, enqueue, and hang its ticket
                    # until some unrelated later submit. Clearing _thread
                    # under the lock makes that submit start a fresh
                    # worker.
                    if self._thread is threading.current_thread():
                        self._thread = None
                    self._cond.notify_all()
                    return
            try:
                results = self._flush_fn([item for item, _t in batch])
            except BaseException as e:  # noqa: BLE001 — per-design, see module doc
                for _item, ticket in batch:
                    ticket._fail(e)
                with self._cond:
                    self._completed += len(batch)
                    if not isinstance(e, Exception):
                        # SimulatedCrash: the worker dies like the process
                        # would — and items already queued for the next
                        # batch die with it (their callers must not hang;
                        # a later submit lazily restarts the worker).
                        for _item, ticket in self._queue:
                            ticket._fail(e)
                        self._completed += len(self._queue)
                        self._queue = []
                        if self._thread is threading.current_thread():
                            self._thread = None  # see idle-exit handoff
                        self._cond.notify_all()
                        return
                    self._cond.notify_all()
                continue
            for i, (_item, ticket) in enumerate(batch):
                r = results[i] if results is not None else None
                if isinstance(r, BaseException):
                    ticket._fail(r)
                else:
                    ticket._resolve(r)
            if self._on_batch is not None:
                try:
                    self._on_batch(len(batch))
                except Exception as e:  # noqa: BLE001 — metrics must not kill I/O
                    log.warning("%s: on_batch hook failed: %s", self._name, e)
            with self._cond:
                self._completed += len(batch)
                self._cond.notify_all()
