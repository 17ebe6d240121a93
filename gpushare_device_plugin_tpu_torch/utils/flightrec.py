"""Crash/postmortem flight recorder: the last N admission traces plus
recent log records, dumped to disk when something dies.

Counterpart of ``gpushare_device_plugin_tpu/utils/flightrec.py``, copied.
The WAL makes a crash *recoverable*; this makes it *explainable*. A
bounded ring of recent log records (fed by a logging handler, each
stamped with the trace/span ids current when it was emitted) rides next
to the trace store's last-N traces; :meth:`FlightRecorder.dump`
snapshots both and writes one JSON file. Dump triggers, all wired by
:meth:`FlightRecorder.install` and
``TpuShareManager.install_signal_handlers``:

- **SIGUSR1**: an operator-requested postmortem of a live daemon, the
  trace analog of SIGQUIT's stack dump.
- **fatal daemon exit**: ``utils.log.Logger.fatal`` runs the registered
  on-fatal hooks before raising SystemExit.
- **fault-injection crash sites**: ``utils.faults`` fires the crash hook
  just before raising ``SimulatedCrash``, so a kill-at-every-step drill
  leaves a flight record exactly where a SIGKILL would have.

Dump format (one JSON document)::

    {"reason": "SIGUSR1", "time_unix": ..., "pid": ...,
     "service": "tpushare", "trace_count": N, "dropped_traces": ...,
     "traces": {<OTLP-JSON, tracing.TraceStore.to_otlp>},
     "logs": [{"time_unix", "level", "logger", "message",
               "trace_id", "span_id"}, ...],
     "timeline": {<utils.timeline.ClusterTimeline.to_doc>}}

The reference's ``kubectl-inspect-tpushare flightrecord <file>`` renders
it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any

from . import tracing
from .lockrank import make_lock

DEFAULT_MAX_LOGS = 512
# Rotation bound: only the newest K dump files are kept in the dump
# directory. Repeated SIGUSR1 postmortems / chaos-suite crash loops used
# to grow the directory without bound — the flight recorder is a ring in
# memory, so its disk footprint is a ring too. 0 disables.
DEFAULT_MAX_DUMPS = 16
_DUMP_PREFIX = "tpushare-flightrec-"


class _RingHandler(logging.Handler):
    """Bounded log-record ring. Formatting happens at emit time (records
    hold live args otherwise) and each entry is stamped with the ids of
    the span that was current on the emitting thread."""

    def __init__(self, recorder: "FlightRecorder") -> None:
        super().__init__(level=logging.DEBUG)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            message = record.getMessage()
        except (TypeError, ValueError):  # mismatched format args
            message = str(record.msg)
        ids = tracing.current_trace_ids()
        self._recorder._append_log(
            {
                "time_unix": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": message,
                "trace_id": ids[0] if ids else "",
                "span_id": ids[1] if ids else "",
            }
        )


class FlightRecorder:
    """Owns the log ring and the dump path; one per process (the module
    singleton :data:`FLIGHT`)."""

    def __init__(
        self,
        store: tracing.TraceStore | None = None,
        max_logs: int = DEFAULT_MAX_LOGS,
        max_dumps: int = DEFAULT_MAX_DUMPS,
    ) -> None:
        self._store = store if store is not None else tracing.STORE
        self._lock = make_lock("flightrec.ring")
        self._logs: deque[dict[str, Any]] = deque(maxlen=max_logs)
        self._dir = ""
        self._installed = False
        self._dumps = 0
        self._keep = max_dumps
        self._handler: _RingHandler | None = None

    # --- wiring -----------------------------------------------------------

    def install(
        self,
        directory: str,
        logger: logging.Logger | None = None,
        max_dumps: int | None = None,
    ) -> None:
        """Attach the log ring to ``logger`` (root by default) and
        register the fatal-exit and injected-crash dump hooks.
        Idempotent; re-install just updates the directory (and the
        rotation bound, when given — ``max_dumps`` keeps the newest K
        dump files on disk, 0 disables rotation)."""
        self._dir = directory
        if max_dumps is not None:
            self._keep = max_dumps
        if self._installed:
            return
        self._installed = True
        self._handler = _RingHandler(self)
        (logger or logging.getLogger()).addHandler(self._handler)
        from . import faults, log

        log.on_fatal(lambda reason: self.dump(f"fatal:{reason}"))
        faults.FAULTS.set_crash_hook(lambda point: self.dump(f"crash:{point}"))

    def uninstall(self, logger: logging.Logger | None = None) -> None:
        """Detach the ring handler and clear the hooks (tests)."""
        if self._handler is not None:
            (logger or logging.getLogger()).removeHandler(self._handler)
            self._handler = None
        from . import faults, log

        faults.FAULTS.set_crash_hook(None)
        log.clear_fatal_hooks()
        self._installed = False

    def install_signal_handler(self, signum: int | None = None) -> bool:
        """SIGUSR1 -> dump. Returns False where signals are unavailable
        (non-main thread, platforms without SIGUSR1).

        The handler only SPAWNS the dump: Python signal handlers run on
        the main thread between bytecodes, and the main thread may be
        holding the (non-reentrant) ring/store lock at that instant —
        an inline dump would self-deadlock the daemon. A worker thread
        just waits its turn for the locks like any other reader."""
        import signal
        import threading

        if signum is None:
            signum = getattr(signal, "SIGUSR1", None)
            if signum is None:
                return False

        def handler(*_: object) -> None:
            threading.Thread(
                target=self.dump, args=("SIGUSR1",),
                name="flightrec-dump", daemon=True,
            ).start()

        try:
            signal.signal(signum, handler)
            return True
        except (OSError, ValueError):  # not main thread / bad signum
            return False

    # --- ring -------------------------------------------------------------

    def _append_log(self, entry: dict[str, Any]) -> None:
        with self._lock:
            self._logs.append(entry)

    def recent_logs(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._logs)

    @property
    def dump_count(self) -> int:
        return self._dumps

    # --- dump -------------------------------------------------------------

    def snapshot(self, reason: str) -> dict[str, Any]:
        """The dump document, built from snapshots (no I/O under locks).
        Includes the cluster-state timeline ring (utils/timeline.py) so
        the postmortem carries the minutes of utilization/fragmentation/
        queue-depth/SLO-burn history *before* the crash, not just the
        instant of death."""
        from .timeline import TIMELINE

        trace_ids = self._store.trace_ids()
        return {
            "reason": reason,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "service": "tpushare",
            "trace_count": len(trace_ids),
            "dropped_traces": self._store.dropped(),
            "traces": self._store.to_otlp(),
            "logs": self.recent_logs(),
            "timeline": TIMELINE.to_doc(),
        }

    def dump(self, reason: str) -> str:
        """Write one flight record; returns its path ('' when disabled
        or the write failed — a dying daemon must not die harder because
        the dump disk is sick)."""
        if not self._dir:
            return ""
        doc = self.snapshot(reason)
        slug = "".join(c if c.isalnum() else "-" for c in reason)[:48]
        path = os.path.join(
            self._dir, f"{_DUMP_PREFIX}{int(time.time())}-{slug}.json"
        )
        try:
            os.makedirs(self._dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except OSError as e:
            logging.getLogger("utils.flightrec").warning(
                "flight-record dump failed: %s", e
            )
            return ""
        self._rotate(keep_path=path)
        with self._lock:  # dumps can come from the signal-spawned thread
            self._dumps += 1
        logging.getLogger("utils.flightrec").info(
            "flight record (%s): %s", reason, path
        )
        return path

    def _rotate(self, keep_path: str = "") -> None:
        """Prune the dump directory to the newest ``max_dumps`` files
        (the one just written always survives, whatever its timestamp —
        a skewed clock must not make a fresh postmortem the 'oldest').
        Best-effort: a sick dump disk must not hurt the dumper."""
        if self._keep <= 0 or not self._dir:
            return
        try:
            entries = []
            with os.scandir(self._dir) as it:
                for entry in it:
                    if not entry.name.startswith(_DUMP_PREFIX):
                        continue
                    if not entry.name.endswith(".json"):
                        continue
                    try:
                        entries.append((entry.stat().st_mtime, entry.path))
                    except OSError:
                        continue
            entries.sort()  # oldest first
            excess = len(entries) - self._keep
            for _mtime, victim in entries:
                if excess <= 0:
                    break
                if keep_path and os.path.abspath(victim) == os.path.abspath(
                    keep_path
                ):
                    continue
                try:
                    os.unlink(victim)
                    excess -= 1
                except OSError:
                    continue
        except OSError as e:
            logging.getLogger("utils.flightrec").warning(
                "flight-record rotation failed: %s", e
            )


def load_dump(path: str) -> dict[str, Any]:
    """Read a flight-record file (the inspect CLI's half)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a flight-record document")
    return doc


# Process-wide recorder, mirroring tracing.STORE / metrics.REGISTRY.
FLIGHT = FlightRecorder()
