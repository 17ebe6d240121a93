"""Leveled logging with glog-style verbosity tiers and trace correlation.

Counterpart of ``gpushare_device_plugin_tpu/utils/log.py``, cut to what
the port calls: :func:`get_logger` (a ``Logger`` with
``info``/``warning``/``error``/``fatal`` and ``v(n, ...)``, emitted at
DEBUG when the process verbosity is at least ``n``), :func:`setup` and
:func:`verbosity`. ``setup`` stamps every record with the ids of the span
current on the emitting thread (``utils.tracing``), rendered as
`` [trace/span]`` between the logger name and the message.

Fatal hooks: ``Logger.fatal`` runs the hooks registered with
:func:`on_fatal` (the flight recorder's dump-on-fatal) before raising
SystemExit, so a dying daemon leaves a postmortem behind.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Callable

from . import tracing

_VERBOSITY = 0
_factory_installed = False
_fatal_hooks: list[Callable[[str], Any]] = []


def _install_record_factory() -> None:
    """Wrap the LogRecord factory to add ``record.trace``: empty outside
    spans, `` [<trace8>/<span8>]`` inside a recording one."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    old_factory = logging.getLogRecordFactory()

    def factory(*args: Any, **kwargs: Any) -> logging.LogRecord:
        record = old_factory(*args, **kwargs)
        ids = tracing.current_trace_ids()
        record.trace = f" [{ids[0][:8]}/{ids[1][:8]}]" if ids else ""
        return record

    logging.setLogRecordFactory(factory)


def setup(verbosity: int = 0, stream: Any = None) -> None:
    global _VERBOSITY
    _VERBOSITY = verbosity
    _install_record_factory()
    logging.basicConfig(
        level=logging.DEBUG if verbosity > 0 else logging.INFO,
        stream=stream or sys.stderr,
        format="%(levelname).1s%(asctime)s %(name)s%(trace)s] %(message)s",
        datefmt="%m%d %H:%M:%S",
        force=True,
    )


def verbosity() -> int:
    return _VERBOSITY


def on_fatal(hook: Callable[[str], Any]) -> None:
    """Register a hook run (with the fatal message) before a fatal exit."""
    _fatal_hooks.append(hook)


def clear_fatal_hooks() -> None:
    _fatal_hooks.clear()


class Logger:
    """Thin wrapper adding ``.v(n)`` gated verbose logging."""

    def __init__(self, name: str) -> None:
        self._log = logging.getLogger(name)

    def info(self, msg: str, *args: object) -> None:
        self._log.info(msg, *args)

    def warning(self, msg: str, *args: object) -> None:
        self._log.warning(msg, *args)

    def error(self, msg: str, *args: object) -> None:
        self._log.error(msg, *args)

    def fatal(self, msg: str, *args: object) -> None:
        self._log.critical(msg, *args)
        rendered = msg % args if args else msg
        for hook in list(_fatal_hooks):
            try:
                hook(rendered)
            except Exception as e:  # noqa: BLE001 — dying anyway; best effort
                self._log.error("fatal hook failed: %s", e)
        raise SystemExit(255)

    def v(self, level: int, msg: str, *args: object) -> None:
        if _VERBOSITY >= level:
            self._log.debug(msg, *args)


def get_logger(name: str) -> Logger:
    return Logger(name)
