"""All-thread stack dump: what SIGQUIT writes.

Counterpart of ``gpushare_device_plugin_tpu/utils/stacktrace.py``, copied
(upstream: ``coredump.go:10-30`` and its SIGQUIT wiring). Upstream grows a
buffer around ``runtime.Stack(all=true)`` and writes
``/etc/kubernetes/go_<ts>.txt``; Python gives the same through
``sys._current_frames``.
"""

from __future__ import annotations

import sys
import time
import traceback
from threading import enumerate as all_threads


def stack_trace() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in all_threads()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)


def coredump(dir_path: str = "/etc/kubernetes") -> str:
    path = f"{dir_path}/tpushare_{int(time.time())}.txt"
    with open(path, "w") as f:
        f.write(stack_trace())
    return path
