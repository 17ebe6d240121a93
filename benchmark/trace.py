"""The profiled stretch of a ``--trace 1`` run, reduced from its Chrome trace.

The stretch records the device's activity alone (kernels, copies, sets);
the device is busy where at least one runs (the union of their intervals).
The idle gaps are the spaces between busy intervals, each named by what
the engine's thread was doing at its start, from the benchmark's own
record of the window's dispatches on the trace's clock (Unix time): inside
a step program's call (``bench.prefill``, ``bench.extend``,
``bench.decode``: the host launching its kernels) or in the engine loop
between dispatches (admission, page grants, the copy of sampled tokens).
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(path: str, window_s: float, host_spans: list[tuple[int, int, str]]) -> dict:
    """``busy_s`` (device-op union, seconds), ``window_s``, each device
    operation's seconds by name (``kernel_s``), and the ``breakdown``: the
    ten device operations that took most time and the host activities
    under which the device sat idle longest (summed over their gaps)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    dev = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    kernel_s: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        kernel_s[name] += (b - a) / 1e6
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    # the dispatches on the trace's microsecond scale
    spans = sorted(((a - base) / 1e3, (b - base) / 1e3, name) for a, b, name in host_spans)
    starts = [s[0] for s in spans]
    idle: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, g0) - 1
        label = "engine loop between dispatches"
        if i >= 0 and spans[i][0] <= g0 < spans[i][1]:
            label = f"{spans[i][2]} (host launching)"
        idle[label] += (g1 - g0) / 1e6
        count[label] += 1
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernel_s": dict(kernel_s),
        "kernels": len(dev),
        "breakdown": {
            "device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[f"{name} ({count[name]} gaps)", s] for name, s in gaps],
        },
    }


def reduce_and_remove(path: str, window_s: float, host_spans) -> dict:
    try:
        return reduce(path, window_s, host_spans)
    finally:
        os.remove(path)
