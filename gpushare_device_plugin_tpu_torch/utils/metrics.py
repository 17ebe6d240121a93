"""Prometheus-exposition metrics for a serving pod (stdlib only).

Counterpart of ``gpushare_device_plugin_tpu/utils/metrics.py``, cut to
what a pod and the node agent export: :class:`MetricsRegistry`
(counters, gauges and fixed-bucket histograms with a trace-id exemplar
per bucket), the process-wide :data:`REGISTRY`, :func:`publish_build_info`,
and :class:`MetricsServer` with the endpoints: ``/metrics`` (text format
0.0.4, or OpenMetrics with exemplars when the scraper asks for it),
``/traces`` (OTLP-JSON from the trace store), ``/decisions``,
``/timeline``, ``/healthz`` and ``/readyz``. The reference's ``/shards``
and ``/fleet`` routes come with the scheduler extender.

One lock per registry; every write is one dict update under it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator
from urllib.parse import parse_qs, urlparse

from . import tracing
from .lockrank import make_lock
from .metric_catalog import BUILD_INFO as BUILD_INFO_GAUGE

# Latency buckets (seconds): 0.5 ms .. 10 s, roughly log-spaced.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)


def _escape_label_value(value: str) -> str:
    """Text-format label-value escaping: backslash, double quote and
    newline, or a scraper misreads the line."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels) + "}"


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = make_lock("metrics.registry")
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        # name -> (buckets, {labels -> [counts..., sum, count]})
        self._hists: dict[str, tuple[tuple[float, ...], dict]] = {}
        self._help: dict[str, tuple[str, str]] = {}  # name -> (type, help)
        # (name, labels) -> {bucket index -> (trace_id, value, unix ts)};
        # index len(buckets) is +Inf. Recorded when an observation happens
        # inside a sampled span; rendered in the OpenMetrics exposition.
        self._exemplars: dict[tuple[str, tuple], dict[int, tuple[str, float, float]]] = {}

    def _describe(self, name: str, mtype: str, help_text: str) -> None:
        self._help.setdefault(name, (mtype, help_text))

    def counter_inc(self, name: str, help_text: str = "", value: float = 1.0,
                    **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._describe(name, "counter", help_text)
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, help_text: str = "", **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._describe(name, "gauge", help_text)
            self._gauges[key] = float(value)

    def observe(self, name: str, seconds: float, help_text: str = "",
                buckets: tuple[float, ...] = DEFAULT_BUCKETS, **labels: str) -> None:
        lkey = tuple(sorted(labels.items()))
        ids = tracing.current_trace_ids()  # outside the lock
        with self._lock:
            self._describe(name, "histogram", help_text)
            bks, series = self._hists.setdefault(name, (buckets, {}))
            row = series.setdefault(lkey, [0] * len(bks) + [0.0, 0])
            bucket_i = len(bks)  # +Inf unless a finite bucket catches it
            for i, b in enumerate(bks):
                if seconds <= b:
                    row[i] += 1
                    bucket_i = min(bucket_i, i)
            row[-2] += seconds
            row[-1] += 1
            if ids is not None:
                self._exemplars.setdefault((name, lkey), {})[bucket_i] = (
                    ids[0], seconds, time.time(),
                )

    # --- programmatic readers ----------------------------------------------

    def counter_value(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key, 0.0)

    def gauge_value(self, name: str, **labels: str) -> float | None:
        """One labeled gauge's value; None when never set."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._gauges.get(key)

    def gauge_series(self, name: str) -> dict[tuple[tuple[str, str], ...], float]:
        """Every labeled series of one gauge family: sorted labels -> value."""
        with self._lock:
            return {labels: val for (n, labels), val in self._gauges.items() if n == name}

    def histogram_stats(self, name: str, **labels: str) -> tuple[int, float]:
        """(observation count, sum) of one labeled series; (0, 0.0) when
        never observed."""
        lkey = tuple(sorted(labels.items()))
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                return 0, 0.0
            row = hist[1].get(lkey)
            if row is None:
                return 0, 0.0
            return row[-1], row[-2]

    def histogram_quantile(self, name: str, q: float, **labels: str) -> float | None:
        """Approximate quantile from the fixed buckets, linear inside the
        winning bucket as PromQL's ``histogram_quantile``; None without
        observations."""
        lkey = tuple(sorted(labels.items()))
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                return None
            bks, series = hist
            row = series.get(lkey)
            if row is None or row[-1] == 0:
                return None
            rank = q * row[-1]
            prev_count, prev_bound = 0, 0.0
            for i, bound in enumerate(bks):
                if row[i] >= rank:
                    in_bucket = row[i] - prev_count
                    if in_bucket <= 0:
                        return bound
                    frac = (rank - prev_count) / in_bucket
                    return prev_bound + (bound - prev_bound) * frac
                prev_count, prev_bound = row[i], bound
            return bks[-1]  # past the last bucket: clamp, as PromQL does

    def exemplar(self, name: str, **labels: str) -> dict[int, tuple[str, float, float]]:
        """Bucket index -> (trace_id, value, ts) exemplars of one series."""
        lkey = tuple(sorted(labels.items()))
        with self._lock:
            return dict(self._exemplars.get((name, lkey), {}))

    def render(self, openmetrics: bool = False) -> str:
        """The text exposition: format 0.0.4 by default; with
        ``openmetrics=True`` the same families with exemplars on the
        histogram bucket lines and the ``# EOF`` terminator."""
        out: list[str] = []
        with self._lock:
            seen: set[str] = set()

            def header(name: str):
                if name in seen:
                    return
                seen.add(name)
                mtype, help_text = self._help.get(name, ("untyped", ""))
                if openmetrics and mtype == "untyped":
                    mtype = "unknown"
                family = name
                if openmetrics and mtype == "counter" and name.endswith("_total"):
                    # OpenMetrics names a counter family without _total
                    family = name[: -len("_total")]
                if help_text:
                    out.append(f"# HELP {family} {help_text}")
                out.append(f"# TYPE {family} {mtype}")

            for (name, labels), val in sorted(self._counters.items()):
                header(name)
                out.append(f"{name}{_fmt_labels(labels)} {val:g}")
            for (name, labels), val in sorted(self._gauges.items()):
                header(name)
                out.append(f"{name}{_fmt_labels(labels)} {val:g}")
            for name, (bks, series) in sorted(self._hists.items()):
                header(name)
                for lkey, row in sorted(series.items()):
                    exemplars = self._exemplars.get((name, lkey), {}) if openmetrics else {}

                    def _ex(i: int) -> str:
                        ex = exemplars.get(i)
                        if ex is None:
                            return ""
                        tid, value, ts = ex
                        return f' # {{trace_id="{tid}"}} {value:g} {ts:.3f}'

                    for i, b in enumerate(bks):
                        lbl = _fmt_labels(lkey + (("le", f"{b:g}"),))
                        out.append(f"{name}_bucket{lbl} {row[i]}{_ex(i)}")
                    lbl = _fmt_labels(lkey + (("le", "+Inf"),))
                    out.append(f"{name}_bucket{lbl} {row[-1]}{_ex(len(bks))}")
                    out.append(f"{name}_sum{_fmt_labels(lkey)} {row[-2]:g}")
                    out.append(f"{name}_count{_fmt_labels(lkey)} {row[-1]}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


# The process-wide registry every engine of the pod publishes to.
REGISTRY = MetricsRegistry()

_BUILD_FACTS: dict[str, str] | None = None


def _build_facts() -> dict[str, str]:
    global _BUILD_FACTS
    if _BUILD_FACTS is None:
        import os
        import platform

        from .. import __version__

        _BUILD_FACTS = {
            "version": __version__,
            "git_rev": os.environ.get("TPUSHARE_GIT_REV", "unknown"),
            "python": platform.python_version(),
        }
    return _BUILD_FACTS


def publish_build_info(component: str, registry: MetricsRegistry | None = None) -> dict[str, str]:
    """Export the ``tpushare_build_info`` gauge (value 1; the facts ride
    the labels) for one component: the port's version, the git revision
    baked into the image (``TPUSHARE_GIT_REV``) and python's version.
    The port carries no ``jax`` label, a subset of the family's labels.
    Returns the label set."""
    labels = {"component": component, **_build_facts()}
    (registry or REGISTRY).gauge_set(
        BUILD_INFO_GAUGE, 1.0,
        "Build/runtime identity (value is always 1; the labels carry "
        "version, git revision and python version)",
        **labels,
    )
    return labels


# Lock waits are microseconds when healthy: the default latency buckets
# start too coarse to see them.
LOCK_WAIT_BUCKETS = (
    0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
)


@contextlib.contextmanager
def timed_acquire(
    mutex: Any, name: str, help_text: str = "",
    registry: MetricsRegistry | None = None, **labels: str,
) -> Iterator[Any]:
    """``with timed_acquire(mutex, metric):`` acquires ``mutex`` and
    records the time spent waiting for it (not the hold time) in a
    histogram: a healthy sharded hot path shows near-zero waits. (The
    first parameter is not named ``lock``, so a ``lock=...`` label can
    pass through ``**labels``.)"""
    t0 = time.perf_counter()
    mutex.acquire()
    (registry or REGISTRY).observe(
        name, time.perf_counter() - t0, help_text,
        buckets=LOCK_WAIT_BUCKETS, **labels,
    )
    try:
        yield mutex
    finally:
        mutex.release()


class MetricsServer:
    """The HTTP endpoint: ``/metrics`` (text format 0.0.4, or OpenMetrics
    when the ``Accept`` header names ``application/openmetrics-text``),
    ``/traces`` (the trace store as OTLP-JSON; ``?trace_id=`` narrows to
    one trace), ``/decisions`` (the decision-provenance ring as JSON;
    ``?pod=ns/name`` and ``?verb=`` narrow), ``/timeline`` (the
    cluster-state timeline ring), ``/shards`` (the shard router's shard
    map: ring ownership, each shard's WAL seq and queue depth, the 2PC
    gangs in flight; what ``inspect shards`` fetches) when
    ``shards_doc_fn`` is wired, 404 otherwise, ``/fleet`` (the fleet
    router's replica map, outcomes, scale state and prefix-hit ratio; what
    ``inspect fleet`` fetches) when ``fleet_doc_fn`` is wired, 404
    otherwise, ``/healthz`` (liveness: 200 while the server thread runs)
    and ``/readyz``, which consults ``ready_fn``: 200 when it returns
    truthy, 503 otherwise (the extender's probe gates on informer sync and
    WAL replay, the daemon's on plugin registration)."""

    def __init__(self, registry: MetricsRegistry = REGISTRY, host: str = "0.0.0.0",
                 port: int = 0, trace_store: "tracing.TraceStore | None" = None,
                 decisions: Any = None, timeline: Any = None,
                 ready_fn: Callable[[], bool] | None = None,
                 shards_doc_fn: Callable[[], dict] | None = None,
                 fleet_doc_fn: Callable[[], dict] | None = None) -> None:
        self._registry = registry
        self._host = host
        self._port = port
        self._store = trace_store if trace_store is not None else tracing.STORE
        if decisions is None:
            from .decisions import DECISIONS

            decisions = DECISIONS
        self._decisions = decisions
        if timeline is None:
            from .timeline import TIMELINE

            timeline = TIMELINE
        self._timeline = timeline
        self._ready_fn = ready_fn
        self._shards_doc_fn = shards_doc_fn
        self._fleet_doc_fn = fleet_doc_fn
        self._server: ThreadingHTTPServer | None = None

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def start(self) -> "MetricsServer":
        registry = self._registry
        store = self._store
        decisions = self._decisions
        timeline = self._timeline
        ready_fn = self._ready_fn
        shards_doc_fn = self._shards_doc_fn
        fleet_doc_fn = self._fleet_doc_fn

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: object) -> None:
                pass

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                url = urlparse(self.path)
                if url.path == "/metrics":
                    openmetrics = "application/openmetrics-text" in self.headers.get("Accept", "")
                    body = registry.render(openmetrics=openmetrics).encode()
                    ctype = ("application/openmetrics-text; version=1.0.0; charset=utf-8"
                             if openmetrics else "text/plain; version=0.0.4; charset=utf-8")
                    self._reply(200, ctype, body)
                elif url.path == "/traces":
                    tid = (parse_qs(url.query).get("trace_id") or [None])[0]
                    self._reply(200, "application/json",
                                json.dumps(store.to_otlp(trace_id=tid)).encode())
                elif url.path == "/decisions":
                    q = parse_qs(url.query)
                    doc = decisions.to_doc(pod=(q.get("pod") or [None])[0],
                                           verb=(q.get("verb") or [None])[0])
                    self._reply(200, "application/json", json.dumps(doc).encode())
                elif url.path == "/timeline":
                    self._reply(200, "application/json",
                                json.dumps(timeline.to_doc()).encode())
                elif url.path == "/shards" and shards_doc_fn is not None:
                    self._reply(200, "application/json", json.dumps(shards_doc_fn()).encode())
                elif url.path == "/fleet" and fleet_doc_fn is not None:
                    self._reply(200, "application/json", json.dumps(fleet_doc_fn()).encode())
                elif url.path == "/healthz":
                    self._reply(200, "text/plain", b"ok\n")
                elif url.path == "/readyz":
                    try:
                        ready = ready_fn is None or bool(ready_fn())
                    except Exception:  # noqa: BLE001 — not ready, not dead
                        ready = False
                    self._reply(200 if ready else 503, "text/plain",
                                b"ok\n" if ready else b"not ready\n")
                else:
                    self._reply(404, "text/plain", b"not found\n")

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True, name="metrics").start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
