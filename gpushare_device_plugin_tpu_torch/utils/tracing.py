"""Zero-dependency tracing for the serving path, OpenTelemetry-shaped.

Counterpart of ``gpushare_device_plugin_tpu/utils/tracing.py`` (the
pod's half; the extender's ``AdmissionTraces`` stays with the control
plane):

- :class:`Span` / :class:`SpanContext`: one timed operation with a
  128-bit trace id, a 64-bit span id, a parent link, attributes and
  events.
- :class:`Tracer`: creates spans. A per-thread stack parents nested
  ``with TRACER.span(...)`` blocks; sampling is decided once per root
  (``sample_ratio``, or a tier's own ratio) and inherited by children.
  An unsampled span is one shared no-op object, so the unsampled path
  generates no ids and appends nothing.
- :class:`TraceStore`: a bounded ring of finished spans keyed by trace
  id, exported as OTLP-JSON (:meth:`TraceStore.to_otlp`) on the metrics
  server's ``/traces``.

The serving engine builds each request's spans at retire time from
timestamps it already keeps (:meth:`Tracer.record_span`), so the decode
loop pays nothing for tracing.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Iterator

STATUS_OK = "ok"
STATUS_ERROR = "error"


class SpanContext:
    """Immutable (trace id, span id, sampled) triple: what crosses a
    process boundary."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def encode(self) -> str:
        """Wire form: ``<trace_id>:<span_id>``."""
        return f"{self.trace_id}:{self.span_id}"

    def __repr__(self) -> str:
        return f"SpanContext({self.trace_id}, {self.span_id})"


def parse_context(value: str | None) -> SpanContext | None:
    """Parse the wire form; a bare trace id keeps the trace, and garbage
    gives None (the value is user-writable: a garbled one must only break
    stitching)."""
    if not value:
        return None
    head, _, tail = value.partition(":")
    trace_id = head.strip()
    span_id = tail.strip()
    if not _is_hex(trace_id, 32):
        return None
    if span_id and not _is_hex(span_id, 16):
        span_id = ""
    return SpanContext(trace_id, span_id, sampled=True)


def _is_hex(s: str, width: int) -> bool:
    if len(s) != width:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


# Ids need uniqueness, not cryptographic strength: one PRNG seeded from the
# OS once, and getrandbits is a single C call.
_ID_RNG = random.Random(os.urandom(16))


def _new_trace_id() -> str:
    return f"{_ID_RNG.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64):016x}"


class Span:
    """One timed operation. Mutation methods are no-ops on a span that
    does not record, so call sites never branch on sampling."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "attributes", "events", "status", "_recording", "_store",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str = "",
        start_ns: int | None = None,
        attributes: dict[str, Any] | None = None,
        recording: bool = True,
        store: "TraceStore | None" = None,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.time_ns() if start_ns is None else start_ns
        self.end_ns = 0
        self.attributes: dict[str, Any] = dict(attributes or {})
        self.events: list[tuple[str, int, dict[str, Any]]] = []
        self.status = STATUS_OK
        self._recording = recording
        self._store = store

    @property
    def recording(self) -> bool:
        return self._recording

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, sampled=self._recording)

    def set_attribute(self, key: str, value: Any) -> None:
        if self._recording:
            self.attributes[key] = value

    def add_event(self, name: str, **attributes: Any) -> None:
        if self._recording:
            self.events.append((name, time.time_ns(), dict(attributes)))

    def end(self, status: str | None = None, end_ns: int | None = None) -> None:
        """Finish the span (idempotent) and hand it to the store."""
        if not self._recording or self.end_ns:
            return
        if status is not None:
            self.status = status
        self.end_ns = time.time_ns() if end_ns is None else end_ns
        if self._store is not None:
            self._store.add(self)

    @property
    def duration_ms(self) -> float:
        if not self.end_ns:
            return 0.0
        return (self.end_ns - self.start_ns) / 1e6

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "status": self.status,
            "attributes": dict(self.attributes),
            "events": [{"name": n, "time_ns": t, "attributes": a} for n, t, a in self.events],
        }


class _NoopSpan(Span):
    """The shared span of unsampled work: every method returns at once."""

    def __init__(self) -> None:
        super().__init__("noop", "", "", recording=False)

    def end(self, status: str | None = None, end_ns: int | None = None) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class TraceStore:
    """Bounded ring of finished spans keyed by trace id. Insertion order
    is eviction order: past ``max_traces`` the oldest trace goes whole,
    and a trace keeps at most ``max_spans_per_trace`` spans."""

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512) -> None:
        self._lock = threading.Lock()
        self._max_traces = max_traces
        self._max_spans = max_spans_per_trace
        self._traces: OrderedDict[str, list[Span]] = OrderedDict()
        self._dropped = 0

    def add(self, span: Span) -> None:
        if not span.trace_id:
            return
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = []
                self._traces[span.trace_id] = spans
                while len(self._traces) > self._max_traces:
                    self._traces.popitem(last=False)
                    self._dropped += 1
            if len(spans) < self._max_spans:
                spans.append(span)

    def trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def snapshot(self) -> dict[str, list[Span]]:
        with self._lock:
            return {tid: list(spans) for tid, spans in self._traces.items()}

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._dropped = 0

    def to_otlp(self, trace_id: str | None = None, service: str = "tpushare") -> dict[str, Any]:
        """OTLP/JSON-shaped export (the ``/traces`` body): the
        ``resourceSpans`` / ``scopeSpans`` / ``spans`` nesting an OTLP
        consumer expects."""
        if trace_id is not None:
            spans = self.trace(trace_id)
        else:
            spans = [s for ss in self.snapshot().values() for s in ss]
        return {
            "resourceSpans": [{
                "resource": {"attributes": [_otlp_attr("service.name", service)]},
                "scopeSpans": [{
                    "scope": {"name": "gpushare_device_plugin_tpu_torch.tracing"},
                    "spans": [_otlp_span(s) for s in spans],
                }],
            }]
        }


def _otlp_attr(key: str, value: Any) -> dict[str, Any]:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def _otlp_span(span: Span) -> dict[str, Any]:
    return {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "parentSpanId": span.parent_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(span.start_ns),
        "endTimeUnixNano": str(span.end_ns),
        "attributes": [_otlp_attr(k, v) for k, v in span.attributes.items()],
        "events": [
            {"timeUnixNano": str(t), "name": n,
             "attributes": [_otlp_attr(k, v) for k, v in a.items()]}
            for n, t, a in span.events
        ],
        "status": {"code": 2 if span.status == STATUS_ERROR else 1},
    }


def _otlp_value(value: dict[str, Any]) -> Any:
    for k in ("stringValue", "boolValue", "doubleValue"):
        if k in value:
            return value[k]
    if "intValue" in value:
        try:
            return int(value["intValue"])
        except (TypeError, ValueError):
            return value["intValue"]
    return None


def _otlp_attrs(attrs) -> dict[str, Any]:
    return {a["key"]: _otlp_value(a.get("value", {})) for a in attrs if "key" in a}


def spans_from_otlp(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """Flatten an OTLP-JSON document back to the flat-dict span form of
    :meth:`Span.to_dict`."""
    out: list[dict[str, Any]] = []
    for rs in doc.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            for sp in ss.get("spans", ()):
                out.append({
                    "trace_id": sp.get("traceId", ""),
                    "span_id": sp.get("spanId", ""),
                    "parent_id": sp.get("parentSpanId", ""),
                    "name": sp.get("name", ""),
                    "start_ns": int(sp.get("startTimeUnixNano", 0) or 0),
                    "end_ns": int(sp.get("endTimeUnixNano", 0) or 0),
                    "status": STATUS_ERROR if sp.get("status", {}).get("code") == 2 else STATUS_OK,
                    "attributes": _otlp_attrs(sp.get("attributes", ())),
                    "events": [
                        {"name": e.get("name", ""),
                         "time_ns": int(e.get("timeUnixNano", 0) or 0),
                         "attributes": _otlp_attrs(e.get("attributes", ()))}
                        for e in sp.get("events", ())
                    ],
                })
    return out


class Tracer:
    """Creates spans against one store with one sampling policy, and
    keeps a span stack per thread."""

    def __init__(self, store: TraceStore | None = None, sample_ratio: float = 1.0) -> None:
        self._store = store if store is not None else TraceStore()
        self._ratio = float(sample_ratio)
        # per-tier overrides of the root sampling ratio; tiers not listed
        # take the default
        self._tier_ratios: dict[str, float] = {}
        self._tls = threading.local()

    @property
    def store(self) -> TraceStore:
        return self._store

    @property
    def sample_ratio(self) -> float:
        return self._ratio

    def tier_sample_ratio(self, tier: str | None) -> float:
        """The root sampling ratio for ``tier`` (the default ratio for a
        tier without an override, or None)."""
        if tier is None:
            return self._ratio
        return self._tier_ratios.get(tier, self._ratio)

    def configure(self, sample_ratio: float | None = None,
                  tier_ratios: dict[str, float] | None = None) -> None:
        """Change the default ratio and/or replace the per-tier table
        (``{}`` clears it)."""
        if sample_ratio is not None:
            self._ratio = float(sample_ratio)
        if tier_ratios is not None:
            self._tier_ratios = {str(t): float(r) for t, r in tier_ratios.items()}

    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def current_span(self) -> Span | None:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        return stack[-1]

    def current_context(self) -> SpanContext | None:
        """The innermost recording span's context, or None: what
        histogram exemplars stamp."""
        span = self.current_span()
        if span is None or not span.recording:
            return None
        return span.context()

    def _sampled_root(self, tier: str | None = None) -> bool:
        ratio = self.tier_sample_ratio(tier)
        if ratio >= 1.0:
            return True
        if ratio <= 0.0:
            return False
        return random.random() < ratio

    def start_span(self, name: str, parent: SpanContext | Span | None = None,
                   attributes: dict[str, Any] | None = None,
                   child_only: bool = False) -> Span:
        """Create a span under ``parent`` (a Span or a SpanContext), else
        under the thread's current span, else as a new root. A
        ``child_only`` span never starts a trace: without a recording
        parent it is the no-op span. The caller must end the span; prefer
        :meth:`span`."""
        if isinstance(parent, Span):
            if not parent.recording:
                return NOOP_SPAN
            parent = parent.context()
        if parent is None:
            cur = self.current_span()
            if cur is not None:
                # an unsampled root's decision holds for its whole stack
                if not cur.recording:
                    return NOOP_SPAN
                parent = cur.context()
            elif child_only:
                return NOOP_SPAN
        if parent is not None:
            if not parent.sampled:
                return NOOP_SPAN
            return Span(name, trace_id=parent.trace_id, span_id=_new_span_id(),
                        parent_id=parent.span_id, attributes=attributes, store=self._store)
        if not self._sampled_root():
            return NOOP_SPAN
        return Span(name, trace_id=_new_trace_id(), span_id=_new_span_id(),
                    attributes=attributes, store=self._store)

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | Span | None = None,
             attributes: dict[str, Any] | None = None,
             child_only: bool = False) -> Iterator[Span]:
        """``with TRACER.span("serve.step_flush") as sp:``: the span is the
        thread's current one inside the block, ends on exit, and is marked
        ``error`` with the exception's repr when the body raises."""
        sp = self.start_span(name, parent=parent, attributes=attributes,
                             child_only=child_only)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set_attribute("error", repr(e))
            sp.end(STATUS_ERROR)
            raise
        finally:
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:
                stack.remove(sp)
        sp.end()

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    parent: SpanContext | None = None,
                    attributes: dict[str, Any] | None = None, status: str = STATUS_OK,
                    events: list[tuple[str, int, dict[str, Any]]] | None = None,
                    tier: str | None = None) -> SpanContext | None:
        """Create an already finished span from explicit timestamps (the
        engine rebuilds each request's timeline at retire). Returns its
        context for children, or None when unsampled. ``tier`` picks a
        per-tier root ratio when this span starts a trace."""
        if parent is None:
            if not self._sampled_root(tier):
                return None
            trace_id = _new_trace_id()
            parent_id = ""
        else:
            if not parent.sampled:
                return None
            trace_id = parent.trace_id
            parent_id = parent.span_id
        sp = Span(name, trace_id=trace_id, span_id=_new_span_id(), parent_id=parent_id,
                  start_ns=start_ns, attributes=attributes, store=self._store)
        if events:
            sp.events.extend(events)
        sp.status = status
        sp.end_ns = end_ns
        self._store.add(sp)
        return sp.context()


# One store and one tracer per process, as the metrics REGISTRY.
STORE = TraceStore()
TRACER = Tracer(store=STORE)


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the innermost recording span on this
    thread, or None: the exemplar hook of the metrics registry."""
    ctx = TRACER.current_context()
    if ctx is None:
        return None
    return ctx.trace_id, ctx.span_id
