"""The port's interference plane without an engine
(gpushare_device_plugin_tpu_torch: ``utils/metric_catalog.py``,
``utils/metrics.py``, ``utils/tracing.py``, ``utils/slo.py``,
``serving/profiler.py``'s flush, ``serving/governor.py``) against the
reference's, on the CPU.

Every scenario runs the same calls on both sides (the same fake clock
and sleep where time matters) and the results must be exactly equal:
registry values and rendered text (sorted lines; exemplar trace ids are
random on each side and masked), quantiles, span trees, SLO verdicts,
page-hook calls and published gauges, and the governor's engage and
release ticks, throttled steps and sleep. The reference tests'
assertions (tests/test_metrics.py, tests/test_tracing.py,
tests/test_interference.py) then hold on the port's values.
"""

import json
import re
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from gpushare_device_plugin_tpu.serving import governor as JGov
from gpushare_device_plugin_tpu.serving import profiler as JProf
from gpushare_device_plugin_tpu.utils import metric_catalog as JCat
from gpushare_device_plugin_tpu.utils import metrics as JMet
from gpushare_device_plugin_tpu.utils import slo as JSlo
from gpushare_device_plugin_tpu.utils import tracing as JTr
from gpushare_device_plugin_tpu_torch.serving import governor as Gov
from gpushare_device_plugin_tpu_torch.serving import profiler as Prof
from gpushare_device_plugin_tpu_torch.utils import metric_catalog as Cat
from gpushare_device_plugin_tpu_torch.utils import metrics as Met
from gpushare_device_plugin_tpu_torch.utils import slo as Slo
from gpushare_device_plugin_tpu_torch.utils import tracing as Tr

REF = SimpleNamespace(met=JMet, tr=JTr, slo=JSlo, gov=JGov, prof=JProf, cat=JCat)
PORT = SimpleNamespace(met=Met, tr=Tr, slo=Slo, gov=Gov, prof=Prof, cat=Cat)
_EXEMPLAR = re.compile(r'# \{trace_id="[0-9a-f]{32}"\} (\S+) \S+$')


def _lines(text: str) -> list[str]:
    """Rendered exposition as sorted lines, with each exemplar's trace id
    and time masked (random and wall-clock on each side)."""
    return sorted(_EXEMPLAR.sub(r'# {trace_id="*"} \1 *', line) for line in text.splitlines())


def both(scenario):
    """Run ``scenario(side)`` on the reference and the port; the port's
    result must equal the reference's. Returns the port's."""
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


# --------------------------------------------------------------------------
# the catalog
# --------------------------------------------------------------------------


def test_catalog_families_are_the_references_letter_for_letter():
    assert len(Cat.CATALOG) == 58
    for name, spec in Cat.CATALOG.items():
        ref = JCat.CATALOG[name]
        assert (spec.name, spec.type, spec.labels) == (ref.name, ref.type, ref.labels)
    consts = {k: v for k, v in vars(Cat).items() if k.isupper() and isinstance(v, str)
              and v.startswith("tpushare_")}
    assert consts and all(getattr(JCat, k) == v for k, v in consts.items())
    assert "tpushare_allocate_total" in Cat.CATALOG  # the device plugin's own family
    assert "tpushare_extender_verb_total" not in Cat.CATALOG  # the cluster control plane's


def test_build_info_carries_a_subset_of_the_family_labels():
    reg = Met.MetricsRegistry()
    labels = Met.publish_build_info("engine", registry=reg)
    assert set(labels) < set(Cat.CATALOG[Cat.BUILD_INFO].labels)
    assert labels["component"] == "engine"
    from gpushare_device_plugin_tpu_torch import __version__

    assert labels["version"] == __version__
    assert reg.gauge_value(Cat.BUILD_INFO, **labels) == 1.0


# --------------------------------------------------------------------------
# the registry (tests/test_metrics.py)
# --------------------------------------------------------------------------


def _counters_and_gauges(side):
    r = side.met.MetricsRegistry()
    r.counter_inc("x_total", "things", outcome="ok")
    r.counter_inc("x_total", outcome="ok")
    r.counter_inc("x_total", outcome="err")
    r.counter_inc("x_total", value=2.5, outcome="err")
    r.gauge_set("y", 3.5, "level")
    r.gauge_set("y", -1.0, "level", pod="a")
    return (_lines(r.render()), _lines(r.render(openmetrics=True)),
            r.counter_value("x_total", outcome="err"), r.gauge_value("y", pod="a"),
            r.gauge_value("y", pod="nope"), sorted(r.gauge_series("y").items()))


def test_counter_and_gauge_render():
    text, om, err, ya, none, series = both(_counters_and_gauges)
    assert "# TYPE x_total counter" in text
    assert 'x_total{outcome="ok"} 2' in text and 'x_total{outcome="err"} 3.5' in text
    assert "# TYPE y gauge" in text and "y 3.5" in text
    assert "# TYPE x counter" in om and om[0] == "# EOF"
    assert (err, ya, none) == (3.5, -1.0, None) and len(series) == 2


def _histogram(side):
    r = side.met.MetricsRegistry()
    for s in (0.0004, 0.003, 0.3, 7.0):
        r.observe("lat_seconds", s, "latency", buckets=(0.001, 0.01, 1.0))
    r.observe("lat_seconds", 0.02, buckets=(0.001, 0.01, 1.0), verb="bind")
    return _lines(r.render()), r.histogram_stats("lat_seconds"), r.histogram_stats("nope")


def test_histogram_buckets_cumulative():
    text, stats, none = both(_histogram)
    for line in ('lat_seconds_bucket{le="0.001"} 1', 'lat_seconds_bucket{le="0.01"} 2',
                 'lat_seconds_bucket{le="1"} 3', 'lat_seconds_bucket{le="+Inf"} 4',
                 "lat_seconds_count 4", 'lat_seconds_count{verb="bind"} 1'):
        assert line in text
    assert stats[0] == 4 and stats[1] == pytest.approx(7.3034) and none == (0, 0.0)


def test_label_values_escaped():
    def run(side):
        r = side.met.MetricsRegistry()
        r.counter_inc("esc_total", "x", reason='say "hi"\nback\\slash')
        return next(line for line in r.render().splitlines() if line.startswith("esc_total"))

    assert both(run) == 'esc_total{reason="say \\"hi\\"\\nback\\\\slash"} 1'


_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL_VALUE = r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
_LABELS = rf"\{{{_NAME}={_LABEL_VALUE}(?:,{_NAME}={_LABEL_VALUE})*\}}"
_NUMBER = r"[+-]?(?:[0-9]*\.?[0-9]+(?:e[+-]?[0-9]+)?|Inf|NaN)"
_OM_EXEMPLAR = rf' # \{{trace_id="[0-9a-f]{{32}}"\}} {_NUMBER} {_NUMBER}'


def _strict_parse(text: str, openmetrics: bool = False) -> int:
    """Every line a HELP/TYPE comment, a sample (with an optional
    OpenMetrics exemplar) or the EOF terminator; returns the samples."""
    sample = re.compile(rf"^{_NAME}(?:{_LABELS})? {_NUMBER}"
                        + (rf"(?:{_OM_EXEMPLAR})?" if openmetrics else "") + "$")
    comment = re.compile(rf"^# (?:HELP|TYPE) {_NAME} .+$")
    samples = 0
    lines = text.splitlines()
    assert lines and text.endswith("\n")
    for i, line in enumerate(lines):
        if line == "# EOF":
            assert openmetrics and i == len(lines) - 1
            continue
        if line.startswith("#"):
            assert comment.match(line), line
            continue
        assert sample.match(line), line
        samples += 1
    return samples


def _exposition(side):
    r = side.met.MetricsRegistry()
    r.counter_inc("ops_total", "ops", outcome="ok", pod='we"ird\npod\\name')
    r.gauge_set("level", -3.5, "level")
    with side.tr.TRACER.span("scrape-span"):
        r.observe("lat_seconds", 0.003, "latency", buckets=(0.001, 0.01, 1.0))
    r.observe("lat_seconds", 99.0, "latency", buckets=(0.001, 0.01, 1.0))
    text, om = r.render(), r.render(openmetrics=True)
    return _strict_parse(text), _strict_parse(om, openmetrics=True), _lines(text), _lines(om)


def test_strict_parser_accepts_full_exposition():
    n_text, n_om, _, om = both(_exposition)
    assert n_text >= 8 and n_om >= 8
    assert any("# {trace_id=" in line for line in om)


def _exemplars(side):
    r = side.met.MetricsRegistry()
    with side.tr.TRACER.span("x") as sp:
        r.observe("h_seconds", 0.005, buckets=(0.001, 0.01, 1.0))
        r.observe("h_seconds", 50.0, buckets=(0.001, 0.01, 1.0))  # +Inf
    ex = r.exemplar("h_seconds")
    r2 = side.met.MetricsRegistry()
    r2.observe("h_seconds", 0.005, buckets=(0.001, 0.01, 1.0))
    return (sorted(ex), [ex[i][0] == sp.trace_id for i in sorted(ex)],
            [ex[i][1] for i in sorted(ex)], r2.exemplar("h_seconds"))


def test_exemplar_recorded_per_bucket():
    buckets, same_trace, values, outside = both(_exemplars)
    assert buckets == [1, 3] and all(same_trace) and values == [0.005, 50.0]
    assert outside == {}


def _quantiles(side):
    r = side.met.MetricsRegistry()
    out = [r.histogram_quantile("never_observed", 0.99)]
    r.observe("lat_seconds", 0.01, buckets=(0.001, 1.0), verb="bind")
    out.append(r.histogram_quantile("lat_seconds", 0.5, verb="filter"))
    for _ in range(10):
        r.observe("one_seconds", 0.0005, buckets=(0.001,))
    out += [r.histogram_quantile("one_seconds", q) for q in (0.5, 0.99)]
    r.observe("over_seconds", 5.0, buckets=(0.001,))
    out.append(r.histogram_quantile("over_seconds", 0.99))
    for _ in range(4):
        r.observe("tail_seconds", 0.5, buckets=(0.001, 0.01, 1.0))
    for v in (0.0002, 0.004, 0.004, 0.03, 0.2, 2.0):
        r.observe("mix_seconds", v, buckets=(0.001, 0.005, 0.05, 0.5, 1.0))
    out.append(r.histogram_quantile("tail_seconds", 0.5))
    out += [r.histogram_quantile("mix_seconds", q) for q in (0.1, 0.5, 0.9, 0.99)]
    return out


def test_histogram_quantiles_equal_the_reference():
    never, other, q50, q99, over, tail, *mix = both(_quantiles)
    assert never is None and other is None
    assert 0.0 < q50 <= q99 <= 0.001
    assert over == 0.001
    assert 0.01 <= tail <= 1.0
    assert mix == sorted(mix) and mix[-1] == 1.0


def test_registry_under_concurrent_writers_and_readers():
    r = Met.MetricsRegistry()
    n_writers, per_writer = 8, 300
    stop = threading.Event()
    reader_errors = []

    def writer(wi):
        for j in range(per_writer):
            r.counter_inc("storm_total", worker=str(wi))
            r.gauge_set("storm_gauge", float(j), worker=str(wi))
            r.observe("storm_seconds", 0.001 * (j % 7), buckets=(0.001, 0.01, 1.0),
                      worker=str(wi))

    def reader():
        while not stop.is_set():
            try:
                r.render()
                r.render(openmetrics=True)
                r.gauge_series("storm_gauge")
                r.histogram_quantile("storm_seconds", 0.99, worker="0")
            except Exception as e:  # noqa: BLE001 — the assertion
                reader_errors.append(repr(e))
                return

    writers = [threading.Thread(target=writer, args=(i,)) for i in range(n_writers)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    assert reader_errors == []
    for wi in range(n_writers):
        assert r.counter_value("storm_total", worker=str(wi)) == per_writer
        assert r.histogram_stats("storm_seconds", worker=str(wi))[0] == per_writer
    series = r.gauge_series("storm_gauge")
    assert len(series) == n_writers and all(v == per_writer - 1 for v in series.values())


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_metrics_server_endpoints():
    r = Met.MetricsRegistry()
    r.counter_inc("served_total", "hits")
    store = Tr.TraceStore()
    tracer = Tr.Tracer(store=store)
    ctx = tracer.record_span("serve.request", 100, 200, attributes={"rid": 7})
    tracer.record_span("serve.queue", 100, 120, parent=ctx)
    tracer.record_span("other", 1, 2)
    srv = Met.MetricsServer(registry=r, host="127.0.0.1", port=0, trace_store=store).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        code, ctype, body = _get(f"{url}/metrics")
        assert code == 200 and "served_total 1" in body
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        code, ctype, body = _get(f"{url}/metrics", accept="application/openmetrics-text")
        assert ctype.startswith("application/openmetrics-text; version=1.0.0")
        assert body.rstrip().endswith("# EOF")
        assert _get(f"{url}/healthz")[2] == "ok\n"
        assert _get(f"{url}/nope")[0] == 404
        assert _get(f"{url}/shards")[0] == 404  # cluster mode's: not ported
        code, ctype, body = _get(f"{url}/decisions")
        assert code == 200 and ctype == "application/json" and "records" in json.loads(body)
        assert _get(f"{url}/readyz")[0] == 200  # no ready_fn: always ready
        _, ctype, body = _get(f"{url}/traces?trace_id={ctx.trace_id}")
        assert ctype == "application/json"
        spans = JTr.spans_from_otlp(json.loads(body))  # the reference reads it
        assert sorted(s["name"] for s in spans) == ["serve.queue", "serve.request"]
        assert len(Tr.spans_from_otlp(json.loads(_get(f"{url}/traces")[2]))) == 3
    finally:
        srv.stop()


# --------------------------------------------------------------------------
# the tracer (tests/test_tracing.py, tests/test_interference.py:686)
# --------------------------------------------------------------------------


def _nesting(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    with t.span("root", attributes={"k": 1}) as root:
        current_is_root = t.current_span() is root
        with t.span("child") as child:
            linked = (child.trace_id == root.trace_id, child.parent_id == root.span_id)
    spans = t.store.trace(root.trace_id)
    return (current_is_root, linked, sorted(s.name for s in spans),
            all(s.end_ns >= s.start_ns for s in spans), t.current_span(),
            [(len(s.trace_id), len(s.span_id)) for s in spans])


def test_span_nesting_and_store():
    current, linked, names, ordered, after, widths = both(_nesting)
    assert current and linked == (True, True) and names == ["child", "root"]
    assert ordered and after is None and widths == [(32, 16), (32, 16)]


def _error_status(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    with pytest.raises(ValueError):
        with t.span("boom") as sp:
            raise ValueError("x")
    (span,) = t.store.trace(sp.trace_id)
    return span.status, span.attributes["error"]


def test_span_error_status():
    status, error = both(_error_status)
    assert status == "error" and "ValueError" in error


def _sampling_zero(side):
    t = side.tr.Tracer(store=side.tr.TraceStore(), sample_ratio=0.0)
    with t.span("x") as sp:
        noop = sp is side.tr.NOOP_SPAN
        sp.set_attribute("k", "v")
        sp.add_event("e")
    with t.span("root"):
        with t.span("child") as c:
            child_recording = c.recording
    starts = [t.start_span(f"s{i}") for i in range(3)]
    for s in starts:
        s.end()
    return (noop, child_recording, all(s is side.tr.NOOP_SPAN for s in starts),
            t.store.trace_ids(), t.record_span("x", 0, 1))


def test_sampling_zero_is_noop():
    noop, child_recording, all_noop, ids, recorded = both(_sampling_zero)
    assert noop and not child_recording and all_noop and ids == [] and recorded is None


def _child_only(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    with t.span("deep", child_only=True) as sp:
        alone = sp.recording
    ids = t.store.trace_ids()
    with t.span("root") as root:
        with t.span("deep", child_only=True) as sp:
            under = (sp.recording, sp.trace_id == root.trace_id)
    return alone, ids, under


def test_child_only_never_roots():
    assert both(_child_only) == (False, [], (True, True))


def _context_roundtrip(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    with t.span("x") as sp:
        ctx = sp.context()
    parsed = side.tr.parse_context(ctx.encode())
    bare = side.tr.parse_context(ctx.trace_id)
    return ((parsed.trace_id, parsed.span_id) == (ctx.trace_id, ctx.span_id),
            (bare.trace_id == ctx.trace_id, bare.span_id),
            [side.tr.parse_context(v) for v in ("", None, "garbage", "zz" * 16 + ":" + "ab" * 8)],
            side.tr.parse_context(ctx.trace_id + ":nothex").span_id)


def test_context_encode_parse_roundtrip():
    assert both(_context_roundtrip) == (True, (True, ""), [None] * 4, "")


def test_threads_have_independent_stacks():
    def run(side):
        t = side.tr.Tracer(store=side.tr.TraceStore())
        seen = {}
        with t.span("main-root"):
            th = threading.Thread(target=lambda: seen.update(cur=t.current_span()))
            th.start()
            th.join()
        return seen["cur"]

    assert both(run) is None


def _bounded_store(side):
    store = side.tr.TraceStore(max_traces=3)
    t = side.tr.Tracer(store=store)
    ids = []
    for i in range(5):
        with t.span(f"r{i}") as sp:
            ids.append(sp.trace_id)
    capped = side.tr.TraceStore(max_spans_per_trace=2)
    tc = side.tr.Tracer(store=capped)
    with tc.span("root") as root:
        for i in range(4):
            with tc.span(f"c{i}"):
                pass
    return (store.trace_ids() == ids[-3:], store.dropped(), len(capped.trace(root.trace_id)),
            [s.name for s in capped.trace(root.trace_id)])


def test_store_bounded_eviction_and_span_cap():
    assert both(_bounded_store) == (True, 2, 2, ["c0", "c1"])


def _record_span(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    ctx = t.record_span("serve.request", 100, 200, attributes={"rid": 7},
                        events=[("admitted", 150, {"slot": 1})], status="error")
    t.record_span("serve.queue", 100, 120, parent=ctx)
    unsampled = t.record_span("x", 1, 2, parent=side.tr.SpanContext("ab" * 16, "cd" * 8, False))
    spans = {s.name: s for s in t.store.trace(ctx.trace_id)}
    root, child = spans["serve.request"], spans["serve.queue"]
    return ((root.start_ns, root.end_ns, root.status, root.events, root.duration_ms),
            (child.parent_id == ctx.span_id, child.start_ns, child.end_ns), unsampled)


def test_record_span_explicit_timestamps():
    root, child, unsampled = both(_record_span)
    assert root == (100, 200, "error", [("admitted", 150, {"slot": 1})], 0.0001)
    assert child == (True, 100, 120) and unsampled is None


def _otlp(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    with t.span("root", attributes={"pod": "default/p", "n": 3, "ok": True, "f": 0.5}) as sp:
        sp.add_event("claimed", chip=2)
    doc = t.store.to_otlp()
    flat = side.tr.spans_from_otlp(doc)
    for span in flat:
        assert span.pop("trace_id") == sp.trace_id
        span.pop("span_id"), span.pop("start_ns"), span.pop("end_ns")
        span["events"][0].pop("time_ns")
    (rs,) = doc["resourceSpans"]
    return (rs["resource"]["attributes"], flat, side.tr.spans_from_otlp(
        t.store.to_otlp(trace_id="no-such")))


def test_otlp_export_shape_and_roundtrip():
    resource, flat, narrowed = both(_otlp)
    assert resource[0]["key"] == "service.name" and narrowed == []
    (span,) = flat
    assert span["name"] == "root" and span["attributes"] == {
        "pod": "default/p", "n": 3, "ok": True, "f": 0.5}
    assert span["events"] == [{"name": "claimed", "attributes": {"chip": 2}}]
    # each side's export reads back through the other's parser
    t = Tr.Tracer(store=Tr.TraceStore())
    with t.span("cross", attributes={"rid": 4}):
        pass
    (mine,) = JTr.spans_from_otlp(t.store.to_otlp())
    assert mine["name"] == "cross" and mine["attributes"] == {"rid": 4}


def test_trace_store_bounds_under_concurrent_writers():
    store = Tr.TraceStore(max_traces=32, max_spans_per_trace=8)
    n_threads, traces_per_thread, spans_per_trace = 8, 40, 12
    errors = []
    stop = threading.Event()

    def writer(tid):
        try:
            for t in range(traces_per_thread):
                trace_id = f"{tid:02d}{t:030d}"
                for s in range(spans_per_trace):
                    store.add(Tr.Span(f"op{s}", trace_id=trace_id,
                                      span_id=f"{tid:02d}{t:06d}{s:08d}"))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                store.trace_ids()
                store.snapshot()
                store.dropped()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(i,)) for i in range(n_threads)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for th in writers + readers:
        th.start()
    for th in writers:
        th.join(timeout=30)
    stop.set()
    for th in readers:
        th.join(timeout=10)
    assert errors == []
    ids = store.trace_ids()
    # each eviction is counted; a trace evicted while its writer still adds
    # spans comes back as a new trace and can be evicted again
    assert len(ids) <= 32 and store.dropped() >= n_threads * traces_per_thread - len(ids)
    assert all(len(spans) <= 8 for spans in store.snapshot().values())


def _tier_sampling(side):
    t = side.tr.Tracer(store=side.tr.TraceStore())
    t.configure(tier_ratios={"best_effort": 0.0})
    out = [t.record_span("serve.request", 0, 1, tier=tier) is None
           for tier in ("best_effort", "critical", None)]
    out += [t.tier_sample_ratio("best_effort"), t.tier_sample_ratio("critical"),
            t.tier_sample_ratio(None)]
    t.configure(tier_ratios={})
    out.append(t.record_span("serve.request", 0, 1, tier="best_effort") is None)
    t.configure(sample_ratio=0.0, tier_ratios={"critical": 1.0})
    out += [t.record_span("x", 0, 1, tier=tier) is None for tier in ("best_effort", "critical")]
    out.append(t.sample_ratio)
    return out


def test_tracer_per_tier_sampling_overrides():
    assert both(_tier_sampling) == [True, False, False, 0.0, 1.0, 1.0, False, True, False, 0.0]


def test_current_trace_ids_follow_the_process_tracer():
    assert Tr.current_trace_ids() is None
    with Tr.TRACER.span("outer") as sp:
        assert Tr.current_trace_ids() == (sp.trace_id, sp.span_id)
    assert Tr.current_trace_ids() is None


# --------------------------------------------------------------------------
# the step profiler's flush (tests/test_interference.py:195-262)
# --------------------------------------------------------------------------


def _flush(side):
    side.tr.STORE.clear()
    reg = side.met.MetricsRegistry()
    out = []
    prof = side.prof.StepProfiler(capacity=64)
    for _ in range(10):
        prof.record(0.002)
    out.append(prof.flush(reg, pod="ns/svc"))
    out.append(reg.histogram_stats(side.prof.STEP_METRIC, pod="ns/svc"))
    out.append((reg.gauge_value(side.prof.P50_GAUGE, pod="ns/svc"),
                reg.gauge_value(side.prof.P99_GAUGE, pod="ns/svc")))
    prof.record(0.004)
    out.append(prof.flush(reg, pod="ns/svc"))
    out.append(reg.histogram_stats(side.prof.STEP_METRIC, pod="ns/svc")[0])
    out.append(prof.flush(reg, pod="ns/svc"))  # nothing new
    lossy = side.prof.StepProfiler(capacity=4)
    for _ in range(10):
        lossy.record(0.001)
    out.append(lossy.flush(reg, pod="ns/x"))  # 6 of 10 fell off the ring
    out.append(reg.histogram_stats(side.prof.STEP_METRIC, pod="ns/x")[0])
    unlabeled = side.prof.StepProfiler(capacity=8)
    unlabeled.record(0.002)
    out.append(unlabeled.flush(reg))
    out.append((reg.histogram_stats(side.prof.STEP_METRIC), reg.gauge_value(side.prof.P99_GAUGE)))
    out.append(unlabeled.p99())
    unlabeled.record(0.004)
    out.append(unlabeled.flush(reg, pod="ns/y"))
    spans = [s for ss in side.tr.STORE.snapshot().values() for s in ss
             if s.name == "serve.step_flush"]
    out.append(sorted(tuple(sorted(s.attributes.items())) for s in spans)[-3:])
    out.append(bool(reg.exemplar(side.prof.STEP_METRIC, pod="ns/svc")))
    out.append(_lines(reg.render()))
    side.tr.STORE.clear()
    return out


def test_profiler_flush_equals_the_reference():
    side_out = both(_flush)
    (n1, stats, gauges, n2, count, n3, lossy, lossy_count, unlabeled, unlabeled_reg, p99,
     later, spans, exemplar, _) = side_out
    assert (n1, stats[0], n2, count, n3) == (10, 10, 1, 11, 0)
    assert stats[1] == pytest.approx(0.020) and gauges == (0.002, 0.002)
    assert (lossy, lossy_count) == (4, 4)
    assert unlabeled == 0 and unlabeled_reg == ((0, 0.0), None) and p99 == 0.002
    assert later == 1 and exemplar
    assert (("dropped", 6), ("steps", 4)) in spans


def test_profiler_constants_equal_the_reference():
    assert (Prof.STEP_METRIC, Prof.P50_GAUGE, Prof.P99_GAUGE, Prof.STEP_HELP,
            Prof.STEP_BUCKETS) == (JProf.STEP_METRIC, JProf.P50_GAUGE, JProf.P99_GAUGE,
                                   JProf.STEP_HELP, JProf.STEP_BUCKETS)


# --------------------------------------------------------------------------
# SLO budgets (tests/test_interference.py:295-379, :821, :838)
# --------------------------------------------------------------------------


def _budget(side, t, goal=0.99, fired=None, **kw):
    return side.slo.SloBudget(
        {"critical": side.slo.SloObjective(tier="critical", goal=goal)},
        clock=lambda: t[0],
        on_page=None if fired is None else (lambda tier, v: fired.append((tier, v.to_dict()))),
        **kw,
    )


def _verdict(b, **kw):
    return {tier: v.to_dict() for tier, v in b.evaluate(**kw).items()}


def _slo_clean(side):
    t = [0.0]
    b = _budget(side, t)
    for _ in range(100):
        b.record("critical", True)
    return _verdict(b)


def _slo_page_episodes(side):
    t, fired = [0.0], []
    b = _budget(side, t, fired=fired)
    out = []
    for i in range(100):
        b.record("critical", i % 5 != 0)  # 20% misses over a 1% budget: burn 20
    out += [_verdict(b), list(fired)]
    b.evaluate()
    out.append(len(fired))  # still paging: no second call
    t[0] += 400.0  # the 5 m window clears
    for _ in range(50):
        b.record("critical", True)
    out.append(_verdict(b))
    t[0] += 30000.0  # everything expires
    for i in range(100):
        b.record("critical", i % 5 != 0)
    out += [_verdict(b), fired]
    return out


def _slo_warn(side):
    t = [0.0]
    b = _budget(side, t)
    for i in range(100):
        b.record("critical", i >= 8)  # burn 8: above warn, below page
    return _verdict(b)


def _slo_expiry(side):
    t = [0.0]
    b = _budget(side, t)
    for _ in range(50):
        b.record("critical", False)
    out = [_verdict(b)]
    for when in (400.0, 4000.0, 30000.0):
        t[0] = when
        out.append(_verdict(b))
    return out


def _slo_publish(side):
    t = [0.0]
    b = _budget(side, t)
    reg = side.met.MetricsRegistry()
    for _ in range(10):
        b.record("critical", False)
    b.publish(reg)
    b.publish(reg, pod="ns/svc")
    return _lines(reg.render())


def _slo_undeclared(side):
    t = [0.0]
    b = side.slo.SloBudget({"critical": side.slo.SloObjective(tier="critical", goal=0.95)},
                           clock=lambda: t[0])
    for _ in range(50):
        b.record("best_effort", False)
    auto = side.slo.SloBudget(clock=lambda: t[0])
    auto.record("anything", False)
    return _verdict(b), b.severity("best_effort"), _verdict(auto)


def _slo_severity_cache(side):
    t, fired = [0.0], []
    b = _budget(side, t, fired=fired)
    out = [b.severity("critical")]
    for _ in range(20):
        b.record("critical", False)
    out += [b.severity("critical"), len(fired), b.severity("critical"), len(fired)]
    t[0] = 400.0
    out.append(b.severity("critical"))
    b.set_on_page(None)
    t[0] = 30000.0
    for _ in range(20):
        b.record("critical", False)
    out += [b.severity("critical"), len(fired), b.severity("nope")]
    return out


def _slo_burn_sequence(side):
    """A budget at goal 0.95 fed bursts at 1 s steps, polled as the
    governor polls it: the severity after every record."""
    t, fired = [0.0], []
    b = _budget(side, t, goal=0.95, fired=fired, bucket_s=1.0)
    out = []
    for i in range(900):
        t[0] = float(i)
        b.record("critical", not (100 <= i < 420 or 600 <= i < 620))
        out.append(b.severity("critical"))
    return out, fired


SLO_SCENARIOS = {
    "clean": _slo_clean, "page_episodes": _slo_page_episodes, "warn": _slo_warn,
    "expiry": _slo_expiry, "publish": _slo_publish, "undeclared": _slo_undeclared,
    "severity_cache": _slo_severity_cache, "burn_sequence": _slo_burn_sequence,
}


@pytest.mark.parametrize("name", list(SLO_SCENARIOS))
def test_slo_budget_equals_the_reference(name):
    got = both(SLO_SCENARIOS[name])
    if name == "clean":
        v = got["critical"]
        assert v["severity"] is None and v["burn_5m"] == 0.0 and v["budget_remaining"] == 1.0
    if name == "page_episodes":
        first, fired_once, n_after, recovered, second, fired = got
        assert first["critical"]["severity"] == "page" and first["critical"]["burn_5m"] == 20.0
        assert first["critical"]["budget_remaining"] == 0.0 and len(fired_once) == 1
        assert n_after == 1 and recovered["critical"]["severity"] != "page"
        assert second["critical"]["severity"] == "page" and [f[0] for f in fired] == ["critical"] * 2
    if name == "warn":
        assert got["critical"]["burn_6h"] == 8.0 and got["critical"]["severity"] == "warn"
    if name == "expiry":
        assert [v["critical"]["severity"] for v in got] == ["page", "warn", None, None]
        assert got[1]["critical"]["burn_5m"] == 0.0
        assert got[-1]["critical"]["requests_6h"] == 0 and got[-1]["critical"]["budget_remaining"] == 1.0
    if name == "publish":
        assert 'tpushare_slo_burn_rate{tier="critical",window="5m"} 100' in got
        assert 'tpushare_slo_severity{tier="critical"} 2' in got
        assert 'tpushare_slo_error_budget_remaining{tier="critical"} 0' in got
        assert 'tpushare_slo_severity{pod="ns/svc",tier="critical"} 2' in got
    if name == "undeclared":
        verdicts, sev, auto = got
        assert "best_effort" not in verdicts and sev is None
        assert auto["anything"]["requests_6h"] == 1
    if name == "severity_cache":
        assert got == [None, "page", 1, "page", 1, "warn", "page", 1, None]
    if name == "burn_sequence":
        sev, fired = got
        assert "page" in sev and sev[-1] == "warn" and len(fired) == 1


def test_slo_objective_rejects_degenerate_goal():
    for side in (REF, PORT):
        with pytest.raises(ValueError):
            side.slo.SloObjective(tier="t", goal=1.0)
        with pytest.raises(ValueError):
            side.slo.SloBudget(bucket_s=0.0)


# --------------------------------------------------------------------------
# the governor (tests/test_interference.py:404-495)
# --------------------------------------------------------------------------


class _FakeTime:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _governor(side, burn_fn, ft, **kw):
    kw.setdefault("registry", side.met.MetricsRegistry())
    return side.gov.StepGovernor(burn_fn, clock=ft.clock, sleep=ft.sleep, **kw)


def _gov_engage(side):
    ft, severity = _FakeTime(), ["page"]
    reg = side.met.MetricsRegistry()
    gov = _governor(side, lambda: severity[0], ft, throttled_steps_per_s=10.0, burst=1.0,
                    poll_interval_steps=1, release_after=2, pod="ns/be", registry=reg)
    out = [gov.before_step(), gov.engaged, gov.engagements, gov.before_step(),
           gov.throttled_steps, gov.stats()]
    return out, _lines(reg.render()), ft.sleeps


def _gov_sustained(side):
    ft = _FakeTime()
    gov = _governor(side, lambda: "page", ft, throttled_steps_per_s=2.0, burst=1.0,
                    poll_interval_steps=1, release_after=10)
    return [gov.before_step() for _ in range(10)], ft.t, gov.stats()


def _gov_hysteresis(side):
    ft, severity = _FakeTime(), ["page"]
    gov = _governor(side, lambda: severity[0], ft, throttled_steps_per_s=100.0,
                    poll_interval_steps=1, release_after=3)
    out = [gov.before_step(), gov.engaged]
    for s in (None, None, None, "page", None, "page", None, None, None):
        severity[0] = s
        gov.poll()
        out.append((gov.engaged, gov.engagements))
    return out, gov.stats()


def _gov_warn(side):
    ft = _FakeTime()
    gov = _governor(side, lambda: "warn", ft, poll_interval_steps=1)
    out = [gov.before_step() for _ in range(5)] + [gov.engaged]
    eager = _governor(side, lambda: "warn", ft, poll_interval_steps=1, engage_on="warn")
    eager.before_step()
    return out + [eager.engaged, eager.stats()]


def _gov_fast_path(side):
    ft, polls = _FakeTime(), [0]

    def burn():
        polls[0] += 1

    gov = _governor(side, burn, ft, poll_interval_steps=4)
    return [gov.before_step() for _ in range(16)], polls[0], ft.sleeps


def _gov_burn_sequence(side):
    """A scripted burn signal against dispatches 30 ms apart: the tick of
    every engage and release, the sleep before each dispatch, and the
    counters the governor published."""
    ft = _FakeTime()
    reg = side.met.MetricsRegistry()
    script = [None] * 20 + ["page"] * 40 + ["warn"] * 10 + [None] * 30 + ["page"] * 5 + [None] * 40
    tick = [0]
    gov = _governor(side, lambda: script[min(tick[0], len(script) - 1)], ft,
                    throttled_steps_per_s=25.0, burst=0.5, poll_interval_steps=2,
                    release_after=4, pod="ns/be", registry=reg)
    trace = []
    for tick[0] in range(len(script)):
        was = gov.engaged
        slept = gov.before_step()
        ft.t += 0.03
        trace.append((tick[0], gov.engaged != was, round(slept, 12)))
    return trace, gov.stats(), _lines(reg.render())


GOVERNOR_SCENARIOS = {
    "engage": _gov_engage, "sustained": _gov_sustained, "hysteresis": _gov_hysteresis,
    "warn": _gov_warn, "fast_path": _gov_fast_path, "burn_sequence": _gov_burn_sequence,
}


@pytest.mark.parametrize("name", list(GOVERNOR_SCENARIOS))
def test_governor_equals_the_reference(name):
    got = both(GOVERNOR_SCENARIOS[name])
    if name == "engage":
        (first, engaged, engagements, second, throttled, stats), text, sleeps = got
        assert first == pytest.approx(0.1) and second == pytest.approx(0.1)
        assert engaged and engagements == 1 and throttled == 2
        assert 'tpushare_governor_engaged{pod="ns/be"} 1' in text
        assert 'tpushare_governor_engagements_total{pod="ns/be"} 1' in text
        assert 'tpushare_governor_throttled_steps_total{pod="ns/be"} 2' in text
        assert stats["throttle_seconds"] == pytest.approx(0.2) and len(sleeps) == 2
    if name == "sustained":
        _, elapsed, stats = got
        assert 4.0 <= elapsed <= 5.5 and stats["throttled_steps"] == 10
    if name == "hysteresis":
        seq, _ = got
        assert seq[1] and [e for e, _ in seq[2:]] == [True, True, False, True, True, True,
                                                      True, True, False]
        assert seq[-1][1] == 2
    if name == "warn":
        assert got[:6] == [0.0] * 5 + [False] and got[6]
    if name == "fast_path":
        slept, polls, sleeps = got
        assert slept == [0.0] * 16 and polls == 4 and sleeps == []
    if name == "burn_sequence":
        trace, stats, text = got
        flips = [t for t, flipped, _ in trace if flipped]
        assert len(flips) >= 3 and stats["engagements"] == 2
        assert stats["throttled_steps"] > 0 and not stats["engaged"]
        assert any(line.startswith("tpushare_governor_throttle_seconds_total") for line in text)


def test_governor_rejects_bad_parameters():
    for bad in (dict(throttled_steps_per_s=0.0), dict(burst=0.0), dict(poll_interval_steps=0),
                dict(release_after=0)):
        msgs = []
        for side in (REF, PORT):
            with pytest.raises(ValueError) as err:
                side.gov.StepGovernor(lambda: None, registry=side.met.MetricsRegistry(), **bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_governor_spans_mark_engage_and_release():
    ft = _FakeTime()
    severity = ["page"]
    Tr.STORE.clear()
    gov = Gov.StepGovernor(lambda: severity[0], poll_interval_steps=1, release_after=1,
                           pod="ns/be", registry=Met.MetricsRegistry(), clock=ft.clock,
                           sleep=ft.sleep)
    gov.before_step()
    severity[0] = None
    gov.poll()
    spans = [s for ss in Tr.STORE.snapshot().values() for s in ss]
    Tr.STORE.clear()
    names = [s.name for s in spans]
    assert names == ["governor.engage", "governor.release"]
    assert spans[0].attributes == {"severity": "page", "pod": "ns/be",
                                   "throttled_steps_per_s": 20.0}
