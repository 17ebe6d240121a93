"""The inspect CLI and the kubelet pod dump, the port against the reference.

The reference's ``tests/test_inspect_cli.py`` (goldens included) runs on
each package through ``torch_cluster_mirror``, and what each run printed
must be byte-equal, with the same apiserver traffic. Its ``shards`` and
``fleet`` cases run on the port's own ``MetricsServer`` and its
``/shards`` and ``/fleet`` routes. The ``why``, ``timeline``,
``trace`` and ``flightrecord`` views are held to the reference's goldens,
then driven end to end through both packages' CLIs against the port's
own endpoints and dumps, whose renders must be byte-equal.
"""

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from gpushare_device_plugin_tpu import const as JConst
from gpushare_device_plugin_tpu.cli import display as JDisp
from gpushare_device_plugin_tpu.cli import inspect as JInspect
from gpushare_device_plugin_tpu.cli import podgetter as JPodgetter
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.cli import display as TDisp
from gpushare_device_plugin_tpu_torch.cli import inspect as TInspect
from gpushare_device_plugin_tpu_torch.cli import podgetter as TPodgetter
from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
from gpushare_device_plugin_tpu_torch.utils import decisions, flightrec, timeline, tracing
from gpushare_device_plugin_tpu_torch.utils.log import get_logger
from gpushare_device_plugin_tpu_torch.utils.metrics import MetricsRegistry, MetricsServer

import fake_apiserver
from fake_apiserver import FakeApiServer
from k8s_fixtures import make_pod
from torch_cluster_mirror import REF, _FastServer, cases, load, mirror_case

ROOT = Path(__file__).resolve().parents[1]

INSPECT = [
    "test_pod_allocation_priority",
    "test_build_node_infos_and_unit",
    "test_cli_summary_end_to_end",
    "test_cli_details_and_node_filter",
    "test_cli_json_output",
    "test_cli_json_empty_cluster",
    "test_cli_no_shared_nodes",
    "test_cli_unknown_node_errors",
    "test_core_holds_in_summary_and_details",
    "test_no_core_holds_keeps_reference_layout",
    "test_parse_engine_metrics_real_exposition",
    "test_cli_details_serving_cache_column",
    "test_cli_serving_cache_matches_bare_pod_name",
    "test_cli_json_serving_cache",
    "test_parse_engine_metrics_spec_families_fold_in",
    "test_cli_details_spec_summary_in_serving_cache_cell",
    "test_cli_json_speculative_subdoc",
    "test_cli_json_no_spec_families_no_speculative_key",
    "test_parse_engine_metrics_adapter_families_fold_in",
    "test_cli_details_adapters_column",
    "test_cli_details_no_adapter_families_no_column",
    "test_cli_json_adapters_subdoc",
    "test_cli_no_metrics_url_keeps_reference_layout",
    "test_cli_summary_moves_column_and_stranded_markers",
    "test_cli_details_stranded_and_moves_lines",
    "test_cli_json_defrag_doc",
    "test_cli_no_defrag_keeps_reference_layout",
    "test_cli_garbled_defrag_annotation_ignored",
    "test_cli_partially_garbled_defrag_annotation_degrades",
    "test_cli_details_class_column_and_interference",
    "test_cli_no_class_keeps_reference_layout",
    "test_cli_json_class_and_interference",
    "test_cli_garbled_interference_annotation_ignored",
    "test_parse_observability_metrics_real_exposition",
    "test_render_top_golden",
    "test_cli_top_end_to_end",
    "test_render_shards_golden",
    "test_render_shards_empty",
    "test_cli_shards_end_to_end",
    "test_cli_shards_requires_url",
    "test_fetch_shards_dedupes_replica_gangs",
    "test_parse_engine_metrics_folds_handoff_families",
    "test_cli_details_tier_column",
    "test_cli_no_tier_keeps_reference_layout",
    "test_cli_details_handoff_counters",
    "test_cli_json_tier_and_handoff",
    "test_render_why_two_tier_group_golden",
    "test_render_fleet_golden",
    "test_render_fleet_empty",
    "test_cli_fleet_end_to_end",
    "test_cli_fleet_requires_url",
    "test_fetch_fleet_merges_replica_rows",
    "test_parse_engine_metrics_folds_fleet_router_families",
]


@pytest.fixture(autouse=True)
def _fast_apiserver_teardown(monkeypatch):
    monkeypatch.setattr(fake_apiserver, "ThreadingHTTPServer", _FastServer)


@pytest.mark.parametrize("name, params", cases("test_inspect_cli", INSPECT))
def test_inspect_cli_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_inspect_cli", name, params, tmp_path_factory,
                compare=("servers", "allocations", "output"))


def test_every_reference_inspect_test_is_mirrored():
    mod = load("test_inspect_cli", REF)
    assert sorted(INSPECT) == sorted(n for n in vars(mod) if n.startswith("test_"))


# --- the why, timeline and trace views on the reference's goldens ------------


def _golden(test_file, name):
    return getattr(load(test_file, REF), name)


@pytest.mark.parametrize("view", ["why", "timeline", "trace", "trace_orphans", "sparkline"])
def test_view_renders_the_references_golden(view):
    if view == "why":
        records = _golden("test_decisions", "WHY_RECORDS")
        got = TDisp.render_why("default/p1", records)
        assert got == _golden("test_decisions", "WHY_GOLDEN")
        assert TDisp.render_why("default/p3", []) == JDisp.render_why("default/p3", [])
    elif view == "timeline":
        doc = _golden("test_decisions", "TIMELINE_DOC")
        assert TDisp.render_timeline(doc) == _golden("test_decisions", "TIMELINE_GOLDEN")
        assert TDisp.render_timeline({"series": {}}) == JDisp.render_timeline({"series": {}})
    elif view == "trace":
        spans = _golden("test_trace_pipeline", "GOLDEN_SPANS")
        assert TDisp.render_trace(spans) == _golden("test_trace_pipeline", "GOLDEN")
    elif view == "trace_orphans":
        spans = _golden("test_trace_pipeline", "GOLDEN_SPANS")
        orphan = [dict(spans[3], parent_id="missing")]
        assert TDisp.render_trace(orphan) == JDisp.render_trace(orphan)
        assert TDisp.render_trace([]) == "(no spans)\n"
    else:
        for values, width in (([], 48), ([1.0, 1.0, 1.0], 48), (list(range(100)), 10)):
            assert TDisp.sparkline(values, width) == JDisp.sparkline(values, width)


# --- both CLIs end to end on the port's endpoints ----------------------------


def _run(cli, argv):
    """``cli.main(argv)`` -> (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv, monkeypatch, client=None):
    """The reference's and the port's CLI on the same argv; their exit
    codes and stdout must be equal, -> the port's (rc, stdout, stderr)."""
    if client is not None:
        monkeypatch.setattr(JInspect, "_client", lambda *a, **k: client)
        monkeypatch.setattr(TInspect, "_client", lambda *a, **k: client)
    ref, port = _run(JInspect, argv), _run(TInspect, argv)
    assert port[:2] == ref[:2], (ref, port)
    return port


@pytest.fixture
def port_server():
    """The port's metrics server over fresh stores (a registry, a trace
    store, a decision log and a timeline of its own)."""
    store = tracing.TraceStore()
    log = decisions.DecisionLog()
    ring = timeline.ClusterTimeline(bucket_s=10.0, buckets=60)
    srv = MetricsServer(MetricsRegistry(), host="127.0.0.1", port=0, trace_store=store,
                        decisions=log, timeline=ring).start()
    try:
        yield srv, store, log, ring
    finally:
        srv.stop()


def test_timeline_view_of_a_port_daemons_ring(port_server, monkeypatch):
    srv, _store, _log, ring = port_server
    url = f"http://127.0.0.1:{srv.port}"
    assert _both(["timeline"], monkeypatch)[0] == 1  # no --timeline-url
    for i, util in enumerate((10.0, 40.0, 95.0)):
        ring.sample(now=1000.0 + 10.0 * i, util_pct=util, pending_pods=float(i))
    rc, out, _ = _both(["timeline", "--timeline-url", url], monkeypatch)
    assert rc == 0 and "util_pct" in out and "pending_pods" in out and "n=3" in out
    rc, out, _ = _both(["timeline", "--timeline-url", url, "-o", "json"], monkeypatch)
    assert json.loads(out)["series"]["util_pct"][-1][1] == 95.0


def test_why_view_of_a_port_daemons_decisions(port_server, monkeypatch):
    srv, _store, log, _ring = port_server
    url = f"http://127.0.0.1:{srv.port}"
    assert _both(["why", "default/p1"], monkeypatch)[0] == 1  # no --decisions-url
    assert _both(["why", "default/p1", "--decisions-url", url], monkeypatch)[0] == 1
    log.emit("default/p1", "allocate", node="node-a", candidates=2,
             placement={"chip": 0, "units": 4}, trace_id="ab" * 16, seq=7)
    log.emit("", "defrag_plan", node="node-a", placement={"quantum": 4, "stranded_units": 2,
             "stranded_pct": 6.25, "planned_moves": []}, moves=["default/p1"])
    rc, out, _ = _both(["why", "default/p1", "--decisions-url", url], monkeypatch)
    assert rc == 0 and "allocate" in out and "wal seq 7" in out


def test_trace_view_of_port_spans(port_server, monkeypatch):
    srv, store, _log, _ring = port_server
    tracer = tracing.Tracer(store=store)
    with tracer.span("admission", attributes={"pod": "default/p1"}) as root:
        with tracer.span("plugin.allocate", attributes={"resource": "aliyun.com/tpu-mem"}):
            with tracer.span("pod.patch"):
                pass
    api = FakeApiServer()
    api.add_node("node-a")
    api.add_pod(make_pod("p1", 4, node="node-a",
                         annotations={const.ANN_TRACE_ID: root.context().encode()}))
    api.add_pod(make_pod("bare", 4, node="node-a"))
    api.start()
    try:
        client = ApiServerClient(api.url)
        url = f"http://127.0.0.1:{srv.port}"
        assert _both(["trace", "default/bare", "--traces-url", url], monkeypatch, client)[0] == 1
        assert _both(["trace", "default/p1"], monkeypatch, client)[0] == 1
        rc, out, _ = _both(["trace", "default/p1", "--traces-url", url], monkeypatch, client)
        assert rc == 0 and out.startswith(f"pod default/p1\ntrace {root.trace_id}\nadmission")
        assert "└─ plugin.allocate" in out and "pod.patch" in out
        rc, out, _ = _both(["trace", "default/p1", "--traces-url", url, "-o", "json"],
                           monkeypatch, client)
        assert {s["name"] for s in json.loads(out)} == {"admission", "plugin.allocate",
                                                         "pod.patch"}
    finally:
        api.stop()


def test_flightrecord_view_of_a_port_dump(tmp_path, monkeypatch):
    store = tracing.TraceStore()
    tracer = tracing.Tracer(store=store)
    recorder = flightrec.FlightRecorder(store=store)
    recorder.install(str(tmp_path))
    try:
        with tracer.span("admission", attributes={"pod": "default/p9"}):
            get_logger("test").warning("card pressure")
        path = recorder.dump("unit-test")
    finally:
        recorder.uninstall()
    rc, out, _ = _both(["flightrecord", path], monkeypatch)
    assert rc == 0 and "reason=unit-test" in out and "admission" in out
    assert "card pressure" in out
    rc, out, _ = _both(["flightrecord", path, "-o", "json"], monkeypatch)
    assert json.loads(out)["reason"] == "unit-test"
    assert _both(["flightrecord", str(tmp_path / "nope.json")], monkeypatch)[0] == 1


def test_unreachable_endpoint_warns_and_renders_the_rest(port_server, monkeypatch):
    srv, _store, _log, ring = port_server
    ring.sample(now=1000.0, util_pct=50.0)
    dead = "http://127.0.0.1:9"  # discard port: nothing listens
    rc, out, err = _both(["timeline", "--timeline-url", dead, "--timeline-url",
                          f"http://127.0.0.1:{srv.port}"], monkeypatch)
    assert rc == 0 and "util_pct" in out
    assert err.startswith(f"warning: {dead}/timeline unreachable: ")


# --- the kubelet pod dump ----------------------------------------------------


def test_podgetter_dumps_the_kubelets_pods_as_the_reference_does():
    pods = [make_pod("p1", 2, node="node-a"), make_pod("p2", 4, node="node-a")]

    class Kubelet(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"items": pods}).encode()
            self.send_response(200 if self.path == "/pods/" else 404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Kubelet)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.02},
                              daemon=True)
    thread.start()
    try:
        argv = ["--kubelet-address", "127.0.0.1", "--kubelet-port", str(srv.server_port),
                "--scheme", "http", "--token", "t"]
        ref, port = _run(JPodgetter, argv), _run(TPodgetter, argv)
        assert port == ref and port[0] == 0
        assert json.loads(port[1]) == {"items": pods}
    finally:
        srv.shutdown()
        srv.server_close()
    rc, out, err = _run(TPodgetter, ["--kubelet-address", "127.0.0.1", "--kubelet-port", "9",
                                     "--scheme", "http", "--token", "t", "--timeout", "2"])
    assert rc == 1 and out == "" and err.startswith("error: kubelet query failed: ")


def test_console_scripts_name_the_ports_entry_points():
    text = (ROOT / "pyproject.toml").read_text()
    for line in ('kubectl-inspect-gpushare-cuda = "gpushare_device_plugin_tpu_torch.cli.inspect:main"',
                 'gpushare-podgetter-cuda = "gpushare_device_plugin_tpu_torch.cli.podgetter:main"',
                 'gpushare-device-plugin-cuda = "gpushare_device_plugin_tpu_torch.cli.daemon:main"'):
        assert line in text, line
    assert const.ANN_EXTENDER_ALLOCATION == JConst.ANN_EXTENDER_ALLOCATION
