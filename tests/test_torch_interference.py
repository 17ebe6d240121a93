"""The interference detector and the node's loops, the port against the
reference.

The reference's ``tests/test_interference.py`` runs on each package
through ``torch_cluster_mirror`` (the extender's usage index each
package's own), and the wire records
(the interference node annotation among them) must be equal. Then the
port's pieces meet the reference's across the wire: each package's
``step_p99s_from_urls`` scrapes the other's ``/metrics``, each reads
the other's interference annotation, and the port's lifecycle runs the
defrag, interference and timeline loops in cluster mode, moving a pod off
a fragmented card and publishing what the inspect CLI renders.
"""

import json
import time

import pytest

from gpushare_device_plugin_tpu.cli import daemon as JDaemon
from gpushare_device_plugin_tpu.cluster import interference as JI
from gpushare_device_plugin_tpu.manager import lifecycle as JLife
from gpushare_device_plugin_tpu.serving.profiler import StepProfiler as JStepProfiler
from gpushare_device_plugin_tpu.utils.metrics import MetricsRegistry as JRegistry
from gpushare_device_plugin_tpu.utils.metrics import MetricsServer as JServer
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator import defrag as TD
from gpushare_device_plugin_tpu_torch.cli import daemon as TDaemon
from gpushare_device_plugin_tpu_torch.cluster import interference as TI
from gpushare_device_plugin_tpu_torch.cluster import pods as P
from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource
from gpushare_device_plugin_tpu_torch.discovery import MockBackend
from gpushare_device_plugin_tpu_torch.manager import lifecycle as TLife
from gpushare_device_plugin_tpu_torch.serving.profiler import StepProfiler
from gpushare_device_plugin_tpu_torch.utils.metrics import MetricsRegistry, MetricsServer
from gpushare_device_plugin_tpu_torch.utils.timeline import TIMELINE

import fake_apiserver
from fake_apiserver import FakeApiServer
from k8s_fixtures import assigned_running_pod
from torch_cluster_mirror import _FastServer, cases, mirror_case

INTERFERENCE = [
    "test_workload_class_normalization",
    "test_node_chip_usage_residency_incremental",
    "test_node_chip_usage_residency_gang_spreads",
    "test_workload_class_index_buckets",
    "test_cluster_usage_index_chip_classes",
    "test_residency_from_pods_matches_index",
    "test_env_builders_inject_workload_class",
    "test_pod_env_reads_workload_class",
    "test_profiler_rolling_quantiles_and_ring_bound",
    "test_profiler_tokens_per_step_weights_speculative_rounds",
    "test_profiler_flush_exports_histogram_and_gauges",
    "test_profiler_flush_skips_samples_lost_to_the_ring",
    "test_profiler_flush_without_pod_label_exports_nothing",
    "test_slo_budget_clean_traffic_no_severity",
    "test_slo_budget_page_and_hook_once_per_episode",
    "test_slo_budget_warn_between_thresholds",
    "test_slo_budget_windows_expire",
    "test_slo_budget_publish_gauges",
    "test_slo_objective_rejects_degenerate_goal",
    "test_governor_engages_on_page_and_throttles",
    "test_governor_sustained_rate_converges",
    "test_governor_hysteretic_release",
    "test_governor_warn_does_not_engage_by_default",
    "test_governor_released_fast_path_costs_nothing",
    "test_detector_baseline_then_ratio_and_flag",
    "test_detector_best_effort_victim_not_reported",
    "test_detector_gang_victim_solo_only_when_every_chip_exclusive",
    "test_detector_bare_pod_name_fallback",
    "test_interference_annotation_roundtrip_and_garbling",
    "test_interference_loop_run_once_publishes_annotation",
    "test_interference_loop_publish_failure_is_swallowed",
    "test_tracer_per_tier_sampling_overrides",
    "test_flightrec_rotation_keeps_newest",
    "test_flightrec_rotation_never_deletes_the_fresh_dump",
    "test_flightrec_rotation_disabled_with_zero",
    "test_detector_cooldown_rejects_post_episode_inflated_baseline",
    "test_interference_loop_prefers_maintained_residency_index",
    "test_interference_parse_keeps_time_unix",
    "test_slo_budget_drops_undeclared_tiers_when_configured",
    "test_slo_severity_single_tier_cached_and_fresh",
    "test_detector_prunes_departed_pods_after_grace",
    "test_governor_sub_unit_burst_never_banks_a_free_dispatch",
    "test_step_p99s_from_urls_scrapes_live_endpoint",
    "test_interference_loop_scrape_urls_beat_registry",
    "test_detector_signal_loss_keeps_last_ratio_until_pair_departs",
]

LC, BE = const.WORKLOAD_LATENCY_CRITICAL, const.WORKLOAD_BEST_EFFORT
LOOP_FLAGS = ("defrag_interval", "defrag_quantum", "defrag_max_moves", "interference_interval",
              "interference_threshold", "interference_scrape_url", "timeline_interval")


@pytest.fixture(autouse=True)
def _fast_apiserver_teardown(monkeypatch):
    monkeypatch.setattr(fake_apiserver, "ThreadingHTTPServer", _FastServer)


@pytest.mark.parametrize("name, params", cases("test_interference", INTERFERENCE))
def test_interference_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_interference", name, params, tmp_path_factory)


# --- across the wire ---------------------------------------------------------


@pytest.mark.parametrize("server", ["port", "ref"])
def test_each_package_scrapes_the_others_step_p99s(server):
    """A pod's ``/metrics`` served by one package, scraped by both
    packages' ``step_p99s_from_urls``: the same p99s, and an unreachable
    endpoint is skipped by both."""
    if server == "port":
        reg, prof, Server = MetricsRegistry(), StepProfiler(), MetricsServer
    else:
        reg, prof, Server = JRegistry(), JStepProfiler(), JServer
    for s in (0.0042, 0.0031, 0.0057):
        prof.record(s)
    prof.flush(reg, pod="default/svc")
    srv = Server(reg, host="127.0.0.1", port=0).start()
    try:
        urls = ["http://127.0.0.1:9/", f"http://127.0.0.1:{srv.port}"]
        got = TI.step_p99s_from_urls(urls, timeout_s=2.0)
        assert got == JI.step_p99s_from_urls(urls, timeout_s=2.0)
        assert got == {"default/svc": pytest.approx(0.0057)}
    finally:
        srv.stop()


def test_each_package_reads_the_others_interference_annotation():
    """The same residency and step p99s through each package's detector:
    equal reports, equal gauges, and each package's annotation read back
    by the other's ``interference_from_node`` as by its own."""
    residencies = [
        ({0: {"ns/svc": LC}, 1: {"ns/lora": BE}}, {"ns/svc": 0.002, "ns/lora": 0.01}),
        ({0: {"ns/svc": LC}, 1: {"ns/lora": BE}}, {"ns/svc": 0.002, "ns/lora": 0.01}),
        ({0: {"ns/svc": LC, "ns/lora": BE}}, {"ns/svc": 0.005, "ns/lora": 0.01}),
    ]
    docs = {}
    for side, mod, Reg in (("port", TI, MetricsRegistry), ("ref", JI, JRegistry)):
        reg = Reg()
        det = mod.InterferenceDetector(threshold=1.25, registry=reg)
        for residency, p99 in residencies:
            reports = det.observe(residency, p99)
        assert [r.to_dict() for r in reports] == [{
            "victim": "ns/svc", "victim_class": LC, "aggressors": ["ns/lora"], "ratio": 2.5,
            "victim_p99_s": 0.005, "baseline_p99_s": 0.002, "flagged": True}]
        assert reg.gauge_value("tpushare_interference_ratio", chip="0", victim="ns/svc",
                               aggressor="ns/lora") == pytest.approx(2.5)
        docs[side] = json.dumps(det.annotation_doc(now_unix=1700000000.0), sort_keys=True)
    assert docs["port"] == docs["ref"]
    node = {"metadata": {"annotations": {const.ANN_INTERFERENCE: docs["ref"]}}}
    assert TI.interference_from_node(node) == JI.interference_from_node(node)
    assert TI.interference_from_node(node)["chips"]["0"]["flagged"] is True


def test_residency_from_pods_is_the_references():
    pods = [
        assigned_running_pod("svc", 8, chip_idx=0),
        assigned_running_pod("lora", 4, chip_idx=0,
                             annotations={const.ANN_WORKLOAD_CLASS: " best-effort "}),
        assigned_running_pod("other", 4, chip_idx=1),
    ]
    got = TI.residency_from_pods(pods)
    assert got == JI.residency_from_pods(pods)
    assert got == {0: {"default/svc": LC, "default/lora": BE}, 1: {"default/other": LC}}


def test_the_daemons_loop_flags_and_config_are_the_references():
    def defaults(mod):
        parser = mod.build_parser()
        return {a.dest: a.default for a in parser._actions if a.dest in LOOP_FLAGS}

    assert defaults(TDaemon) == defaults(JDaemon) and len(defaults(TDaemon)) == len(LOOP_FLAGS)
    fields = ("interference_interval_s", "interference_threshold", "interference_scrape_urls",
              "defrag_interval_s", "defrag_quantum", "defrag_max_moves", "timeline_interval_s")
    port, ref = TLife.ManagerConfig(), JLife.ManagerConfig()
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    args = TDaemon.build_parser().parse_args([
        "--defrag-interval", "2", "--defrag-quantum", "4", "--defrag-max-moves", "3",
        "--interference-interval", "1.5", "--interference-threshold", "1.5",
        "--interference-scrape-url", "http://a:1", "--interference-scrape-url", "http://b:2",
        "--timeline-interval", "0.5"])
    assert (args.defrag_interval, args.defrag_quantum, args.defrag_max_moves,
            args.interference_interval, args.interference_threshold,
            args.interference_scrape_url, args.timeline_interval) == (
        2.0, 4, 3, 1.5, 1.5, ["http://a:1", "http://b:2"], 0.5)


# --- the lifecycle runs the node's loops -------------------------------------


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError("timed out")


def test_the_lifecycle_runs_the_nodes_loops(tmp_path):
    """Cluster mode with every loop on: the defrag loop moves the 8-unit
    pod off card 2 onto card 0's 8-unit sliver through the WAL and the
    patch pipeline and publishes its status, the interference loop
    publishes its annotation, the timeline samples utilization, and
    ``_stop_all`` stops all three."""
    node = "node-loops"
    api = FakeApiServer()
    api.add_node(node)
    for name, units, chip in (("a", 24, 0), ("b", 24, 1), ("c", 8, 2)):
        api.add_pod(assigned_running_pod(name, units, chip_idx=chip, node=node))
    api.start()
    client = ApiServerClient(api.url)
    cfg = TLife.ManagerConfig(
        plugin_dir=str(tmp_path), node_name=node, checkpoint_path=str(tmp_path / "wal.ckpt"),
        reconcile_interval_s=0, defrag_interval_s=0.2, interference_interval_s=0.2,
        timeline_interval_s=0.1)
    manager = TLife.TpuShareManager(MockBackend(num_chips=3, hbm_bytes=32 << 30), cfg,
                                    api_client=client,
                                    pod_source=ApiServerPodSource(client, node))
    before = len(TIMELINE.to_doc()["series"].get("util_pct", []))
    try:
        manager._start_loops(manager._build_inventory())
        assert manager._defrag and manager._interference and manager._timeline_loop
        moved = _wait(lambda: P.chip_idx_from_annotation(client.get_pod("default", "c")) == 0)
        assert moved
        status = _wait(lambda: TD.status_from_node(client.get_node(node)))
        assert status["completed"] >= 1 and status["quantum"] == 24
        ann = _wait(lambda: TI.interference_from_node(client.get_node(node)))
        assert ann["chips"] == {} and ann["threshold"] == 1.25
        _wait(lambda: len(TIMELINE.to_doc()["series"].get("util_pct", [])) > before
              or TIMELINE.to_doc()["series"].get("util_pct"))
        assert manager._ckpt.pending() == {}
    finally:
        manager._stop_all()
        manager._ckpt.close()
        manager._patch_pipeline.stop()
        api.stop()
    assert (manager._defrag, manager._interference, manager._timeline_loop) == (None, None, None)
