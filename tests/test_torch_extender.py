"""The scheduler extender: the port's against the reference's.

Every case of the reference's ``tests/test_extender.py`` runs on each
package through ``torch_cluster_mirror``: the pure filter and score
tables, the HTTP webhook's filter, prioritize and bind, the core-held
chips, the informer-backed index at 2,000 pods, and the concurrent binds.
The apiserver records (PATCH bodies, the bind annotations, bindings) must
be equal, but for the two concurrent-bind cases: which of two racing
threads wins is the scheduler's, so those hold the reference's own
assertions (both binds land, and no chip is double-booked) on each
package.
"""

import copy
import importlib
from pathlib import Path

import pytest

from fake_apiserver import FakeApiServer
from k8s_fixtures import make_pod
from torch_cluster_mirror import PORT, REF, cases, load, mirror_case

EXTENDER = [
    "test_pod_resource_detection",
    "test_filter_requires_single_chip_fit",
    "test_filter_non_advertising_node",
    "test_prioritize_prefers_tight_fit",
    "test_prioritize_spread_prefers_empty_node",
    "test_choose_chip_annotations",
    "test_choose_chip_gpu_family",
    "test_filter_bind_roundtrip",
    "test_bind_sequential_pods_pack_same_chip",
    "test_bind_overcommit_errors",
    "test_health_endpoints",
    "test_extender_excludes_core_held_chips",
    "test_informer_backed_extender_scale_2000_pods",
    "test_index_overlay_counts_bind_before_nodename_lands",
]

THREADED = [
    "test_concurrent_binds_to_different_nodes_overlap",
    "test_concurrent_binds_same_chip_no_double_book",
]


@pytest.mark.parametrize("name, params", cases("test_extender", EXTENDER))
def test_extender_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_extender", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_extender", THREADED))
def test_concurrent_binds_hold_on_both_packages(name, params, tmp_path_factory):
    mirror_case("test_extender", name, params, tmp_path_factory, compare=())


# --- a bind landing between the index read and the overlay check -------------


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["reference", "port"])
def test_bind_landing_between_index_and_overlay_reads(pkg):
    """The informer applies a bound pod's watch event between the view's
    index read and its in-flight overlay check. The reference reads the
    index first, so the bound pod is counted by neither and a second pod
    fits on the full chip (``ROADMAP.md`` §3 fault 9, the double-booking
    its churn storm finds in about one run of 25); the port decides the
    overlay first, so the chip stays full."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    const = m("const")
    api = FakeApiServer()
    api.start()
    node = load("test_extender", pkg).shared_node("n1", chips=1, units=8)
    api.nodes["n1"] = node
    client = m("cluster.apiserver").ApiServerClient(api.url)
    informer = m("cluster.informer").PodInformer(client).start(sync_timeout_s=10)
    core = m("extender.server").ExtenderCore(client, informer=informer)
    try:
        api.add_pod(make_pod("first", 8, node=""))
        assert core.bind({"podName": "first", "podNamespace": "default",
                          "node": "n1"})["error"] == ""
        landed = copy.deepcopy(api.pods[("default", "first")])
        assert landed["metadata"]["annotations"][const.ENV_MEM_IDX] == "0"
        rv = int(landed["metadata"].get("resourceVersion", "1"))
        # the cache before the bind's events: pending, no annotation
        before = make_pod("first", 8, node="")
        before["metadata"]["resourceVersion"] = str(rv + 1000)
        informer.note_pod_update(before)
        landed["metadata"]["resourceVersion"] = str(rv + 2000)
        view_for = core._view_for

        def index_read_then_event(n, resource):
            view = view_for(n, resource)
            informer.note_pod_update(landed)  # the bind's events land now
            return view

        core._view_for = index_read_then_event
        failed = core.filter({"pod": make_pod("second", 8, node=""),
                              "nodes": {"items": [node]}})["failedNodes"]
        if pkg == PORT:
            assert "n1" in failed
        else:
            assert failed == {}  # the reference's fault: a double-booking
    finally:
        informer.stop()
        api.stop()


@pytest.mark.parametrize("module", ["server", "shards"])
def test_entry_points_exit_zero_on_sigterm(tmp_path, module):
    """``python -m`` the port's extender (or shard router) against a fake
    apiserver: ``/healthz`` answers, and SIGTERM stops it with exit 0 (the
    reference's process dies of the signal)."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    api = FakeApiServer()
    api.start()
    kc = tmp_path / "kubeconfig.json"
    kc.write_text(json.dumps({
        "current-context": "f", "contexts": [{"name": "f", "context": {"cluster": "f"}}],
        "clusters": [{"name": "f", "cluster": {"server": api.url}}]}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KUBECONFIG=str(kc), HOME=str(tmp_path))
    extra = ["--checkpoint-dir", str(tmp_path / "wals")] if module == "shards" else []
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.extender.{module}", "--port", str(port),
         "--host", "127.0.0.1", *extra],
        cwd=Path(__file__).resolve().parents[1], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    assert json.load(r)["ok"] is True
                    break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        api.stop()
