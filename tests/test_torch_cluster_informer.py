"""The pod informer over the port's ``http.client`` watch, against the
reference's (``tests/test_informer.py``, through ``torch_cluster_mirror``):
the same cache after adds, deletes, relists, tombstones and a 410 Gone."""

import threading

import pytest

from gpushare_device_plugin_tpu.cluster.apiserver import ApiServerClient as RefClient
from gpushare_device_plugin_tpu.cluster.informer import PodInformer as RefInformer
from gpushare_device_plugin_tpu_torch.cluster import informer as T
from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiError, ApiServerClient

from fake_apiserver import FakeApiServer
from k8s_fixtures import assigned_running_pod, make_pod
from torch_cluster_mirror import cases, mirror_case

INFORMER = [
    "test_initial_list_seeds_cache",
    "test_watch_add_modify_delete",
    "test_running_share_pods_filters_by_label",
    "test_other_node_pods_excluded",
    "test_refresh_closes_watch_lag",
    "test_note_pod_update_overrides_stale_cache",
    "test_watch_survives_apiserver_restart",
    "test_stale_watch_event_does_not_revert_newer_pod",
    "test_error_event_triggers_relist",
    "test_stop_returns_promptly_on_idle_watch",
    "test_refresh_prunes_deleted_pods",
    "test_refresh_keeps_entries_newer_than_list",
    "test_pod_rebinding_to_other_node_evicts",
    "test_evict_tombstone_blocks_lagging_watch_event",
    "test_relist_does_not_revert_newer_note_pod_update",
    "test_lagging_deleted_event_does_not_evict_recreation",
    "test_chip_state_matches_batch_computation",
    "test_sentinel_tombstone_cleared_by_authoritative_list",
    "test_tombstone_map_bounded_by_size",
    "test_tombstones_age_out_without_relist",
    "test_stale_list_does_not_resurrect_evicted_ghost",
]


@pytest.mark.parametrize("name, params", cases("test_informer", INFORMER))
def test_informer_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_informer", name, params, tmp_path_factory)


def test_read_timeout_classification():
    """The port's watch raises the socket's TimeoutError on a silent
    stream (the reference's requests wraps it); both shapes classify."""
    assert T._is_read_timeout(TimeoutError("timed out"))
    wrapped = RuntimeError("watch interrupted")
    wrapped.__cause__ = TimeoutError("timed out")
    assert T._is_read_timeout(wrapped)
    assert T._is_read_timeout(OSError("x", TimeoutError("timed out")))
    assert not T._is_read_timeout(ConnectionResetError("reset"))
    assert not T._is_read_timeout(ApiError(410, "gone"))


def _cache(informer) -> dict:
    return {
        (p["metadata"]["namespace"], p["metadata"]["name"]): (
            p["metadata"].get("annotations") or {},
            p["metadata"].get("labels") or {},
            p["status"].get("phase"),
        )
        for p in informer.all_pods()
    }


def _wait(cond, timeout=5.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.01)):
        if cond():
            return True
        ev.wait(0.01)
    return cond()


def test_both_informers_hold_the_same_cache_through_churn_and_an_outage():
    """Both packages' informers watch one apiserver through adds, a phase
    change, deletes, an outage that severs their watches (both serve the
    last-good cache, then relist) and more churn after it: their caches,
    chip states and pending sets agree after each step."""
    api = FakeApiServer()
    api.add_node("node-a")
    api.start()
    ref = RefInformer(RefClient(api.url), "node-a").start(sync_timeout_s=5)
    port = T.PodInformer(ApiServerClient(api.url), "node-a").start(sync_timeout_s=5)
    try:
        def agree():
            return (
                _cache(port) == _cache(ref)
                and port.chip_state() == ref.chip_state()
                and sorted(p["metadata"]["name"] for p in port.pending_pods())
                == sorted(p["metadata"]["name"] for p in ref.pending_pods())
            )

        for i in range(12):
            api.add_pod(make_pod(f"p{i}", 1 + i % 4))
        for i in range(6):
            api.add_pod(assigned_running_pod(f"r{i}", 2 + i, chip_idx=i % 4))
        api.add_pod(make_pod("elsewhere", 2, node="node-b"))
        assert _wait(lambda: len(_cache(ref)) == 18 and agree())
        api.set_pod_phase("default", "p0", "Running")
        api.delete_pod("default", "r1")
        api.delete_pod("default", "p3")
        assert _wait(lambda: len(_cache(ref)) == 16 and agree())
        api.set_outage(True)
        threading.Event().wait(0.6)  # both watches severed, relists refused
        assert agree() and len(_cache(port)) == 16
        api.set_outage(False)
        api.add_pod(make_pod("late", 3))
        api.delete_pod("default", "p5")
        assert _wait(lambda: "late" in {k[1] for k in _cache(port)}
                     and "late" in {k[1] for k in _cache(ref)} and agree(), 10.0)
    finally:
        port.stop()
        ref.stop()
        api.stop()


# --- the apiserver client's wire --------------------------------------------


class _Recorder:
    """An HTTP server that records each request line, body and content
    type, and answers every GET with an empty list (a watch with one
    ADDED line and the terminating chunk)."""

    def __init__(self):
        import http.server

        seen = self.seen = []

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self, body: bytes, chunked=False):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                if chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self.wfile.write(f"{len(body):x}\r\n".encode() + body + b"\r\n0\r\n\r\n")
                else:
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def _record(self):
                n = int(self.headers.get("Content-Length", "0"))
                seen.append((self.command, self.path, self.headers.get("Content-Type"),
                             self.headers.get("Authorization"), self.rfile.read(n)))

            def do_GET(self):
                self._record()
                if "watch=true" in self.path:
                    line = b'{"type": "ADDED", "object": {"metadata": {"name": "w"}}}\n'
                    return self._answer(line, chunked=True)
                self._answer(b'{"items": [], "metadata": {"resourceVersion": "7"}}')

            do_PATCH = do_POST = do_GET

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, args=(0.02,), daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/prefix"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _drive(client) -> list:
    client.list_pods(field_selector="spec.nodeName=n,status.phase=Pending",
                     label_selector="tpu/resource=tpu-mem")
    client.list_pods(namespace="kube-system", label_selector="tpu/resource")
    client.list_pods_with_rv(field_selector="spec.nodeName=n")
    client.get_pod("default", "p")
    client.get_node("n")
    client.list_nodes(label_selector="a=b")
    client.patch_pod("default", "p", {"metadata": {"annotations": {"k": "v"}}})
    client.patch_node("n", {"metadata": {"annotations": {"f": "1:abc"}}})
    client.patch_node_status("n", {"aliyun.com/tpu-count": "1"})
    client.create_event("default", {"reason": "R", "message": "m"})
    client.bind_pod("default", "p", "n")
    got = list(client.watch_pods(resource_version="5", field_selector="spec.nodeName=n"))
    return got


def test_the_client_sends_the_references_requests_byte_for_byte():
    """Every verb's method, path, query, content type, bearer token and
    body are the reference's (whose watch goes through requests), and the
    watch yields the same events."""
    rec = _Recorder()
    try:
        want = _drive(RefClient(rec.url, token="tok"))
        ref_seen = list(rec.seen)
        rec.seen.clear()
        got = _drive(ApiServerClient(rec.url, token="tok"))
        assert got == want == [("ADDED", {"metadata": {"name": "w"}})]
        assert rec.seen == ref_seen
        assert all(path.startswith("/prefix/api/v1/") for _, path, *_ in rec.seen)
    finally:
        rec.stop()


def test_kubeconfig_in_json_needs_no_yaml(tmp_path, monkeypatch):
    """A JSON kubeconfig reads with the standard library; one in YAML
    without PyYAML raises an error that names the file."""
    import json
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    kc = tmp_path / "config.json"
    kc.write_text(json.dumps({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k", "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": "http://10.0.0.1:8080/gw"}}],
        "users": [{"name": "u", "user": {"token": "secret"}}],
    }))
    client = ApiServerClient.from_kubeconfig(str(kc))
    assert client.base_url == "http://10.0.0.1:8080/gw"
    assert client._headers == {"Authorization": "Bearer secret"}
    kc_yaml = tmp_path / "config.yaml"
    kc_yaml.write_text("current-context: c\nclusters: []\n")
    with pytest.raises(RuntimeError, match=str(kc_yaml)):
        ApiServerClient.from_kubeconfig(str(kc_yaml))
