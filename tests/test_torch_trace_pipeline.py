"""One admission, one trace: the port's pipeline against the reference's.

Every case of the reference's ``tests/test_trace_pipeline.py`` runs on each
package through ``torch_cluster_mirror``: the extender's filter and bind,
the WAL and the PATCH, a real gRPC Allocate through the plugin server, all
in one trace stitched through the pod's ``tpushare.aliyun.com/trace-id``
annotation; ``/traces``, ``inspect trace``, exemplars, log correlation and
the flight recorder. The apiserver records and envs must be equal, and so
must what each case printed, but for the two renders that print measured
durations and span ids (``inspect trace``'s timeline, ``inspect
flightrecord``), which hold the reference's own assertions.

Then the trace crosses packages, both ways: one package's extender binds,
the other package's allocator admits through its plugin server, and
``inspect trace`` over both processes' ``/traces`` renders one tree:
admission, ``extender.bind``, then ``plugin.allocate`` under it.
"""

import importlib
import json
import re
import time
from pathlib import Path

import pytest

from fake_apiserver import FakeApiServer
from fake_kubelet import FakeKubelet
from k8s_fixtures import make_pod
from torch_cluster_mirror import PORT, REF, cases, mirror_case

NAMES = re.findall(r"^def (test_\w+)",
                   (Path(__file__).parent / "test_trace_pipeline.py").read_text(), re.M)
TIMED = ["test_inspect_trace_cli_renders_timeline", "test_inspect_flightrecord_cli"]


@pytest.mark.parametrize("name, params",
                         cases("test_trace_pipeline", [n for n in NAMES if n not in TIMED]))
def test_trace_pipeline_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_trace_pipeline", name, params, tmp_path_factory,
                compare=("servers", "allocations", "output"))


@pytest.mark.parametrize("name, params", cases("test_trace_pipeline", TIMED))
def test_trace_renders_hold_on_both_packages(name, params, tmp_path_factory):
    mirror_case("test_trace_pipeline", name, params, tmp_path_factory)


def test_mirror_covers_every_reference_case():
    assert len(NAMES) == 15


NODE = "trace-node"


@pytest.mark.parametrize("ext_pkg, node_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["reference-extender", "port-extender"])
def test_trace_stitches_across_packages(tmp_path, monkeypatch, capsys, ext_pkg, node_pkg):
    ext = lambda name: importlib.import_module(f"{ext_pkg}.{name}")  # noqa: E731
    node = lambda name: importlib.import_module(f"{node_pkg}.{name}")  # noqa: E731
    const = node("const")
    for side in (ext, node):
        side("utils.tracing").STORE.clear()
        side("utils.tracing").TRACER.configure(sample_ratio=1.0)
    api = FakeApiServer()
    api.add_node(NODE, capacity={const.RESOURCE_MEM: "128", const.RESOURCE_COUNT: "4"})
    api.start()
    servers = []
    try:
        ext_client = ext("cluster.apiserver").ApiServerClient(api.url)
        client = node("cluster.apiserver").ApiServerClient(api.url)
        informer = node("cluster.informer").PodInformer(client, NODE).start()
        try:
            api.add_pod(make_pod("p1", 4, node=""))
            core = ext("extender.server").ExtenderCore(ext_client)
            core.filter({"pod": ext_client.get_pod("default", "p1"),
                         "nodes": {"items": [ext_client.get_node(NODE)]}})
            assert core.bind({"podName": "p1", "podNamespace": "default",
                              "node": NODE})["error"] == ""
            raw = api.pods[("default", "p1")]["metadata"]["annotations"][const.ANN_TRACE_ID]
            trace_id, _, bind_span_id = raw.partition(":")
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                cached = informer.get_pod("default", "p1")
                if cached and const.ENV_MEM_IDX in (cached["metadata"].get("annotations") or {}):
                    break
                time.sleep(0.01)
            inv = node("device").DeviceInventory(
                node("discovery").MockBackend(num_chips=4, hbm_bytes=32 << 30).chips())
            kubelet = FakeKubelet(str(tmp_path))
            kubelet.start()
            allocator = node("allocator.cluster").ClusterAllocator(inv, client, informer, NODE)
            plugin = node("plugin").TpuSharePlugin(
                inv, allocate_fn=allocator.allocate,
                config=node("plugin").PluginConfig(plugin_dir=str(tmp_path)))
            plugin.serve()
            try:
                reg = kubelet.wait_for_registration()
                resp = kubelet.allocate(reg.endpoint, [[f"g{i}" for i in range(4)]])
                assert resp.container_responses[0].envs[const.ENV_TPU_VISIBLE_CHIPS] == "0"
            finally:
                plugin.stop()
                kubelet.stop()
        finally:
            informer.stop()
        ext_spans = ext("utils.tracing").STORE.trace(trace_id)
        node_spans = node("utils.tracing").STORE.trace(trace_id)
        assert {"admission", "extender.filter", "extender.bind"} <= {s.name for s in ext_spans}
        assert {"plugin.allocate", "allocator.admit", "allocator.env"} <= {
            s.name for s in node_spans}
        # one tree: one root, every other span's parent in the trace
        spans = [s.to_dict() for s in ext_spans + node_spans]
        ids = {s["span_id"] for s in spans}
        assert [s["name"] for s in spans if not s["parent_id"]] == ["admission"]
        assert all(s["parent_id"] in ids for s in spans if s["parent_id"])
        assert {s["trace_id"] for s in spans} == {trace_id}
        plugin_root = next(s for s in spans if s["name"] == "plugin.allocate")
        assert plugin_root["parent_id"] == bind_span_id
        # inspect trace over both processes' /traces, with each package's CLI
        for side in (ext, node):
            srv = side("utils.metrics").MetricsServer(host="127.0.0.1", port=0).start()
            servers.append(srv)
        urls = [x for srv in servers for x in ("--traces-url", f"http://127.0.0.1:{srv.port}")]
        renders = []
        for pkg in (REF, PORT):
            cli = importlib.import_module(f"{pkg}.cli.inspect")
            monkeypatch.setattr(cli, "_client", lambda *a, **k: client)
            assert cli.main(["trace", "default/p1", *urls, "-o", "json"]) == 0
            got = json.loads(capsys.readouterr().out)
            assert sorted(s["span_id"] for s in got) == sorted(ids)
            assert cli.main(["trace", "default/p1", *urls]) == 0
            out = capsys.readouterr().out
            renders.append(re.sub(r"[\d.]+ms", "<ms>", out))
            lines = out.splitlines()
            admission = next(i for i, ln in enumerate(lines) if ln.startswith("admission"))
            bind = next(i for i, ln in enumerate(lines) if "extender.bind" in ln)
            allocate = next(i for i, ln in enumerate(lines) if "plugin.allocate" in ln)
            assert admission < bind < allocate
            assert sum(ln.startswith("admission") for ln in lines) == 1
        assert renders[0] == renders[1]
    finally:
        for srv in servers:
            srv.stop()
        api.stop()
