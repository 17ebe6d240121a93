"""The PyTorch port stands alone: no import of JAX, optax, ml_dtypes or the reference
package, entry points that do not drop to the CPU without being asked,
and a kernel loader that raises instead of falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpushare_device_plugin_tpu_torch.device import resolve_device
from gpushare_device_plugin_tpu_torch.ops import _build
from gpushare_device_plugin_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, SlotEngine
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gpushare_device_plugin_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "gpushare_device_plugin_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_reference_or_jax_import_in_the_port():
    bad = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in _port_files()
        for name in _imports(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert len(_port_files()) > 10 and not bad, bad
    # every subpackage is walked, the fleet's policy registry and the
    # device plugin's node agent included
    walked = set(_port_files())
    assert PORT / "extender" / "policy.py" in walked
    for sub in ("discovery", "device", "allocator", "manager", "plugin", "native", "cli",
                "cluster", "topology"):
        assert any(p.parent == PORT / sub for p in walked), sub
    assert PORT / "plugin" / "api" / "deviceplugin_pb2.py" in walked
    # the node agent's modules
    for rel in ("manager/lifecycle.py", "manager/watchers.py", "cli/daemon.py",
                "allocator/cluster.py", "utils/flightrec.py", "utils/timeline.py",
                "utils/stacktrace.py"):
        assert PORT / rel in walked, rel
    # and its cluster half
    for rel in ("cluster/apiserver.py", "cluster/informer.py", "cluster/kubelet.py",
                "cluster/podsource.py", "cluster/pods.py", "cluster/node.py",
                "cluster/noderes.py", "cluster/usage.py", "cluster/indexes.py",
                "cluster/events.py", "cluster/reconciler.py", "topology/model.py",
                "allocator/assume.py", "allocator/checkpoint.py"):
        assert PORT / rel in walked, rel
    # and the scheduler extender
    for rel in ("extender/logic.py", "extender/index.py", "extender/server.py",
                "extender/shards.py", "extender/simcluster.py", "utils/tracing.py",
                "utils/metrics.py", "utils/lockrank.py"):
        assert PORT / rel in walked, rel


def _load_time_imports(path):
    """The imports a module runs when it loads: those outside any function."""
    tree = ast.parse(path.read_text(), str(path))
    nested = {
        id(n)
        for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
        for n in ast.walk(f)
    }
    for node in ast.walk(tree):
        if id(node) in nested:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_module_needs_requests_urllib3_or_yaml():
    """The card's machine has none of them. The port talks HTTP through
    http.client; yaml is imported only where a kubeconfig that is not JSON
    is read (``ApiServerClient.from_kubeconfig``), never when a module
    loads; requests and urllib3 are imported nowhere."""
    third_party = ("requests", "urllib3", "yaml")
    at_load = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in _port_files() for name in _load_time_imports(p)
        if name.split(".")[0] in third_party
    ]
    assert not at_load, at_load
    anywhere = {
        (str(p.relative_to(ROOT)), name.split(".")[0])
        for p in _port_files() for name in _imports(p)
        if name.split(".")[0] in third_party
    }
    assert anywhere == {("gpushare_device_plugin_tpu_torch/cluster/apiserver.py", "yaml")}


def test_nvml_discovery_imports_no_torch():
    """The daemon's default backend reads the cards through NVML and opens
    no CUDA context: NVML and its backend, and the plugin's grpc-free
    layers (fan-out, allocator, health watcher), never import torch."""
    mods = ["gpushare_device_plugin_tpu_torch.native.nvml",
            "gpushare_device_plugin_tpu_torch.discovery.nvmldev",
            "gpushare_device_plugin_tpu_torch.device",
            "gpushare_device_plugin_tpu_torch.allocator.local",
            "gpushare_device_plugin_tpu_torch.allocator.cluster",
            "gpushare_device_plugin_tpu_torch.manager.health",
            "gpushare_device_plugin_tpu_torch.manager.watchers",
            "gpushare_device_plugin_tpu_torch.manager.lifecycle",
            "gpushare_device_plugin_tpu_torch.utils.flightrec",
            "gpushare_device_plugin_tpu_torch.utils.timeline",
            "gpushare_device_plugin_tpu_torch.utils.stacktrace",
            "gpushare_device_plugin_tpu_torch.utils.metrics",
            "gpushare_device_plugin_tpu_torch.plugin.server",
            "gpushare_device_plugin_tpu_torch.cli.daemon"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from gpushare_device_plugin_tpu_torch.discovery import from_name\n"
        "from_name('nvml', library='/nonexistent/libnvidia-ml.so.1').probe()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'torch']\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_manager_loads_and_accounts_without_grpc():
    """The card's machine has no grpc: with it blocked, the manager, the
    daemon's module and the flight recorder import, and the inventory,
    both allocate functions and the health sink build and run. Only the
    plugins, which serve gRPC, need it; they import it where they are
    built."""
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None  # any import of grpc raises ImportError\n"
        "import gpushare_device_plugin_tpu_torch.cli.daemon\n"
        "from gpushare_device_plugin_tpu_torch.discovery import MockBackend, ChipHealth\n"
        "from gpushare_device_plugin_tpu_torch.manager import ManagerConfig, TpuShareManager\n"
        "from gpushare_device_plugin_tpu_torch.utils.flightrec import FLIGHT\n"
        "m = TpuShareManager(MockBackend(num_chips=2, hbm_bytes=4 << 30),\n"
        "                    ManagerConfig(standalone=True, plugin_dir='/nonexistent'))\n"
        "inv = m._build_inventory()\n"
        "mem = m._build_allocator(inv, unhealthy_fn=lambda: [])\n"
        "core = m._build_core_allocate_fn(inv, unhealthy_fn=lambda: [])\n"
        "assert core([[inv.chips()[0].id]])[0].envs['TPU_VISIBLE_CHIPS'] == '0'\n"
        "sink = m._local_sink(inv)\n"
        "sink(inv.chips()[1].id, ChipHealth.UNHEALTHY)\n"
        "try:\n"
        "    mem([['a']])\n"
        "    raise SystemExit('a held and a sick card took a grant')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "sink(None, ChipHealth.HEALTHY)\n"
        "assert mem([['a', 'b']])[0].envs['TPU_VISIBLE_CHIPS'] == '1'\n"
        "try:\n"
        "    m._build_plugins(inv)\n"
        "    raise SystemExit('the plugins built without grpc')\n"
        "except ImportError:\n"
        "    pass\n"
        "bad = [n for n in sys.modules if sys.modules[n] is not None and (\n"
        "       n.split('.')[0] in ('torch', 'grpc') or n.startswith('google.protobuf'))]\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_cluster_half_loads_and_admits_without_torch_or_grpc():
    """With torch, grpc, requests, urllib3 and yaml all blocked, the
    cluster modules and the daemon's module import, a cluster-mode manager
    builds its allocators against a fake apiserver read through a JSON
    kubeconfig, and the mem allocator admits a pod and persists it."""
    code = (
        "import json, os, sys, tempfile\n"
        "for name in ('grpc', 'torch', 'requests', 'urllib3', 'yaml'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "sys.path.insert(0, 'tests')\n"
        "import gpushare_device_plugin_tpu_torch.cli.daemon\n"
        "from fake_apiserver import FakeApiServer\n"
        "from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient\n"
        "from gpushare_device_plugin_tpu_torch.cluster.informer import PodInformer\n"
        "from gpushare_device_plugin_tpu_torch.discovery import MockBackend\n"
        "from gpushare_device_plugin_tpu_torch.manager import ManagerConfig, TpuShareManager\n"
        "api = FakeApiServer(); api.add_node('n'); api.start()\n"
        "kc = os.path.join(tempfile.mkdtemp(), 'kubeconfig')\n"
        "json.dump({'current-context': 'c', 'contexts': [{'name': 'c', 'context':\n"
        "    {'cluster': 'k'}}], 'clusters': [{'name': 'k', 'cluster': {'server': api.url}}]},\n"
        "    open(kc, 'w'))\n"
        "client = ApiServerClient.from_kubeconfig(kc)\n"
        "api.add_pod({'metadata': {'name': 'p', 'namespace': 'default', 'uid': 'u',\n"
        "    'creationTimestamp': '2026-01-01T00:00:00Z'}, 'spec': {'nodeName': 'n',\n"
        "    'containers': [{'name': 'c', 'resources': {'limits': {'aliyun.com/tpu-mem': '2'}}}]},\n"
        "    'status': {'phase': 'Pending'}})\n"
        "informer = PodInformer(client, 'n').start(sync_timeout_s=5)\n"
        "m = TpuShareManager(MockBackend(num_chips=2, hbm_bytes=4 << 30),\n"
        "                    ManagerConfig(plugin_dir='/nonexistent', node_name='n'),\n"
        "                    api_client=client, pod_source=informer)\n"
        "inv = m._build_inventory()\n"
        "mem = m._build_allocator(inv, unhealthy_fn=lambda: [])\n"
        "m._build_core_allocate_fn(inv, unhealthy_fn=lambda: [])\n"
        "assert mem([['a', 'b']])[0].envs['ALIYUN_COM_TPU_MEM_POD'] == '2'\n"
        "ann = api.pods[('default', 'p')]['metadata']['annotations']\n"
        "assert ann['ALIYUN_COM_TPU_MEM_ASSIGNED'] == 'true', ann\n"
        "informer.stop(); m._patch_pipeline.stop(); api.stop()\n"
        "bad = [n for n in sys.modules if sys.modules[n] is not None and (\n"
        "       n.split('.')[0] in ('torch', 'grpc', 'requests', 'urllib3', 'yaml'))]\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_inspect_cli_and_the_node_loops_load_without_torch():
    """With torch, grpc, requests, urllib3 and yaml all blocked, the inspect
    CLI, the kubelet pod dump, the defragmenter and the interference
    detector import, and the CLI renders a fake apiserver's node whose
    defrag status it reads through the defragmenter."""
    code = (
        "import io, json, sys, contextlib\n"
        "for name in ('grpc', 'torch', 'requests', 'urllib3', 'yaml'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "sys.path.insert(0, 'tests')\n"
        "from fake_apiserver import FakeApiServer\n"
        "from gpushare_device_plugin_tpu_torch.cli import inspect, podgetter\n"
        "from gpushare_device_plugin_tpu_torch.allocator import defrag\n"
        "from gpushare_device_plugin_tpu_torch.cluster import interference\n"
        "from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient\n"
        "api = FakeApiServer(); api.add_node('n'); api.start()\n"
        "api.nodes['n']['status'] = {'capacity': {'aliyun.com/tpu-mem': '64',\n"
        "    'aliyun.com/tpu-count': '2'}, 'allocatable': {'aliyun.com/tpu-mem': '64',\n"
        "    'aliyun.com/tpu-count': '2'}}\n"
        "api.nodes['n']['metadata'].setdefault('annotations', {})[\n"
        "    'tpushare.aliyun.com/defrag-status'] = json.dumps({'completed': 0, 'quantum': 8})\n"
        "inspect._client = lambda *a, **k: ApiServerClient(api.url)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert inspect.main([]) == 0\n"
        "api.stop()\n"
        "assert 'MOVES' in out.getvalue(), out.getvalue()\n"
        "bad = [n for n in sys.modules if sys.modules[n] is not None and (\n"
        "       n.split('.')[0] in ('torch', 'grpc', 'requests', 'urllib3', 'yaml'))]\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_extender_loads_and_binds_without_torch():
    """With torch, grpc, requests, urllib3 and yaml all blocked, the
    extender's modules import, the webhook server binds a pod through
    filter, prioritize and bind over HTTP, and the sharded router admits
    one and serves ``/shards``: what the extender's Deployment runs."""
    code = (
        "import json, sys, tempfile, urllib.request\n"
        "for name in ('grpc', 'torch', 'requests', 'urllib3', 'yaml'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "sys.path.insert(0, 'tests')\n"
        "from fake_apiserver import FakeApiServer\n"
        "from k8s_fixtures import make_pod\n"
        "from gpushare_device_plugin_tpu_torch.extender import index, logic, simcluster\n"
        "from gpushare_device_plugin_tpu_torch.extender.server import ExtenderCore, ExtenderHTTPServer\n"
        "from gpushare_device_plugin_tpu_torch.extender.shards import ShardExtender, ShardRouter\n"
        "from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient\n"
        "from gpushare_device_plugin_tpu_torch.utils.metrics import MetricsServer\n"
        "api = FakeApiServer()\n"
        "nodes = simcluster.make_cluster(4, seed=0)\n"
        "for n in nodes: api.nodes[n['metadata']['name']] = n\n"
        "api.start()\n"
        "client = ApiServerClient(api.url)\n"
        "http = ExtenderHTTPServer(ExtenderCore(client), host='127.0.0.1', port=0); http.start()\n"
        "def post(verb, body):\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{http.port}/scheduler/{verb}',\n"
        "        data=json.dumps(body).encode(), headers={'Content-Type': 'application/json'})\n"
        "    return json.load(urllib.request.urlopen(req, timeout=10))\n"
        "pod = make_pod('p0', 4, node=''); api.add_pod(pod)\n"
        "names = [n['metadata']['name'] for n in nodes]\n"
        "fit = post('filter', {'pod': pod, 'nodenames': names})['nodenames']\n"
        "best = max(post('prioritize', {'pod': pod, 'nodenames': fit}), key=lambda e: e['score'])\n"
        "assert post('bind', {'podName': 'p0', 'podNamespace': 'default', 'node': best['host']})\\\n"
        "    == {'error': ''}\n"
        "http.stop()\n"
        "router = ShardRouter([ShardExtender(f'shard-{i}', client) for i in range(2)])\n"
        "router.set_nodes(nodes)\n"
        "pod = make_pod('p1', 4, node=''); api.add_pod(pod)\n"
        "assert router.admit(pod)['error'] == ''\n"
        "srv = MetricsServer(host='127.0.0.1', port=0, shards_doc_fn=router.shards_doc).start()\n"
        "doc = json.load(urllib.request.urlopen(f'http://127.0.0.1:{srv.port}/shards', timeout=10))\n"
        "assert doc['ring']['shards'] == 2, doc\n"
        "srv.stop(); api.stop()\n"
        "assert simcluster.audit_cluster(nodes, client.list_pods()) == []\n"
        "bad = [n for n in sys.modules if sys.modules[n] is not None and (\n"
        "       n.split('.')[0] in ('torch', 'grpc', 'requests', 'urllib3', 'yaml'))]\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_importing_every_port_module_leaves_jax_out():
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def _raw_locks(path):
    """``threading.Lock/RLock/Condition`` made in ``path``: called as
    ``threading.X()`` (or through an alias of the module) or imported with
    ``from threading import X``."""
    tree = ast.parse(path.read_text(), str(path))
    kinds = ("Lock", "RLock", "Condition")
    modules = {"threading"} | {a.asname for node in ast.walk(tree)
                               if isinstance(node, ast.Import)
                               for a in node.names if a.name == "threading" and a.asname}
    bare = {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module == "threading"
            for a in node.names if a.name in kinds}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id in modules and fn.attr in kinds):
            yield f"{path.relative_to(ROOT)}:{node.lineno} threading.{fn.attr}"
        elif isinstance(fn, ast.Name) and fn.id in bare:
            yield f"{path.relative_to(ROOT)}:{node.lineno} {fn.id}"


def test_every_port_lock_is_made_through_the_ranked_factory():
    """tpulint's unranked-lock rule (``tools/tpulint/rules_locks.py``) on
    the port: no module but ``utils/lockrank.py`` makes a threading Lock,
    RLock or Condition, so the witness and the model checker see every
    lock. The one exception is the kernel build's module lock
    (``ops/_build.py``), which no control-plane path takes. Events stay
    allowed (stop flags); a protocol's events go through ``make_event``."""
    raw = [hit for p in sorted(PORT.rglob("*.py")) if p != PORT / "utils" / "lockrank.py"
           for hit in _raw_locks(p)]
    assert [hit.split(":")[0] for hit in raw] == ["gpushare_device_plugin_tpu_torch/ops/_build.py"], raw


def test_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = T.TransformerConfig(vocab=8, d_model=16, n_layers=1, n_heads=2, d_ff=8,
                              compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.init_slot_cache(cfg, 1, 8)
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotEngine(params, cfg, slots=1, max_len=8, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.generate(params, [[1, 2]], cfg, max_new=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_train_loop(DecoderTask(cfg, batch=1, seq=4), TrainLoopConfig(total_steps=1), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(MeshSpec())
    assert resolve_device("cpu") == torch.device("cpu")


def test_paged_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.TransformerConfig(vocab=8, d_model=16, n_layers=1, n_heads=2, d_ff=8,
                              compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.init_paged_cache(cfg, 1, 3, 4)
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    geo = dict(slots=1, max_len=8, total_pages=2, page_size=4, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedSlotEngine(params, cfg, **geo)
    assert G.init_paged_cache(cfg, 1, 3, 4, device="cpu")["k"].shape == (1, 3, 4, 2, 8)
    assert PagedSlotEngine(params, cfg, **geo, device="cpu").device == torch.device("cpu")


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_PREFIXES", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert not (tmp_path / "build").exists()
    assert _build.sources() == ["flash_bwd", "flash_bwd_sm90", "flash_fwd", "flash_fwd_sm90"]


def test_pod_workload_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    from gpushare_device_plugin_tpu_torch.workloads import bert as B
    from gpushare_device_plugin_tpu_torch.workloads import mnist
    from gpushare_device_plugin_tpu_torch.workloads import resnet as R
    from gpushare_device_plugin_tpu_torch.workloads.trainer import BertTask, ResNetTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bcfg = B.BertConfig(vocab=16, d_model=8, n_layers=1, n_heads=2, d_ff=8, max_seq=8)
    rcfg = R.ResNetConfig(stage_sizes=(1,), width=4, num_classes=4)
    for call in (
        lambda: B.init_params(bcfg, torch.Generator()),
        lambda: R.init_params(rcfg, torch.Generator()),
        lambda: mnist.init_params(torch.Generator()),
        lambda: mnist.train(steps=1, batch=2),
        lambda: run_train_loop(BertTask(bcfg, 1, 4), TrainLoopConfig(total_steps=1), 0),
        lambda: run_train_loop(ResNetTask(rcfg, 1, 8), TrainLoopConfig(total_steps=1), 0),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert mnist.train(steps=1, batch=2, device="cpu") > 0


def test_tensor_parallel_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    """The sharded paths resolve their device like the rest: a mesh made
    for the card keeps every engine, init and cache on it, and raises
    without one; a mesh made for the CPU keeps them there."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.TransformerConfig(vocab=8, d_model=16, n_layers=1, n_heads=2, d_ff=8,
                              compute_dtype=torch.float32)
    card = Mesh(MeshSpec(tp=2), rank=0, device=torch.device("cuda", 0), backend="gloo",
                groups={}, ranks={})
    host = Mesh(MeshSpec(tp=2), rank=1, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, torch.Generator(), mesh=host)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_train_state(cfg, torch.Generator(), mesh=card)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.init_slot_cache(cfg, 1, 8, mesh=host)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotEngine(params, cfg, slots=1, max_len=8, prefill_chunk=4, mesh=card)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedSlotEngine(params, cfg, slots=1, max_len=8, total_pages=2, page_size=4,
                        prefill_chunk=4, mesh=card)
    eng = SlotEngine(params, cfg, slots=1, max_len=8, prefill_chunk=4, mesh=host)
    assert eng.device == torch.device("cpu") and eng.mesh is host
    assert eng.cache["k"].shape[3] == 1  # the rank's half of the two kv heads
    assert T.init_train_state(cfg, torch.Generator(), mesh=host)[0]["out"].shape == (16, 4)
