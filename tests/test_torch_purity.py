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
    for sub in ("discovery", "device", "allocator", "manager", "plugin", "native", "cli"):
        assert any(p.parent == PORT / sub for p in walked), sub
    assert PORT / "plugin" / "api" / "deviceplugin_pb2.py" in walked
    # the node agent's modules
    for rel in ("manager/lifecycle.py", "manager/watchers.py", "cli/daemon.py",
                "allocator/cluster.py", "utils/flightrec.py", "utils/timeline.py",
                "utils/stacktrace.py"):
        assert PORT / rel in walked, rel


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
