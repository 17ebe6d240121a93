"""The PyTorch port stands alone: no import of JAX, optax or the reference
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
from gpushare_device_plugin_tpu_torch.serving.engine import SlotEngine
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gpushare_device_plugin_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "gpushare_device_plugin_tpu")


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
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_PREFIXES", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert not (tmp_path / "build").exists()
    assert _build.sources() == ["flash_bwd", "flash_bwd_sm90", "flash_fwd", "flash_fwd_sm90"]
