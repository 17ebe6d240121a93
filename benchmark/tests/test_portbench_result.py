"""The result line: its keys, their order, and the refusals of the command."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.serve import Pod

from .conftest import MOCK, run_tiny, tiny_cell


def test_the_result_line_keys():
    doc, _ = run_tiny()
    assert list(doc) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert doc["attempted"] > 0 and doc["failed"] == 0
    for m in doc["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(doc["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in doc["checks"].values())
    json.dumps(doc)


def test_a_traced_result_line_has_the_layers_and_a_breakdown():
    doc, _ = run_tiny(trace=True)
    assert list(doc)[-2:] == ["breakdown", "checks"]
    assert set(doc["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(doc["device"])
    assert "decode_rows_mean" in doc["metrics"] and "goodput_tok_s" not in doc["metrics"]


@pytest.mark.parametrize("trace", [False, True])
def test_only_a_traced_run_warms_the_profiler_in_set_up(trace):
    pod = Pod(tiny_cell(), 5, device="cpu", discovery="mock", discovery_kwargs=MOCK,
              trace=trace)
    assert ("profiler_warm_s" in pod.parts) == trace
    pod.close()


def _command(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           manifest.load_manifest()["workloads"][0]["name"], "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=300)


def test_without_a_card_the_command_prints_no_result():
    out = _command(manifest.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmarks_files_the_command_prints_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
