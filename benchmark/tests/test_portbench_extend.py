"""A later change adds a cell, a configuration, a traffic mix and a per-layer
metric as new files and entries only: a throwaway set of each, in a copy,
runs through the harness's data path with no other file edited."""

from __future__ import annotations

import filecmp
import json
import shutil
import time

from benchmark import harness, manifest

from .conftest import MOCK, TINY_CONFIG, TINY_TRAFFIC

METRIC = '''"""Tokens the window served (a throwaway per-layer metric)."""


def read(run):
    return float(sum(len(o.tokens) for o in run.window.outcomes))
'''


def test_new_files_and_entries_run_with_no_other_edit(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "configs" / "tinymodel.json").write_text(json.dumps(TINY_CONFIG))
    (bench / "traffic" / "tinymix.json").write_text(json.dumps(TINY_TRAFFIC))
    (bench / "metrics" / "throwaway_tokens.py").write_text(METRIC)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(doc))
    doc["configs"].append({"name": "tinymodel", "source": "https://example.org/tiny",
                           "file": "benchmark/configs/tinymodel.json", "reduced": [],
                           "why": "throwaway"})
    doc["workloads"].append({"name": "tinymodel.tinymix", "config": "tinymodel",
                             "traffic": "tinymix", "chips": 1, "why": "throwaway"})
    doc["per_layer"].append({"name": "throwaway_tokens", "unit": "tokens", "better": "higher",
                             "source": "program_counter", "layer": "engine loop",
                             "moves": "goodput_tok_s", "workloads": ["tinymodel.tinymix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = manifest.find_cell("tinymodel.tinymix", root=tmp_path)
    assert [m["name"] for m in cell.end_to_end] == ["goodput_tok_s", "setup_s"]
    for trace in (False, True):
        out, _ = harness.run(cell, 77, 1.5, trace, time.perf_counter(), device="cpu",
                             discovery="mock", discovery_kwargs=MOCK, log=lambda m: None,
                             bench_dir=bench)
        assert out["correct"]
        names = set(out["metrics"])
        assert names == ({"throwaway_tokens"} if trace
                         else {"goodput_tok_s", "setup_s"})
    # every entry that was there is there unchanged, and every file but the
    # new ones is the original
    for key, entries in old.items():
        assert doc[key][: len(entries)] == entries if isinstance(entries, list) else True
    cmp = filecmp.dircmp(manifest.BENCH_DIR, bench, ignore=["__pycache__"])
    assert not cmp.diff_files
    new = {p.relative_to(bench).as_posix() for p in bench.rglob("*") if p.is_file()
           and "__pycache__" not in p.parts} - {
        p.relative_to(manifest.BENCH_DIR).as_posix() for p in manifest.BENCH_DIR.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}
    assert new == {"configs/tinymodel.json", "traffic/tinymix.json",
                   "metrics/throwaway_tokens.py"}
