"""BENCHMARK.json against the contract's shape rules, and lookup by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.load_manifest()


def test_top_level_keys_and_command():
    assert set(M) == KEYS
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert len(json.dumps(M)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in M["configs"]] + [w["name"] for w in M["workloads"]]
    names += [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [k for c in M["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    texts = [w["why"] for w in M["workloads"]] + [c["why"] for c in M["configs"]]
    texts += [c["source"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    for w in M["workloads"]:
        e2e, layer = manifest.cell_metrics(M, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:  # a per-layer metric's cells report what it moves
            assert m["moves"] in names


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_find_cell_loads_config_traffic_and_readers(name):
    cell = manifest.find_cell(name)
    assert cell.config["serving"]["max_len"] % cell.config["serving"]["prefill_chunk"] == 0
    assert "requests" in cell.traffic and "trace_stretch" in cell.traffic
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    used = {c["name"] for c in M["configs"]} & {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.find_cell("no-such-model.chat")


def test_config_files_name_their_reference_and_limits():
    for c in M["configs"]:
        doc = json.loads((manifest.ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"]
        assert (manifest.ROOT / doc["reference"]).exists()
        limits = doc["check"]["limits"]
        assert limits and set(limits) <= {"max_logit_gap", "mean_logit_gap"}
        assert all(v > 0 for v in limits.values())
        assert doc["control"]["bits"] in ("int4", "int8")
