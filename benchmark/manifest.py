"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own (``configs/<config>.json``, whose
``file`` the manifest gives, and ``traffic/<traffic>.json``). A metric's
reader is ``metrics/<name>.py``. Which metrics a cell reports: an
end-to-end metric without a ``workloads`` key is reported by every cell,
one with the key by the cells it lists; a per-layer metric by the cells
its ``workloads`` key lists, or else by every cell that reports the
end-to-end metric it ``moves``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str) -> tuple[tuple[dict, ...], tuple[dict, ...]]:
    """The end-to-end and the per-layer metrics ``cell`` reports."""
    e2e = tuple(m for m in manifest["end_to_end"] if _reports(m, cell))
    names = {m["name"] for m in e2e}
    layer = tuple(
        m for m in manifest["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)
    )
    return e2e, layer


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic loaded; raises
    ``KeyError`` for a name the manifest does not hold."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e, layer = cell_metrics(manifest, name)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file whose name may hold dots (``metrics/x.y.py``)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{name}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(run) -> float | None`` of the metric ``name``."""
    return load_module(bench_dir / "metrics" / f"{name}.py", name.replace(".", "_")).read
