"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program (top-level module names compared whole)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import manifest

BANNED = ("jax", "jaxlib", "flax", "gpushare_device_plugin_tpu")
PORT = "gpushare_device_plugin_tpu_torch"



def _tops(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_tiny_run_loads_no_jax():
    """The harness, every metric reader and the reference, through a whole
    run of the tiny cell (traced, with its control)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(manifest.ROOT)!r})
sys.path.insert(0, {str(manifest.BENCH_DIR)!r})
import run
import benchmark.reference.decoder
from benchmark import manifest
from benchmark.tests.conftest import run_tiny
doc = manifest.load_manifest()
for m in doc["end_to_end"] + doc["per_layer"]:
    manifest.metric_reader(m["name"])
run_tiny(trace=True, control=True)
assert not run.loaded_banned(), run.loaded_banned()
"""
    tops = _tops(code)
    assert PORT in tops  # the program did run
    assert not tops & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(manifest.ROOT)!r})
import benchmark.reference.decoder, benchmark.check, benchmark.weights
"""
    tops = _tops(code)
    assert PORT not in tops and not tops & set(BANNED)
    for path in (manifest.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] not in (PORT,) + BANNED for n in names), (path, names)


def test_nothing_reads_the_smoke_script_or_the_jax_benches():
    for path in manifest.BENCH_DIR.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("chip_smoke", "bench_mfu", "bench.py"):
            assert name not in text, (path, name)
