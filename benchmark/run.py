"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks`` (each number compared, with its limit;
they are also the last lines of standard error). Exits non-zero, printing
no result, without a CUDA card, with fewer cards than the cell asks for,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache the program or its libraries keep lives at a
# fixed place inside the checkout.
CACHE = ROOT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BANNED = ("jax", "jaxlib", "flax", "gpushare_device_plugin_tpu")


def loaded_banned() -> list[str]:
    """Banned top-level module names present in ``sys.modules`` (compared
    whole: the port's name starts with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, manifest

    cell = manifest.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing to measure", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        doc, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START, log=log)
    except harness.Refused as e:
        log(f"refused: {e}")
        return 4
    banned = loaded_banned()
    if banned:
        log(f"loaded in this process: {', '.join(banned)}")
        return 3
    for name, c in doc["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
