"""The readings a cell's correctness limit is set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--control]

One process serves the cell once per seed (set-up, window, reference, as a
benchmark run does) and prints one JSON line per seed with the numbers
compared. ``--control`` runs the cell's control instead, as its
configuration's ``control`` says: ``int4`` puts the reference in the
program's place in int4 (its picks are judged under ``max_logit_gap`` and
``mean_logit_gap``, by the cell's limits; the program's own readings are
printed beside them as ``program_max_gap`` and ``program_mean_gap``);
``int8`` switches the program's own int8 path on (weights through
``quant.quantize_leaf``, the int8 KV cache), and its ``max_logit_gap`` and
``mean_logit_gap`` against the configuration's reference are the
control's readings. Either way ``correct`` has to come out false.
Benchmark runs never run this.
"""

import gc
import time

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402,F401  (the cache directories and sys.path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch

    from benchmark import harness, manifest

    cell = manifest.find_cell(args.workload)
    bits = cell.config["control"]["bits"]
    override = {"weights": bits, "kv_cache": bits} if args.control and bits == "int8" else None

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        # each seed starts from an empty allocator, as a run's own process does
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        doc, readings = harness.run(cell, seed, args.seconds, False, t, precision=override,
                                    control=args.control and bits != "int8", log=log)
        print(json.dumps({"seed": seed, "control": args.control, "correct": doc["correct"],
                          "readings": readings, "metrics": doc["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
