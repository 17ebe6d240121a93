"""Find a rate cell's knee once, on the card: one pod, one window per rate.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 0.2,0.3,...

For each arrival rate (requests per engine tick) it serves the cell's mix
at that rate from an empty pool and prints one JSON line: requests arrived
and admitted, the queue (arrived, not yet admitted) at each quarter of the
window, goodput and the TTFT tail. The knee is the highest rate whose queue
does not grow over the window. Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402,F401  (the cache directories and sys.path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()

    from benchmark import counts, manifest, traffic
    from benchmark.serve import Pod
    from gpushare_device_plugin_tpu_torch.serving.engine import Request

    cell = manifest.find_cell(args.workload)
    pod = Pod(cell, args.seed)
    print(json.dumps({"setup": pod.parts, "setup_s": time.perf_counter() - T_START}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, arrival={"kind": "poisson", "rate_per_tick": rate})
        trace, _ = traffic.generate(mix, args.seed, pod.dims["V"])
        reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new, arrival=r.arrival)
                for r in trace]
        w = pod.window(args.seconds, requests=reqs)
        queue = []
        for q in (0.25, 0.5, 0.75, 1.0):
            t = w.t_open + q * w.seconds
            queue.append(sum(o.arrival_s <= t for o in w.outcomes)
                         - sum(o.admit_s is not None and o.admit_s <= t for o in w.outcomes))
        ttft = [(o.first_s if o.first_s is not None else w.t_close) - o.arrival_s
                for o in w.arrived()]
        print(json.dumps({
            "rate_per_tick": rate, "seconds": w.seconds, "dispatches": w.dispatches,
            "arrived": len(w.arrived()), "queue_at_quarters": queue,
            "goodput_tok_s": w.served() / w.seconds,
            "ttft_p90_ms": 1e3 * counts.ceil_rank(ttft, 0.9),
            "decode_step_p50_ms": 1e3 * (counts.ceil_rank(w.step_s, 0.5) or 0.0),
            "decode_rows_mean": len(w.decode_keys()) / max(1, len(w.step_s)),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
