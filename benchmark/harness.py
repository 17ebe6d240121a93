"""One run of one cell, from set-up to the result line's fields.

Order: set up the pod (``setup_s`` runs from the process's start to the
window's open), serve the window, read the memory peak, free the program's
state, reduce the profiled stretch, read the metrics, then judge the
served tokens against the reference (not counted in any metric).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from . import check, manifest
from . import trace as TRACE
from .serve import Pod, Window

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: manifest.Cell
    dims: dict  # weights.model_dims of the configuration
    precision: dict  # what the program served: weights and KV cache
    setup_s: float
    window: Window
    cap_bytes: int  # the pod's cap, from configure_torch_from_env
    peak_reserved: int
    peaks: dict  # the card's published peaks (peaks.json)
    trace: dict | None  # the profiled stretch, reduced (trace.py)


def device_peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``)."""
    for name, row in PEAKS["cards"].items():
        if name in kind:
            return row
    return {}


class Refused(RuntimeError):
    """The run cannot give a result (not a wrong one)."""


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, t_start: float, *,
        device: str = "cuda", discovery: str = "nvml", discovery_kwargs: dict | None = None,
        precision: dict | None = None, control: bool = False, log=print,
        bench_dir: Path = manifest.BENCH_DIR) -> tuple[dict, dict]:
    """(the result line, the check's readings). ``precision`` overrides the
    configuration's (a control that switches the program's own lower
    precision on); ``control`` judges the reference control's tokens in
    place of the served ones (a control that the program has no path for)."""
    cuda = torch.device(device).type == "cuda"
    try:
        pod = Pod(cell, seed, device=device, discovery=discovery,
                  discovery_kwargs=discovery_kwargs, precision=precision, trace=trace)
        pod.parts["pod_s"] = time.perf_counter() - t_start
        win = pod.window(seconds, trace_plan=cell.traffic["trace_stretch"] if trace else None)
        # set-up runs until the window opens: the pool's fill counts in it
        setup_s = win.t_open - t_start
        pod.parts["fill_s"] = win.t_open - t_start - pod.parts["pod_s"]
        log("setup " + json.dumps({k: round(v, 3) for k, v in pod.parts.items()}
                                  | {"setup_s": round(setup_s, 3)}))
    except torch.cuda.OutOfMemoryError as e:
        peak = torch.cuda.max_memory_reserved() if cuda else 0
        log(f"out of memory: {str(e).splitlines()[0][:300]}")
        return ({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                 "device": device_doc(cuda, peak),
                 "checks": {"pod_out_of_memory": {"value": 1, "limit": 0}}}, {})
    if not win.drained:
        raise Refused("the trace ran out before the window closed: give the mix more requests")
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    dims = pod.dims
    rec = Run(cell=cell, dims=dims, precision=pod.precision, setup_s=setup_s, window=win,
              cap_bytes=pod.cap_bytes, peak_reserved=peak,
              peaks=device_peaks(torch.cuda.get_device_name(0) if cuda else "cpu"), trace=None)
    pool = {"plan": [pod.plan.slots, pod.plan.total_pages], "weight_bytes": pod.weight_bytes,
            "launches": {k: v for k, v in pod.launches.items() if v}}
    pod.close()
    del pod
    if win.stretch is not None and win.stretch["path"]:
        rec.trace = TRACE.reduce_and_remove(win.stretch["path"],
                                            win.stretch["t1"] - win.stretch["t0"],
                                            win.stretch["spans"])
        log("kernels " + json.dumps({k[:100]: v for k, v in rec.trace["kernel_s"].items()
                                     if "fwd" in k}))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.metric_reader(m["name"], bench_dir)(rec)
        if value is None:
            if not trace:
                raise Refused(f"end-to-end metric {m['name']} has nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log("window " + json.dumps({
        "seconds": round(win.seconds, 3), "arrived": len(win.arrived()), "tokens": win.served(),
        "finished": sum(o.finish_s is not None and o.finish_s >= win.t_open
                        for o in win.outcomes),
        "dispatches": win.dispatches, "decode_steps": len(win.step_s), "chunks": len(win.chunks),
        "rows_at_tenths": [win.occupancy(win.t_open + q / 10 * win.seconds) for q in range(1, 11)],
        "cap_bytes": rec.cap_bytes, "peak_reserved": peak, **pool}))
    ck = cell.config["check"]
    chosen = check.sample(win.outcomes, seed)
    t = time.perf_counter()
    readings = {"max_logit_gap": 0.0, "mean_logit_gap": 0.0}
    if chosen:
        # the reference computes what the configuration states, whatever
        # precision the program was switched to; a reference control's
        # picks are judged in the served tokens' place
        readings = check.widest_gaps(
            dims, seed, chosen, cell.config["serving"]["precision"], device,
            control_bits=check.BITS[cell.config["control"]["bits"]] if control else None)
    readings["reference_s"] = time.perf_counter() - t
    log("check " + json.dumps(readings))
    checks = {
        "window_served_nothing": {"value": int(not chosen), "limit": 0},
        "pod_over_cap_bytes": {"value": max(0, peak - rec.cap_bytes), "limit": 0},
        **{name: {"value": readings[name], "limit": float(limit)}
           for name, limit in ck["limits"].items()},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    doc = {"correct": correct, "attempted": len(win.live()), "failed": 0, "metrics": metrics,
           "device": device_doc(cuda, peak, rec.trace)}
    if trace and rec.trace is not None:
        doc["breakdown"] = rec.trace["breakdown"]
    doc["checks"] = checks
    return doc, readings


def device_doc(cuda: bool, peak: int, tr: dict | None = None) -> dict:
    doc = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        doc["busy_s"] = tr["busy_s"]
        doc["window_s"] = tr["window_s"]
    return doc
