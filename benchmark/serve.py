"""One pod of a cell: the port's paged serving path, set up as a pod runs it,
and a measured window over it.

Set-up (``Pod``): the env the port's plugin grants the cell's slice
(``LocalAllocator`` over the card as discovery finds it), applied with
``configure_torch_from_env`` (which caps the process at its fraction of the
card); the weights drawn on the device from the seed (``weights.py``) and,
for an int8 configuration, quantized a layer at a time by the program's
``quant.quantize_leaf``; the pool sized by ``paged_plan_from_pod_env``; a
``PagedSlotEngine`` and its ``warmup()``; and, where the mix asks, one pass
that serves each shared prefix once, so the prefix cache is warm.

The window (``Pod.window``): ``PagedSlotEngine.run(trace)`` from an empty
pool; the window opens at the first dispatch once the tick clock reaches
the mix's ``open_at_tick`` and is ended ``seconds`` later by
``request_drain()`` from a timer thread. The benchmark wraps, on the engine
object only, the three step programs (each dispatch's tick and wall time,
and each prompt chunk's position and length) and ``_grow`` (the live
``RequestResult`` of every row admitted, and the row its chunks run in), so
the tokens each request had at the open are known and requests drained
mid-flight keep their times. A
``--trace 1`` run also profiles one stretch of the window (``trace.py``).
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import inspect
import os
import tempfile
import threading
import time

import torch

from . import traffic as TR
from . import weights as W

PRIME_RID0 = 1 << 40  # the priming pass's request ids, above any trace's


@dataclasses.dataclass
class Outcome:
    """One request that arrived in the window; times are ``perf_counter``."""

    rid: int
    prompt_len: int
    max_new: int
    tokens: list[int]
    arrival_s: float
    first_s: float | None
    finish_s: float | None
    prefix_tokens: int
    prompt: tuple[int, ...]
    admitted: bool
    admit_s: float | None = None
    before: int = 0  # tokens it had when the window opened
    slot: int = -1  # the engine row that served it


@dataclasses.dataclass
class Chunk:
    t: float  # perf_counter at dispatch
    fresh: bool  # a row's first chunk (the flash prefill program)
    pos: int
    n: int


@dataclasses.dataclass
class Window:
    """What the window served. ``outcomes`` holds every request that had
    arrived by its close (those that arrived before its open too);
    ``chunks``, ``step_s`` and ``dispatches`` are the window's own."""

    t_open: float
    t_close: float
    outcomes: list[Outcome]
    chunks: list[Chunk]
    step_s: list[float]  # each decode step's wall (the engine's StepProfiler)
    dispatches: int
    drained: bool
    stretch: dict | None  # the profiled stretch: t0, t1 and the trace file

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def arrived(self) -> list[Outcome]:
        """The requests that arrived while the window was open."""
        return [o for o in self.outcomes if o.arrival_s >= self.t_open]

    def live(self) -> list[Outcome]:
        """The requests the window owed: arrived by its close and not
        finished before its open."""
        return [o for o in self.outcomes if o.finish_s is None or o.finish_s >= self.t_open]

    def served(self) -> int:
        """Tokens emitted while the window was open."""
        return sum(len(o.tokens) - o.before for o in self.outcomes)

    def decode_keys(self) -> list[int]:
        """The keys each token decoded in the window attended: a request's
        j-th token (j >= 1) comes from a decode step at position
        prompt_len + j - 1, over prompt_len + j keys (its first comes from
        its prompt's last chunk)."""
        return [o.prompt_len + j for o in self.outcomes
                for j in range(max(1, o.before), len(o.tokens))]

    def occupancy(self, t: float) -> int:
        """Rows holding a request at ``t``: admitted and not yet finished."""
        return sum(o.admit_s is not None and o.admit_s <= t and (o.finish_s is None
                                                                 or o.finish_s > t)
                   for o in self.outcomes)


def model_config(doc: dict):
    """The port's ``TransformerConfig`` of a configuration file."""
    from gpushare_device_plugin_tpu_torch.workloads.transformer import TransformerConfig

    m = W.model_dims(doc)
    if m["Dh"] * m["H"] != m["d"]:
        raise ValueError("the port derives head_dim as hidden_size / heads")
    if m["eps"] != 1e-6:
        raise ValueError("the port's RMSNorm eps is 1e-6")
    return TransformerConfig(
        vocab=m["V"], d_model=m["d"], n_layers=m["L"], n_heads=m["H"], n_kv_heads=m["Hkv"],
        d_ff=m["F"], max_seq=int(doc["max_position_embeddings"]), rope_theta=m["theta"],
        compute_dtype=torch.bfloat16,
    )


def plugin_env(gib: int, discovery: str, **kwargs) -> dict[str, str]:
    """What the port's plugin injects into a pod of one ``gib``-GiB
    container on this node: discovery's chips as the plugin advertises
    them, one first-fit grant."""
    from gpushare_device_plugin_tpu_torch.allocator.local import LocalAllocator
    from gpushare_device_plugin_tpu_torch.device import DeviceInventory
    from gpushare_device_plugin_tpu_torch.discovery import from_name

    (grant,) = LocalAllocator(DeviceInventory(from_name(discovery, **kwargs).chips())).allocate(
        [gib])
    return dict(grant.envs)


def program_weights(m: dict, seed: int, device, precision: str) -> dict:
    """The port's params tree of the raw weights, in the precision served:
    ``"bf16"`` as drawn, ``"int8"`` through ``quant.quantize_leaf`` a layer
    at a time (the bf16 tree never exists whole)."""
    from gpushare_device_plugin_tpu_torch.workloads import quant

    if precision not in ("bf16", "int8"):
        raise ValueError(f"unknown weight precision {precision!r}")
    L = m["L"]

    def served(name, w):
        if precision == "bf16":
            return w
        return quant.quantize_leaf(name, w)

    layers: dict = {}
    for i in range(L):
        raw = W.draw_layer(m, seed, i, device)
        for name, w in raw.items():
            part = served(name, w[None])
            if isinstance(part, dict):
                dest = layers.setdefault(name, {
                    k: torch.empty((L,) + v.shape[1:], dtype=v.dtype, device=device)
                    for k, v in part.items()})
                for k, v in part.items():
                    dest[k][i].copy_(v[0])
            else:
                layers.setdefault(name, torch.empty((L,) + part.shape[1:], dtype=part.dtype,
                                                    device=device))[i].copy_(part[0])
            del part
        del raw
    ones = torch.ones((L, m["d"]), dtype=torch.float32, device=device)
    layers.update(ln1=ones, ln2=ones.clone())
    tree = {"embed": served("embed", W.draw_embed(m, seed, device)), "layers": layers,
            "final_norm": torch.ones((m["d"],), dtype=torch.float32, device=device),
            "out": served("out", W.draw_out(m, seed, device))}
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return tree


class Dispatches:
    """What the window's dispatches did, recorded by wrappers on one engine
    object (its class is untouched)."""

    def __init__(self, engine, open_at_tick: int, on_open):
        self.engine = engine
        self.open_at_tick = open_at_tick
        self.on_open = on_open
        self.stretch = None
        self.opened = None  # at the window's open: its time, and what was served by then
        self.log: list[tuple[int, float, float]] = []  # (tick at entry, entry, exit)
        self.chunks: list[Chunk] = []
        self.results: dict[int, object] = {}
        self.slot_of: dict[int, int] = {}  # rid -> the row its chunks ran in
        self._growing = None  # the request whose row grew last
        self._clock = None
        for name in ("_prefill", "_extend", "_decode"):
            setattr(engine, name, self._wrap(getattr(engine, name), name[1:]))
        grow = engine._grow

        def grown(s, got):
            if s.req is not None and 0 <= s.req.rid < PRIME_RID0:
                self.results[s.req.rid] = s.result
                self._growing = s.req.rid
            return grow(s, got)

        engine._grow = grown

    def _wrap(self, program, kind: str):
        sig = inspect.signature(program)

        def call(*args, **kwargs):
            t_in = time.perf_counter()
            tick = self.engine.ticks
            if self.opened is None and tick >= self.open_at_tick:
                self.opened = {
                    "t": t_in, "steps": self.engine.profiler.count, "chunks": len(self.chunks),
                    "tokens": {rid: len(res.tokens) for rid, res in self.results.items()}}
                self.stretch = self.on_open(t_in)
            if self.stretch is not None:
                self.stretch.before(t_in)
            if kind != "decode":
                a = sig.bind(*args, **kwargs).arguments
                # a row grows its pages just before each of its chunks
                if self._growing is not None:
                    self.slot_of[self._growing] = int(a["slot"])
                self.chunks.append(Chunk(t=t_in, fresh=kind == "prefill",
                                         pos=0 if kind == "prefill" else int(a["pos"]),
                                         n=int(a["n_real"])))
            ns_in = time.time_ns()
            out = program(*args, **kwargs)
            self.log.append((tick, t_in, time.perf_counter()))
            if self.stretch is not None and self.stretch.on:
                self.stretch.spans.append((ns_in, time.time_ns(), f"bench.{kind}"))
            if self.stretch is not None:
                self.stretch.after(kind)
            return out

        return call

    def unwrap(self) -> None:
        for name in ("_prefill", "_extend", "_decode", "_grow"):
            self.engine.__dict__.pop(name, None)

    def arrival_time(self, arrival: float, t_start: float, t_end: float) -> float:
        """When the tick clock reached ``arrival``: a dispatch entered at
        tick k holds the clock at k from its entry and at k + 1 from its
        exit (the engine counts the tick as the dispatch returns)."""
        if arrival <= 0:
            return t_start
        if self._clock is None:
            self._clock = ([v for tick, _, _ in self.log for v in (tick, tick + 1)],
                           [t for _, t_in, t_out in self.log for t in (t_in, t_out)])
        values, times = self._clock
        i = bisect.bisect_left(values, arrival)
        return times[i] if i < len(values) else t_end


class Stretch:
    """The profiled stretch of a ``--trace 1`` window: starts at the first
    dispatch at or after ``start_at``, stops after a dispatch once
    ``min_s`` have passed (and, with ``until_fresh_prefill``, a fresh
    prompt's first chunk ran in it), or ``max_s`` have."""

    def __init__(self, start_at: float, plan: dict, cuda: bool):
        self.start_at = start_at
        self.min_s = float(plan["min_s"])
        self.max_s = float(plan["max_s"])
        self.until_prefill = bool(plan.get("until_fresh_prefill", False))
        self.cuda = cuda
        self.prof = None
        self.on = False
        self.saw_prefill = False
        self.t0 = self.t1 = None
        self.path = None
        # the dispatches inside the stretch: (start, end) in Unix ns, the
        # trace's clock, and the program they ran
        self.spans: list[tuple[int, int, str]] = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def before(self, t: float) -> None:
        if self.prof is None and t >= self.start_at:
            self._sync()
            self.prof = torch.profiler.profile(activities=profiled(self.cuda))
            self.prof.start()
            self.t0 = time.perf_counter()
            self.on = True

    def after(self, kind: str) -> None:
        if not self.on:
            return
        self.saw_prefill |= kind == "prefill"
        el = time.perf_counter() - self.t0
        if (el >= self.min_s and (self.saw_prefill or not self.until_prefill)) or el >= self.max_s:
            self.stop()

    def stop(self) -> None:
        if self.on:
            self._sync()
            self.t1 = time.perf_counter()  # before the profiler flushes its buffers
            self.prof.stop()
            self.on = False

    def export(self) -> str | None:
        """Write the stretch's trace (a Chrome trace) to a temporary file."""
        if self.prof is None:
            return None
        fd, self.path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        return self.path


def profiled(cuda: bool) -> list:
    """The device's activity alone on a card: recording every host op would
    slow the host, which bounds this engine, and inflate the idle share.
    (The CPU's, where there is no card, so the code path runs anywhere.)"""
    P = torch.profiler.ProfilerActivity
    return [P.CUDA] if cuda else [P.CPU]


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once (CUPTI's first start is slow)."""
    with torch.profiler.profile(activities=profiled(cuda)):
        torch.ones(8, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()


class Pod:
    """A serving pod of ``cell`` set up from ``seed`` (see the module doc).
    ``parts`` holds each set-up step's seconds."""

    def __init__(self, cell, seed: int, *, device: str = "cuda", discovery: str = "nvml",
                 discovery_kwargs: dict | None = None, precision: dict | None = None,
                 trace: bool = False):
        from gpushare_device_plugin_tpu_torch.parallel.podenv import (
            MEMORY_FRACTION,
            PodTpuEnv,
            configure_torch_from_env,
        )
        from gpushare_device_plugin_tpu_torch.serving.engine import (
            PagedSlotEngine,
            Request,
            paged_plan_from_pod_env,
        )
        from gpushare_device_plugin_tpu_torch.workloads import quant

        self.cell, self.seed, self.device = cell, seed, device
        self.cuda = torch.device(device).type == "cuda"
        self.parts: dict[str, float] = {}
        serving = cell.config["serving"]
        prec = dict(serving["precision"], **(precision or {}))
        self.precision = prec
        t = time.perf_counter()
        envs = plugin_env(int(serving["pod_gib"]), discovery, **(discovery_kwargs or {}))
        if self.cuda:
            os.environ.update(envs)
            settings = configure_torch_from_env()
            total = torch.cuda.get_device_properties(0).total_memory
        else:
            settings = configure_torch_from_env(envs)
            total = PodTpuEnv.from_env(envs).mem_units_chip * 2**30
        self.fraction = float(settings.get(MEMORY_FRACTION, 1.0))
        self.cap_bytes = int(self.fraction * total)
        self.pod_env = envs
        self.parts["pod_env_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.dims = W.model_dims(cell.config)
        self.cfg = model_config(cell.config)
        self.params = program_weights(self.dims, seed, device, prec["weights"])
        self.weight_bytes = quant.param_bytes(self.params)
        self.parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        kv = None if prec["kv_cache"] == "bf16" else prec["kv_cache"]
        geo = {k: int(serving[k]) for k in ("max_len", "prefill_chunk", "page_size")}
        self.plan = paged_plan_from_pod_env(
            self.cfg, geo["max_len"], weight_bytes=self.weight_bytes, page_size=geo["page_size"],
            prefill_chunk=geo["prefill_chunk"], env=PodTpuEnv.from_env(envs), kv_dtype=kv,
            slots=int(serving["slots"]), headroom=float(serving.get("headroom", 0.90)))
        self.engine = PagedSlotEngine(
            self.params, self.cfg, slots=self.plan.slots, total_pages=self.plan.total_pages,
            eos_id=None, kv_dtype=kv, device=device, profiler_capacity=1 << 16, **geo)
        self._sync()
        self.parts["engine_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.engine.warmup()
        self._sync()
        self.parts["warmup_s"] = time.perf_counter() - t

        t = time.perf_counter()
        mix = cell.traffic
        drawn, prefixes = TR.generate(mix, seed, self.dims["V"])
        self.requests = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new, arrival=r.arrival)
                         for r in drawn]
        self.parts["traffic_s"] = time.perf_counter() - t
        if mix.get("prime_prefixes") and prefixes:
            t = time.perf_counter()
            self.engine.run([Request(rid=PRIME_RID0 + i, prompt=p, max_new=1, arrival=0.0)
                             for i, p in enumerate(prefixes)])
            self._sync()
            self.engine.profiler.reset()
            self.parts["prime_s"] = time.perf_counter() - t
        if trace:
            t = time.perf_counter()
            warm_profiler(self.cuda)
            self.parts["profiler_warm_s"] = time.perf_counter() - t

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def window(self, seconds: float, *, requests=None, trace_plan: dict | None = None) -> Window:
        """Serve the trace from an empty pool; the window opens at the mix's
        ``open_at_tick`` and is drained ``seconds`` later."""
        from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa

        engine = self.engine
        reqs = self.requests if requests is None else requests
        by_rid = {r.rid: r for r in reqs}
        engine.profiler.reset()
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        timer = threading.Timer(seconds, engine.request_drain)

        def on_open(t_open: float):
            """At the window's open, on the engine's thread: the drain's timer
            starts, and a traced run's stretch is placed."""
            timer.start()
            if trace_plan is None:
                return None
            return Stretch(t_open + float(trace_plan["start_frac"]) * seconds, trace_plan,
                           self.cuda)

        rec = Dispatches(engine, int(self.cell.traffic.get("open_at_tick", 0)), on_open)
        try:
            stats = engine.run(reqs)
        finally:
            t_close = time.perf_counter()
            if timer.is_alive():
                timer.cancel()
                timer.join()
            rec.unwrap()
            if rec.stretch is not None:
                rec.stretch.stop()
        stretch = rec.stretch
        if rec.opened is None:
            raise RuntimeError("the trace ended before the window opened")
        t_open = rec.opened["t"]
        before = rec.opened["tokens"]
        self.launches = dict(fa.LAUNCHES)
        snap = engine.drain_snapshot() or {"requests": []}
        drained = bool(snap["requests"])
        t0e = t_close - stats.wall_s  # the engine's own clock starts here
        outcomes = []
        final_tick = engine.ticks
        for rid in sorted(set(rec.results) | {r["rid"] for r in snap["requests"]}):
            req = by_rid[rid]
            if req.arrival > final_tick:
                continue  # not yet arrived when the window closed
            res = rec.results.get(rid)
            arrival = rec.arrival_time(req.arrival, t0e, t_close)
            if res is None:  # arrived, never admitted
                row = next(r for r in snap["requests"] if r["rid"] == rid)
                outcomes.append(Outcome(rid, len(req.prompt), req.max_new, list(row["tokens"]),
                                        arrival, None, None, 0, req.prompt, False))
                continue
            outcomes.append(Outcome(
                rid, len(req.prompt), req.max_new, list(res.tokens), arrival,
                t0e + res.first_token_s if res.first_token_tick >= 0 else None,
                t0e + res.finish_s if res.finish_tick >= 0 else None,
                int(res.prefix_tokens), req.prompt, True,
                t0e + res.admit_s if res.admit_tick >= 0 else None, before.get(rid, 0),
                rec.slot_of.get(rid, -1)))
        st = None
        if stretch is not None and stretch.t0 is not None:
            st = {"t0": stretch.t0, "t1": stretch.t1, "path": stretch.export(),
                  "spans": stretch.spans}
        return Window(t_open=t_open, t_close=t_close, outcomes=outcomes,
                      chunks=rec.chunks[rec.opened["chunks"]:],
                      step_s=list(engine.profiler.window())[rec.opened["steps"]:],
                      dispatches=sum(t_in >= t_open for _, t_in, _ in rec.log),
                      drained=drained, stretch=st)

    def close(self) -> None:
        """Free the engine and the weights (the reference runs after)."""
        self.engine = None
        self.params = None
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
