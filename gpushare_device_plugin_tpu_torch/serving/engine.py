"""Continuous-batching serving engines over slot-pool KV caches, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/serving/engine.py``
(``SlotEngine``, ``PagedSlotEngine`` in its base mode, the
request/result/stats records, ``poisson_trace``, ``shared_prefix_trace``
and slice sizing, from a byte count or from the plugin's env:
``slots_from_pod_env``, ``slots_for_gang``, ``paged_plan_from_pod_env``). ``SlotEngine`` keeps a fixed pool of KV-cache rows
(``init_slot_cache``):

- admission packs a waiting request into a free row, one fixed-width
  prompt chunk per loop turn (``prefill_slot`` for the first chunk, then
  ``extend_slot``), so decoding rows keep decoding while a prompt
  streams in;
- one pool-wide ``decode_step`` advances every decoding row by a token;
  a row that emits EOS or reaches its ``max_new`` retires at once and
  its slot takes the next request;
- greedy decoding: every request's tokens are those of a solo greedy
  ``generate()`` of its prompt.

``PagedSlotEngine`` keeps the same loop over a paged cache
(``init_paged_cache``, ``pages.py``), with a radix prefix cache, SLO-tier
preemption, drain/restore, multi-LoRA serving (many tenants' adapters
paged beside the KV, ``adapters.py``, one dispatch for any mix of
tenants and base-model rows) and speculative decoding (a draft model's
KV in the same pages, one draft and one verify dispatch a round).

**Static shapes.** The pool, the chunk width and the step batch never
change shape. PyTorch compiles nothing here, so ``trace_counts`` is a
shape guard: each program (prefill, extend, decode; draft and verify on a
speculative engine) records the distinct input shapes it has run on, and
slot churn must leave every count at 1.

**Tensor parallelism.** Both engines take a ``mesh`` (a granted gang's,
``parallel/podenv.py::gang_mesh``), kept only when its tp is above 1: the
engine then holds its rank's shard of the weights
(``transformer.shard_params``) and of every cache, adapter slab and
draft pool (the rank's kv heads, its adapter view), and every program
runs the tp collectives. Each rank runs its own copy of this host loop,
so every rank must dispatch the same program at the same turn: the
schedule is deterministic, and the two decisions that read a clock or
another thread (an engaged governor's draft shedding, a concurrent
:meth:`PagedSlotEngine.request_drain`) are rank 0's, broadcast.

**Clocks.** Ticks (one per model dispatch: a prompt chunk or a decode
step) and wall seconds, as in the reference.

**Observability** (the interference plane): every decode step's wall
time goes into ``profiler`` (a ring), flushed to ``/metrics`` under
``metrics_pod`` once per run; each retired request leaves a
``serve.request`` span tree, rebuilt at retire from timestamps the loop
keeps anyway, and its SLO verdict in ``slo_budget``; a best-effort
engine's ``governor`` (``governor.py``) is asked before every model
dispatch and may delay it, never alter it. The paged engine also
publishes its pages, prefix cache, preemptions, adapters and speculative
counters (:meth:`PagedSlotEngine.publish_metrics`). Warmup adds no
sample to a histogram or counter (``_warming``); its gauges are
overwritten by the next run.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from ..const import (
    SLO_TIER_BEST_EFFORT,
    SLO_TIER_CRITICAL,
    WORKLOAD_BEST_EFFORT,
    WORKLOAD_LATENCY_CRITICAL,
    MemoryUnit,
)
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.mesh import Mesh
from ..parallel.podenv import PodTpuEnv
from ..utils.metric_catalog import (
    ENGINE_ADAPTER_ENABLED,
    ENGINE_ADAPTER_EVICTIONS_TOTAL,
    ENGINE_ADAPTER_HITS_TOTAL,
    ENGINE_ADAPTER_MISS_STALL_SECONDS,
    ENGINE_ADAPTER_MISSES_TOTAL,
    ENGINE_PREEMPTIONS,
    ENGINE_PREEMPTIONS_TOTAL,
    ENGINE_PREFIX_CACHED_PAGES,
    ENGINE_PREFIX_HIT_RATIO,
    ENGINE_PREFIX_HIT_TOKENS,
    ENGINE_SPEC_ACCEPTANCE_LEN,
    ENGINE_SPEC_ACCEPTED_TOKENS_PER_STEP,
    ENGINE_SPEC_DRAFT_STEPS_TOTAL,
    ENGINE_SPEC_ENABLED,
    ENGINE_SPEC_K,
    ENGINE_SPEC_ROLLBACK_PAGES_TOTAL,
)
from ..utils.metrics import REGISTRY, publish_build_info
from ..utils.tracing import TRACER
from ..workloads import generate as G
from ..workloads.lora import LoraConfig, flatten_lora, lora_flat_len
from ..workloads.transformer import TransformerConfig, shard_params
from .adapters import AdapterCache
from .drainproto import DrainHandshake
from .pages import SCRATCH, PagedPlan, PageAllocator, paged_plan_for_slice, pages_for, row_span_for
from .profiler import StepProfiler, ceil_rank_quantile
from .radix import RadixCache

log = logging.getLogger(__name__)

TIER_CRITICAL = SLO_TIER_CRITICAL
TIER_BEST_EFFORT = SLO_TIER_BEST_EFFORT
_TIERS = (TIER_CRITICAL, TIER_BEST_EFFORT)
# The AdapterCache speaks workload-class names; a request's tier maps 1:1.
_TIER_CLASS = {TIER_CRITICAL: WORKLOAD_LATENCY_CRITICAL, TIER_BEST_EFFORT: WORKLOAD_BEST_EFFORT}


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``arrival`` is in engine ticks; ``tier`` and
    the tick-clock targets ``slo_ttft_ticks`` / ``slo_tpot_ticks`` are
    scored in :meth:`ServeStats.summary`."""

    rid: int
    prompt: tuple[int, ...]
    max_new: int
    arrival: float = 0.0
    tier: str = TIER_CRITICAL
    slo_ttft_ticks: float | None = None
    slo_tpot_ticks: float | None = None
    # the tenant's LoRA adapter ("" = the base model, the null adapter): a
    # multi-LoRA PagedSlotEngine pins it from its lora_store for the
    # request's lifetime; an engine without a store rejects a non-empty id
    adapter_id: str = ""

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")
        if self.tier not in _TIERS:
            raise ValueError(f"request {self.rid}: tier {self.tier!r} not in {_TIERS}")


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome and latency on both clocks."""

    rid: int
    prompt_len: int
    tokens: list[int]
    arrival_tick: float
    first_token_tick: int = -1
    finish_tick: int = -1
    arrival_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    admit_tick: int = -1
    admit_s: float = 0.0
    trace_id: str = ""  # the request's serve trace; "" when unsampled
    tier: str = TIER_CRITICAL
    slo_ttft_ticks: float | None = None
    slo_tpot_ticks: float | None = None
    # paged engine: prompt tokens served from the radix cache, and one dict
    # per preemption ({evict,readmit}_{tick,s})
    prefix_tokens: int = 0
    preemptions: list[dict] = dataclasses.field(default_factory=list)

    @property
    def ttft_ticks(self) -> float:
        return self.first_token_tick - self.arrival_tick

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def tpot_ticks(self) -> float:
        """Ticks per output token after the first (nan for one token)."""
        if len(self.tokens) <= 1:
            return float("nan")
        return (self.finish_tick - self.first_token_tick) / (len(self.tokens) - 1)

    def meets_slo(self) -> bool | None:
        if self.slo_ttft_ticks is None and self.slo_tpot_ticks is None:
            return None
        if self.slo_ttft_ticks is not None and self.ttft_ticks > self.slo_ttft_ticks:
            return False
        if (
            self.slo_tpot_ticks is not None and len(self.tokens) > 1
            and self.tpot_ticks > self.slo_tpot_ticks
        ):
            return False
        return True


@dataclasses.dataclass
class ServeStats:
    """One serving run's results and aggregate metrics."""

    results: list[RequestResult]
    ticks: int
    wall_s: float
    trace_counts: dict[str, int]
    # the paged engine's cache telemetry (PagedSlotEngine.cache_stats)
    engine_cache: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def _quantile(vals: list[float], q: float) -> float:
        return ceil_rank_quantile(vals, q)

    def _spec_tiers(self) -> dict:
        return (self.engine_cache.get("speculative") or {}).get("tiers") or {}

    def tier_summary(self) -> dict:
        out: dict = {}
        spec_tiers = self._spec_tiers()
        for tier in sorted({r.tier for r in self.results} | set(spec_tiers)):
            rs = [r for r in self.results if r.tier == tier]
            tpot = [r.tpot_ticks for r in rs if len(r.tokens) > 1]
            scored = [s for s in (r.meets_slo() for r in rs) if s is not None]
            out[tier] = {
                "requests": len(rs),
                "ttft_p50_ticks": self._quantile([r.ttft_ticks for r in rs], 0.50),
                "ttft_p99_ticks": self._quantile([r.ttft_ticks for r in rs], 0.99),
                "tpot_p50_ticks": round(self._quantile(tpot, 0.50), 3) if tpot else None,
                "tpot_p99_ticks": round(self._quantile(tpot, 0.99), 3) if tpot else None,
                "preemptions": sum(len(r.preemptions) for r in rs),
                "slo_attainment": round(sum(scored) / len(scored), 3) if scored else None,
            }
            if tier in spec_tiers:
                # which tier the draft's proposals pay off for
                out[tier]["spec_proposed"] = spec_tiers[tier]["proposed"]
                out[tier]["spec_accepted"] = spec_tiers[tier]["accepted"]
        return out

    def summary(self) -> dict:
        tokens = sum(len(r.tokens) for r in self.results)
        ttft_t = [r.ttft_ticks for r in self.results]
        ttft_s = [r.ttft_s for r in self.results]
        out = {
            "requests": len(self.results),
            "tokens": tokens,
            "ticks": self.ticks,
            "wall_s": round(self.wall_s, 4),
            "goodput_tokens_per_s": round(tokens / self.wall_s, 1) if self.wall_s > 0 else None,
            "goodput_tokens_per_tick": round(tokens / max(self.ticks, 1), 3),
            "ttft_p50_ticks": self._quantile(ttft_t, 0.50),
            "ttft_p99_ticks": self._quantile(ttft_t, 0.99),
            "ttft_p50_ms": round(self._quantile(ttft_s, 0.50) * 1e3, 2),
            "ttft_p99_ms": round(self._quantile(ttft_s, 0.99) * 1e3, 2),
            "trace_counts": dict(self.trace_counts),
        }
        if any(r.tier != TIER_CRITICAL or r.meets_slo() is not None
               for r in self.results) or self._spec_tiers():
            out["tiers"] = self.tier_summary()
        if self.engine_cache:
            out["cache"] = dict(self.engine_cache)
        return out


@dataclasses.dataclass
class _Slot:
    state: str = "free"  # free | prefill | decode
    req: Request | None = None
    done: int = 0  # prompt tokens prefilled so far
    last: int = 0  # last sampled token (decode input)
    result: RequestResult | None = None


class SlotEngine:
    """Continuous-batching engine over ``slots`` KV-cache rows of
    ``max_len`` positions, with ``prefill_chunk``-wide prompt chunks.
    ``params`` must already live on ``device`` (``cuda`` unless
    ``device="cpu"``). A request whose chunk-padded prompt or
    ``prompt + max_new`` cannot fit a row is rejected at submit time.
    ``metrics_pod`` labels what the engine publishes (nothing is
    exported without it), ``slo_budget`` (``utils/slo.py``) takes each
    retired request's SLO verdict, and ``governor``
    (:class:`~.governor.StepGovernor`) paces every model dispatch. With a
    tp ``mesh`` (every rank calls this alike, with the whole ``params``
    or its shard of them), the engine serves on the rank's shards
    (module docstring), on the mesh's device."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        slots: int,
        max_len: int,
        prefill_chunk: int = 64,
        eos_id: int | None = None,
        kv_dtype: str | None = None,
        device: str | torch.device | None = None,
        profiler_capacity: int = 1024,
        metrics_pod: str = "",
        slo_budget=None,
        governor=None,
        mesh: Mesh | None = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if max_len > cfg.max_seq:
            raise ValueError(
                f"max_len {max_len} exceeds cfg.max_seq {cfg.max_seq} "
                "(RoPE table bound)"
            )
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} exceeds the slot row "
                f"({max_len} positions) — even one chunk cannot be packed"
            )
        self.mesh = _tp_mesh(mesh)
        self.device = resolve_device(self.mesh.device if self.mesh is not None and device is None
                                     else device)
        self.params = params if self.mesh is None else shard_params(params, self.mesh, cfg)
        self.cfg = cfg
        self.n_slots = slots
        self.max_len = max_len
        self.chunk = prefill_chunk
        self.eos_id = eos_id
        self.kv_dtype = kv_dtype
        self.cache = self._make_cache(kv_dtype)
        self.ticks = 0
        self._shapes: dict[str, set] = {"prefill": set(), "extend": set(), "decode": set()}
        self.metrics_pod = metrics_pod
        self.profiler = StepProfiler(capacity=profiler_capacity)
        self.slo_budget = slo_budget
        self.governor = governor
        self._warming = False
        publish_build_info(component="engine")

    def _make_cache(self, kv_dtype: str | None) -> G.KVCache:
        """The KV layout the engine runs on (the paged engine overrides it)."""
        return G.init_slot_cache(self.cfg, self.n_slots, self.max_len, kv_dtype=kv_dtype,
                                 device=self.device, mesh=self.mesh)

    def _agreed(self, flag: bool) -> bool:
        """A host decision every tp rank takes alike: rank 0's ``flag``,
        broadcast over the gang (``flag`` itself without a mesh)."""
        if self.mesh is None:
            return flag
        dev = "cpu" if self.mesh.backend == "gloo" else self.device
        t = torch.tensor([int(flag)], device=dev)
        dist.broadcast(t, src=self.mesh.axis_ranks("tp")[0], group=self.mesh.group("tp"))
        return bool(t.item())

    @property
    def trace_counts(self) -> dict[str, int]:
        """Distinct input shapes each program has run on (the shape guard)."""
        return {name: len(seen) for name, seen in self._shapes.items()}

    def _guard(self, program: str, *tensors: torch.Tensor) -> None:
        self._shapes[program].add(tuple((tuple(t.shape), t.dtype) for t in tensors))

    def _prefill(self, tokens: torch.Tensor, slot: int, n_real: int) -> torch.Tensor:
        self._guard("prefill", tokens, self.cache["k"], self.cache["len"])
        logits, self.cache = G.prefill_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, n_real=n_real, mesh=self.mesh
        )
        return torch.argmax(logits[0], -1)

    def _extend(self, tokens: torch.Tensor, slot: int, n_real: int) -> torch.Tensor:
        self._guard("extend", tokens, self.cache["k"], self.cache["len"])
        logits, self.cache = G.extend_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, n_real=n_real, mesh=self.mesh
        )
        return torch.argmax(logits[0], -1)

    def _decode(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        self._guard("decode", tokens, active, self.cache["k"], self.cache["len"])
        logits, new = G.decode_step(self.params, tokens, self.cache, self.cfg, mesh=self.mesh)
        # Idle rows (free, mid-prefill) must not advance: their next
        # chunk or decode write lands where their real content ends.
        new["len"] = torch.where(active, new["len"], self.cache["len"])
        self.cache = new
        return torch.argmax(logits, -1)

    def warmup(self) -> None:
        """Run all three programs once off the clock (fresh-slot prefill,
        continuation chunk, decode step). Slot 0's row is scribbled on,
        which the visibility invariant makes safe; ticks and the step
        profile are reset afterwards."""
        plen = self.chunk + 1
        if max(2 * self.chunk, plen + 2) > self.max_len:
            plen = min(self.chunk, self.max_len - 2)
        self._warming = True
        try:
            self.run([Request(rid=-1, prompt=tuple(range(1, plen + 1)), max_new=2, arrival=0.0)])
        finally:
            self._warming = False
        self.ticks = 0
        self.profiler.reset()

    def validate(self, req: Request) -> None:
        # Every prefill write is a FULL chunk, so the prompt's footprint
        # is its chunk-padded length.
        plen = len(req.prompt)
        padded = -(-plen // self.chunk) * self.chunk
        need = max(padded, plen + req.max_new)
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {plen} (chunk-padded {padded}) "
                f"+ max_new {req.max_new} needs {need} positions, exceeding "
                f"the slot row ({self.max_len}) — size the pool for the "
                "workload or reject upstream (slice-aware admission)"
            )

    def _note_slo(self, res: RequestResult) -> None:
        """The retired request's SLO verdict into ``slo_budget``; requests
        without targets, and warmup's, record nothing."""
        if self.slo_budget is None or res.rid < 0:
            return
        ok = res.meets_slo()
        if ok is not None:
            self.slo_budget.record(res.tier, ok)

    def _flush_step_profile(self) -> None:
        """Export the step profile once per run (never during warmup)."""
        if not self._warming:
            self.profiler.flush(REGISTRY, pod=self.metrics_pod)

    def _record_request_trace(self, res: RequestResult, base_ns: int) -> None:
        """The request's spans (queue wait, prefill, decode, retire, and
        one per preemption), rebuilt at retire from the run's timestamps,
        so the decode loop pays nothing. Unsampled requests, and warmup's,
        record nothing."""
        if res.rid < 0:
            return

        def at(seconds: float) -> int:
            return base_ns + int(seconds * 1e9)

        attrs = {
            "rid": res.rid,
            "prompt_len": res.prompt_len,
            "tokens": len(res.tokens),
            "ttft_ticks": res.ttft_ticks,
            "slots": self.n_slots,
            "tier": res.tier,
        }
        if res.prefix_tokens:
            attrs["prefix_tokens"] = res.prefix_tokens
        ctx = TRACER.record_span("serve.request", at(res.arrival_s), at(res.finish_s),
                                 attributes=attrs, tier=res.tier)
        if ctx is None:
            return
        res.trace_id = ctx.trace_id
        admit = res.admit_s if res.admit_tick >= 0 else res.arrival_s
        TRACER.record_span("serve.queue", at(res.arrival_s), at(admit), parent=ctx,
                           attributes={"wait_ticks": max(0, res.admit_tick - res.arrival_tick)})
        TRACER.record_span("serve.prefill", at(admit), at(res.first_token_s), parent=ctx,
                           attributes={"chunks": -(-res.prompt_len // self.chunk),
                                       "chunk_width": self.chunk})
        TRACER.record_span("serve.decode", at(res.first_token_s), at(res.finish_s), parent=ctx,
                           attributes={"decode_steps": max(0, len(res.tokens) - 1)})
        TRACER.record_span("serve.retire", at(res.finish_s), at(res.finish_s), parent=ctx,
                           attributes={"finish_tick": res.finish_tick})
        for pre in res.preemptions:
            # evict -> re-admission (or the finish of a request drained
            # while preempted)
            TRACER.record_span(
                "serve.preempt", at(pre["evict_s"]), at(pre.get("readmit_s", res.finish_s)),
                parent=ctx,
                attributes={"evict_tick": pre["evict_tick"],
                            "readmit_tick": pre.get("readmit_tick", -1), "tier": res.tier},
            )

    def _chunk(self, req: Request, done: int) -> tuple[torch.Tensor, int]:
        real = req.prompt[done : done + self.chunk]
        buf = np.zeros((self.chunk,), np.int64)
        buf[: len(real)] = real
        return torch.from_numpy(buf).to(self.device), len(real)

    def run(self, requests: Sequence[Request]) -> ServeStats:
        """Serve ``requests`` to completion. Each loop turn: move arrived
        requests to the queue, admit queued requests into free slots, run
        ONE prompt chunk for the oldest mid-prefill slot, then one decode
        step across all decoding slots. Each dispatch is one tick."""
        for r in requests:
            self.validate(r)
        self.ticks = 0
        incoming = sorted(requests, key=lambda r: (r.arrival, r.rid))
        slots = [_Slot() for _ in range(self.n_slots)]
        pending: deque[Request] = deque()
        results: list[RequestResult] = []
        live: dict[int, RequestResult] = {}
        i = 0
        t0 = time.perf_counter()
        base_ns = time.time_ns()  # wall anchor of the request spans

        def now() -> float:
            return time.perf_counter() - t0

        def retire(idx: int) -> None:
            s = slots[idx]
            s.result.finish_tick = self.ticks
            s.result.finish_s = now()
            results.append(s.result)
            self._record_request_trace(s.result, base_ns)
            self._note_slo(s.result)
            slots[idx] = _Slot()

        while i < len(incoming) or pending or any(s.state != "free" for s in slots):
            while i < len(incoming) and incoming[i].arrival <= self.ticks:
                req = incoming[i]
                live[req.rid] = RequestResult(
                    rid=req.rid, prompt_len=len(req.prompt), tokens=[],
                    arrival_tick=req.arrival, arrival_s=now(), tier=req.tier,
                    slo_ttft_ticks=req.slo_ttft_ticks,
                    slo_tpot_ticks=req.slo_tpot_ticks,
                )
                pending.append(req)
                i += 1
            if not pending and all(s.state == "free" for s in slots):
                # Pool idle, nothing queued: jump to the next arrival.
                self.ticks = max(self.ticks, int(math.ceil(incoming[i].arrival)))
                continue

            for idx, s in enumerate(slots):
                if s.state == "free" and pending:
                    req = pending.popleft()
                    res = live[req.rid]
                    res.admit_tick = self.ticks
                    res.admit_s = now()
                    slots[idx] = _Slot(state="prefill", req=req, done=0, result=res)

            pre = [idx for idx, s in enumerate(slots) if s.state == "prefill"]
            if pre:
                idx = min(pre, key=lambda j: slots[j].result.arrival_tick)
                s = slots[idx]
                tokens, n_real = self._chunk(s.req, s.done)
                if self.governor is not None:
                    # a prompt chunk is a dispatch too: pace it like a step
                    self.governor.before_step()
                fn = self._prefill if s.done == 0 else self._extend
                tok = fn(tokens, idx, n_real)
                self.ticks += 1
                s.done += n_real
                if s.done == len(s.req.prompt):
                    first = int(tok)
                    s.result.first_token_tick = self.ticks
                    s.result.first_token_s = now()
                    s.result.tokens.append(first)
                    if (self.eos_id is not None and first == self.eos_id) or s.req.max_new == 1:
                        retire(idx)
                    else:
                        s.state = "decode"
                        s.last = first

            dec = [idx for idx, s in enumerate(slots) if s.state == "decode"]
            if dec:
                toks = np.zeros((self.n_slots,), np.int64)
                active = np.zeros((self.n_slots,), bool)
                for idx in dec:
                    toks[idx] = slots[idx].last
                    active[idx] = True
                if self.governor is not None:
                    # may sleep, never skips: outside the timed step, so
                    # pacing is not read as contention
                    self.governor.before_step()
                step_t0 = time.perf_counter()
                nxt = self._decode(
                    torch.from_numpy(toks).to(self.device),
                    torch.from_numpy(active).to(self.device),
                )
                self.ticks += 1
                nxt = nxt.cpu().numpy()  # waits for the step's device work
                self.profiler.record(time.perf_counter() - step_t0)
                for idx in dec:
                    s = slots[idx]
                    t = int(nxt[idx])
                    s.result.tokens.append(t)
                    s.last = t
                    if (
                        self.eos_id is not None and t == self.eos_id
                    ) or len(s.result.tokens) >= s.req.max_new:
                        retire(idx)

        results.sort(key=lambda r: r.rid)
        self._flush_step_profile()
        return ServeStats(
            results=results, ticks=self.ticks, wall_s=time.perf_counter() - t0,
            trace_counts=self.trace_counts,
        )


# ---------------------------------------------------------------------------
# paged engine: page-table KV + radix prefix cache + SLO-tiered admission
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PagedSlot:
    state: str = "free"  # free | prefill | decode
    req: Request | None = None
    # effective prompt: the original prompt plus tokens generated before a
    # preemption or a drain (re-admission prefills them again)
    prompt: tuple[int, ...] = ()
    done: int = 0  # prompt tokens materialized in the row (incl. prefix hits)
    pos: int = 0  # logical row length (host mirror of len[slot])
    last: int = 0
    result: RequestResult | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    table: np.ndarray | None = None  # [row_pages] int32 physical page ids
    # [pages_per_adapter] int32 slab page ids of the row's adapter (None
    # without a lora_store; all SCRATCH = the null adapter, a zero delta)
    atable: np.ndarray | None = None
    # True when the row's draft-pool KV is not to be trusted (a handoff
    # import carries the target's KV only): the row plain-decodes for its
    # lifetime and its pages never go into the radix tree, where a later
    # prefix match would speculate over draft KV that was never written
    draft_stale: bool = False


class PagedSlotEngine(SlotEngine):
    """:class:`SlotEngine` over paged KV: rows read and write through
    per-request page tables (``pages.py``) instead of owning a contiguous
    ``max_len`` row, so a request pins only the pages its tokens occupy.
    On top of the allocator:

    - a radix prefix cache (``radix.py``): requests that share a system
      prompt prefill it once and branch by reference-counted pages
      (``radix=False`` disables it);
    - SLO-tiered admission: :data:`TIER_CRITICAL` requests admit ahead of
      :data:`TIER_BEST_EFFORT` ones and, under page pressure, evict radix
      pages and then preempt best-effort rows, whose requests re-queue and
      prefill again on re-admission;
    - drain and restore (:meth:`request_drain`, :meth:`restore_snapshot`)
      and the page export/import of a KV handoff;
    - the two halves of disaggregated serving (``handoff.py``): on a
      prefill tier (:meth:`set_handoff_sink`) a request whose prompt is
      done with decode work left is exported at its first token — its
      pages fetched to the host in the cache's own dtype — and retired;
      on a decode tier, an imported request (:meth:`seed_handoff_import`)
      is admitted straight into decode state on pages whose KV was
      written by :meth:`import_kv_pages`, under its own adapter;
    - multi-LoRA serving (``lora_store`` and ``lora_cfg``, given
      together): each request's ``adapter_id`` names its tenant's adapter
      in ``lora_store`` (``""`` runs the base model). Adapters live as
      flat f32 vectors in a slab ``[total_pages + 1, page_size * d_model]``
      whose rows are pages of the same allocator as the KV, with an
      :class:`~.adapters.AdapterCache` as the ledger; every dispatch
      gathers each row's adapter through its adapter page table, so a
      batch that mixes tenants and base rows is one dispatch per step.
      Idle adapters are the first rung of the eviction ladder, before
      radix pages and preemption. Radix pages are shared only within one
      adapter id. Size the pool with ``paged_plan_for_slice(lora=True)``;
    - speculative decoding (``draft_params`` and ``draft_cfg``, given
      together): a draft model proposes ``spec_k`` tokens per decoding row
      a round (one draft dispatch of ``spec_k + 1`` steps), the target
      scores every row's block in one verify dispatch
      (``paged_verify_block``), and each row emits its longest accepted
      prefix plus the target's own next token: the plain engine's tokens.
      The draft's KV lives in a second pool indexed by the same page ids
      and tables, so one allocator and one refcount cover both; every
      program that writes the target's KV writes the draft's in the same
      engine call. Lookahead pages come from a plain ``allocator.alloc``:
      drafts sit below adapters, radix pages and rows on the eviction
      ladder, and a starved row plain-decodes; rejected positions' tail
      pages go back after the verify. Draft programs run the base model;
      the verify carries each row's adapter. Size the pool with
      ``paged_plan_for_slice(draft_cfg=..., draft_weight_bytes=...)``.

    Greedy tokens are those of a solo ``generate()`` (of ``merge_lora``'s
    weights for a tenant's request): each layer gathers a row's pages into
    the contiguous layout before running the slot pool's layer math, and
    page tables and adapter tables are data, so the shape guard stays at
    one shape per program through churn, preemption and any tenant mix.

    Geometry: ``prefill_chunk`` must be a page-size multiple (radix
    matches floor to chunk boundaries) and ``total_pages`` must cover one
    ``max_len`` row (a lone request can always finish). ``metrics_pod``,
    ``slo_budget`` and ``governor`` are :class:`SlotEngine`'s; an engaged
    governor sheds draft dispatches first (a round is optional work, the
    plain step is not)."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        slots: int,
        max_len: int,
        total_pages: int,
        page_size: int,
        prefill_chunk: int = 64,
        eos_id: int | None = None,
        kv_dtype: str | None = None,
        radix: bool = True,
        device: str | torch.device | None = None,
        profiler_capacity: int = 1024,
        draft_params=None,
        draft_cfg: TransformerConfig | None = None,
        spec_k: int = 4,
        lora_store: dict | None = None,
        lora_cfg: LoraConfig | None = None,
        metrics_pod: str = "",
        slo_budget=None,
        governor=None,
        mesh: Mesh | None = None,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if (lora_store is None) != (lora_cfg is None):
            raise ValueError(
                "lora_store and lora_cfg enable multi-LoRA serving "
                "together — passing one without the other is a config bug"
            )
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError(
                "draft_params and draft_cfg enable speculative decoding "
                "together — passing one without the other is a config bug"
            )
        if draft_cfg is not None:
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target vocab "
                    f"{cfg.vocab} — draft proposals could never be compared "
                    "token-for-token against target greedy picks"
                )
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if prefill_chunk % page_size != 0:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of "
                f"page_size {page_size} (radix matches floor to chunk "
                "boundaries, so shared pages must cover whole chunks)"
            )
        if total_pages < pages_for(max_len, page_size):
            raise ValueError(
                f"total_pages {total_pages} cannot cover one {max_len}"
                f"-position row ({pages_for(max_len, page_size)} pages of "
                f"{page_size}) — even a lone request could deadlock; size "
                "the pool with paged_plan_for_slice"
            )
        self.page_size = page_size
        self.total_pages = total_pages
        # The table spans max_len rounded up to a chunk multiple, so the
        # final chunk's pad tail maps to SCRATCH entries instead of the last
        # real page; row_span_for keeps this width and the sizing math's
        # the same.
        self.row_pages = row_span_for(max_len, prefill_chunk) // page_size
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = int(spec_k)
        # True parks every row on the plain decode path (a suspended
        # speculative engine emits the plain engine's stream)
        self._spec_suspended = False
        self.lora_store = lora_store
        self.lora_cfg = lora_cfg
        if lora_cfg is not None:
            # one slab row per pool page; an adapter's flat vector stripes
            # over ceil(len / row) pages of the KV pool's id space. On a tp
            # gang whose tp divides d_model a row is 1/tp as wide (the
            # per-chip charge of paged_plan_for_slice), and the vector is
            # the rank's view (its B slices of column-parallel targets, A
            # slices of row-parallel ones, the rest whole), so an adapter
            # may take more pages than on one chip.
            tp_mesh = _tp_mesh(mesh)
            tp = 1 if tp_mesh is None else tp_mesh.shape["tp"]
            row = page_size * cfg.d_model
            self._adapter_page_floats = row // tp if cfg.d_model % tp == 0 else row
            self.pages_per_adapter = max(
                1, -(-lora_flat_len(cfg, lora_cfg, tp_mesh) // self._adapter_page_floats))
        super().__init__(
            params, cfg, slots=slots, max_len=max_len, prefill_chunk=prefill_chunk,
            eos_id=eos_id, kv_dtype=kv_dtype, device=device,
            profiler_capacity=profiler_capacity, metrics_pod=metrics_pod,
            slo_budget=slo_budget, governor=governor, mesh=mesh,
        )
        self.allocator = PageAllocator(total_pages)
        self.radix = RadixCache(page_size, self.allocator) if radix else None
        self.preemptions = 0
        self.adapters = None
        if lora_cfg is not None:
            self.adapters = AdapterCache(self.allocator, self.pages_per_adapter)
            # row SCRATCH is the null adapter and stays zero
            self._lora_slab = torch.zeros(
                (total_pages + 1, self._adapter_page_floats), dtype=torch.float32,
                device=self.device,
            )
            # each layer's adapter page columns, read a layer at a time
            self._lora_reads = G.lora_layer_reads(self.cfg, lora_cfg,
                                                  self._adapter_page_floats, self.mesh,
                                                  self.device)
            self._reset_adapter_pub()
        self.draft_cache = None
        if draft_cfg is not None:
            self._shapes.update(draft=set(), verify=set())
            # the draft's KV: a second pool under the same page ids, so a
            # page exists in both pools or in neither; on a gang both the
            # draft's weights and its pool are cut by the draft's config
            if self.mesh is not None:
                self.draft_params = shard_params(draft_params, self.mesh, draft_cfg)
            self.draft_cache = G.init_paged_cache(
                draft_cfg, slots, total_pages + 1, page_size, kv_dtype=kv_dtype,
                device=self.device, mesh=self.mesh,
            )
            self._reset_spec_stats()
        self._drain = DrainHandshake()
        # rid -> tokens already generated elsewhere (a drained snapshot's,
        # or a handoff's first token): the result starts with them and
        # admission prefills prompt + tokens
        self._restore_tokens: dict[int, tuple[int, ...]] = {}
        # the prefill tier's export sink, and rid -> a staged KV import of
        # the decode tier (pages already written, adopted at admission)
        self._handoff_sink = None
        self._import_seeds: dict[int, dict] = {}
        # snapshot_ids this engine already restored: a mover may deliver the
        # same snapshot twice, and the second delivery must not serve again
        self._restored_ids: deque[str] = deque(maxlen=16)

    def _make_cache(self, kv_dtype: str | None) -> G.KVCache:
        # +1: physical page 0 is the scratch write sink (pages.SCRATCH)
        return G.init_paged_cache(
            self.cfg, self.n_slots, self.total_pages + 1, self.page_size,
            kv_dtype=kv_dtype, device=self.device, mesh=self.mesh,
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of ``arr``: through pinned memory on the
        card, so the copy is asynchronous."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _lora_kw(self, atab: torch.Tensor | None) -> dict:
        """The programs' LoRA arguments: with a store, every dispatch
        gathers its rows' adapters (``atab`` [B, AP] adapter page tables;
        all SCRATCH for base-model rows) from the slab, a layer at a time."""
        if (self.adapters is None) != (atab is None):
            raise ValueError("adapter tables go to the programs of an engine with a "
                             "lora_store, and only to those")
        if atab is None:
            return {}
        return {
            "lora": G.LoraRows(self._lora_slab, atab.long(), self._lora_reads),
            "lora_scale": self.lora_cfg.scale,
        }

    def _lora_guard(self, atab: torch.Tensor | None) -> tuple:
        return () if atab is None else (atab, self._lora_slab)

    def _spec_guard(self) -> tuple:
        return () if self.draft_cache is None else (self.draft_cache["k"],
                                                    self.draft_cache["len"])

    def _prefill(self, tokens: torch.Tensor, slot: int, table: torch.Tensor,
                 n_real: int, atab: torch.Tensor | None = None) -> torch.Tensor:
        """The fresh-row chunk; a speculative engine's draft prefills the
        same chunk through the same table in the same call, so its pool
        never falls out of step with the target's."""
        self._guard("prefill", tokens, table, self.cache["k"], self.cache["len"],
                    *self._spec_guard(), *self._lora_guard(atab))
        logits, self.cache = G.paged_prefill_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, page_table=table,
            n_real=n_real, mesh=self.mesh, **self._lora_kw(atab),
        )
        if self.draft_cache is not None:
            _, self.draft_cache = G.paged_prefill_slot(
                self.draft_params, tokens, self.draft_cache, self.draft_cfg, slot=slot,
                page_table=table, n_real=n_real, mesh=self.mesh,
            )
        return torch.argmax(logits[0], -1)

    def _extend(self, tokens: torch.Tensor, slot: int, table: torch.Tensor, pos: int,
                n_real: int, atab: torch.Tensor | None = None) -> torch.Tensor:
        self._guard("extend", tokens, table, self.cache["k"], self.cache["len"],
                    *self._spec_guard(), *self._lora_guard(atab))
        logits, self.cache = G.paged_extend_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, page_table=table,
            pos=pos, n_real=n_real, mesh=self.mesh, **self._lora_kw(atab),
        )
        if self.draft_cache is not None:
            _, self.draft_cache = G.paged_extend_slot(
                self.draft_params, tokens, self.draft_cache, self.draft_cfg, slot=slot,
                page_table=table, pos=pos, n_real=n_real, mesh=self.mesh,
            )
        return torch.argmax(logits[0], -1)

    def _decode(self, tokens: torch.Tensor, tables: torch.Tensor,
                active: torch.Tensor, atab: torch.Tensor | None = None,
                live_rows: int | None = None) -> torch.Tensor:
        """The pool-wide decode step; rows at or past ``live_rows`` (the
        highest decoding row plus one) are idle and not attended
        (:func:`generate.paged_decode_step`)."""
        self._guard("decode", tokens, tables, active, self.cache["k"], self.cache["len"],
                    *self._spec_guard(), *self._lora_guard(atab))
        logits, new = G.paged_decode_step(
            self.params, tokens, self.cache, self.cfg, page_tables=tables, mesh=self.mesh,
            live_rows=live_rows, **self._lora_kw(atab),
        )
        new["len"] = torch.where(active, new["len"], self.cache["len"])
        self.cache = new
        if self.draft_cache is not None:
            _, dnew = G.paged_decode_step(self.draft_params, tokens, self.draft_cache,
                                          self.draft_cfg, page_tables=tables, mesh=self.mesh,
                                          live_rows=live_rows)
            dnew["len"] = torch.where(active, dnew["len"], self.draft_cache["len"])
            self.draft_cache = dnew
        return torch.argmax(logits, -1)

    def _draft(self, tokens: torch.Tensor, tables: torch.Tensor,
               active: torch.Tensor) -> torch.Tensor:
        """``spec_k`` greedy proposals [B, spec_k] for the active rows from
        their last tokens (``tokens`` [B]). The last of the ``spec_k + 1``
        steps writes the last proposal's own KV, which a fully accepted
        round leaves valid (an unwritten entry there would poison every
        later proposal). Active rows' draft lengths advance by
        ``spec_k + 1``; the others keep theirs."""
        self._guard("draft", tokens, tables, active, *self._spec_guard())
        lens0 = self.draft_cache["len"]
        tok, props = tokens, []
        for _ in range(self.spec_k + 1):
            logits, self.draft_cache = G.paged_decode_step(
                self.draft_params, tok, self.draft_cache, self.draft_cfg, page_tables=tables,
                mesh=self.mesh)
            tok = torch.argmax(logits, -1)
            props.append(tok)
        self.draft_cache["len"] = torch.where(active, lens0 + self.spec_k + 1, lens0)
        return torch.stack(props[: self.spec_k], dim=1)

    def _verify(self, block: torch.Tensor, tables: torch.Tensor, active: torch.Tensor,
                atab: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Score each active row's block (its last token and its proposals,
        [B, spec_k + 1]) in one target forward. Returns the target's greedy
        picks [B, spec_k + 1] and each row's accepted count ``a`` [B] (the
        longest proposal prefix equal to the picks); both pools' lengths
        become ``pos + a + 1`` for active rows, which rewinds past the
        rejected entries, and stay for the others."""
        self._guard("verify", block, tables, active, self.cache["k"], self.cache["len"],
                    *self._spec_guard(), *self._lora_guard(atab))
        pos0, dlen0 = self.cache["len"], self.draft_cache["len"]
        logits, new = G.paged_verify_block(self.params, block, self.cache, self.cfg,
                                           page_tables=tables, mesh=self.mesh,
                                           **self._lora_kw(atab))
        greedy = torch.argmax(logits, -1)
        match = (block[:, 1:] == greedy[:, : self.spec_k]).int()
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        new["len"] = torch.where(active, pos0 + accepted.int() + 1, pos0)
        self.cache = new
        self.draft_cache["len"] = torch.where(active, new["len"], dlen0)
        return greedy, accepted

    def _reset_spec_stats(self) -> None:
        self._spec_draft_steps = 0
        self._spec_rollback_pages = 0
        self._spec_tiers: dict[str, dict[str, int]] = {}
        self._spec_lookahead_high = 0
        # counters go to /metrics as deltas past these watermarks, so a
        # second run does not count the first one's again
        self._spec_pub = {"draft_steps": 0, "rollback": 0}
        # value -> multiplicity, flushed once per run: accepted proposals
        # per row a round, and tokens emitted a round
        self._spec_accept_hist: dict[int, int] = {}
        self._spec_step_hist: dict[int, int] = {}

    def _reset_adapter_pub(self) -> None:
        self._adapter_pub = {"hits": 0, "misses": 0, "evictions": 0}
        # seconds each slab load stalled a request (or overlapped its wait)
        self._adapter_stalls: list[float] = []
        # rid -> perf_counter of its first head-blocked acquire: the wait
        # counts into the stall when the acquire lands
        self._adapter_waits: dict[int, float] = {}

    def validate(self, req: Request) -> None:
        super().validate(req)
        if req.adapter_id:
            if self.lora_cfg is None:
                raise ValueError(
                    f"request {req.rid}: adapter {req.adapter_id!r} on an "
                    "engine with no lora_store — the router sent a tenant "
                    "request to a base-model replica"
                )
            if req.adapter_id not in self.lora_store:
                raise ValueError(
                    f"request {req.rid}: unknown adapter "
                    f"{req.adapter_id!r} — not in this engine's lora_store"
                )

    # --- multi-LoRA adapters (adapters.py) ------------------------------------

    def _write_adapter_pages(self, adapter_id: str, pages: list[int]) -> None:
        """Stripe the adapter's flat vector (``workloads/lora.py``'s layout,
        zero-padded to whole slab rows) into its fresh slab pages: the
        device half of an :class:`~.adapters.AdapterCache` miss."""
        flat = flatten_lora(self.lora_store[adapter_id], self.cfg, self.lora_cfg, self.mesh)
        buf = torch.zeros((len(pages), self._adapter_page_floats), dtype=torch.float32,
                          device=self.device)
        buf.view(-1)[: flat.numel()] = flat.to(self.device)
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        self._lora_slab.index_copy_(0, ids, buf)

    def _admit_adapter(self, req: Request) -> list[int] | None:
        """Pin ``req``'s adapter for one row, loading it on a miss. None:
        the pool cannot hold it now; the request stays at the head of the
        queue and retries next turn. The load's time, and the time the
        head waited for it, go into the miss-stall histogram."""
        t0 = time.perf_counter()
        got = self.adapters.acquire(req.adapter_id, tier=_TIER_CLASS[req.tier])
        if got is None:
            self._adapter_waits.setdefault(req.rid, t0)
            return None
        pages, loaded = got
        if loaded:
            self._write_adapter_pages(req.adapter_id, pages)
        waited = t0 - self._adapter_waits.pop(req.rid, t0)
        stall = waited + (time.perf_counter() - t0 if loaded else 0.0)
        if loaded or waited > 0.0:
            self._adapter_stalls.append(stall)
        return pages

    def _prefetch_adapter(self, req: Request) -> None:
        """Load on arrival, so the slab write overlaps the queue wait. The
        adapter is left resident and unpinned (admission's acquire is then
        a hit); only free pages are taken, nothing is evicted. The load
        counts into the miss-stall histogram all the same."""
        if self.adapters.resident(req.adapter_id):
            return
        if self.allocator.free_pages < self.pages_per_adapter:
            return
        got = self.adapters.acquire(req.adapter_id, tier=_TIER_CLASS[req.tier])
        if got is None:
            return
        pages, loaded = got
        t0 = time.perf_counter()
        if loaded:
            self._write_adapter_pages(req.adapter_id, pages)
            self._adapter_stalls.append(time.perf_counter() - t0)
        self.adapters.release(req.adapter_id)

    def warmup(self) -> None:
        """Run every paged program once off the clock (with the null
        adapter on a multi-LoRA engine), then flush the synthetic
        requests' footprint: radix adoptions, adapters, hit telemetry,
        allocator counters, the preemption count and the speculative
        counters start cold.

        A speculative engine takes a second synthetic request: the first
        has one token left after its prefill, which never drafts (a round
        costs two dispatches), so a ``spec_k + 2``-token request runs one
        draft/verify round."""
        super().warmup()
        if self.draft_cfg is not None:
            plen = self.chunk + 1
            if max(2 * self.chunk, plen + self.spec_k + 2) > self.max_len:
                plen = min(self.chunk, self.max_len - (self.spec_k + 2))
            if plen >= 1:
                self._warming = True
                try:
                    self.run([Request(rid=-1, prompt=tuple(range(1, plen + 1)),
                                      max_new=self.spec_k + 2, arrival=0.0)])
                finally:
                    self._warming = False
            self.ticks = 0
            self.profiler.reset()
            self._reset_spec_stats()
        if self.radix is not None:
            self.radix.clear()
            self.radix.reset_stats()
        if self.adapters is not None:
            self.adapters.clear()
            self.adapters.reset_stats()
            self._reset_adapter_pub()
        self.allocator.reset_stats()
        self.preemptions = 0

    def publish_metrics(self) -> None:
        """Export pages, the step profile, prefix-cache and preemption
        gauges, and the speculative and adapter families to ``/metrics``
        (at the end of every run)."""
        labels = {"pod": self.metrics_pod} if self.metrics_pod else {}
        self.allocator.publish(REGISTRY, pod=self.metrics_pod)
        self._flush_step_profile()
        if self.radix is not None:
            REGISTRY.gauge_set(
                ENGINE_PREFIX_HIT_RATIO, self.radix.hit_ratio(),
                "Fraction of looked-up prompt tokens served from the radix prefix cache",
                **labels,
            )
            REGISTRY.gauge_set(ENGINE_PREFIX_CACHED_PAGES, self.radix.cached_pages,
                               "KV pages held by the radix prefix cache", **labels)
        REGISTRY.gauge_set(ENGINE_PREEMPTIONS, self.preemptions,
                           "Requests preempted by page eviction since engine start", **labels)
        self._publish_spec(labels)
        self._publish_adapters(labels)

    def _publish_adapters(self, labels: dict) -> None:
        """The adapter families: residency gauges, counter deltas since the
        last flush, and the miss-stall seconds inside a
        ``serve.adapter_load`` span (so the buckets carry an exemplar).
        Warmup publishes nothing."""
        if self.adapters is None or self._warming:
            return
        REGISTRY.gauge_set(ENGINE_ADAPTER_ENABLED, 1.0,
                           "1 when this engine serves per-request LoRA adapters "
                           "(a lora_store is attached)", **labels)
        self.adapters.publish(REGISTRY, pod=self.metrics_pod)
        for fam, cur, key, help_ in (
            (ENGINE_ADAPTER_HITS_TOTAL, self.adapters.hits, "hits",
             "Adapter acquisitions served from the resident slab"),
            (ENGINE_ADAPTER_MISSES_TOTAL, self.adapters.misses, "misses",
             "Adapter acquisitions that had to load from the store"),
            (ENGINE_ADAPTER_EVICTIONS_TOTAL, self.adapters.evictions, "evictions",
             "Idle adapters evicted from the slab (LRU, tier-shielded)"),
        ):
            delta = cur - self._adapter_pub[key]
            if delta:
                REGISTRY.counter_inc(fam, help_, value=float(delta), **labels)
                self._adapter_pub[key] = cur
        stalls, self._adapter_stalls = self._adapter_stalls, []
        if stalls:
            with TRACER.span("serve.adapter_load", attributes={"loads": len(stalls)}):
                for v in stalls:
                    REGISTRY.observe(
                        ENGINE_ADAPTER_MISS_STALL_SECONDS, float(v),
                        "Seconds a request stalled on (or its queue wait overlapped "
                        "with) its adapter's slab load",
                        buckets=(0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0), **labels,
                    )

    def _publish_spec(self, labels: dict) -> None:
        """The speculative families: gauges, counter deltas since the last
        flush, and the two acceptance histograms inside ``serve.draft`` /
        ``serve.verify`` spans. Warmup's draft round publishes nothing."""
        if self.draft_cfg is None or self._warming:
            return
        REGISTRY.gauge_set(ENGINE_SPEC_ENABLED, 1.0,
                           "1 when this engine decodes speculatively (draft model loaded)",
                           **labels)
        REGISTRY.gauge_set(ENGINE_SPEC_K, float(self.spec_k),
                           "Draft proposal length per speculative round", **labels)
        delta = self._spec_draft_steps - self._spec_pub["draft_steps"]
        if delta:
            REGISTRY.counter_inc(
                ENGINE_SPEC_DRAFT_STEPS_TOTAL,
                "Draft-model lookahead dispatches (one per speculative round)",
                value=float(delta), **labels,
            )
            self._spec_pub["draft_steps"] = self._spec_draft_steps
        delta = self._spec_rollback_pages - self._spec_pub["rollback"]
        if delta:
            REGISTRY.counter_inc(
                ENGINE_SPEC_ROLLBACK_PAGES_TOTAL,
                "KV pages released by rejected-draft rollback (both pools' entries "
                "freed by refcount)",
                value=float(delta), **labels,
            )
            self._spec_pub["rollback"] = self._spec_rollback_pages
        accept, self._spec_accept_hist = self._spec_accept_hist, {}
        if accept:
            with TRACER.span("serve.draft",
                             attributes={"rounds": sum(accept.values()), "k": self.spec_k}):
                for val, n in sorted(accept.items()):
                    for _ in range(n):
                        REGISTRY.observe(
                            ENGINE_SPEC_ACCEPTANCE_LEN, float(val),
                            "Accepted draft tokens per row per speculative round (0..k; "
                            "the emitted correction token is not counted)",
                            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0), **labels,
                        )
        steps, self._spec_step_hist = self._spec_step_hist, {}
        if steps:
            with TRACER.span("serve.verify", attributes={"steps": sum(steps.values())}):
                for val, n in sorted(steps.items()):
                    for _ in range(n):
                        REGISTRY.observe(
                            ENGINE_SPEC_ACCEPTED_TOKENS_PER_STEP, float(val),
                            "Tokens emitted per verify dispatch, summed over the round's "
                            "speculating rows",
                            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0), **labels,
                        )

    def cache_stats(self) -> dict:
        """Page occupancy, prefix hits and preemptions, and the adapter
        and speculative rows of engines that have them
        (``ServeStats.engine_cache``)."""
        out = {
            "total_pages": self.total_pages,
            "free_pages": self.allocator.free_pages,
            "used_pages": self.allocator.used_pages,
            "high_water_pages": self.allocator.high_water,
            "page_size": self.page_size,
            "preemptions": self.preemptions,
        }
        if self.radix is not None:
            out.update(
                prefix_hit_ratio=round(self.radix.hit_ratio(), 4),
                prefix_hit_requests=self.radix.hit_requests,
                prefix_cached_pages=self.radix.cached_pages,
                prefix_evicted_pages=self.radix.evicted_pages,
            )
        if self.governor is not None:
            out["governor"] = self.governor.stats()
        if self.adapters is not None:
            out["adapters"] = {
                "enabled": True,
                "pages_per_adapter": self.adapters.pages_per_adapter,
                **self.adapters.stats(),
            }
        if self.draft_cfg is not None:
            tiers = {t: dict(row) for t, row in sorted(self._spec_tiers.items())}
            out["speculative"] = {
                "enabled": True,
                "k": self.spec_k,
                "draft_steps": self._spec_draft_steps,
                "proposed": sum(r["proposed"] for r in tiers.values()),
                "accepted": sum(r["accepted"] for r in tiers.values()),
                "rollback_pages": self._spec_rollback_pages,
                # one table and one refcount for both pools: the draft's
                # occupancy is the KV occupancy
                "draft_pool_used_pages": self.allocator.used_pages,
                "lookahead_high_water_pages": self._spec_lookahead_high,
                "tiers": tiers,
            }
        return out

    # --- drain/restore: the defrag move's engine hand-off -------------------

    def request_drain(self) -> None:
        """Ask the run in progress (or the next one) to quiesce at its next
        iteration boundary: admission stops, every unfinished request goes
        into :meth:`drain_snapshot`, and its pages are freed. A caller on
        another thread then collects with :meth:`wait_drained`."""
        self._drain.request()

    def wait_drained(self, timeout: float | None = None) -> dict | None:
        """Block until the serving thread quiesced after
        :meth:`request_drain` and return the snapshot (None when the run
        retired everything). Raises ``TimeoutError`` after ``timeout``
        seconds with no run at a boundary, and disarms the drain."""
        return self._drain.wait(timeout)

    def drain_snapshot(self) -> dict | None:
        """The JSON-safe snapshot of the last drained run: engine geometry
        and one row per unfinished request (prompt, tokens so far, tier and
        SLO targets, queue state). KV bytes are not carried: a restore
        prefills prompt + tokens again, and radix prefixes resolve against
        the destination's own cache."""
        return self._drain.snapshot()

    def _drain_row(self, req: Request, res: RequestResult | None, state: str) -> dict:
        return {
            "rid": req.rid,
            "state": state,
            "prompt": list(req.prompt),
            "max_new": req.max_new,
            "arrival": float(req.arrival),
            "tier": req.tier,
            "slo_ttft_ticks": req.slo_ttft_ticks,
            "slo_tpot_ticks": req.slo_tpot_ticks,
            "adapter_id": req.adapter_id,
            "tokens": list(res.tokens) if res is not None else [],
        }

    def restore_snapshot(self, snapshot: dict | None) -> ServeStats:
        """Re-admit a drained snapshot on this engine and serve it to
        completion. Each request prefills its prompt plus its pre-drain
        tokens again, so the combined tokens are those of a run that was
        never drained. Raises ``ValueError`` when the source engine's
        ``eos_id`` or ``kv_dtype`` differs (the tokens would diverge); the
        pool geometry may differ. A ``snapshot_id`` this engine already
        restored is a no-op: delivery may repeat."""
        empty = ServeStats(results=[], ticks=0, wall_s=0.0, trace_counts=self.trace_counts)
        if not snapshot or not snapshot.get("requests"):
            return empty
        snap_id = snapshot.get("snapshot_id")
        if snap_id is not None and snap_id in self._restored_ids:
            log.warning("restore_snapshot: snapshot %s already restored on this "
                        "engine; duplicate delivery ignored", snap_id)
            return empty
        eng = snapshot.get("engine") or {}
        if eng.get("eos_id", self.eos_id) != self.eos_id or (
            eng.get("kv_dtype", self.kv_dtype) != self.kv_dtype
        ):
            raise ValueError(
                f"snapshot from engine {eng} cannot restore here "
                f"(eos_id={self.eos_id}, kv_dtype={self.kv_dtype}) — "
                "greedy tokens would silently diverge"
            )
        reqs: list[Request] = []
        seeds: dict[int, tuple[int, ...]] = {}
        for row in snapshot["requests"]:
            req = Request(
                rid=int(row["rid"]),
                prompt=tuple(int(t) for t in row["prompt"]),
                max_new=int(row["max_new"]),
                arrival=0.0,  # every drained request has already arrived
                tier=str(row.get("tier", TIER_CRITICAL)),
                slo_ttft_ticks=row.get("slo_ttft_ticks"),
                slo_tpot_ticks=row.get("slo_tpot_ticks"),
                adapter_id=str(row.get("adapter_id") or ""),
            )
            reqs.append(req)
            seeds[req.rid] = tuple(int(t) for t in row.get("tokens") or ())
        self._restore_tokens = seeds
        try:
            stats = self.run(reqs)
        finally:
            self._restore_tokens = {}
        # recorded once the run quiesced: a restore that died mid-run stays
        # deliverable again
        if snap_id is not None:
            self._restored_ids.append(snap_id)
        return stats

    def fetch_kv_pages(self, page_ids: Sequence[int]) -> list[dict[str, torch.Tensor]]:
        """The KV contents of ``page_ids`` as host tensors in the cache's
        own dtypes (bf16 stays bf16), one dict per page (every cache
        buffer but ``len``, sliced on the page axis): one gather and one
        device-to-host copy per buffer. Pages are read, never written."""
        ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long, device=self.device)
        host = {key: val.index_select(1, ids).cpu()
                for key, val in self.cache.items() if key != "len"}
        return [{key: arr[:, n] for key, arr in host.items()} for n in range(len(ids))]

    def export_kv_pages(self, page_ids: Sequence[int]) -> list[dict]:
        """:meth:`fetch_kv_pages` as numpy arrays. numpy has no bf16, so
        bf16 pages leave as f32, which holds every bf16 value exactly (the
        KV handoff ships :meth:`fetch_kv_pages`' bf16 instead)."""
        return [{key: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                 for key, t in page.items()} for page in self.fetch_kv_pages(page_ids)]

    def import_kv_pages(self, page_ids: Sequence[int], blobs: Sequence[dict]) -> None:
        """Write page contents into pages ``page_ids``: dicts of numpy
        arrays or host tensors per cache buffer, as :meth:`export_kv_pages`,
        :meth:`fetch_kv_pages` or ``handoff.decode_page`` give them (on this
        or another engine, or the reference's, whose bf16 arrive as
        ``ml_dtypes`` arrays). Raises ``ValueError`` on any geometry
        mismatch before touching the cache."""
        if len(page_ids) != len(blobs):
            raise ValueError(
                f"import_kv_pages: {len(page_ids)} pages but {len(blobs)} payloads"
            )
        if not page_ids:
            return
        staged = {}
        for key, val in self.cache.items():
            if key == "len":
                continue
            try:
                stacked = torch.stack([_host_tensor(b[key]) for b in blobs], dim=1)
            except KeyError as e:
                raise ValueError(f"import_kv_pages: payload missing cache buffer {e}") from None
            stacked = self._rank_heads(stacked, val)
            expected = (val.shape[0], len(blobs)) + tuple(val.shape[2:])
            if tuple(stacked.shape) != expected:
                raise ValueError(
                    f"import_kv_pages: buffer {key!r} shape {tuple(stacked.shape)} does "
                    f"not fit this engine's {expected} (source engine geometry differs)"
                )
            staged[key] = stacked
        ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long, device=self.device)
        for key, stacked in staged.items():
            buf = self.cache[key]
            buf.index_copy_(1, ids, stacked.to(buf.device, buf.dtype))

    def _rank_heads(self, pages: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
        """Whole-head pages (a single-chip engine's) cut to this tp rank's
        kv heads when its pool holds a share of them (dim 3 of both)."""
        if (self.mesh is None or pages.dim() < 4 or pages.shape[3] != self.cfg.kv_heads
                or buf.shape[3] == pages.shape[3]):
            return pages
        n = buf.shape[3]
        return pages.narrow(3, self.mesh.axis_index("tp") * n, n)

    # --- disaggregated prefill/decode handoff (handoff.py) ------------------

    def set_handoff_sink(self, sink) -> None:
        """Arm (or clear, with None) the prefill tier's export sink:
        ``sink(export)`` is called from :meth:`run` for every request that
        completes its prompt with decode work left, after the row retired
        here (its pages already fetched to the host inside ``export``)."""
        self._handoff_sink = sink

    def seed_handoff_import(self, rid: int, *, pages: Sequence[int], pos: int, last: int,
                            prompt: Sequence[int]) -> None:
        """Stage one imported request for the next :meth:`run`: when the
        request with this rid reaches the head of admission it adopts
        ``pages`` (KV already written by :meth:`import_kv_pages`, covering
        positions ``[0, pos)``) straight into decode state with ``last`` as
        its next input token. The pages belong to the row from then on:
        retire or a preemption releases them through this engine's
        allocator, which must be where the caller allocated them."""
        self._import_seeds[int(rid)] = {
            "pages": [int(p) for p in pages],
            "pos": int(pos),
            "last": int(last),
            "prompt": tuple(int(t) for t in prompt),
        }

    def seed_restore_tokens(self, seeds: dict) -> None:
        """Seed tokens already generated for rids the next :meth:`run`
        serves, into the restore path's own table: each request's result
        starts with them and admission prefills ``prompt + tokens``, so the
        retired token list is the combined stream. The handoff seeds every
        handed-off request with its first token, which is also what makes
        the re-prefill fallback lossless."""
        for rid, toks in seeds.items():
            self._restore_tokens[int(rid)] = tuple(int(t) for t in toks)

    def clear_handoff_seeds(self) -> None:
        """Drop the restore-token seeds and any unconsumed import seed,
        releasing the latter's pages (a seeded rid that never arrived must
        not leak its pages)."""
        self._restore_tokens = {}
        leftovers, self._import_seeds = self._import_seeds, {}
        for seed in leftovers.values():
            if seed["pages"]:
                self.allocator.release(seed["pages"])

    def _export_handoff(self, s: _PagedSlot, t: int) -> dict:
        """The prefill tier's export of one just-completed prompt: the
        JSON-safe request row (everything the decode tier needs to serve it
        without the KV: the re-prefill guarantee), the engine's geometry,
        and the row's pages fetched to the host (``fetch_s`` is that copy's
        wall time). Called before retire frees the pages."""
        row = self._drain_row(s.req, s.result, "handoff")
        row["prompt"] = list(s.prompt)  # the effective prompt the pages hold
        n = pages_for(s.pos, self.page_size)
        t0 = time.perf_counter()
        pages = self.fetch_kv_pages(s.pages[:n])
        return {
            "request": row,
            "pos": int(s.pos),
            "first_token": int(t),
            "first_token_tick": int(self.ticks),
            "meta": {
                "page_size": self.page_size,
                "kv_dtype": self.kv_dtype,
                "eos_id": self.eos_id,
                "pos": int(s.pos),
                "n_pages": n,
            },
            "pages": pages,
            "fetch_s": time.perf_counter() - t0,
        }

    # --- page bookkeeping ---------------------------------------------------

    def _fresh_slot(self) -> _PagedSlot:
        s = _PagedSlot(table=np.full((self.row_pages,), SCRATCH, np.int32))
        if self.adapters is not None:
            s.atable = np.full((self.pages_per_adapter,), SCRATCH, np.int32)
        return s

    def _grow(self, s: _PagedSlot, got: list[int]) -> None:
        """Append granted pages to a row and map them in its table
        (allocated entries are always a prefix of the row)."""
        base = len(s.pages)
        s.pages.extend(got)
        s.table[base : base + len(got)] = got

    def _spec_round(self, slots: list[_PagedSlot], retire) -> list[int]:
        """One draft and one verify dispatch (two ticks) over the decoding
        rows that can take a round; returns those rows (none: no dispatch).
        A row takes part when at least two of its tokens are left (a round
        costs two dispatches), its block fits the row, and a plain
        ``allocator.alloc`` covers its lookahead pages (a handoff import,
        ``draft_stale``, never takes part): a draft never
        evicts or preempts. Each row emits its accepted proposals and the
        target's next token, retires on EOS or ``max_new``, and otherwise
        rolls back: its own tail pages past ``pages_for(pos)`` return to
        the pool (shared prefix pages are never past ``pos``)."""
        k, ps = self.spec_k, self.page_size
        row_cap = min(self.row_pages * ps, self.max_len)
        rows, lookahead = [], 0
        for idx, s in enumerate(slots):
            if s.state != "decode" or s.draft_stale or s.req.max_new - len(s.result.tokens) < 2:
                continue
            if s.pos + k + 1 > row_cap:  # the verify writes pos..pos+k
                continue
            need = pages_for(s.pos + k + 1, ps) - len(s.pages)
            if need > 0:
                got = self.allocator.alloc(need)
                if got is None:
                    continue
                self._grow(s, got)
                lookahead += need
            rows.append(idx)
        self._spec_lookahead_high = max(self._spec_lookahead_high, lookahead)
        if not rows:
            return rows
        toks = np.zeros((self.n_slots,), np.int64)
        active = np.zeros((self.n_slots,), bool)
        tables = np.full((self.n_slots, self.row_pages), SCRATCH, np.int32)
        for idx in rows:
            tables[idx] = slots[idx].table
            toks[idx] = slots[idx].last
            active[idx] = True
        atab = None
        if self.adapters is not None:
            at = np.full((self.n_slots, self.pages_per_adapter), SCRATCH, np.int32)
            for idx in rows:
                at[idx] = slots[idx].atable
            atab = self._upload(at)
        if self.governor is not None:
            self.governor.before_step()
        step_t0 = time.perf_counter()
        toks_d, tables_d, active_d = self._upload(toks), self._upload(tables), self._upload(active)
        drafts = self._draft(toks_d, tables_d, active_d)
        self.ticks += 1
        self._spec_draft_steps += 1
        if self.governor is not None:
            self.governor.before_step()
        block = torch.cat([toks_d[:, None], drafts], dim=1)
        greedy, accepted = self._verify(block, tables_d, active_d, atab)
        self.ticks += 1
        # one copy back, which waits for the round's device work
        host = torch.cat([drafts, greedy, accepted[:, None]], dim=1).cpu().numpy()
        drafts_np, greedy_np, acc_np = host[:, :k], host[:, k : 2 * k + 1], host[:, -1]
        emitted = 0
        for idx in rows:
            s = slots[idx]
            a = int(acc_np[idx])
            self._spec_accept_hist[a] = self._spec_accept_hist.get(a, 0) + 1
            trow = self._spec_tiers.setdefault(s.req.tier, {"proposed": 0, "accepted": 0})
            trow["proposed"] += k
            trow["accepted"] += a
            done = False
            # the accepted proposals, then the target's own pick: the
            # stream sequential decode steps would emit
            for j in range(a + 1):
                t = int(drafts_np[idx, j]) if j < a else int(greedy_np[idx, a])
                s.pos += 1
                s.result.tokens.append(t)
                s.last = t
                emitted += 1
                if (self.eos_id is not None and t == self.eos_id) or (
                    len(s.result.tokens) >= s.req.max_new
                ):
                    done = True
                    break
            if done:
                retire(idx)
                continue
            keep = pages_for(s.pos, ps)
            tail = s.pages[keep:]
            if tail:
                self.allocator.release(tail)
                del s.pages[keep:]
                s.table[keep:] = SCRATCH
                self._spec_rollback_pages += len(tail)
        self._spec_step_hist[emitted] = self._spec_step_hist.get(emitted, 0) + 1
        self.profiler.record(time.perf_counter() - step_t0, tokens=emitted / len(rows))
        return rows

    def run(self, requests: Sequence[Request], *, drain_at_tick: int | None = None) -> ServeStats:
        """Serve to completion with paged admission. Each loop turn:
        (1) enqueue arrivals; (2) admit pending requests in (tier, arrival)
        order — a seeded handoff import straight into decode state on its
        imported pages, any other request radix-matching its prompt and
        granting its first chunk's pages, evicting radix LRU pages and then
        preempting best-effort rows when a critical request is short; (3)
        one prompt chunk for the oldest mid-prefill row that can get its
        pages (on a prefill tier, a row done with its prompt is exported to
        the handoff sink); (4) on a
        speculative engine, one draft/verify round over the decoding rows
        that can take it; (5) one pool-wide decode step over the other
        decoding rows whose next position has a page. A row that
        cannot get its next page stalls in place while its neighbours
        decode. A turn that dispatches nothing preempts the youngest row of
        any tier and gives its pages to the oldest.

        ``drain_at_tick`` (or a concurrent :meth:`request_drain`) ends the
        run at the next boundary once the tick clock reaches it: unfinished
        requests go into :meth:`drain_snapshot`, their pages are freed, and
        only retired results are returned."""
        for r in requests:
            self.validate(r)
        self.ticks = 0
        # The drain handshake is not reset here: an uncollected capture of
        # an earlier run survives until request_drain re-arms.
        incoming = sorted(requests, key=lambda r: (r.arrival, r.rid))
        slots = [self._fresh_slot() for _ in range(self.n_slots)]
        pending: list[Request] = []
        results: list[RequestResult] = []
        live: dict[int, RequestResult] = {}
        i = 0
        t0 = time.perf_counter()
        base_ns = time.time_ns()  # wall anchor of the request spans
        ps = self.page_size

        def now() -> float:
            return time.perf_counter() - t0

        def tier_key(req: Request) -> tuple:
            return (0 if req.tier == TIER_CRITICAL else 1, req.arrival, req.rid)

        def release_row(s: _PagedSlot) -> None:
            if s.pages:
                self.allocator.release(s.pages)
            s.pages = []
            s.table[:] = SCRATCH
            if self.adapters is not None and s.req is not None and s.req.adapter_id:
                # unpin the tenant's adapter: it stays resident (the next
                # request for it is a hit) but becomes evictable
                self.adapters.release(s.req.adapter_id)
                s.atable[:] = SCRATCH

        def preempt_one(critical_only: bool = True, protect: int | None = None) -> bool:
            """Free one victim's pages and re-queue its request. Victims are
            best-effort rows, youngest admission first; with
            ``critical_only=False`` (the zero-progress fallback) any tier may
            be chosen but the protected (oldest) row, so the oldest request
            makes progress and the loop ends."""
            cands = [
                (idx, s) for idx, s in enumerate(slots)
                if s.state != "free" and idx != protect
                and (s.req.tier == TIER_BEST_EFFORT or not critical_only)
            ]
            if not cands:
                return False
            idx, s = max(
                cands,
                key=lambda p: (p[1].req.tier == TIER_BEST_EFFORT, p[1].req.arrival, p[1].req.rid),
            )
            s.result.preemptions.append({"evict_tick": self.ticks, "evict_s": now()})
            self.preemptions += 1
            REGISTRY.counter_inc(
                ENGINE_PREEMPTIONS_TOTAL,
                "Paged-engine preemptions (victim pages evicted for a higher-priority request)",
                **({"pod": self.metrics_pod} if self.metrics_pod else {}),
            )
            release_row(s)
            pending.append(s.req)
            slots[idx] = self._fresh_slot()
            return True

        def try_pages(n: int, tier: str) -> list[int] | None:
            """All-or-nothing grant of ``n`` pages: the free list, then idle
            adapters (LRU, tier-shielded), then radix LRU eviction (any
            tier), then best-effort preemption (critical requesters only).
            An idle adapter is one reload away, a cached prefix a
            re-prefill, a preempted row its decode progress. Eviction and
            preemption happen only when releasing the whole escalation set
            would cover ``n`` (``freeable``): a grant that would fail anyway
            destroys nothing."""
            got = self.allocator.alloc(n)
            if got is not None:
                return got
            groups: list[list[int]] = []
            if self.adapters is not None:
                groups.extend(self.adapters.evictable(tier=_TIER_CLASS[tier]))
            if self.radix is not None:
                groups.append(self.radix.pages())
            if tier == TIER_CRITICAL:
                groups.extend(
                    s.pages for s in slots
                    if s.state != "free" and s.req.tier == TIER_BEST_EFFORT
                )
            if self.allocator.free_pages + self.allocator.freeable(groups) < n:
                return None
            if self.adapters is not None:
                while self.allocator.free_pages < n:
                    if not self.adapters.evict(n - self.allocator.free_pages,
                                               tier=_TIER_CLASS[tier]):
                        break
                got = self.allocator.alloc(n)
                if got is not None:
                    return got
            if self.radix is not None:
                while self.allocator.free_pages < n:
                    if not self.radix.evict(n - self.allocator.free_pages):
                        break
                got = self.allocator.alloc(n)
                if got is not None:
                    return got
            if tier == TIER_CRITICAL:
                while self.allocator.free_pages < n:
                    if not preempt_one():
                        break
                got = self.allocator.alloc(n)
            return got

        def grant_oldest(s: _PagedSlot, protect: int) -> None:
            """Give the protected row of a zero-progress turn the pages of
            its next dispatch: from the free list, else by evicting idle
            adapters (past the tier shield: this is the last resort), else
            by radix eviction, else by preempting more rows. (The reference
            leaves the freed pages on the free list, where the victim's
            re-admission can take them back every turn and the run never
            ends.)"""
            if s.state == "prefill":
                need = pages_for(min(s.done + self.chunk, len(s.prompt)), ps) - len(s.pages)
            else:
                need = pages_for(s.pos + 1, ps) - len(s.pages)
            while need > 0:
                got = self.allocator.alloc(need)
                if got is not None:
                    self._grow(s, got)
                    return
                short = need - self.allocator.free_pages
                if self.adapters is not None and self.adapters.evict(short):
                    continue
                if self.radix is not None and self.radix.evict(short):
                    continue
                if not preempt_one(critical_only=False, protect=protect):
                    return

        def reclaim_idle() -> bool:
            """The last rung of a zero-progress turn that has no row to
            preempt (multi-LoRA only): evict one idle adapter past the tier
            shield, else one adapter's worth of radix pages. Without it a
            best-effort head, or a lone best-effort row, can wait for
            pages that only shielded idle adapters or radix pages hold,
            which neither an adapter load nor its tier may reclaim, and
            the run raises (``ROADMAP.md`` §3 fault 5)."""
            if self.adapters is None:
                return False
            if self.adapters.evict(1):
                return True
            return self.radix is not None and self.radix.evict(self.pages_per_adapter) > 0

        def retire(idx: int) -> None:
            s = slots[idx]
            res = s.result
            res.finish_tick = self.ticks
            res.finish_s = now()
            results.append(res)
            self._record_request_trace(res, base_ns)
            self._note_slo(res)
            # Adopt the original prompt's full pages into the radix tree of
            # the request's adapter (pages past the prompt hold generated
            # tokens and are freed); the tree takes its own reference, so
            # releasing the row's recycles only the unshared tail. A
            # draft_stale row's pages stay out: a later match would
            # speculate over draft KV that was never written.
            if self.radix is not None and s.req.rid >= 0 and not s.draft_stale:
                full = len(s.req.prompt) // ps
                if full:
                    self.radix.insert(tuple(s.req.prompt[: full * ps]), s.pages[:full],
                                      adapter_id=s.req.adapter_id)
            release_row(s)
            slots[idx] = self._fresh_slot()

        while i < len(incoming) or pending or any(s.state != "free" for s in slots):
            if self._agreed(self._drain.armed()) or (
                drain_at_tick is not None and self.ticks >= drain_at_tick
            ):
                # Quiesce: capture in-flight rows, the pending queue (a
                # preempted request waits there with its tokens) and arrivals
                # not yet reached; free the pool and stop.
                rows = []
                for s in sorted((s for s in slots if s.state != "free"),
                                key=lambda s: (s.req.arrival, s.req.rid)):
                    rows.append(self._drain_row(s.req, live[s.req.rid], "slot"))
                    release_row(s)
                for req in sorted(pending, key=tier_key):
                    rows.append(self._drain_row(req, live[req.rid], "pending"))
                for req in incoming[i:]:
                    row = self._drain_row(req, None, "queued")
                    # a restored request not yet enqueued keeps its
                    # pre-drain tokens, whose only copy is _restore_tokens
                    seed = self._restore_tokens.get(req.rid)
                    if seed:
                        row["tokens"] = list(seed)
                    rows.append(row)
                self._drain.publish({
                    "version": 1,
                    "drain_tick": self.ticks,
                    "engine": {
                        "slots": self.n_slots, "max_len": self.max_len,
                        "page_size": self.page_size, "prefill_chunk": self.chunk,
                        "total_pages": self.total_pages,
                        "eos_id": self.eos_id, "kv_dtype": self.kv_dtype,
                    },
                    "requests": rows,
                })
                break
            while i < len(incoming) and incoming[i].arrival <= self.ticks:
                req = incoming[i]
                live[req.rid] = RequestResult(
                    rid=req.rid, prompt_len=len(req.prompt),
                    # restore: pre-drain tokens seed the result, admission
                    # prefills prompt + tokens, and the retired token list
                    # is the combined stream
                    tokens=list(self._restore_tokens.get(req.rid, ())),
                    arrival_tick=req.arrival, arrival_s=now(), tier=req.tier,
                    slo_ttft_ticks=req.slo_ttft_ticks, slo_tpot_ticks=req.slo_tpot_ticks,
                )
                pending.append(req)
                if self.adapters is not None and req.adapter_id:
                    self._prefetch_adapter(req)  # the slab load overlaps the wait
                i += 1
            if not pending and all(s.state == "free" for s in slots):
                self.ticks = max(self.ticks, int(math.ceil(incoming[i].arrival)))
                continue
            dispatched = False

            # --- admission in strict (tier, arrival) order: a blocked head
            # blocks the line, so best-effort never overtakes a page-starved
            # critical request
            free_rows = [idx for idx, s in enumerate(slots) if s.state == "free"]
            while pending and free_rows:
                # re-sort each pass: a preemption in try_pages re-queues
                pending.sort(key=tier_key)
                req = pending[0]
                res = live[req.rid]
                apages = None
                if self.adapters is not None and req.adapter_id:
                    # pin the tenant's adapter before any KV grant, so the
                    # KV rungs below cannot evict it; no room: the head
                    # blocks the line and retries next turn
                    apages = self._admit_adapter(req)
                    if apages is None:
                        break
                seed = self._import_seeds.pop(req.rid, None) if self._import_seeds else None
                if seed is not None:
                    # a handoff import (decode tier): the prompt's KV already
                    # sits in this engine's pages, so the row goes straight
                    # to decode state under its own adapter. The pages
                    # belong to the row: retire or a preemption releases
                    # them (a preempted import re-queues and prefills
                    # prompt + tokens again).
                    pending.pop(0)
                    idx = free_rows.pop(0)
                    s = slots[idx]
                    s.state = "decode"
                    s.req = req
                    s.prompt = seed["prompt"]
                    s.done = s.pos = seed["pos"]
                    s.result = res
                    if apages is not None:
                        s.atable[:] = apages
                    self._grow(s, list(seed["pages"]))
                    s.last = seed["last"]
                    if not res.tokens:
                        res.tokens.append(s.last)
                    res.admit_tick = self.ticks
                    res.admit_s = now()
                    if res.first_token_tick is None:  # it came with the handoff
                        res.first_token_tick = self.ticks
                        res.first_token_s = now()
                    # the row's device length, where the decode step writes
                    # and attends from
                    self.cache["len"][idx] = seed["pos"]
                    if self.draft_cache is not None:
                        # imported pages hold the target's KV only: the row
                        # plain-decodes for its lifetime
                        s.draft_stale = True
                        self.draft_cache["len"][idx] = seed["pos"]
                    continue
                eff = req.prompt + tuple(res.tokens)
                matched, mpages = 0, []
                if self.radix is not None:
                    # count=False: a page-starved head re-matches every turn;
                    # the lookup is recorded once, when the admission lands.
                    # Only pages this request's adapter wrote can match.
                    matched, mpages = self.radix.match(eff, count=False,
                                                       adapter_id=req.adapter_id)
                    # floor to a chunk boundary, so the chunk walk lands
                    # where a fresh prefill's would
                    aligned = (matched // self.chunk) * self.chunk
                    keep = aligned // ps
                    if keep < len(mpages):
                        self.allocator.release(mpages[keep:])
                        mpages = mpages[:keep]
                        matched = aligned
                first_real = min(self.chunk, len(eff) - matched)
                need = pages_for(matched + first_real, ps) - len(mpages)
                fresh = try_pages(max(need, 0), req.tier)
                if fresh is None:
                    if mpages:
                        self.allocator.release(mpages)
                    if apages is not None:
                        # unpin, so the idle adapter stays evictable for a
                        # row that can make progress (a re-pin is a hit)
                        self.adapters.release(req.adapter_id)
                    break
                pending.pop(0)
                if self.radix is not None:
                    self.radix.record_lookup(len(eff), matched)
                idx = free_rows.pop(0)
                s = slots[idx]
                s.state = "prefill"
                s.req = req
                s.prompt = eff
                s.done = s.pos = matched
                s.result = res
                if apages is not None:
                    s.atable[:] = apages
                self._grow(s, mpages + fresh)
                if res.preemptions and "readmit_tick" not in res.preemptions[-1]:
                    res.preemptions[-1]["readmit_tick"] = self.ticks
                    res.preemptions[-1]["readmit_s"] = now()
                else:
                    res.admit_tick = self.ticks
                    res.admit_s = now()
                if matched and req.rid >= 0:
                    res.prefix_tokens += matched
                    # one live span per admission, so the histogram bucket
                    # carries an exemplar that links /metrics to /traces
                    with TRACER.span("serve.prefix_hit",
                                     attributes={"rid": req.rid, "tokens": matched}):
                        REGISTRY.observe(
                            ENGINE_PREFIX_HIT_TOKENS, float(matched),
                            "Prompt tokens served from the radix prefix cache per admission",
                            buckets=(1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0),
                            **({"pod": self.metrics_pod} if self.metrics_pod else {}),
                        )

            # --- one prompt chunk for the oldest mid-prefill row that can
            # get its pages. (The reference tries the oldest only: a stalled
            # best-effort head then starves every critical row behind it,
            # and the run can cycle forever.)
            pre = [idx for idx, s in enumerate(slots) if s.state == "prefill"]
            for idx in sorted(pre, key=lambda j: slots[j].result.arrival_tick):
                s = slots[idx]
                if s.state != "prefill":  # preempted by a grant in this pass
                    continue
                real = s.prompt[s.done : s.done + self.chunk]
                n_real = len(real)
                need = pages_for(s.done + n_real, ps) - len(s.pages)
                got = try_pages(need, s.req.tier) if need > 0 else []
                if got is None:  # the row stalls in place and retries next turn
                    continue
                self._grow(s, got)
                if self.governor is not None:
                    self.governor.before_step()
                buf = np.zeros((self.chunk,), np.int64)
                buf[:n_real] = real
                tokens, table = self._upload(buf), self._upload(s.table)
                atab = None if s.atable is None else self._upload(s.atable[None])
                if s.done == 0:
                    tok = self._prefill(tokens, idx, table, n_real, atab)
                else:
                    tok = self._extend(tokens, idx, table, s.done, n_real, atab)
                self.ticks += 1
                dispatched = True
                s.done += n_real
                s.pos = s.done
                if s.done == len(s.prompt):
                    t = int(tok)
                    if not s.result.tokens:
                        s.result.first_token_tick = self.ticks
                        s.result.first_token_s = now()
                    s.result.tokens.append(t)
                    if (self.eos_id is not None and t == self.eos_id) or (
                        len(s.result.tokens) >= s.req.max_new
                    ):
                        retire(idx)
                    elif self._handoff_sink is not None and s.req.rid >= 0:
                        # prefill tier: the decode belongs to the peer. Fetch
                        # the row's KV before retire frees the pages, retire
                        # (the prompt's pages still go into the local radix
                        # tree), then hand the export over.
                        export = self._export_handoff(s, t)
                        retire(idx)
                        self._handoff_sink(export)
                    else:
                        s.state = "decode"
                        s.last = t
                break

            # --- one speculative round: a draft dispatch proposes spec_k
            # tokens for every eligible decoding row, a verify dispatch
            # scores them, and each row emits up to spec_k + 1 tokens.
            # Eligibility is data: the other rows plain-decode below.
            spec_rows = []
            if self.draft_cfg is not None and not self._spec_suspended and (
                # an engaged governor sheds draft dispatches first; warmup
                # runs them anyway, or their first shape would land mid-run
                # once the governor releases
                self._warming or self.governor is None
                or not self._agreed(self.governor.engaged)
            ):
                spec_rows = self._spec_round(slots, retire)
                if spec_rows:
                    dispatched = True

            # --- pool-wide decode over the rows whose next position has a
            # page (rows of this turn's speculative round sit it out)
            dec = [idx for idx, s in enumerate(slots)
                   if s.state == "decode" and idx not in spec_rows]
            for idx in dec:
                s = slots[idx]
                # a grant below may preempt a best-effort row later in this
                # pass: its slot is fresh by then and gets no page
                if s.state != "decode":
                    continue
                if pages_for(s.pos + 1, ps) > len(s.pages):
                    got = try_pages(1, s.req.tier)
                    if got is not None:
                        self._grow(s, got)
            active_rows = [
                idx for idx in dec
                if slots[idx].state == "decode"
                and pages_for(slots[idx].pos + 1, ps) <= len(slots[idx].pages)
            ]
            if active_rows:
                toks = np.zeros((self.n_slots,), np.int64)
                active = np.zeros((self.n_slots,), bool)
                # Rows not decoding get an all-SCRATCH table: their device
                # len is stale (a retired occupant's, or mid-prefill), and
                # the step's masked write must not land in a shared page.
                tables = np.full((self.n_slots, self.row_pages), SCRATCH, np.int32)
                for idx in dec:
                    tables[idx] = slots[idx].table
                for idx in active_rows:
                    toks[idx] = slots[idx].last
                    active[idx] = True
                atab = None
                if self.adapters is not None:
                    # rows not decoding gather the null adapter
                    at = np.full((self.n_slots, self.pages_per_adapter), SCRATCH, np.int32)
                    for idx in dec:
                        at[idx] = slots[idx].atable
                    atab = self._upload(at)
                if self.governor is not None:
                    self.governor.before_step()
                step_t0 = time.perf_counter()
                nxt = self._decode(self._upload(toks), self._upload(tables), self._upload(active),
                                   atab, max(dec) + 1)
                self.ticks += 1
                dispatched = True
                nxt = nxt.cpu().numpy()  # waits for the step's device work
                self.profiler.record(time.perf_counter() - step_t0)
                for idx in active_rows:
                    s = slots[idx]
                    s.pos += 1
                    t = int(nxt[idx])
                    s.result.tokens.append(t)
                    s.last = t
                    if (self.eos_id is not None and t == self.eos_id) or (
                        len(s.result.tokens) >= s.req.max_new
                    ):
                        retire(idx)

            if not dispatched:
                # Zero progress: every occupied row (and the pending head)
                # is page-starved, and the freeable gate already counted all
                # a radix drain could free. Preempt the youngest row of any
                # tier, never the oldest, and hand the freed pages to the
                # oldest at once (one max_len row always fits the pool).
                occupied = [
                    (s.req.arrival, s.req.rid, idx)
                    for idx, s in enumerate(slots) if s.state != "free"
                ]
                protect = min(occupied)[2] if occupied else None
                if not (preempt_one(critical_only=False, protect=protect) or reclaim_idle()):
                    raise RuntimeError(
                        "paged pool wedged: no dispatch possible, no preemptable "
                        f"row — total_pages {self.total_pages} cannot make progress "
                        f"(free {self.allocator.free_pages})"
                    )
                if protect is not None:
                    grant_oldest(slots[protect], protect)

        self.publish_metrics()
        results.sort(key=lambda r: r.rid)
        # quiesced either way: a drain racing the run's end gets None
        self._drain.finish_run()
        return ServeStats(
            results=results, ticks=self.ticks, wall_s=time.perf_counter() - t0,
            trace_counts=self.trace_counts, engine_cache=self.cache_stats(),
        )


def _tp_mesh(mesh: Mesh | None) -> Mesh | None:
    """The engines' mesh: a gang's tp mesh, kept only when tp is above 1
    (as the reference keeps it); any other axis above 1 raises."""
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    if mesh.size != mesh.shape["tp"]:
        raise ValueError(f"serving shards over tp only, got mesh {mesh.shape}")
    return mesh


def _host_tensor(x) -> torch.Tensor:
    """One page buffer as a host tensor: tensors as they are, numpy arrays
    without a copy, and the reference's ``ml_dtypes`` bf16 arrays through
    their 16-bit words (the port never imports ``ml_dtypes``)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:  # torch tensors over numpy memory are writable
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def poisson_trace(
    n: int,
    *,
    seed: int,
    rate: float,
    vocab: int,
    prompt_lens: tuple[int, int],
    max_new: tuple[int, int] | Sequence[int],
    adapters: Sequence[str] | None = None,
) -> list[Request]:
    """Poisson arrivals at ``rate`` requests/tick, prompt lengths uniform
    over (lo, hi) inclusive; ``max_new`` a (lo, hi) tuple draws uniformly,
    a list draws from it as choices. ``adapters`` gives each request a
    LoRA adapter id drawn uniformly from the list (``""`` is the base
    model). Same draws per seed as the reference's (numpy
    ``RandomState``)."""
    if isinstance(max_new, tuple) and len(max_new) != 2:
        raise ValueError(
            f"max_new tuple must be (lo, hi), got {max_new!r}; pass a list "
            "for a choices mix"
        )
    rng = np.random.RandomState(seed)
    choices = None if isinstance(max_new, tuple) else list(max_new)
    t = 0.0
    out = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        mn = (
            int(choices[rng.randint(len(choices))]) if choices is not None
            else int(rng.randint(max_new[0], max_new[1] + 1))
        )
        prompt = tuple(int(x) for x in rng.randint(0, vocab, size=plen))
        out.append(Request(
            rid=rid, prompt=prompt, max_new=mn, arrival=t,
            adapter_id=_draw_adapter(rng, adapters),
        ))
    return out


def _draw_adapter(rng: np.random.RandomState, adapters: Sequence[str] | None) -> str:
    """One uniform draw from ``adapters`` (no draw without a list)."""
    return "" if adapters is None else str(adapters[rng.randint(len(adapters))])


def shared_prefix_trace(
    n: int,
    *,
    seed: int,
    rate: float,
    vocab: int,
    prefixes: tuple[int, int],
    tail_lens: tuple[int, int],
    max_new: tuple[int, int] | Sequence[int],
    tiers: Sequence[tuple[str, float, float | None, float | None]] | None = None,
    adapters: Sequence[str] | None = None,
) -> list[Request]:
    """Poisson arrivals whose prompts share system prompts: ``prefixes`` is
    ``(count, length)``; ``count`` shared prefixes are drawn once, and each
    request picks one uniformly and appends a tail of ``tail_lens`` (lo,
    hi) tokens (the radix cache's workload). ``tiers`` rows ``(tier,
    weight, slo_ttft_ticks, slo_tpot_ticks)`` are sampled by weight; None
    keeps every request critical with no targets. ``max_new`` and
    ``adapters`` follow :func:`poisson_trace`: tenants then share the
    system prompts, but each adapter prefills its own copy of their pages
    (``radix.py``). Same draws per seed as the reference's."""
    n_pre, pre_len = prefixes
    if n_pre < 1 or pre_len < 0:
        raise ValueError(f"prefixes must be (count>=1, len>=0), got {prefixes}")
    rng = np.random.RandomState(seed)
    pres = [tuple(int(x) for x in rng.randint(0, vocab, size=pre_len)) for _ in range(n_pre)]
    choices = None if isinstance(max_new, tuple) else list(max_new)
    if tiers is not None:
        weights = np.asarray([t[1] for t in tiers], np.float64)
        weights = weights / weights.sum()
    t = 0.0
    out = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        pre = pres[rng.randint(n_pre)]
        tlen = int(rng.randint(tail_lens[0], tail_lens[1] + 1))
        tail = tuple(int(x) for x in rng.randint(0, vocab, size=tlen))
        mn = (
            int(choices[rng.randint(len(choices))]) if choices is not None
            else int(rng.randint(max_new[0], max_new[1] + 1))
        )
        tier, slo_ttft, slo_tpot = TIER_CRITICAL, None, None
        if tiers is not None:
            tier, _, slo_ttft, slo_tpot = tiers[int(rng.choice(len(tiers), p=weights))]
        out.append(Request(
            rid=rid, prompt=pre + tail, max_new=mn, arrival=t, tier=tier,
            slo_ttft_ticks=slo_ttft, slo_tpot_ticks=slo_tpot,
            adapter_id=_draw_adapter(rng, adapters),
        ))
    return out


# --- the static lockstep baseline ----------------------------------------------


def run_static_baseline(
    params,
    cfg: TransformerConfig,
    requests: Sequence[Request],
    *,
    batch: int,
    eos_id: int | None = None,
    kv_dtype: str | None = None,
    warmup: bool = True,
    trials: int = 1,
    device: str | torch.device | None = None,
) -> ServeStats:
    """The pre-engine serving discipline, as the reference instruments it:
    waves of up to ``batch`` requests run lockstep through
    ``generate.make_generate(padded=True)`` (one padded prefill and the
    global ``max_new`` decode steps for every row), and nothing is
    admitted until the whole wave retires.

    The reference's accounting: a wave is taken the moment the pool is
    idle from whatever has arrived, its prefill costs one tick and each
    decode step one more; a member's tokens exist only when the wave
    returns, so its first token and its finish are the wave's completion
    on both clocks. Tokens are cut to each request's ``max_new`` and
    first EOS. Every wave has the shape (``batch``, longest prompt), dummy
    rows holding a one-token prompt. ``warmup`` runs one wave off the
    clock first (``SlotEngine.warmup``'s counterpart); of ``trials`` runs,
    whose ticks and tokens are the same, the fastest wall is kept. On
    ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    gmax = max(r.max_new for r in requests)
    tp_max = max(len(r.prompt) for r in requests)
    gen = G.make_generate(cfg, max_new=gmax, eos_id=eos_id, padded=True, kv_dtype=kv_dtype,
                          device=dev)
    incoming = sorted(requests, key=lambda r: (r.arrival, r.rid))
    if warmup:
        gen(params, torch.zeros((batch, tp_max), dtype=torch.long, device=dev),
            torch.ones((batch,), dtype=torch.long, device=dev)).cpu()
    best: ServeStats | None = None
    for _ in range(max(1, trials)):
        results: list[RequestResult] = []
        tick = 0
        i = 0
        t0 = time.perf_counter()
        while i < len(incoming):
            if incoming[i].arrival > tick:
                tick = int(math.ceil(incoming[i].arrival))
            wave = [r for r in incoming[i:] if r.arrival <= tick][:batch]
            i += len(wave)
            prompts = np.zeros((batch, tp_max), np.int64)
            lens = np.ones((batch,), np.int64)  # dummy rows: a one-token prompt
            for row, r in enumerate(wave):
                prompts[row, :len(r.prompt)] = r.prompt
                lens[row] = len(r.prompt)
            out = gen(params, torch.from_numpy(prompts).to(dev),
                      torch.from_numpy(lens).to(dev)).tolist()
            tick += 1 + gmax  # one prefill tick, then the lockstep decode ticks
            wall = time.perf_counter() - t0
            for row, r in enumerate(wave):
                toks = out[row][:r.max_new]
                if eos_id is not None and eos_id in toks:
                    toks = toks[:toks.index(eos_id) + 1]
                results.append(RequestResult(
                    rid=r.rid, prompt_len=len(r.prompt), tokens=toks, arrival_tick=r.arrival,
                    first_token_tick=tick, finish_tick=tick, first_token_s=wall, finish_s=wall,
                ))
        wall_total = time.perf_counter() - t0
        # A lockstep run has no live arrival clock: arrivals convert at the
        # run's seconds per tick, so its wall TTFT compares with the engine's.
        spt = wall_total / max(tick, 1)
        for res in results:
            res.arrival_s = min(res.arrival_tick * spt, res.first_token_s)
        results.sort(key=lambda r: r.rid)
        stats = ServeStats(results=results, ticks=tick, wall_s=wall_total, trace_counts={})
        if best is None or stats.wall_s < best.wall_s:
            best = stats
    return best


def kv_slot_bytes(cfg: TransformerConfig, max_len: int, kv_dtype: str | None = None) -> int:
    """Device bytes one slot row pins: K+V across layers at ``max_len``
    positions (+ per-(token, head) f32 scales for int8 caches)."""
    itemsize = 1 if kv_dtype == "int8" else cfg.compute_dtype.itemsize
    per = 2 * cfg.n_layers * max_len * cfg.kv_heads * cfg.head_dim * itemsize
    if kv_dtype == "int8":
        per += 2 * cfg.n_layers * max_len * cfg.kv_heads * 4
    return per


def slots_for_slice(
    slice_bytes: int,
    cfg: TransformerConfig,
    max_len: int,
    *,
    weight_bytes: int,
    kv_dtype: str | None = None,
    headroom: float = 0.90,
) -> int:
    """Slot-pool size a ``slice_bytes`` memory slice sustains: weights
    come off the top, ``headroom`` covers activations and workspace, the
    rest divides by per-slot KV bytes. 0 means the slice cannot serve this
    config at all."""
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom must be in (0, 1], got {headroom}")
    usable = slice_bytes * headroom - weight_bytes
    if usable <= 0:
        return 0
    return int(usable // kv_slot_bytes(cfg, max_len, kv_dtype))


def slots_for_gang(
    per_chip_bytes: int,
    n_chips: int,
    cfg: TransformerConfig,
    max_len: int,
    *,
    weight_bytes: int,
    kv_dtype: str | None = None,
    headroom: float = 0.90,
) -> int:
    """Slot-pool size a multi-chip gang sustains, over the per-chip
    shares: a tensor-parallel engine pins about ``weight_bytes / n`` and
    ``kv_slot_bytes / n`` per slot on each chip when the kv heads divide
    by the gang size, and the full amounts when they do not (the cache
    then replicates). 0 means the gang cannot serve this config."""
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom must be in (0, 1], got {headroom}")
    per_slot = kv_slot_bytes(cfg, max_len, kv_dtype)
    if n_chips > 1 and cfg.kv_heads % n_chips == 0:
        per_slot = -(-per_slot // n_chips)
        weight_bytes = -(-weight_bytes // n_chips)
    usable = per_chip_bytes * headroom - weight_bytes
    if usable <= 0:
        return 0
    return int(usable // per_slot)


def _pod_slice(pod: PodTpuEnv, unit: MemoryUnit) -> tuple[int, int, str]:
    """(bytes to size over, chips they span, a description for errors):
    a gang sizes over this container's per-chip share, a single-chip pod
    over its whole slice."""
    if pod.is_gang:
        per_chip = pod.gang_container_per_chip_bytes(unit)
        desc = (f"gang slice of {per_chip / unit.num_bytes:g} {unit.value}/chip x "
                f"{len(pod.gang_chips)} chips")
        return per_chip, len(pod.gang_chips), desc
    return pod.mem_bytes(unit), 1, f"slice of {pod.mem_units_container} {unit.value}"


def slots_from_pod_env(
    cfg: TransformerConfig,
    max_len: int,
    *,
    weight_bytes: int,
    env: PodTpuEnv | None = None,
    kv_dtype: str | None = None,
    headroom: float = 0.90,
    unit: MemoryUnit = MemoryUnit.GiB,
) -> int:
    """Slot pool for this pod's ``aliyun.com/tpu-mem`` slice, read from
    the plugin-injected env (``PodTpuEnv.from_env()`` unless ``env`` is
    given). A gang sizes over its per-chip share (:func:`slots_for_gang`).
    Raises when the slice cannot hold one slot: a misconfigured pod fails
    at startup, not mid-serve."""
    pod = env if env is not None else PodTpuEnv.from_env()
    nbytes, n_chips, desc = _pod_slice(pod, unit)
    if pod.is_gang:
        n = slots_for_gang(nbytes, n_chips, cfg, max_len, weight_bytes=weight_bytes,
                           kv_dtype=kv_dtype, headroom=headroom)
    else:
        n = slots_for_slice(nbytes, cfg, max_len, weight_bytes=weight_bytes,
                            kv_dtype=kv_dtype, headroom=headroom)
    if n < 1:
        raise ValueError(
            f"{desc} cannot hold weights ({weight_bytes / 2**30:.2f} GiB) plus one "
            f"{max_len}-position KV slot ({kv_slot_bytes(cfg, max_len, kv_dtype) / 2**30:.3f} "
            f"GiB) at headroom {headroom} — request a larger aliyun.com/tpu-mem "
            "slice, shrink max_len, or quantize (kv_dtype='int8')"
        )
    return n


def paged_plan_from_pod_env(
    cfg: TransformerConfig,
    max_len: int,
    *,
    weight_bytes: int,
    page_size: int,
    prefill_chunk: int = 64,
    env: PodTpuEnv | None = None,
    kv_dtype: str | None = None,
    headroom: float = 0.90,
    unit: MemoryUnit = MemoryUnit.GiB,
    slots: int | None = None,
    draft_cfg: TransformerConfig | None = None,
    draft_weight_bytes: int = 0,
    lora: bool = False,
) -> PagedPlan:
    """The paged mode of :func:`slots_from_pod_env`: a
    :class:`PagedSlotEngine` pool (dispatch rows and KV pages; with
    ``draft_cfg`` a speculative engine's draft weights and draft KV per
    page, with ``lora=True`` the adapter slab's row per page) sized by
    :func:`~.pages.paged_plan_for_slice` to this pod's slice, a gang over
    its per-chip share. A speculative engine asks for nothing beyond its
    slice. Raises when the slice cannot hold one ``max_len`` row of
    pages, the least the paged engine needs to make progress."""
    pod = env if env is not None else PodTpuEnv.from_env()
    nbytes, n_chips, desc = _pod_slice(pod, unit)
    plan = paged_plan_for_slice(
        nbytes, cfg, max_len, page_size=page_size, prefill_chunk=prefill_chunk,
        weight_bytes=weight_bytes, kv_dtype=kv_dtype, headroom=headroom, slots=slots,
        n_chips=n_chips, draft_cfg=draft_cfg, draft_weight_bytes=draft_weight_bytes, lora=lora,
    )
    if plan.total_pages < pages_for(max_len, page_size):
        raise ValueError(
            f"{desc} cannot hold weights ({weight_bytes / 2**30:.2f} GiB) plus one "
            f"{max_len}-position row of {page_size}-token KV pages at headroom {headroom} "
            "— request a larger aliyun.com/tpu-mem slice, shrink max_len, or quantize "
            "(kv_dtype='int8')"
        )
    return plan
