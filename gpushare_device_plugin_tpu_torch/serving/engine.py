"""Continuous-batching serving engine over a slot-pool KV cache, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/serving/engine.py``
(``SlotEngine``, the request/result/stats records, ``poisson_trace`` and
slice sizing). A fixed pool of KV-cache rows (``init_slot_cache``):

- admission packs a waiting request into a free row, one fixed-width
  prompt chunk per loop turn (``prefill_slot`` for the first chunk, then
  ``extend_slot``), so decoding rows keep decoding while a prompt
  streams in;
- one pool-wide ``decode_step`` advances every decoding row by a token;
  a row that emits EOS or reaches its ``max_new`` retires at once and
  its slot takes the next request;
- greedy decoding: every request's tokens are those of a solo greedy
  ``generate()`` of its prompt.

**Static shapes.** The pool, the chunk width and the step batch never
change shape. PyTorch compiles nothing here, so ``trace_counts`` is a
shape guard: each of the three programs (prefill, extend, decode) records
the distinct input shapes it has run on, and slot churn must leave every
count at 1.

**Clocks.** Ticks (one per model dispatch: a prompt chunk or a decode
step) and wall seconds, as in the reference. The governor, SLO budget,
tracing and ``/metrics`` hooks of the reference are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from ..const import SLO_TIER_BEST_EFFORT, SLO_TIER_CRITICAL
from ..device import resolve_device
from ..workloads import generate as G
from ..workloads.transformer import TransformerConfig
from .profiler import StepProfiler, ceil_rank_quantile

TIER_CRITICAL = SLO_TIER_CRITICAL
TIER_BEST_EFFORT = SLO_TIER_BEST_EFFORT
_TIERS = (TIER_CRITICAL, TIER_BEST_EFFORT)


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
    tier: str = TIER_CRITICAL
    slo_ttft_ticks: float | None = None
    slo_tpot_ticks: float | None = None

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

    @staticmethod
    def _quantile(vals: list[float], q: float) -> float:
        return ceil_rank_quantile(vals, q)

    def tier_summary(self) -> dict:
        out: dict = {}
        for tier in sorted({r.tier for r in self.results}):
            rs = [r for r in self.results if r.tier == tier]
            tpot = [r.tpot_ticks for r in rs if len(r.tokens) > 1]
            scored = [s for s in (r.meets_slo() for r in rs) if s is not None]
            out[tier] = {
                "requests": len(rs),
                "ttft_p50_ticks": self._quantile([r.ttft_ticks for r in rs], 0.50),
                "ttft_p99_ticks": self._quantile([r.ttft_ticks for r in rs], 0.99),
                "tpot_p50_ticks": round(self._quantile(tpot, 0.50), 3) if tpot else None,
                "tpot_p99_ticks": round(self._quantile(tpot, 0.99), 3) if tpot else None,
                "slo_attainment": round(sum(scored) / len(scored), 3) if scored else None,
            }
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
        if any(r.tier != TIER_CRITICAL or r.meets_slo() is not None for r in self.results):
            out["tiers"] = self.tier_summary()
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
    ``prompt + max_new`` cannot fit a row is rejected at submit time."""

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
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.n_slots = slots
        self.max_len = max_len
        self.chunk = prefill_chunk
        self.eos_id = eos_id
        self.kv_dtype = kv_dtype
        self.cache = G.init_slot_cache(cfg, slots, max_len, kv_dtype=kv_dtype, device=self.device)
        self.ticks = 0
        self._shapes: dict[str, set] = {"prefill": set(), "extend": set(), "decode": set()}
        self.profiler = StepProfiler(capacity=profiler_capacity)

    @property
    def trace_counts(self) -> dict[str, int]:
        """Distinct input shapes each program has run on (the shape guard)."""
        return {name: len(seen) for name, seen in self._shapes.items()}

    def _guard(self, program: str, *tensors: torch.Tensor) -> None:
        self._shapes[program].add(tuple((tuple(t.shape), t.dtype) for t in tensors))

    def _prefill(self, tokens: torch.Tensor, slot: int, n_real: int) -> torch.Tensor:
        self._guard("prefill", tokens, self.cache["k"], self.cache["len"])
        logits, self.cache = G.prefill_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, n_real=n_real
        )
        return torch.argmax(logits[0], -1)

    def _extend(self, tokens: torch.Tensor, slot: int, n_real: int) -> torch.Tensor:
        self._guard("extend", tokens, self.cache["k"], self.cache["len"])
        logits, self.cache = G.extend_slot(
            self.params, tokens, self.cache, self.cfg, slot=slot, n_real=n_real
        )
        return torch.argmax(logits[0], -1)

    def _decode(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        self._guard("decode", tokens, active, self.cache["k"], self.cache["len"])
        logits, new = G.decode_step(self.params, tokens, self.cache, self.cfg)
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
        self.run([Request(rid=-1, prompt=tuple(range(1, plen + 1)), max_new=2, arrival=0.0)])
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

        def now() -> float:
            return time.perf_counter() - t0

        def retire(idx: int) -> None:
            s = slots[idx]
            s.result.finish_tick = self.ticks
            s.result.finish_s = now()
            results.append(s.result)
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
        return ServeStats(
            results=results, ticks=self.ticks, wall_s=time.perf_counter() - t0,
            trace_counts=self.trace_counts,
        )


def poisson_trace(
    n: int,
    *,
    seed: int,
    rate: float,
    vocab: int,
    prompt_lens: tuple[int, int],
    max_new: tuple[int, int] | Sequence[int],
) -> list[Request]:
    """Poisson arrivals at ``rate`` requests/tick, prompt lengths uniform
    over (lo, hi) inclusive; ``max_new`` a (lo, hi) tuple draws uniformly,
    a list draws from it as choices. Same draws per seed as the
    reference's (numpy ``RandomState``)."""
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
        out.append(Request(
            rid=rid,
            prompt=tuple(int(x) for x in rng.randint(0, vocab, size=plen)),
            max_new=mn,
            arrival=t,
        ))
    return out


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
