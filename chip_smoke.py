#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpushare_device_plugin_tpu_torch``) on
one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Build every CUDA kernel from ``ops/csrc`` and hold each against its
   plain PyTorch version at Llama-3-8B attention shapes (H=32, Hkv=8,
   D=128), bf16 and f32: S in {64, 512, 2048} causal, a left-padded
   (``start``) batch with fully masked rows, a right-padded (``kv_len``)
   batch. Times the kernel, the plain version, one PyTorch library call
   on the same inputs (a yardstick the port never calls) and the bound.
2. Serve: ``llama3_8b()`` at full width and depth (32 layers, bf16,
   random weights made on the card from a seeded generator) in
   ``SlotEngine(slots=8, max_len=2048, prefill_chunk=512)`` over a
   16-request Poisson trace. Kernel launch counts are zeroed just before
   the run and read just after; the shape guard must stay at one shape
   per program.
3. Engine vs solo and kernel vs plain, end to end: each request's tokens
   against the port's solo greedy ``generate``, and one full-depth
   prefill's last-position logits with ``attention="flash"`` against
   ``"plain"``.

Float32 matrix products run in full f32 (TF32 off, set below). The last
line of stdout is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit from ``nvidia-smi``; before that, one
JSON line ``{"kernels": [...]}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from gpushare_device_plugin_tpu_torch.ops import _build
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.serving.engine import SlotEngine, poisson_trace
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads.transformer import init_params, llama3_8b

# H100 SXM published peaks (dense): device memory rate and the operation
# rate per input type (f32 runs outside the tensor cores).
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain tolerances. f32: both sum the same f32 terms in another
# order. bf16: O is rounded to an 8-bit mantissa and P is rounded to bf16
# before the PV product in both, at other running maxima, so they may
# differ by two roundings: |diff| <= 2^-7 * max(|plain|, 1). lse is f32 in
# both from the same exact products.
F32_ATOL = 1e-5
BF16_REL = 2.0 ** -7
LSE_ATOL = 1e-4
# End to end in bf16 (32 layers): the engine's batched products and the
# solo run's take other cuBLAS algorithms, so logits differ slightly, and
# the logits are bf16 values (the output projection runs in bf16), so
# near ties are common over a 128k vocabulary. A token may differ only at
# a step where the solo run's top-two gap is at most TOP2_GAP_REL * |top
# logit| (two bf16 steps); from there on the sequences are not compared.
# The flash and plain prefills' last-position logits must agree within
# LOGIT_REL * max|logit| (four bf16 steps).
TOP2_GAP_REL = 2.0 ** -6
LOGIT_REL = 2.0 ** -5
SERVED_S = 512  # the engine's prompt chunk: the kernel's shape on the main path


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def attention_inputs(gen, B, S, H, Hkv, D, dtype):
    """q [B,S,H,D] and k/v as strided views of one [B,S,2,Hkv,D] tensor,
    the layout the decoder's projection hands the kernel."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((B, S, 2, Hkv, D), generator=gen, device="cuda").to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def flash_bound(q, k, v, *, causal, start, kv_len):
    """Least time for this call on the card: each input read once, each
    output written once, against 4*D flops per visible (query, key) pair
    per head, counted from these inputs' masks."""
    B, S, H, D = q.shape
    vis = fa._visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    flops = 4.0 * D * H * float(vis.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) * 1.0
    nbytes += q.numel() * q.element_size() + B * S * H * 4  # O and lse
    nbytes += sum(b.numel() * 4 for b in (start, kv_len) if b is not None)
    t_ops = flops / PEAK_OPS_PER_S[q.dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def compare(o, lse, po, plse, dtype):
    """Max |O - plain| and whether O and lse are within tolerance."""
    err = (o.float() - po.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL).all())
    else:
        ok = bool((err <= BF16_REL * po.float().abs().clamp(min=1.0)).all())
    dead = torch.isneginf(plse)
    ok &= bool((torch.isneginf(lse) == dead).all())
    ok &= bool(((lse - plse).abs()[~dead] <= LSE_ATOL).all())
    ok &= bool(torch.isfinite(o.float()).all())
    return float(err.max()), ok


def phase_kernels(gen) -> dict:
    print("phase 1: flash_fwd kernel vs plain", flush=True)
    failures = 0
    served = None
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (64, 512, 2048):
            cases.append((dtype, 1, S, "causal"))
        cases.append((dtype, 2, 512, "start"))
        cases.append((dtype, 2, 512, "kv_len"))
    for dtype, B, S, mode in cases:
        q, k, v = attention_inputs(gen, B, S, 32, 8, 128, dtype)
        start = kv_len = None
        if mode == "causal":  # a full prompt chunk, as prefill_slot passes it
            kv_len = torch.tensor([S], dtype=torch.int32, device="cuda")
        if mode == "start":  # rows before start[b] see nothing: dead rows
            start = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
        if mode == "kv_len":
            kv_len = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
        run = lambda: fa.flash_fwd(q, k, v, causal=True, start=start, kv_len=kv_len)  # noqa: E731
        o, lse = run()
        torch.cuda.synchronize()
        po, plse = fa.flash_fwd_plain(
            q, k, v, causal=True, scale=128 ** -0.5, start=start, kv_len=kv_len
        )
        err, ok = compare(o, lse, po, plse, dtype)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(
            lambda: fa.flash_fwd_plain(
                q, k, v, causal=True, scale=128 ** -0.5, start=start, kv_len=kv_len
            ), 3, warmup=1,
        )
        lib_ms = None
        if mode != "start":  # SDPA's dead rows are NaN: no like-for-like call
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # same tensors, [B,H,S,D] views
            mask = None
            if mode == "kv_len":
                vis = fa._visible(B, S, causal=True, start=None, kv_len=kv_len, device="cuda")
                mask = vis[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True
            )
            lib_ms = cuda_ms(lib, 20)
        bound_ms, bound_by = flash_bound(q, k, v, causal=True, start=start, kv_len=kv_len)
        row = dict(
            dtype=str(dtype).split(".")[-1], B=B, S=S, mode=mode,
            max_abs_err=err, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        print("  flash_fwd", json.dumps(row), flush=True)
        failures += not ok
        if dtype == torch.bfloat16 and B == 1 and S == SERVED_S:
            served = row
    if failures:
        raise SystemExit(f"phase 1 failed: {failures} case(s) out of tolerance")
    return served


def profile_decode_step(engine, steps: int = 3) -> dict:
    """Device busy share of the engine's pool-wide decode step (all rows
    active): summed kernel time from ``torch.profiler`` over the host wall
    time of ``steps`` steps, and the kernels that take most of it. Runs
    after the served trace, on retired rows, and touches no result."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.ones(engine.n_slots, dtype=torch.long, device="cuda")
    active = torch.ones(engine.n_slots, dtype=torch.bool, device="cuda")
    engine._decode(toks, active)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode(toks, active)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:4]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in events) / steps,
        "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 / steps for e in top},
    }


def solo_with_gaps(params, cfg, prompt, max_new):
    """Solo greedy decode of one prompt, step for step as ``generate``
    runs it, with the top-two logit gap at every step."""
    p = torch.tensor([prompt], dtype=torch.long, device="cuda")
    cache = G.init_cache(cfg, 1, len(prompt) + max_new)
    logits, cache = G.prefill(params, p, cache, cfg)
    toks, gaps = [], []
    for step in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        gaps.append((float(top2[0] - top2[1]), float(top2[0].abs())))
        tok = torch.argmax(logits, -1)
        toks.append(int(tok))
        if step + 1 < max_new:
            logits, cache = G.decode_step(params, tok, cache, cfg)
    return toks, gaps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.sources():
        print(_build.build_log(name).strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    served = phase_kernels(gen)

    print("phase 2: serve llama3_8b (32 layers, bf16)", flush=True)
    cfg = llama3_8b()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    weight_gb = sum(
        t.numel() * t.element_size() for t in
        [params["embed"], params["out"], params["final_norm"], *params["layers"].values()]
    ) / 1e9
    engine = SlotEngine(params, cfg, slots=8, max_len=2048, prefill_chunk=512, eos_id=128001)
    engine.warmup()
    trace = poisson_trace(
        16, seed=0, rate=0.5, vocab=cfg.vocab, prompt_lens=(128, 1536), max_new=(16, 64)
    )
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    stats = engine.run(trace)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    summary = stats.summary()
    serve = {
        "weights_gb": round(weight_gb, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "requests": summary["requests"],
        "tokens": summary["tokens"],
        "ticks": summary["ticks"],
        "wall_s": summary["wall_s"],
        "goodput_tokens_per_s": summary["goodput_tokens_per_s"],
        "ttft_p50_ms": summary["ttft_p50_ms"],
        "ttft_p99_ms": summary["ttft_p99_ms"],
        "decode_step_p50_ms": engine.profiler.p50() * 1e3,
        "decode_step_p99_ms": engine.profiler.p99() * 1e3,
        "decode_steps": engine.profiler.count,
        "shape_guard": stats.trace_counts,
        "launches": launches,
    }
    print("  serve", json.dumps(serve), flush=True)
    serve["decode_step_profile"] = profile_decode_step(engine)
    print("  decode step profile", json.dumps(serve["decode_step_profile"]), flush=True)
    if stats.trace_counts != {"prefill": 1, "extend": 1, "decode": 1}:
        raise SystemExit(f"phase 2 failed: shape guard moved: {stats.trace_counts}")
    if launches["flash_fwd"] < 1:
        raise SystemExit("phase 2 failed: the serving path never launched flash_fwd")
    if len(stats.results) != len(trace):
        raise SystemExit("phase 2 failed: not every request was served")

    print("phase 3: engine vs solo generate, flash vs plain prefill", flush=True)
    diverged = []
    for req, res in zip(trace, stats.results):
        want, gaps = solo_with_gaps(params, cfg, list(req.prompt), req.max_new)
        if req.rid == 0:
            ref = G.generate(params, [list(req.prompt)], cfg, max_new=req.max_new)
            if ref[0, len(req.prompt):].tolist() != want:
                raise SystemExit("phase 3 failed: solo decode != generate")
        got = res.tokens
        if len(got) != len(want):
            raise SystemExit(f"phase 3 failed: request {req.rid} length {len(got)} != {len(want)}")
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if j is not None:
            gap, top = gaps[j]
            diverged.append({"rid": req.rid, "step": j, "solo_top2_gap": gap, "top": top})
            if gap > TOP2_GAP_REL * top:
                raise SystemExit(
                    f"phase 3 failed: request {req.rid} diverges at step {j} "
                    f"where the solo top-two gap {gap} > {TOP2_GAP_REL} * {top}"
                )
    print("  engine vs solo:", len(trace) - len(diverged), "identical,",
          "diverged at near ties:", json.dumps(diverged), flush=True)
    prompt = torch.tensor([list(trace[0].prompt)], dtype=torch.long, device="cuda")
    logits = {}
    for attention in ("flash", "plain"):
        c = dataclasses.replace(cfg, attention=attention)
        cache = G.init_cache(c, 1, prompt.shape[1])
        logits[attention], _ = G.prefill(params, prompt, cache, c)
    diff = float((logits["flash"] - logits["plain"]).abs().max())
    tol = LOGIT_REL * float(logits["plain"].abs().max())
    print(f"  prefill logits flash vs plain: max |diff| {diff} (tolerance {tol})", flush=True)
    if not math.isfinite(diff) or diff > tol:
        raise SystemExit(f"phase 3 failed: flash vs plain logits differ by {diff}")

    kernel = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "gpushare_device_plugin_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "gpushare_device_plugin_tpu/ops/flash_attention.py:96",
        "launches": launches["flash_fwd"],
        "max_abs_err": served["max_abs_err"],
        "ms": served["ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
