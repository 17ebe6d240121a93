#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpushare_device_plugin_tpu_torch``) on
one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Build every CUDA kernel from ``ops/csrc`` and hold the forward
   against its plain PyTorch version at Llama-3-8B attention shapes
   (H=32, Hkv=8, D=128), each case through the entry ``flash_fwd`` picks
   for its dtype and head dim (bf16 at D in {64, 128}: the tensor-core
   ``flash_fwd``; f32: ``flash_fwd_scalar``), bf16 and f32: S in {64,
   512, 2048} causal, a left-padded (``start``) batch with fully masked
   rows, a right-padded (``kv_len``) batch; and in bf16 a ragged S=300,
   D=64 at S=2048, and the training shape B=4 x S=2048 (causal, no
   bounds). At the served shape (1 x 512) and the training shape
   ``flash_fwd_scalar`` runs too, on the same inputs. Every entry runs
   twice and must give the same bits. Times each kernel (with its TFLOP/s
   and the fraction of its bound), the plain version, one PyTorch library
   call on the same inputs (a yardstick the port never calls) and the
   bound; kernel and library call also by device time alone
   (``torch.profiler``), which leaves out the host's cost per call.
2. Serve: ``llama3_8b()`` at full width and depth (32 layers, bf16,
   random weights made on the card from a seeded generator) in
   ``SlotEngine(slots=8, max_len=2048, prefill_chunk=512)`` over a
   16-request Poisson trace. Kernel launch counts are zeroed just before
   the run and read just after: ``flash_fwd`` must run and
   ``flash_fwd_scalar`` never. The shape guard must stay at one shape per
   program.
3. Engine vs solo and kernel vs plain, end to end: each request's tokens
   against the port's solo greedy ``generate``, and one full-depth
   prefill's last-position logits with ``attention="flash"`` against
   ``"plain"``.
4. The backward kernels against ``flash_bwd_plain`` at the same attention
   shapes, each case through the entries ``flash_bwd`` picks for its dtype
   and head dim (bf16 at D in {64, 128}: the tensor-core ``flash_bwd_dq``
   / ``flash_bwd_dkv``; f32: ``flash_bwd_dq_scalar`` /
   ``flash_bwd_dkv_scalar``): causal S in {512, 2048}, the training shape
   B=4 x S=2048 (bf16, where the scalar entries run too, on the same
   inputs), a ``start`` batch with dead rows, a ``kv_len`` batch, bf16 at
   D=64, and one ``flash_attention_lse`` backward with a nonzero lse
   cotangent. Every entry runs twice and must give the same bits. Times
   each kernel (with its TFLOP/s and the fraction of its bound), the plain
   version, the backward of ``F.scaled_dot_product_attention`` (a
   yardstick that computes all three gradients in one call) and the
   bound.
5. Train: ``llama3_8b()`` at full width cut to 4 layers, bf16 compute, f32
   params made on the card from a seeded generator, remat "full", the
   default AdamW: ``run_train_loop(DecoderTask(batch=4, seq=2048))`` for 8
   steps. Launch counts are zeroed just before and read just after; the
   loss must be finite and fall, each tensor-core backward kernel must
   run once per layer per step, the scalar ones never, and the forward
   twice (once more in the recompute).
6. Flash against plain, gradient end to end: one ``loss_fn`` backward at
   the same width and depth (B=1, S=2048) with ``attention="flash"`` and
   with ``"plain"``: every leaf gets a nonzero gradient, losses and
   gradients agree.

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
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)
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
# Backward kernels vs plain. f32: the same f32 sums in another order, over
# up to g*S = 8192 terms, and expf against torch.exp: 1e-4 of the tensor's
# largest magnitude. bf16: P and dS are rounded to an 8-bit mantissa in
# both versions at slightly different f32 scores, and each output once:
# one output rounding, 2^-7 * |plain|, plus 2^-8 of the tensor's largest
# magnitude for the terms that round the other way.
BWD_F32_REL = 1e-4
BWD_BF16_REL = 2.0 ** -7
BWD_BF16_TOP = 2.0 ** -8
TRAIN_B, TRAIN_S, TRAIN_LAYERS, TRAIN_STEPS = 4, 2048, 4, 8
# Phase 6, flash vs plain at full width in bf16: the kernels round P and dS
# to bf16 where the plain path keeps f32 softmax (and its bf16 scores), so
# the losses may differ by one bf16 step and each gradient leaf by 2^-5 in
# relative Frobenius norm.
GRAD_LOSS_REL = 2.0 ** -7
GRAD_LEAF_REL = 2.0 ** -5


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


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the kernel time ``torch.profiler``
    sums over ``iters`` calls, over ``iters``. Unlike :func:`cuda_ms` it
    leaves out the gaps in which the device waits for the host, which set
    the time of a small call made through a Python wrapper."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3 / iters


def attention_inputs(gen, B, S, H, Hkv, D, dtype):
    """q [B,S,H,D] and k/v as strided views of one [B,S,2,Hkv,D] tensor,
    the layout the decoder's projection hands the kernel."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((B, S, 2, Hkv, D), generator=gen, device="cuda").to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def flash_bound(q, k, v, *, causal, start, kv_len):
    """Least time for this call on the card: each input read once, each
    output written once, against 4*D flops per visible (query, key) pair
    per head, counted from these inputs' masks. Returns (ms, what bounds
    it, flops)."""
    B, S, H, D = q.shape
    vis = fa._visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    flops = 4.0 * D * H * float(vis.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) * 1.0
    nbytes += q.numel() * q.element_size() + B * S * H * 4  # O and lse
    nbytes += sum(b.numel() * 4 for b in (start, kv_len) if b is not None)
    t_ops = flops / PEAK_OPS_PER_S[q.dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


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
    """Phase 1; returns the rows at the served and the training shape, by
    (kernel entry, "served" or "train")."""
    print("phase 1: flash forward kernels vs plain", flush=True)
    failures = 0
    rows = {}
    train_case = (torch.bfloat16, TRAIN_B, TRAIN_S, 128, "train")
    served_case = (torch.bfloat16, 1, SERVED_S, 128, "causal")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (64, 512, 2048):
            cases.append((dtype, 1, S, 128, "causal"))
        cases.append((dtype, 2, 512, 128, "start"))
        cases.append((dtype, 2, 512, 128, "kv_len"))
    cases += [(torch.bfloat16, 1, 300, 128, "causal"), (torch.bfloat16, 1, 2048, 64, "causal"),
              train_case]
    for case in cases:
        dtype, B, S, D, mode = case
        q, k, v = attention_inputs(gen, B, S, 32, 8, D, dtype)
        start = kv_len = None
        if mode == "causal":  # a full prompt chunk, as prefill_slot passes it
            kv_len = torch.tensor([S], dtype=torch.int32, device="cuda")
        if mode == "start":  # rows before start[b] see nothing: dead rows
            start = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
        if mode == "kv_len":
            kv_len = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
        bounds = dict(causal=True, start=start, kv_len=kv_len)
        plain = lambda: fa.flash_fwd_plain(q, k, v, scale=D ** -0.5, **bounds)  # noqa: E731
        po, plse = plain()
        plain_ms = cuda_ms(plain, 3, warmup=1)
        lib_ms = lib_device_ms = None
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
            lib_device_ms = device_ms(lib)
        bound_ms, bound_by, flops = flash_bound(q, k, v, **bounds)
        entries = [fa.fwd_entry(dtype, D)]
        if case in (served_case, train_case):  # the scalar entry too, on the same inputs
            entries.append("flash_fwd_scalar")
        for entry in entries:
            run = lambda: fa._launch_fwd(entry, q, k, v, scale=D ** -0.5, **bounds)  # noqa: E731
            (o, lse), (o2, lse2) = run(), run()
            torch.cuda.synchronize()
            err, ok = compare(o, lse, po, plse, dtype)
            same_bits = torch.equal(o, o2) and torch.equal(lse, lse2)
            ms = cuda_ms(run, 20)
            dev_ms = device_ms(run)
            row = dict(
                kernel=entry, dtype=str(dtype).split(".")[-1], B=B, S=S, D=D, mode=mode,
                max_abs_err=err, ok=ok, same_bits=same_bits, ms=ms, device_ms=dev_ms,
                tflops=flops / ms / 1e9, bound_fraction=bound_ms / ms,
                device_bound_fraction=bound_ms / dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_device_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            print("  ", json.dumps(row), flush=True)
            failures += not (ok and same_bits)
            if case == served_case:
                rows[(entry, "served")] = row
            if case == train_case:
                rows[(entry, "train")] = row
    if failures:
        raise SystemExit(f"phase 1 failed: {failures} case(s) out of tolerance or not repeatable")
    return rows


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


def phase_serve(gen) -> dict:
    """Phases 2 and 3; returns the kernel launches of the served run."""
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
    if launches["flash_fwd"] < 1 or launches["flash_fwd_scalar"]:
        raise SystemExit(f"phase 2 failed: the serving path's forward launches {launches}")
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

    return launches


def bwd_close(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        tol = BWD_F32_REL * max(top, 1.0)
    else:
        tol = BWD_BF16_REL * want.abs() + BWD_BF16_TOP * top
    return bool(((got - want).abs() <= tol).all()) and bool(torch.isfinite(got).all())


DQ_ENTRIES = ("flash_bwd_dq", "flash_bwd_dq_scalar")


def bwd_bound(entry, q, k, v, *, causal, start, kv_len):
    """Least time for one backward kernel call: 6*D (dQ) or 8*D (dK/dV)
    flops per visible (query, key) pair per head, against q, k, v, dO,
    lse and delta read once and the kernel's outputs written once.
    Returns (ms, what bounds it, flops)."""
    B, S, H, D = q.shape
    vis = fa._visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    per_pair = 6.0 if entry in DQ_ENTRIES else 8.0
    flops = per_pair * D * H * float(vis.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q)) + 2 * B * S * H * 4.0
    nbytes += sum(b.numel() * 4 for b in (start, kv_len) if b is not None)
    nbytes += (q.numel() * q.element_size() if entry in DQ_ENTRIES
               else 2 * k.numel() * k.element_size())
    t_ops = flops / PEAK_OPS_PER_S[q.dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


def sdpa_backward_ms(q, k, v, do, mask) -> float:
    """Time of the backward of ``F.scaled_dot_product_attention`` on the
    same inputs (k/v [B, Hkv, S, D] views, GQA passed as enable_gqa=True),
    which computes dq, dk and dv in one call: a yardstick only."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True
    )
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 5)


def phase_backward() -> dict:
    """Phase 4; returns the rows at the training shape, by kernel entry."""
    print("phase 4: flash backward kernels vs plain", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    failures = 0
    train_rows = {}
    train_case = (torch.bfloat16, TRAIN_B, TRAIN_S, 128, "causal")
    cases = [train_case]
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(dtype, 1, 512, 128, "causal"), (dtype, 1, 2048, 128, "causal"),
                  (dtype, 2, 512, 128, "start"), (dtype, 2, 512, 128, "kv_len")]
    cases.append((torch.bfloat16, 1, 2048, 64, "causal"))
    for case in cases:
        dtype, B, S, D, mode = case
        q, k, v = attention_inputs(gen, B, S, 32, 8, D, dtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        start = kv_len = None
        if mode == "start":  # row 1's queries < 200 see nothing; keys < 200 no query sees
            start = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
        if mode == "kv_len":  # row 1's keys >= 300 no query sees
            kv_len = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
        bounds = dict(causal=True, start=start, kv_len=kv_len)
        o, lse = fa.flash_fwd(q, k, v, **bounds)
        delta = (do.float() * o.float()).sum(-1)
        plain = lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=D ** -0.5, **bounds)  # noqa: E731
        want = dict(zip(("dq", "dk", "dv"), plain()))
        plain_ms = cuda_ms(plain, 3, warmup=1)
        lib_ms = None
        if mode != "start":  # SDPA's dead rows are NaN: no like-for-like call
            mask = None
            if mode == "kv_len":
                mask = fa._visible(B, S, causal=True, start=None, kv_len=kv_len, device="cuda")[:, None]
            lib_ms = sdpa_backward_ms(q, k, v, do, mask)
        entries = list(fa.bwd_entries(dtype, D))
        if case == train_case:  # the scalar entries too, on the same inputs
            entries += fa.bwd_entries(torch.float32, D)
        for entry in entries:
            run = lambda: fa._launch_bwd(entry, q, k, v, do, lse, delta, scale=D ** -0.5, **bounds)  # noqa: E731
            names = ("dq",) if entry in DQ_ENTRIES else ("dk", "dv")
            got, again = run(), run()
            torch.cuda.synchronize()
            got = dict(zip(names, got if isinstance(got, tuple) else (got,)))
            again = dict(zip(names, again if isinstance(again, tuple) else (again,)))
            ok = all(bwd_close(got[n], want[n], dtype) for n in names)
            same_bits = all(torch.equal(got[n], again[n]) for n in names)
            if mode == "start":  # dead rows' dq, unseen keys' dk and dv: exactly 0
                ok &= not any(got[n][1, :200].any() for n in names)
            if mode == "kv_len":
                ok &= not any(got[n][1, 300:].any() for n in names if n != "dq")
            err = max(float((got[n].float() - want[n].float()).abs().max()) for n in names)
            ms = cuda_ms(run, 10)
            bound_ms, bound_by, flops = bwd_bound(entry, q, k, v, **bounds)
            row = dict(
                kernel=entry, dtype=str(dtype).split(".")[-1], B=B, S=S, D=D, mode=mode,
                max_abs_err=err, ok=ok, same_bits=same_bits, ms=ms,
                tflops=flops / ms / 1e9, bound_fraction=bound_ms / ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            )
            print("  ", json.dumps(row), flush=True)
            if case == train_case:
                train_rows[entry] = row
            failures += not (ok and same_bits)

    # The (O, lse) pair with a nonzero lse cotangent, through the autograd
    # Function: the kernels against the plain version given the same
    # delta, and against autograd through the plain forward.
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_() for t in attention_inputs(gen, 1, 512, 32, 8, 128, dtype))
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        dlse = torch.randn(q.shape[:3], generator=gen, device="cuda")
        o, lse = fa.flash_attention_lse(q, k, v)
        got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        delta = (do.float() * o.detach().float()).sum(-1) - dlse
        want = fa.flash_bwd_plain(q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
                                  causal=True, scale=128 ** -0.5)
        ok = all(bwd_close(g, w, dtype) for g, w in zip(got, want))
        if dtype == torch.float32:
            po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=128 ** -0.5)
            auto = torch.autograd.grad((po, plse), (q, k, v), (do, dlse))
            ok &= all(bwd_close(g, w, dtype) for g, w in zip(got, auto))
        errs = {n: float((g.float() - w.float()).abs().max()) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        print("   lse pair", str(dtype).split(".")[-1], json.dumps({"ok": ok, **errs}), flush=True)
        failures += not ok
    if failures:
        raise SystemExit(f"phase 4 failed: {failures} case(s) out of tolerance")
    return train_rows


def profile_train_step(step_fn, state, batch) -> dict:
    """Device busy share of one more training step: summed kernel time
    from ``torch.profiler`` over the step's host wall time, the kernels
    that take most of it, and each flash kernel's time and launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = step_fn(state, batch)
        float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    flash = [e for e in events
             if any(n in e.key for n in ("flash", "fwd_kernel", "dq_kernel", "dkv_kernel"))]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernels": sum(e.count for e in events),
        "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top},
        "flash_kernels_ms_launches": {e.key[:60]: [dev_us(e) / 1e3, e.count] for e in flash},
    }


def phase_train() -> dict:
    """Phase 5; returns the kernel launches of the training run."""
    print(f"phase 5: train llama3_8b width, {TRAIN_LAYERS} layers, B={TRAIN_B} S={TRAIN_S}",
          flush=True)
    cfg = dataclasses.replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    task = DecoderTask(cfg, batch=TRAIN_B, seq=TRAIN_S)
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, loss):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(loss)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    state, _ = run_train_loop(
        task, TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1), 0, on_metrics=on_metrics
    )
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    p50 = sorted(step_s[1:])[len(step_s[1:]) // 2]
    train = {
        "params": sum(t.numel() for t in tree_leaves(state[0])),
        "losses": losses,
        "step_s": step_s,
        "step_p50_s_steps_1_7": p50,
        "tokens_per_s": TRAIN_B * TRAIN_S / p50,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    print("  train", json.dumps(train), flush=True)
    batch = task.make_batch(torch.Generator().manual_seed(99), TRAIN_STEPS).cuda()
    print("  train step profile",
          json.dumps(profile_train_step(task.make_step(), state, batch)), flush=True)
    per_run = TRAIN_LAYERS * TRAIN_STEPS
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"phase 5 failed: losses {losses}")
    want = {name: 0 for name in fa.LAUNCHES}  # the scalar entries, flash_fwd_scalar too: never
    want.update(flash_fwd=2 * per_run, flash_bwd_dq=per_run, flash_bwd_dkv=per_run)
    if launches != want:
        raise SystemExit(f"phase 5 failed: launches {launches} != {want}")
    return launches


def phase_grad_parity() -> None:
    print("phase 6: loss_fn gradients, flash vs plain", flush=True)
    cfg = dataclasses.replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(6), device="cuda")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    names = list(T._flatten(params))
    tokens = T.demo_batch(torch.Generator().manual_seed(6), 1, TRAIN_S, cfg.vocab).cuda()
    loss, grads = {}, {}
    for attention in ("flash", "plain"):
        out = T.loss_fn(params, tokens, dataclasses.replace(cfg, attention=attention))
        grads[attention] = torch.autograd.grad(out, leaves)
        loss[attention] = float(out.detach())
    rel = {
        n: float((f - p).float().norm() / p.float().norm())
        for n, f, p in zip(names, grads["flash"], grads["plain"])
    }
    zero = [n for n, g in zip(names, grads["flash"]) if not (torch.isfinite(g).all() and g.any())]
    print("  losses", json.dumps(loss), "relative Frobenius error by leaf", json.dumps(rel),
          "zero or non-finite flash gradients", zero, flush=True)
    if zero:
        raise SystemExit(f"phase 6 failed: no gradient reached {zero}")
    if abs(loss["flash"] - loss["plain"]) > GRAD_LOSS_REL * abs(loss["plain"]):
        raise SystemExit(f"phase 6 failed: losses {loss}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_LEAF_REL}
    if bad:
        raise SystemExit(f"phase 6 failed: gradients differ: {bad}")


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
    forward = phase_kernels(gen)

    serve_launches = phase_serve(gen)
    backward = phase_backward()
    train_launches = phase_train()
    phase_grad_parity()

    paths = {"serve": serve_launches, "train": train_launches}
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
               "bound_fraction")
    fwd_numbers = (*numbers, "device_ms", "device_bound_fraction", "library_device_ms")
    kernels = []
    fwd_main = fa.fwd_entry(torch.bfloat16, 128)
    for entry in (fwd_main, fa.fwd_entry(torch.float32, 128)):
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": f"gpushare_device_plugin_tpu_torch/ops/csrc/{fa._SOURCE[entry]}.cu",
            "replaces": "gpushare_device_plugin_tpu/ops/flash_attention.py:96",
            "launches": serve_launches[entry],
            "launches_by_path": {k: v[entry] for k, v in paths.items()},
            "on_main_path": entry == fwd_main,
            "shape": "served: bf16 B=1 S=512 H=32 Hkv=8 D=128 causal kv_len",
            **{k: forward[(entry, "served")][k] for k in fwd_numbers},
            "at_training_shape": {
                "shape": f"bf16 B={TRAIN_B} S={TRAIN_S} H=32 Hkv=8 D=128 causal",
                **{k: forward[(entry, "train")][k] for k in fwd_numbers},
            },
        })
    main_path = fa.bwd_entries(torch.bfloat16, 128)
    for entry in (*main_path, *fa.bwd_entries(torch.float32, 128)):
        row = backward[entry]
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": f"gpushare_device_plugin_tpu_torch/ops/csrc/{fa._SOURCE[entry]}.cu",
            "replaces": "gpushare_device_plugin_tpu/ops/flash_attention.py:"
                        + ("251" if entry in DQ_ENTRIES else "309"),
            "launches": train_launches[entry],
            "launches_by_path": {k: v[entry] for k, v in paths.items()},
            "on_main_path": entry in main_path,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "tflops", "bound_fraction")},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
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
