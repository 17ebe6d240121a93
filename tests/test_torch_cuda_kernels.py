"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``. Without a
card every test skips. Tolerances: forward f32 1e-5 (the same f32 sums in
another order); forward bf16 two roundings of an 8-bit mantissa,
2^-7 * max(|plain|, 1). Backward f32 1e-4 of the tensor's largest
magnitude (the same f32 sums in another order, over up to g*S terms);
backward bf16 one rounding of the output, 2^-7 * |plain|, plus 2^-8 of the
tensor's largest magnitude for the P and dS values that round the other
way at slightly different f32 scores.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.workloads import transformer as T


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def bwd_close(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        tol = 1e-4 * max(top, 1.0)
    else:
        tol = 2.0 ** -7 * want.abs() + 2.0 ** -8 * top
    return bool(((got - want).abs() <= tol).all()) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 300, 8, 128, generator=gen, device="cuda").to(dt)
    kv = torch.randn(2, 300, 2, 2, 128, generator=gen, device="cuda").to(dt)
    start = torch.tensor([0, 70], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([300, 130], dtype=torch.int32, device="cuda")
    entry = fa.fwd_entry(dt, 128)  # bf16: the tensor-core entry; f32: the scalar one
    before = fa.LAUNCHES[entry]
    o, lse = fa.flash_fwd(q, kv[:, :, 0], kv[:, :, 1], start=start, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[entry] == before + 1
    po, plse = fa.flash_fwd_plain(
        q, kv[:, :, 0], kv[:, :, 1], causal=True, scale=128 ** -0.5, start=start, kv_len=kv_len
    )
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7 * po.float().abs().clamp(min=1)
    assert ((o.float() - po.float()).abs() <= tol).all()
    assert torch.equal(torch.isneginf(lse), torch.isneginf(plse))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_plain_on_card(dtype, causal):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 300, 8, 128, generator=gen, device="cuda").to(dt)
    kv = torch.randn(2, 300, 2, 2, 128, generator=gen, device="cuda").to(dt)
    do = torch.randn(2, 300, 8, 128, generator=gen, device="cuda").to(dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    # Row 1: keys before 70 and from 130 on are pad; its queries < 70 see nothing.
    start = torch.tensor([0, 70], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([300, 130], dtype=torch.int32, device="cuda")
    bounds = dict(causal=causal, start=start, kv_len=kv_len)
    o, lse = fa.flash_fwd(q, k, v, **bounds)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fa.LAUNCHES)
    got = fa.flash_bwd(q, k, v, do, lse, delta, **bounds)
    torch.cuda.synchronize()
    # bf16 at D = 128 takes the tensor-core entries, f32 the scalar ones.
    want_entries = {
        torch.bfloat16: ("flash_bwd_dq", "flash_bwd_dkv"),
        torch.float32: ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar"),
    }[dt]
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {
        e: 1 for e in want_entries
    }
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=128 ** -0.5, **bounds)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == dt, name
        assert bwd_close(g, w, dt), (name, float((g.float() - w.float()).abs().max()))
    dq, dk, dv = got
    if causal:
        assert not dq[1, :70].any()  # dead rows
    assert not dk[1, :70].any() and not dv[1, 130:].any()  # keys no query sees


@pytest.mark.cuda
def test_decoder_backward_on_card_reaches_every_weight():
    """loss.backward() through ``transformer.forward`` with the flash
    kernels: attention stays in the graph, so ``wq`` (which feeds only
    attention) gets a gradient, and each layer launches each backward
    kernel once (twice the forward under full remat)."""
    _card()
    cfg = T.TransformerConfig(
        vocab=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
        attention="flash",
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = T.init_train_state(cfg, gen)
    tokens = T.demo_batch(torch.Generator().manual_seed(1), 2, 128, cfg.vocab).cuda()
    before = dict(fa.LAUNCHES)
    loss = T.loss_fn(params, tokens, cfg)
    loss.backward()
    torch.cuda.synchronize()
    grads = {name: p.grad for name, p in T._flatten(params).items()}
    assert all(g is not None and torch.isfinite(g).all() and g.any() for g in grads.values())
    assert grads["layers__wq"].abs().sum() > 0
    assert fa.LAUNCHES["flash_bwd_dq"] - before["flash_bwd_dq"] == cfg.n_layers
    assert fa.LAUNCHES["flash_bwd_dkv"] - before["flash_bwd_dkv"] == cfg.n_layers
    assert fa.LAUNCHES["flash_fwd"] - before["flash_fwd"] == 2 * cfg.n_layers
    plain = T.loss_fn(params, tokens, dataclasses.replace(cfg, attention="plain"))
    plain, loss = float(plain.detach()), float(loss.detach())
    assert abs(plain - loss) <= 2.0 ** -7 * abs(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [300, 2048])
@pytest.mark.parametrize("D", [64, 128])
def test_tensor_core_backward_matches_plain_on_card(D, S, causal, groups):
    """The bf16 wgmma entries against ``flash_bwd_plain`` with a ragged
    edge (S = 300) and at full length, GQA groups 1 and 4, and both masks:
    row 1 has keys before 70 (left pad) and from S - 170 on (right pad).
    Dead rows' dq and unseen keys' dk/dv are exactly zero, and two calls
    give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(D + S + groups + causal)
    B, Hkv = 2, 2
    H = Hkv * groups
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(B, S, 2, Hkv, D, generator=gen, device="cuda").bfloat16()
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    start = torch.tensor([0, 70], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([S, S - 170], dtype=torch.int32, device="cuda")
    bounds = dict(causal=causal, start=start, kv_len=kv_len)
    o, lse = fa.flash_fwd(q, k, v, **bounds)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fa.LAUNCHES)
    got = fa.flash_bwd(q, k, v, do, lse, delta, **bounds)
    again = fa.flash_bwd(q, k, v, do, lse, delta, **bounds)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {
        "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
    }
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=D ** -0.5, **bounds)
    for g, w, a, name in zip(got, want, again, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert bwd_close(g, w, torch.bfloat16), (name, float((g.float() - w.float()).abs().max()))
        assert torch.equal(g, a), name  # no atomics: the same bits every run
    dq, dk, dv = got
    if causal:
        assert not dq[1, :70].any()  # dead rows
    assert not dk[1, :70].any() and not dv[1, :70].any()  # keys no query sees
    assert not dk[1, S - 170:].any() and not dv[1, S - 170:].any()


@pytest.mark.cuda
def test_backward_entries_refuse_what_they_do_not_take():
    """The tensor-core entries raise, and do not fall back, on inputs they
    do not take; f32 goes to the scalar entries."""
    _card()
    q = torch.randn(1, 64, 2, 128, device="cuda").bfloat16()
    lse = torch.zeros(1, 64, 2, device="cuda")
    with pytest.raises(ValueError, match="bf16 with D"):
        fa._launch_bwd("flash_bwd_dq", q.float(), q.float(), q.float(), q.float(), lse, lse,
                       causal=True, scale=1.0, start=None, kv_len=None)
    odd = torch.randn(1, 64, 2, 129, device="cuda").bfloat16()[..., 1:]  # rows off 16 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch_bwd("flash_bwd_dkv", odd, odd, odd, odd, lse, lse,
                       causal=True, scale=1.0, start=None, kv_len=None)
    before = dict(fa.LAUNCHES)
    fa.flash_bwd(q.float(), q.float(), q.float(), q.float(), lse, lse)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {
        "flash_bwd_dq_scalar": 1, "flash_bwd_dkv_scalar": 1,
    }


@pytest.mark.cuda
def test_tensor_core_backward_ignores_strides_of_size_one_dims():
    """A batch of one whose batch dim has stride 1 (as a permuted view
    gives it) reaches the tensor-core entries: that stride is never used."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    S, H, Hkv, D = 256, 8, 2, 128
    q = torch.randn(S, H, D, 1, generator=gen, device="cuda").bfloat16().permute(3, 0, 1, 2)
    kv = torch.randn(1, S, 2, Hkv, D, generator=gen, device="cuda").bfloat16()
    do = torch.randn(1, S, H, D, generator=gen, device="cuda").bfloat16()
    assert q.stride(0) == 1
    k, v = kv[:, :, 0], kv[:, :, 1]
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fa.LAUNCHES)
    got = fa.flash_bwd(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert bwd_close(g, w, torch.bfloat16), name


def fwd_close(o, lse, po, plse) -> bool:
    """bf16 O within two roundings of an 8-bit mantissa, 2^-7 * max(|plain|,
    1); lse within 1e-4; the same dead rows (lse = -inf, O = 0)."""
    ok = bool(((o.float() - po.float()).abs() <= 2.0 ** -7 * po.float().abs().clamp(min=1)).all())
    dead = torch.isneginf(plse)
    ok &= torch.equal(torch.isneginf(lse), dead)
    ok &= bool(((lse - plse).abs()[~dead] <= 1e-4).all())
    ok &= not o[dead].any()
    return ok and bool(torch.isfinite(o.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", ["none", "start", "kv_len"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [300, 2048])
@pytest.mark.parametrize("D", [64, 128])
def test_tensor_core_forward_matches_plain_on_card(D, S, causal, groups, bounds):
    """The bf16 wgmma forward against ``flash_fwd_plain`` with a ragged
    edge (S = 300) and at full length, GQA groups 1 and 4, with no bounds,
    a ``start`` batch (row 1's keys before 70 are pad: under causality its
    queries before 70 see nothing) and a ``kv_len`` batch (row 1's keys
    from S - 170 on are pad). Two calls give the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(D + S + groups + causal)
    B, Hkv = 2, 2
    H = Hkv * groups
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(B, S, 2, Hkv, D, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    start = torch.tensor([0, 70], dtype=torch.int32, device="cuda") if bounds == "start" else None
    kv_len = (torch.tensor([S, S - 170], dtype=torch.int32, device="cuda")
              if bounds == "kv_len" else None)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, start=start, kv_len=kv_len)
    o2, lse2 = fa.flash_fwd(q, k, v, causal=causal, start=start, kv_len=kv_len)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {"flash_fwd": 2}
    po, plse = fa.flash_fwd_plain(q, k, v, causal=causal, scale=D ** -0.5, start=start,
                                  kv_len=kv_len)
    assert o.shape == po.shape and o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert fwd_close(o, lse, po, plse), float((o.float() - po.float()).abs().max())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # no atomics: the same bits
    if bounds == "start" and causal:
        assert torch.isneginf(lse[1, :70]).all() and not o[1, :70].any()  # dead rows


@pytest.mark.cuda
def test_tensor_core_forward_ignores_strides_of_size_one_dims():
    """A batch of one whose batch dim has stride 1 (as a permuted view
    gives it), the served shape's case, reaches the tensor-core entry."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    S, H, Hkv, D = 512, 8, 2, 128
    q = torch.randn(S, H, D, 1, generator=gen, device="cuda").bfloat16().permute(3, 0, 1, 2)
    kv = torch.randn(1, S, 2, Hkv, D, generator=gen, device="cuda").bfloat16()
    assert q.stride(0) == 1
    k, v = kv[:, :, 0], kv[:, :, 1]
    kv_len = torch.tensor([S], dtype=torch.int32, device="cuda")
    before = fa.LAUNCHES["flash_fwd"]
    o, lse = fa.flash_fwd(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=D ** -0.5, kv_len=kv_len)
    assert fwd_close(o, lse, po, plse)


@pytest.mark.cuda
def test_tensor_core_forward_refuses_misaligned_rows():
    """bf16 at D = 128 with rows off 16 bytes raises, and launches neither
    forward entry: nothing drops to the scalar kernel."""
    _card()
    odd = torch.randn(1, 64, 2, 129, device="cuda").bfloat16()[..., 1:]
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(odd, odd, odd)
    with pytest.raises(ValueError, match="bf16 with D"):
        fa._launch_fwd("flash_fwd", odd.float(), odd.float(), odd.float(), causal=True,
                       scale=1.0, start=None, kv_len=None)
    assert fa.LAUNCHES == before


def _paged_model():
    """A small bf16 decoder with head dim 128 (the tensor-core forward's),
    its weights on the card and a CPU copy."""
    cfg = T.TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              d_ff=512, max_seq=128, compute_dtype=torch.bfloat16)
    params = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu",
                           dtype=torch.bfloat16)
    on_card = {
        key: ({k: v.cuda() for k, v in val.items()} if isinstance(val, dict) else val.cuda())
        for key, val in params.items()
    }
    return cfg, params, on_card


def _close_bf16(got, want, what):
    """bf16 on the card against bf16 on the CPU (other summation orders and
    GEMM algorithms, through 2 layers): within 2^-5 of the tensor's
    largest magnitude."""
    got, want = got.float().cpu(), want.float()
    tol = 2.0 ** -5 * max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol, what


@pytest.mark.cuda
def test_paged_primitives_on_card_match_cpu():
    """paged_prefill_slot (through flash_fwd), paged_extend_slot over a
    shared prefix page, and paged_decode_step with an idle row at
    ``len == row_span`` on an all-scratch table, on the card against the
    same calls on the CPU: logits of the rows that read real pages, and
    every page but the scratch page."""
    _card()
    from gpushare_device_plugin_tpu_torch.workloads import generate as G

    cfg, cpu_params, card_params = _paged_model()
    ps, C, mp = 8, 16, 4
    caches = {d: G.init_paged_cache(cfg, 3, 11, ps, device=d) for d in ("cpu", "cuda")}
    params = {"cpu": cpu_params, "cuda": card_params}
    toks = torch.randint(0, cfg.vocab, (3, C), generator=torch.Generator().manual_seed(6))
    tables = torch.tensor([[7, 2, 0, 0], [7, 2, 9, 4], [0, 0, 0, 0]], dtype=torch.int32)
    logits = {}
    before = fa.LAUNCHES["flash_fwd"]
    for d in ("cpu", "cuda"):
        c = caches[d]
        lp, c = G.paged_prefill_slot(params[d], toks[0].to(d), c, cfg, slot=0,
                                     page_table=tables[0].to(d), n_real=C)
        le, c = G.paged_extend_slot(params[d], toks[1].to(d), c, cfg, slot=1,
                                    page_table=tables[1].to(d), pos=C, n_real=11)
        c = {**c, "len": torch.tensor([C, 27, mp * ps], dtype=torch.int32, device=d)}
        dec_tables = tables.clone()
        dec_tables[0, 2] = 5
        ld, c = G.paged_decode_step(params[d], toks[2, :3].to(d), c, cfg,
                                    page_tables=dec_tables.to(d))
        logits[d], caches[d] = (lp, le, ld[:2]), c
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] - before == cfg.n_layers  # one prefill, each layer
    for got, want, what in zip(logits["cuda"], logits["cpu"], ("prefill", "extend", "decode")):
        _close_bf16(got, want, what)
    assert caches["cuda"]["len"].tolist() == caches["cpu"]["len"].tolist() == [C + 1, 28, mp * ps + 1]
    for key in ("k", "v"):
        _close_bf16(caches["cuda"][key][:, 1:], caches["cpu"][key][:, 1:], key)


@pytest.mark.cuda
def test_tiny_paged_engine_prefills_through_flash_fwd_on_card():
    """A small bf16 PagedSlotEngine on the card: every prefill dispatch
    launches flash_fwd once per layer (never the scalar entry), the shape
    guard stays at one shape per program, radix hits happen, and no page
    leaks."""
    _card()
    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, shared_prefix_trace

    cfg, _, params = _paged_model()
    eng = PagedSlotEngine(params, cfg, slots=3, max_len=96, total_pages=40, page_size=8,
                          prefill_chunk=16, eos_id=None)
    eng.warmup()
    prefills = []
    program = eng._prefill
    eng._prefill = lambda *a: (prefills.append(1), program(*a))[1]
    reqs = shared_prefix_trace(8, seed=1, rate=0.5, vocab=cfg.vocab, prefixes=(2, 32),
                               tail_lens=(4, 30), max_new=(4, 12))
    before = dict(fa.LAUNCHES)
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
    assert len(stats.results) == len(reqs)
    assert all(len(r.tokens) == q.max_new for r, q in zip(stats.results, reqs))
    assert launched["flash_fwd"] == cfg.n_layers * len(prefills) > 0
    assert launched["flash_fwd_scalar"] == 0
    assert stats.trace_counts == {"prefill": 1, "extend": 1, "decode": 1}
    assert stats.engine_cache["prefix_hit_requests"] > 0
    assert eng.allocator.used_pages == eng.radix.cached_pages
    # bf16 pages leave as f32 blobs and come back the same bits
    pages = eng.radix.pages()
    blobs = eng.export_kv_pages(pages)
    assert blobs[0]["k"].dtype == np.float32
    targets = eng.allocator.alloc(len(pages))
    eng.import_kv_pages(targets, blobs)
    assert torch.equal(eng.cache["k"][:, targets], eng.cache["k"][:, pages])
    assert torch.equal(eng.cache["v"][:, targets], eng.cache["v"][:, pages])


def _bert_qkv(gen, B, S, H, D):
    """q, k, v as strided views of one [B, S, 3, H, D] tensor, the layout
    BERT's fused projection hands the kernels."""
    qkv = torch.randn(B, S, 3, H, D, generator=gen, device="cuda").bfloat16()
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [300, 512])
def test_noncausal_bert_shape_entries_match_plain_on_card(S):
    """BERT-base's attention (H = Hkv = 12, D = 64, non-causal, no bounds)
    through the tensor-core forward and backward entries against their
    plain versions, each run twice for the same bits."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    q, k, v = _bert_qkv(gen, 4, S, 12, 64)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal=False)
    o2, lse2 = fa.flash_fwd(q, k, v, causal=False)
    delta = (do.float() * o.float()).sum(-1)
    got = fa.flash_bwd(q, k, v, do, lse, delta, causal=False)
    again = fa.flash_bwd(q, k, v, do, lse, delta, causal=False)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {
        "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
    }
    po, plse = fa.flash_fwd_plain(q, k, v, causal=False, scale=0.125)
    assert ((o.float() - po.float()).abs() <= 2.0 ** -7 * po.float().abs().clamp(min=1)).all()
    assert ((lse - plse).abs() <= 1e-4).all()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=False, scale=0.125)
    for g, w, a, name in zip(got, want, again, ("dq", "dk", "dv")):
        assert bwd_close(g, w, torch.bfloat16), (name, float((g.float() - w.float()).abs().max()))
        assert torch.equal(g, a), name


@pytest.mark.cuda
def test_bert_base_auto_attention_takes_the_tensor_core_kernels_on_card():
    """BERT-base's width at two layers, bf16 over f32 params, remat on,
    attention "auto": one loss_fn backward launches the tensor-core
    forward twice per layer (forward and recompute) and each backward
    entry once per layer; the scalar entries never."""
    _card()
    from gpushare_device_plugin_tpu_torch.workloads import bert as B
    from gpushare_device_plugin_tpu_torch.workloads.attention import use_flash

    cfg = dataclasses.replace(B.bert_base(), n_layers=2)
    params, _ = B.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = [t.cuda() for t in B.demo_batch(torch.Generator().manual_seed(1), 4, 512, cfg)]
    assert use_flash("auto", torch.empty(4, 512, 12, 64, device="cuda", dtype=torch.bfloat16))
    before = dict(fa.LAUNCHES)
    loss = B.loss_fn(params, *batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.LAUNCHES.items() if c != before[n]} == {
        "flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
    }
    assert torch.isfinite(loss) and params["layers"]["wqkv"].grad.abs().sum() > 0


@pytest.mark.cuda
def test_pod_over_its_memory_fraction_ooms_itself_on_card():
    """A child process given a 1-unit slice by the plugin's env caps
    itself with configure_torch_from_env(): half a GiB fits, 2 GiB raises
    torch.cuda.OutOfMemoryError in the child."""
    _card()
    import os
    import subprocess
    import sys
    from pathlib import Path

    whole = torch.cuda.get_device_properties(0).total_memory >> 30
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(TPU_VISIBLE_CHIPS="0", ALIYUN_COM_TPU_MEM_IDX="0",
               ALIYUN_COM_TPU_MEM_CONTAINER="1", ALIYUN_COM_TPU_MEM_DEV=str(whole))
    code = (
        "import torch\n"
        "from gpushare_device_plugin_tpu_torch.parallel.podenv import configure_torch_from_env\n"
        "print(configure_torch_from_env())\n"
        "small = torch.empty(1 << 29, dtype=torch.uint8, device='cuda')\n"
        "try:\n"
        "    torch.empty(2 << 30, dtype=torch.uint8, device='cuda')\n"
        "except torch.cuda.OutOfMemoryError:\n"
        "    print('OOM-RAISED')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OOM-RAISED" in out.stdout, out.stdout


def _card_lora_store(cfg, lcfg, tenants, device):
    """Seeded adapters with every leaf random (``b`` too), so each
    tenant's tokens leave the base model's."""
    from gpushare_device_plugin_tpu_torch.workloads import lora as L

    gen = torch.Generator().manual_seed(7)
    store = {}
    for aid in tenants:
        lora = L.init_lora(cfg, lcfg, gen, device="cpu")
        for ab in lora.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.5
            ab["a"] = ab["a"] * 4.0
        store[aid] = {n: {k: v.to(device) for k, v in ab.items()} for n, ab in lora.items()}
    return store


@pytest.mark.cuda
def test_mixed_tenant_engine_on_card_matches_merged_solo():
    """A multi-LoRA PagedSlotEngine on the card, f32 (TF32 off), every
    LoRA target: a batch that mixes three tenants and base rows serves
    each request the tokens of merge_lora + solo greedy generate on the
    card, every prefill dispatch launches the forward kernel once per
    layer, the shape guard holds, and the pool ends with every page held
    by the radix cache or a resident adapter."""
    _card()
    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, shared_prefix_trace
    from gpushare_device_plugin_tpu_torch.workloads import generate as G
    from gpushare_device_plugin_tpu_torch.workloads import lora as L

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = T.TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                                  d_ff=512, max_seq=128, compute_dtype=torch.float32)
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), device="cuda")
        lcfg = L.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wkv", "wo", "wi", "wdown"))
        store = _card_lora_store(cfg, lcfg, ("t0", "t1", "t2"), "cuda")
        eng = PagedSlotEngine(params, cfg, slots=3, max_len=96, total_pages=160, page_size=8,
                              prefill_chunk=16, eos_id=None, lora_store=store, lora_cfg=lcfg)
        eng.warmup()
        prefills = []
        program = eng._prefill
        eng._prefill = lambda *a: (prefills.append(1), program(*a))[1]
        reqs = shared_prefix_trace(8, seed=1, rate=0.5, vocab=cfg.vocab, prefixes=(2, 32),
                                   tail_lens=(4, 30), max_new=(4, 12),
                                   adapters=["t0", "t1", "t2", ""])
        before = dict(fa.LAUNCHES)
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
        entry = fa.fwd_entry(torch.float32, cfg.head_dim)
        assert launched[entry] == cfg.n_layers * len(prefills) > 0
        for req, res in zip(reqs, stats.results):
            merged = L.merge_lora(params, store[req.adapter_id], lcfg) if req.adapter_id else params
            solo = G.generate(merged, [list(req.prompt)], cfg, max_new=req.max_new)
            assert res.tokens == solo[0, len(req.prompt):].tolist(), (req.rid, req.adapter_id)
        assert stats.trace_counts == {"prefill": 1, "extend": 1, "decode": 1}
        assert stats.engine_cache["adapters"]["misses"] >= 3
        assert eng.allocator.used_pages == eng.radix.cached_pages + eng.adapters.cached_pages
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_lora_train_step_on_card_launches_the_tensor_core_kernels():
    """LoRA fine-tuning on the card, bf16 base, head dim 128: one
    ``lora_loss_fn`` backward gives every adapter leaf a nonzero gradient
    and none to the base; one ``make_lora_train_step`` step launches
    ``flash_fwd`` twice per layer (forward and recompute) and each
    tensor-core backward kernel once per layer, the scalar entries never,
    and leaves the base bitwise unchanged."""
    _card()
    from gpushare_device_plugin_tpu_torch.workloads import lora as L
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    cfg = T.TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                              d_ff=512, max_seq=256)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = T.init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    lcfg = L.LoraConfig()
    lora = L.init_lora(cfg, lcfg, gen, device="cuda")
    for ab in lora.values():  # b off zero, so a's gradient is not zero either
        ab["b"].normal_(0.0, 0.01, generator=gen)
    leaves = [t.requires_grad_() for t in tree_leaves(lora)]
    tokens = T.demo_batch(torch.Generator().manual_seed(1), 2, 128, cfg.vocab).cuda()
    grads = torch.autograd.grad(L.lora_loss_fn(lora, params, tokens, cfg, lcfg), leaves)
    assert all(torch.isfinite(g).all() and g.any() for g in grads)
    base = {k: v.clone() for k, v in T._flatten(params).items()}
    step, init_opt = L.make_lora_train_step(cfg, lcfg)
    opt_state = init_opt(lora)
    before = dict(fa.LAUNCHES)
    lora, opt_state, loss = step(params, lora, opt_state, tokens)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
    want = {n: 0 for n in fa.LAUNCHES}
    want.update(flash_fwd=2 * cfg.n_layers, flash_bwd_dq=cfg.n_layers, flash_bwd_dkv=cfg.n_layers)
    assert launched == want and torch.isfinite(loss)
    assert all(torch.equal(base[k], v) for k, v in T._flatten(params).items())


@pytest.mark.cuda
def test_tiny_spec_engine_on_card_matches_its_cpu_tokens():
    """A small speculative PagedSlotEngine, f32 (TF32 off), a target at head
    dim 128 and a draft at head dim 64: on the card it serves the tokens
    the same engine serves on the CPU, each prefill dispatch launches the
    forward kernel once per target and draft layer, the shape guard holds
    five programs, and every lookahead page comes back."""
    _card()
    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, shared_prefix_trace

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = T.TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                                  d_ff=512, max_seq=128, compute_dtype=torch.float32)
        dcfg = T.TransformerConfig(vocab=256, d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                                   d_ff=256, max_seq=128, compute_dtype=torch.float32)
        weights = {name: T.init_params(c, torch.Generator().manual_seed(seed), device="cpu")
                   for name, c, seed in (("target", cfg, 5), ("draft", dcfg, 6))}
        reqs = shared_prefix_trace(8, seed=1, rate=0.5, vocab=cfg.vocab, prefixes=(2, 32),
                                   tail_lens=(4, 30), max_new=(4, 12))
        tokens = {}
        for device in ("cpu", "cuda"):
            p = {name: {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
                            else v.to(device)) for k, v in w.items()}
                 for name, w in weights.items()}
            eng = PagedSlotEngine(p["target"], cfg, slots=3, max_len=96, total_pages=40,
                                  page_size=8, prefill_chunk=16, eos_id=None,
                                  draft_params=p["draft"], draft_cfg=dcfg, spec_k=3,
                                  device=device)
            eng.warmup()
            prefills = []
            program = eng._prefill
            eng._prefill = lambda *a, _p=program: (prefills.append(1), _p(*a))[1]
            before = dict(fa.LAUNCHES)
            stats = eng.run(reqs)
            tokens[device] = [r.tokens for r in stats.results]
            assert stats.trace_counts == {"prefill": 1, "extend": 1, "decode": 1, "draft": 1,
                                          "verify": 1}
            assert stats.engine_cache["speculative"]["draft_steps"] > 0
            assert eng.allocator.used_pages == eng.radix.cached_pages
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
        entry = fa.fwd_entry(torch.float32, cfg.head_dim)
        assert launched[entry] == (cfg.n_layers + dcfg.n_layers) * len(prefills) > 0
        assert tokens["cuda"] == tokens["cpu"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_bf16_page_wire_round_trip_on_card():
    """A bf16 engine's pages, fetched to the host in bf16, cross the
    handoff's wire at 2 bytes an element under the dtype name "bfloat16"
    and write back into other pages of the card's pool bit for bit."""
    _card()
    import json

    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, shared_prefix_trace
    from gpushare_device_plugin_tpu_torch.serving.handoff import decode_page, encode_page

    cfg, _, params = _paged_model()
    eng = PagedSlotEngine(params, cfg, slots=3, max_len=96, total_pages=40, page_size=8,
                          prefill_chunk=16, eos_id=None)
    eng.run(shared_prefix_trace(6, seed=2, rate=0.5, vocab=cfg.vocab, prefixes=(2, 32),
                                tail_lens=(4, 30), max_new=(4, 8)))
    pages = eng.radix.pages()
    assert pages
    host = eng.fetch_kv_pages(pages)
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in host[0].values())
    wires = [encode_page(p) for p in host]
    hlen = int.from_bytes(wires[0][:4], "little")
    head = json.loads(wires[0][4:4 + hlen])
    assert [e[1] for e in head] == ["bfloat16", "bfloat16"]
    numel = sum(int(np.prod(e[2])) for e in head)
    assert len(wires[0]) == 4 + hlen + 2 * numel
    targets = eng.allocator.alloc(len(pages))
    eng.import_kv_pages(targets, [decode_page(w) for w in wires])
    torch.cuda.synchronize()
    for key in ("k", "v"):
        assert torch.equal(eng.cache[key][:, targets], eng.cache[key][:, pages])


@pytest.mark.cuda
def test_disagg_handoff_imports_into_a_card_engine():
    """DisaggServer over two card engines, f32 (TF32 off): every request's
    pages cross the wire into the decode tier's pool and decode there; the
    tokens equal a unified card engine's with the decode tier's slots, the
    prefill tier launches the forward kernel once per layer per prefill
    dispatch, and every page comes back."""
    _card()
    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, poisson_trace
    from gpushare_device_plugin_tpu_torch.serving.handoff import DisaggServer

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = T.TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                                  d_ff=512, max_seq=128, compute_dtype=torch.float32)
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
        geo = dict(max_len=96, page_size=8, prefill_chunk=16, eos_id=None)
        reqs = poisson_trace(8, seed=4, rate=0.5, vocab=cfg.vocab, prompt_lens=(8, 60),
                             max_new=(4, 12))
        unified = PagedSlotEngine(params, cfg, slots=4, total_pages=48, **geo)
        want = {r.rid: r.tokens for r in unified.run(reqs).results}
        # the decode pool stages every handoff of the prefill run at once
        ds = DisaggServer(PagedSlotEngine(params, cfg, slots=2, total_pages=24, **geo),
                          PagedSlotEngine(params, cfg, slots=4, total_pages=64, **geo))
        ds.warmup()
        prefills = []
        program = ds.prefill._prefill
        ds.prefill._prefill = lambda *a: (prefills.append(1), program(*a))[1]
        before = dict(fa.LAUNCHES)
        out = ds.serve(reqs)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
        assert out["dropped"] == [] and ds.outcomes == {"delivered": len(reqs)}
        assert {e["path"] for e in out["results"].values()} == {"handoff"}
        assert {rid: e["tokens"] for rid, e in out["results"].items()} == want
        entry = fa.fwd_entry(torch.float32, cfg.head_dim)
        assert launched[entry] == cfg.n_layers * len(prefills) > 0
        assert ds.wire["pages"] > 0 and ds.ledger.pages_in_flight == 0
        for eng in (ds.prefill, ds.decode):
            assert eng.allocator.used_pages == eng.radix.cached_pages
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _solo_with_gaps(params, cfg, prompt, max_new):
    """Solo greedy decode on the card, with the top-two logit gap and the
    top logit's magnitude at every step."""
    from gpushare_device_plugin_tpu_torch.workloads import generate as G

    p = torch.tensor([prompt], dtype=torch.long, device="cuda")
    cache = G.init_cache(cfg, 1, len(prompt) + max_new)
    logits, cache = G.prefill(params, p, cache, cfg)
    toks, gaps = [], []
    for step in range(max_new):
        top2 = torch.topk(logits[0].float(), 2).values
        gaps.append((float(top2[0] - top2[1]), float(top2[0].abs())))
        tok = torch.argmax(logits, -1)
        toks.append(int(tok))
        if step + 1 < max_new:
            logits, cache = G.decode_step(params, tok, cache, cfg)
    return toks, gaps


@pytest.mark.cuda
def test_bf16_fleet_scale_down_on_card_keeps_the_unified_tokens():
    """Two bf16 card engines behind ``FleetServer``, e0 scaled down mid-trace
    through the journaled protocol: nothing dropped or served twice, a
    request migrated, the journal resolved, every prefill dispatch on the
    tensor-core forward, and each request's tokens a unified engine's or,
    where they differ, a solo decode's up to a near tie (the first differing
    step's solo top-two gap at most 2^-6 of the top logit: another batch
    shape takes other GEMM algorithms in bf16)."""
    _card()
    import tempfile

    from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
    from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
    from gpushare_device_plugin_tpu_torch.serving import FleetServer
    from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine, shared_prefix_trace

    cfg, _, params = _paged_model()
    geo = dict(max_len=96, page_size=8, prefill_chunk=16, eos_id=None)
    reqs = shared_prefix_trace(10, seed=2, rate=0.5, vocab=cfg.vocab, prefixes=(2, 32),
                               tail_lens=(4, 30), max_new=[4, 8, 12])
    unified = PagedSlotEngine(params, cfg, slots=6, total_pages=72, **geo)
    want = {r.rid: r.tokens for r in unified.run(reqs).results}
    engines = {f"e{i}": PagedSlotEngine(params, cfg, slots=3, total_pages=36, **geo)
               for i in range(2)}
    prefills = []
    for eng in engines.values():
        eng.warmup()
        program = eng._prefill
        eng._prefill = lambda *a, _p=program: (prefills.append(1), _p(*a))[1]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = AllocationCheckpoint(f"{tmp}/scale.wal")
        fleet = FleetServer(engines, checkpoint=ckpt, assume=AssumeCache())
        before = dict(fa.LAUNCHES)
        out = fleet.serve(reqs, scale_down=("e0", 6))
        torch.cuda.synchronize()
        assert ckpt.pending() == {}
        ckpt.close()
    launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()}
    assert out["dropped"] == [] and out["double_served"] == []
    assert fleet.executor.completed_ops == 1 and fleet.executor.migrated_requests >= 1
    assert "migrated" in {e["path"] for e in out["results"].values()}
    assert launched["flash_fwd"] == cfg.n_layers * len(prefills) > 0
    assert launched["flash_fwd_scalar"] == 0
    for eng in engines.values():
        assert eng.trace_counts == {"prefill": 1, "extend": 1, "decode": 1}
        assert eng.allocator.used_pages == eng.radix.cached_pages
    for r in reqs:
        got = out["results"][r.rid]["tokens"]
        if got == want[r.rid]:
            continue
        solo, gaps = _solo_with_gaps(params, cfg, list(r.prompt), r.max_new)
        j = next((i for i, (a, b) in enumerate(zip(got, solo)) if a != b), None)
        if j is None:
            assert len(got) == len(solo)
        else:
            gap, top = gaps[j]
            assert gap <= 2.0 ** -6 * top, (r.rid, j, gap, top)


RING_RANK = """
import datetime, sys, torch, torch.distributed as dist
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from gpushare_device_plugin_tpu_torch.parallel.ring import ring_attention

rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_mesh(MeshSpec(sp=2), backend="gloo")
gen = torch.Generator(device="cuda").manual_seed(12)
S, T = 2048, 1024
q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((1, S, 32, 128), (1, S, 8, 128), (1, S, 8, 128), (1, S, 32, 128)))
full = [t.clone().requires_grad_() for t in (q, k, v)]
want_o = fa.flash_attention(*full, causal=True)
want = [want_o, *torch.autograd.grad(want_o, full, do)]
mine = [t[:, rank * T:(rank + 1) * T].clone().requires_grad_() for t in (q, k, v)]
before = dict(fa.LAUNCHES)
o = ring_attention(*mine, mesh, causal=True, hop_attention="auto")
got = [o, *torch.autograd.grad(o, mine, do[:, rank * T:(rank + 1) * T])]
torch.cuda.synchronize()
assert fa.LAUNCHES["flash_fwd"] - before["flash_fwd"] == rank + 1, fa.LAUNCHES
assert fa.LAUNCHES["flash_bwd_dq"] - before["flash_bwd_dq"] == rank + 1, fa.LAUNCHES
assert mesh.traffic["shift"].calls == 2
w = [t[:, rank * T:(rank + 1) * T].float() for t in want]
assert ((got[0].float() - w[0]).abs() <= 2.0 ** -7 * w[0].abs().clamp(min=1)).all()
for g, x in zip(got[1:], w[1:]):
    tol = 2.0 ** -7 * x.abs() + 2.0 ** -8 * x.abs().max()
    assert ((g.float() - x).abs() <= tol).all(), float((g.float() - x).abs().max())
print("RING-OK", rank, flush=True)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_two_rank_gloo_ring_on_card_matches_one_flash_attention(tmp_path):
    """Two gloo ranks share the card (each exchange staged through host
    memory): the causal ring with "auto" hops launches the flash kernels
    (rank i: i+1 forward and i+1 of each backward kernel) and its O, dQ,
    dK and dV shards match one flash_attention over the whole sequence
    by the kernel tolerances above."""
    _card()
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", RING_RANK, str(tmp_path / "rdv"), str(r)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RING-OK {r}" in out, out[-3000:]


TP_RANK = """
import datetime, sys, torch, torch.distributed as dist
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

rank, tp = int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}", world_size=tp, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_mesh(MeshSpec(tp=tp), backend="gloo")
cfg = T.TransformerConfig(vocab=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=1024, max_seq=512)
whole = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), dtype=torch.bfloat16)
tokens = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(6))
tokens = tokens.cuda()
with torch.no_grad():
    want = T.forward(whole, tokens, cfg)
    shards = T.shard_params(whole, mesh, cfg)
    before = fa.LAUNCHES["flash_fwd"]
    got = T.gather_logits(T.forward(shards, tokens, cfg, mesh), cfg, mesh)
torch.cuda.synchronize()
assert fa.LAUNCHES["flash_fwd"] - before == cfg.n_layers, fa.LAUNCHES
kv_local = cfg.kv_heads // tp if cfg.kv_heads % tp == 0 else cfg.kv_heads
assert shards["layers"]["wq"].shape[2] == cfg.n_heads // tp
assert shards["layers"]["wkv"].shape[3] == kv_local
assert shards["out"].shape[1] == cfg.vocab // tp
assert mesh.traffic["tp_all_reduce"].calls == 2 * cfg.n_layers + 1
err = float((got - want).abs().max())
assert err <= 2.0 ** -5 * float(want.abs().max()), err
print("TP-OK", rank, err, flush=True)
dist.destroy_process_group()
"""


def _tp_ranks_on_card(tmp_path, tp: int) -> None:
    """Run TP_RANK as ``tp`` gloo ranks sharing the card; each must pass."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", TP_RANK, str(tmp_path / "rdv"), str(r),
                               str(tp)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(tp)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"TP-OK {r}" in out, out[-3000:]


@pytest.mark.cuda
def test_two_rank_gloo_tp_decoder_forward_on_card_matches_one_rank(tmp_path):
    """Two gloo ranks share the card as a tp=2 mesh: the decoder's forward
    on each rank's shards (two of four q heads and one of two kv heads,
    half the MLP and vocabulary) launches the bf16 flash kernel once a
    layer on its local heads, makes one tp all-reduce after each
    row-parallel projection and the embedding, and its gathered logits
    match one rank's forward on the whole weights within 2^-5 of their
    largest magnitude (the partial sums of two ranks rounded to bf16
    before their sum, through two layers)."""
    _card()
    _tp_ranks_on_card(tmp_path, 2)


@pytest.mark.cuda
def test_four_rank_gloo_tp_decoder_with_replicated_wkv_launches_flash_on_card(tmp_path):
    """tp=4 over two kv heads: tp does not divide them, so every rank holds
    the whole ``wkv`` and selects the one kv head its q head uses. "auto"
    attention still launches the flash kernel once a layer on each rank
    (one q head over one kv head), and the gathered logits match one
    rank's forward within the same 2^-5 of their largest magnitude."""
    _card()
    _tp_ranks_on_card(tmp_path, 4)


@pytest.mark.cuda
def test_nvml_and_cuda_discovery_agree_on_card():
    """The device plugin's two backends see the same cards: NVML's UUIDs are
    torch.cuda's, formatted as NVML formats them, with the same whole GiB (their byte counts differ by the driver's share) and the same
    device file wherever the CUDA backend can read the driver's minor."""
    _card()
    from gpushare_device_plugin_tpu_torch.discovery import from_name
    from gpushare_device_plugin_tpu_torch.discovery.nvmldev import NvmlBackend, pair_with_cuda

    nvml, cuda = from_name("nvml"), from_name("cuda")
    assert nvml.probe() and cuda.probe()
    assert isinstance(from_name("auto"), NvmlBackend)
    assert nvml.topology().generation == cuda.topology().generation
    nv, cu = nvml.chips(), cuda.chips()
    assert all(c.id.startswith("GPU-") and c.hbm_bytes > 0 for c in nv)
    assert all(c.id.startswith("GPU-") for c in cu)
    assert all(c.device_path.startswith("/dev/nvidia") for c in nv)
    pairs, problems = pair_with_cuda(nv, cu)
    assert problems == []
    assert len(pairs) == len(cu)  # CUDA_VISIBLE_DEVICES may hide cards from CUDA
