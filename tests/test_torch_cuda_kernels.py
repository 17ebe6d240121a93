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
