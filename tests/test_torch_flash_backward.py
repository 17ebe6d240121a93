"""Gradients of the port's flash attention (the autograd Function in
gpushare_device_plugin_tpu_torch/ops/flash_attention.py) against
``jax.vjp`` of the reference Pallas kernels in interpret mode.

On CPU tensors the Function's backward runs ``flash_bwd_plain``, the
backward kernels' function in plain PyTorch. Blocks of 32 over S = 64
give the reference several tiles and its causal skip. f32, atol 5e-5: the
reference's own tolerance for its kernel's gradients against its oracle
(tests/test_flash_attention.py). bf16, atol 5e-2: the reference's own
tolerance for its bf16 gradients (``test_bf16_gradients`` there); both
sides round P and dS to bf16 at the same places, so this closes the chain
kernel -> plain version (on the card) -> reference in the working dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_lse as jflash_lse,
)
from gpushare_device_plugin_tpu_torch.ops import _build
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa

ATOL = 5e-5
BF16_ATOL = 5e-2
B, S, D = 2, 64, 16


def _inputs(H, Hkv, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, h, D).astype(np.float32) for h in (H, Hkv, Hkv, H))
    dlse = rng.randn(B, S, H).astype(np.float32)
    return q, k, v, do, dlse


def _ref_grads(q, k, v, do, **kw):
    bounds = {n: jnp.asarray(b) for n, b in kw.items() if isinstance(b, np.ndarray)}
    rest = {n: b for n, b in kw.items() if not isinstance(b, np.ndarray)}

    def f(q, k, v):
        return jflash(q, k, v, block_q=32, block_k=32, interpret=True, **bounds, **rest)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = {n: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for n, b in kw.items()}
    o = fa.flash_attention(q, k, v, **kw)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _assert_grads_close(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_gradients_match_reference(causal, H, Hkv):
    q, k, v, do, _ = _inputs(H, Hkv, seed=0)
    _, want = _ref_grads(q, k, v, do, causal=causal)
    _, got = _port_grads(q, k, v, do, causal=causal)
    _assert_grads_close(got, want)


def test_start_dead_rows_have_finite_zero_gradients():
    q, k, v, do, _ = _inputs(4, 2, seed=1)
    start = np.array([0, 40], np.int32)  # row 1's queries < 40 see no key
    _, want = _ref_grads(q, k, v, do, causal=True, start=start)
    o, got = _port_grads(q, k, v, do, causal=True, start=start)
    _assert_grads_close(got, want)
    dq, dk, dv = got
    assert all(np.isfinite(g).all() for g in got)
    assert np.all(o[1, :40] == 0) and np.all(dq[1, :40] == 0)
    # Keys before start are seen by no query: their dK and dV are zero.
    assert np.all(dk[1, :40] == 0) and np.all(dv[1, :40] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_gradients_match_reference(causal):
    q, k, v, do, _ = _inputs(4, 2, seed=2)
    kv_len = np.array([64, 21], np.int32)
    _, want = _ref_grads(q, k, v, do, causal=causal, kv_len=kv_len)
    _, got = _port_grads(q, k, v, do, causal=causal, kv_len=kv_len)
    _assert_grads_close(got, want)
    assert np.all(got[1][1, 21:] == 0) and np.all(got[2][1, 21:] == 0)


def test_start_and_kv_len_window_gradients_match_reference():
    q, k, v, do, _ = _inputs(4, 2, seed=3)
    start, kv_len = np.array([5, 10], np.int32), np.array([50, 33], np.int32)
    _, want = _ref_grads(q, k, v, do, causal=True, start=start, kv_len=kv_len)
    _, got = _port_grads(q, k, v, do, causal=True, start=start, kv_len=kv_len)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_pair_gradients_with_lse_cotangent_match_reference(causal):
    q, k, v, do, dlse = _inputs(4, 2, seed=4)

    def f(q, k, v):
        return jflash_lse(q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    torch.autograd.backward((o, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    _assert_grads_close([t.grad.numpy() for t in (tq, tk, tv)], want)

    # lse alone (no dO): its gradient is the dlse-only cotangent.
    _, vjp_lse = jax.vjp(lambda *a: f(*a)[1], *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp_lse(jnp.asarray(dlse))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention_lse(tq, tk, tv, causal=causal)[1].backward(torch.from_numpy(dlse))
    _assert_grads_close([t.grad.numpy() for t in (tq, tk, tv)], want)


def test_cpu_backward_takes_the_plain_version_without_the_kernels(monkeypatch):
    def no_kernel(name):
        raise AssertionError("the kernel loader must not run for CPU tensors")

    monkeypatch.setattr(_build, "load", no_kernel)
    before = dict(fa.LAUNCHES)
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(4, 2, seed=5))
    q.requires_grad_()
    o = fa.flash_attention(q, k, v)
    assert o.grad_fn is not None
    o.backward(do)
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert fa.LAUNCHES == before
    # Without grad, the output carries no graph.
    assert fa.flash_attention(q.detach(), k, v).grad_fn is None


def test_bwd_wrapper_rejects_bad_stats():
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(4, 2, seed=6))
    lse = torch.zeros(B, S, 4)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_bwd(q, k, v, do[:, :10], lse, lse)
    with pytest.raises(ValueError, match="delta must be f32"):
        fa.flash_bwd(q, k, v, do, lse, lse.double())


_BF16_BOUNDS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "start": dict(causal=True, start=np.array([0, 40], np.int32)),
    "kv_len": dict(causal=False, kv_len=np.array([64, 21], np.int32)),
    "window": dict(causal=True, start=np.array([5, 10], np.int32),
                   kv_len=np.array([50, 33], np.int32)),
}


@pytest.mark.parametrize("bounds", sorted(_BF16_BOUNDS))
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)])
def test_bf16_gradients_match_reference(bounds, H, Hkv):
    """The plain backward in bf16 (the dtype the tensor-core kernels run)
    against ``jax.vjp`` of the reference's bf16 Pallas kernels."""
    q, k, v, do, _ = _inputs(H, Hkv, seed=7)
    kw = _BF16_BOUNDS[bounds]
    jbounds = {n: jnp.asarray(b) for n, b in kw.items() if isinstance(b, np.ndarray)}

    def f(q, k, v):
        return jflash(q, k, v, causal=kw["causal"], block_q=32, block_k=32, interpret=True,
                      **jbounds)

    jq, jk, jv, jdo = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v, do))
    _, vjp = jax.vjp(f, jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]

    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    tkw = {n: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for n, b in kw.items()}
    o = fa.flash_attention(tq, tk, tv, **tkw)
    o.backward(torch.from_numpy(do).bfloat16())
    for t, w, name in zip((tq, tk, tv), want, ("dq", "dk", "dv")):
        assert t.grad.dtype == torch.bfloat16, name
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=BF16_ATOL, rtol=0, err_msg=name)


_SM90 = ("flash_bwd_dq", "flash_bwd_dkv")
_SCALAR = ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar")


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, _SM90),
    (torch.bfloat16, 64, _SM90),
    (torch.bfloat16, 32, _SCALAR),
    (torch.bfloat16, 96, _SCALAR),
    (torch.bfloat16, 120, _SCALAR),
    (torch.float32, 128, _SCALAR),
    (torch.float32, 64, _SCALAR),
])
def test_backward_entry_is_chosen_by_dtype_and_head_dim(monkeypatch, dtype, D, want):
    """bf16 with D in {64, 128} takes the tensor-core entries, everything
    else the scalar ones, and ``flash_bwd`` launches what ``bwd_entries``
    names. Meta tensors reach the launch path without a card."""
    assert fa.bwd_entries(dtype, D) == want
    launched = []

    def record(entry, q, k, v, *args, **kw):
        launched.append(entry)
        return q if entry in ("flash_bwd_dq", "flash_bwd_dq_scalar") else (k, v)

    monkeypatch.setattr(fa, "_launch_bwd", record)
    q = torch.empty(1, 8, 4, D, dtype=dtype, device="meta")
    kv = torch.empty(1, 8, 2, D, dtype=dtype, device="meta")
    stats = torch.empty(1, 8, 4, device="meta")
    fa.flash_bwd(q, kv, kv, q, stats, stats)
    assert launched == list(want)
