"""The port's cached generation (gpushare_device_plugin_tpu_torch/workloads/
generate.py) against the reference, f32 on the CPU.

Logits agree within 1e-4 and caches within 1e-5 (int8 codes within one
quantization step: a value at a rounding boundary may land either side
after f32 sums in another order); greedy tokens are exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu_torch.workloads import generate as G

from torch_parity import EOS, assert_cache_close, configs, params_pair, tokens

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_logits_and_cache_match_reference(model, kv_dtype, padded):
    jcfg, tcfg, jp, tp = model
    toks = tokens((2, 12), seed=1)
    pad = np.array([0, 5], np.int32) if padded else None
    jl, jc = JG.prefill(
        jp, jnp.asarray(toks), JG.init_cache(jcfg, 2, 20, kv_dtype=kv_dtype), jcfg,
        pad=None if pad is None else jnp.asarray(pad),
    )
    tl, tc = G.prefill(
        tp, torch.from_numpy(toks).long(),
        G.init_cache(tcfg, 2, 20, kv_dtype=kv_dtype, device="cpu"), tcfg,
        pad=None if pad is None else torch.from_numpy(pad),
    )
    _close(tl, jl)
    assert_cache_close(tc, jc)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_slot_prefill_extend_decode_match_reference(model, kv_dtype):
    """One slot pool driven through the three engine programs on both
    sides: fresh-slot prefill, continuation chunk, pool-wide decode."""
    jcfg, tcfg, jp, tp = model
    jc = JG.init_slot_cache(jcfg, 3, 32, kv_dtype=kv_dtype)
    tc = G.init_slot_cache(tcfg, 3, 32, kv_dtype=kv_dtype, device="cpu")
    chunk = tokens((8,), seed=2)
    for slot, n_real in ((1, 8), (2, 5)):
        jl, jc = JG.prefill_slot(jp, jnp.asarray(chunk), jc, jcfg, slot=slot, n_real=n_real)
        tl, tc = G.prefill_slot(tp, torch.from_numpy(chunk).long(), tc, tcfg, slot=slot, n_real=n_real)
        _close(tl, jl)
    nxt = tokens((8,), seed=3)
    jl, jc = JG.extend_slot(jp, jnp.asarray(nxt), jc, jcfg, slot=1, n_real=6)
    tl, tc = G.extend_slot(tp, torch.from_numpy(nxt).long(), tc, tcfg, slot=1, n_real=6)
    _close(tl, jl)
    assert tc["len"].tolist() == [0, 14, 5]
    step = tokens((3,), seed=4)
    jl, jc = JG.decode_step(jp, jnp.asarray(step), jc, jcfg)
    tl, tc = G.decode_step(tp, torch.from_numpy(step).long(), tc, tcfg)
    _close(tl, jl)
    assert_cache_close(tc, jc)


def test_row_update_clamps_like_dynamic_update_slice():
    rows = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    new = -np.ones((2, 2, 3), np.float32)
    pos = np.array([6, 1], np.int32)  # row 0 at len == Smax: start clamps to 4
    want = np.asarray(JG._row_update(jnp.asarray(rows), jnp.asarray(new), jnp.asarray(pos)))
    got = G._row_update(torch.from_numpy(rows.copy()), torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy()[0, 4:] == -1)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_generate_tokens_equal_reference(model, kv_dtype):
    jcfg, tcfg, jp, tp = model
    prompt = tokens((2, 10), seed=5)
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt), jcfg, max_new=12, kv_dtype=kv_dtype))
    got = G.generate(tp, prompt, tcfg, max_new=12, kv_dtype=kv_dtype, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_generate_prompt_lens_and_eos_equal_reference(model, kv_dtype):
    jcfg, tcfg, jp, tp = model
    prompt = tokens((3, 10), seed=6)
    lens = np.array([10, 4, 7], np.int32)
    want = np.asarray(JG.generate(
        jp, jnp.asarray(prompt), jcfg, max_new=9, prompt_lens=jnp.asarray(lens),
        eos_id=EOS, kv_dtype=kv_dtype,
    ))
    got = G.generate(
        tp, prompt, tcfg, max_new=9, prompt_lens=lens, eos_id=EOS, kv_dtype=kv_dtype,
        device="cpu",
    )
    assert got.shape == (3, 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_lens", [False, True])
def test_generate_max_new_zero_equals_reference(model, with_lens):
    """max_new=0: the prompt alone ([B, Tp]), or an empty [B, 0] block with
    prompt_lens, as the reference's zero-length scan returns."""
    jcfg, tcfg, jp, tp = model
    prompt = tokens((2, 5), seed=8)
    kw = dict(prompt_lens=np.array([5, 3], np.int32)) if with_lens else {}
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt), jcfg, max_new=0,
                                  **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = G.generate(tp, prompt, tcfg, max_new=0, device="cpu", **kw)
    assert got.shape == want.shape == ((2, 0) if with_lens else (2, 5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_int8_weights_equal_reference():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg, seed=2, transform=JQ.quantize_decoder)
    prompt = tokens((1, 7), seed=7)
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt), jcfg, max_new=8))
    got = G.generate(tp, prompt, tcfg, max_new=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_after_eos_and_sampler_contract():
    gen = np.array([[1, 3, 2, 3, 5], [4, 4, 4, 4, 3]], np.int32)
    np.testing.assert_array_equal(
        G._mask_after_eos(torch.from_numpy(gen), 3).numpy(),
        np.asarray(JG._mask_after_eos(jnp.asarray(gen), 3)),
    )
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0]])
    assert G.sample_logits(logits).tolist() == [1]  # ties: first index, like jnp
    g = torch.Generator().manual_seed(0)
    peaked = torch.tensor([[0.5, 2.0, 1.0, -1.0]])
    assert G.sample_logits(peaked, g, temperature=0.7, top_k=1).tolist() == [1]
    assert G.sample_logits(peaked, g, temperature=1.0, top_p=1e-3).tolist() == [1]
    assert G.sample_logits(logits, g, temperature=1.0, top_k=1).item() in (1, 2)
    with pytest.raises(ValueError, match="top_k"):
        G.sample_logits(logits, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        G.sample_logits(logits, top_p=1.5)
    with pytest.raises(ValueError, match="kv_dtype"):
        G.init_cache(configs()[1], 1, 4, kv_dtype="fp8", device="cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("padded", [False, True])
def test_make_generate_greedy_tokens_equal_reference(model, padded, kv_dtype):
    jcfg, tcfg, jp, tp = model
    prompt = tokens((3, 10), seed=11)
    lens = np.array([10, 4, 7], np.int32)
    kw = dict(max_new=9, eos_id=EOS, padded=padded, kv_dtype=kv_dtype)
    jgen = JG.make_generate(jcfg, **kw)
    gen = G.make_generate(tcfg, **kw, device="cpu")
    if padded:
        want = jgen(jp, jnp.asarray(prompt), jnp.asarray(lens), jax.random.key(0))
        got = gen(tp, prompt, lens)
        assert got.shape == (3, 9)
    else:
        want = jgen(jp, jnp.asarray(prompt), jax.random.key(0))
        got = gen(tp, prompt)
        assert got.shape == (3, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_generate_sampling_reproducible_from_one_generator(model):
    _, tcfg, _, tp = model
    prompt = tokens((2, 6), seed=12)
    gen = G.make_generate(tcfg, max_new=8, temperature=1.0, top_k=20, top_p=0.9, device="cpu")
    first = gen(tp, prompt, torch.Generator().manual_seed(7))
    again = gen(tp, prompt, torch.Generator().manual_seed(7))
    other = gen(tp, prompt, torch.Generator().manual_seed(8))
    assert first.shape == (2, 14) and torch.equal(first, again)
    assert not torch.equal(first, other)
    with pytest.raises(ValueError, match="generator"):
        gen(tp, prompt)
