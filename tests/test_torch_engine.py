"""The port's SlotEngine (gpushare_device_plugin_tpu_torch/serving/) against
the reference SlotEngine on the same Poisson trace, f32 on the CPU.

Tokens and the tick clock must be exactly equal; the shape guard must
stay at one input shape per program through slot churn; admission errors
must read the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import profiler as JP
from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import profiler as P
from gpushare_device_plugin_tpu_torch.workloads import generate as G

from torch_parity import EOS, assert_cache_close, configs, params_pair

TRACE = dict(n=10, seed=1, rate=0.6, prompt_lens=(3, 40), max_new=(2, 12))
POOL = dict(slots=3, max_len=64, prefill_chunk=16, eos_id=EOS)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _engines(model, **kw):
    jcfg, tcfg, jp, tp = model
    je = JE.SlotEngine(jp, jcfg, **POOL, **kw)
    te = E.SlotEngine(tp, tcfg, **POOL, **kw, device="cpu")
    je.warmup()
    te.warmup()
    return je, te


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_tokens_and_ticks_equal_reference(model, kv_dtype):
    je, te = _engines(model, kv_dtype=kv_dtype)
    vocab = model[0].vocab
    js = je.run(JE.poisson_trace(**TRACE, vocab=vocab))
    ts = te.run(E.poisson_trace(**TRACE, vocab=vocab))
    assert [r.tokens for r in ts.results] == [r.tokens for r in js.results]
    assert [r.first_token_tick for r in ts.results] == [r.first_token_tick for r in js.results]
    assert ts.ticks == js.ticks
    # slot churn in a second run leaves one shape per program
    te.run(E.poisson_trace(**{**TRACE, "seed": 2}, vocab=vocab))
    assert te.trace_counts == {"prefill": 1, "extend": 1, "decode": 1}
    assert ts.summary()["trace_counts"] == te.trace_counts


def test_poisson_trace_draws_equal_reference():
    kw = dict(n=6, seed=3, rate=0.5, vocab=100, prompt_lens=(5, 9))
    for max_new in ((2, 7), [4, 4, 40]):
        want = JE.poisson_trace(**kw, max_new=max_new)
        got = E.poisson_trace(**kw, max_new=max_new)
        assert [(r.rid, r.prompt, r.max_new, r.arrival) for r in got] == [
            (r.rid, r.prompt, r.max_new, r.arrival) for r in want
        ]
    with pytest.raises(ValueError, match="max_new tuple"):
        E.poisson_trace(**kw, max_new=(1, 2, 3))


def test_validate_and_constructor_errors_equal_reference(model):
    jcfg, tcfg, jp, tp = model
    je = JE.SlotEngine(jp, jcfg, **POOL)
    te = E.SlotEngine(tp, tcfg, **POOL, device="cpu")
    assert te.validate(E.Request(rid=6, prompt=tuple(range(1, 61)), max_new=4)) is None
    for prompt_len, max_new in ((60, 5), (20, 50), (64, 1)):
        req = dict(rid=7, prompt=tuple(range(1, prompt_len + 1)), max_new=max_new)
        with pytest.raises(ValueError) as jerr:
            je.validate(JE.Request(**req))
        with pytest.raises(ValueError) as terr:
            te.validate(E.Request(**req))
        assert str(terr.value) == str(jerr.value)
    for bad in (dict(slots=0), dict(prefill_chunk=0), dict(max_len=1000), dict(prefill_chunk=65)):
        kw = {**POOL, **bad}
        with pytest.raises(ValueError) as jerr:
            JE.SlotEngine(jp, jcfg, **kw)
        with pytest.raises(ValueError) as terr:
            E.SlotEngine(tp, tcfg, **kw, device="cpu")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="empty prompt"):
        E.Request(rid=1, prompt=(), max_new=1)
    with pytest.raises(ValueError, match="tier"):
        E.Request(rid=1, prompt=(1,), max_new=1, tier="gold")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_idle_row_at_max_len_writes_clamped_like_reference(model, kv_dtype):
    """A retired row parked at len == max_len is still written by the
    pool-wide decode step; the write clamps onto the last position (as
    dynamic_update_slice does) and nothing raises."""
    jcfg, tcfg, jp, tp = model
    jc = JG.init_slot_cache(jcfg, 2, 16, kv_dtype=kv_dtype)
    tc = G.init_slot_cache(tcfg, 2, 16, kv_dtype=kv_dtype, device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    _, jc = JG.prefill_slot(jp, jnp.asarray(prompt), jc, jcfg, slot=1, n_real=8)
    _, tc = G.prefill_slot(tp, torch.from_numpy(prompt).long(), tc, tcfg, slot=1, n_real=8)
    jc = {**jc, "len": jnp.asarray([16, 8], jnp.int32)}
    tc = {**tc, "len": torch.tensor([16, 8], dtype=torch.int32)}
    step = np.array([5, 6], np.int32)
    jl, jc = JG.decode_step(jp, jnp.asarray(step), jc, jcfg)
    tl, tc = G.decode_step(tp, torch.from_numpy(step).long(), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert_cache_close(tc, jc)


def test_sizing_equals_reference(model):
    jcfg, tcfg = model[0], model[1]
    for kv_dtype in (None, "int8"):
        assert E.kv_slot_bytes(tcfg, 128, kv_dtype) == JE.kv_slot_bytes(jcfg, 128, kv_dtype)
        for slice_bytes in (10_000, 2_000_000, 50_000_000):
            assert E.slots_for_slice(
                slice_bytes, tcfg, 128, weight_bytes=300_000, kv_dtype=kv_dtype
            ) == JE.slots_for_slice(
                slice_bytes, jcfg, 128, weight_bytes=300_000, kv_dtype=kv_dtype
            )
    with pytest.raises(ValueError, match="headroom"):
        E.slots_for_slice(1, tcfg, 8, weight_bytes=0, headroom=0.0)


def test_step_profiler_and_quantiles_equal_reference():
    vals = [0.3, 0.1, 0.2, 0.9, 0.5]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert P.ceil_rank_quantile(vals, q) == JP.ceil_rank_quantile(vals, q)
    prof = P.StepProfiler(capacity=3)
    for v in vals:
        prof.record(v)
    assert prof.count == 5 and sorted(prof.window()) == [0.2, 0.5, 0.9]
    assert prof.p50() == 0.5 and prof.p99() == 0.9
    prof.reset()
    assert prof.count == 0 and np.isnan(prof.p50())


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_static_baseline_ticks_tokens_and_ttfts_equal_reference(model, kv_dtype):
    """tests/test_serving_engine.py's static-baseline trace: the lockstep
    waves' ticks, each request's tokens and its first-token tick (the
    wave's completion) equal the reference's; and the tokens equal the
    slot engine's, which wins on ticks."""
    jcfg, tcfg, jp, tp = model
    trace = dict(n=10, seed=13, rate=0.25, prompt_lens=(2, 8), max_new=[2, 3, 4, 12])
    kw = dict(batch=3, eos_id=EOS, kv_dtype=kv_dtype, warmup=False)
    js = JE.run_static_baseline(jp, jcfg, JE.poisson_trace(**trace, vocab=jcfg.vocab), **kw)
    reqs = E.poisson_trace(**trace, vocab=tcfg.vocab)
    ts = E.run_static_baseline(tp, tcfg, reqs, **kw, device="cpu")
    assert ts.ticks == js.ticks
    assert [r.rid for r in ts.results] == [r.rid for r in js.results]
    assert [r.tokens for r in ts.results] == [r.tokens for r in js.results]
    assert [r.first_token_tick for r in ts.results] == [r.first_token_tick for r in js.results]
    assert [r.finish_tick for r in ts.results] == [r.finish_tick for r in js.results]
    assert all(r.first_token_s >= r.arrival_s for r in ts.results)
    assert ts.summary()["ttft_p99_ticks"] == js.summary()["ttft_p99_ticks"]
    eng = E.SlotEngine(tp, tcfg, slots=3, max_len=32, prefill_chunk=4, eos_id=EOS,
                       kv_dtype=kv_dtype, device="cpu")
    es = eng.run(reqs)
    assert [r.tokens for r in es.results] == [r.tokens for r in ts.results]
    assert es.ticks < ts.ticks


def test_static_baseline_keeps_the_fastest_of_its_trials(model):
    _, tcfg, _, tp = model
    reqs = E.poisson_trace(n=4, seed=2, rate=1.0, prompt_lens=(2, 6), max_new=(2, 4),
                           vocab=tcfg.vocab)
    stats = E.run_static_baseline(tp, tcfg, reqs, batch=2, eos_id=EOS, trials=2, device="cpu")
    assert stats.trace_counts == {} and stats.wall_s > 0
    assert sorted(r.rid for r in stats.results) == [r.rid for r in reqs]
