"""The port's PagedSlotEngine (gpushare_device_plugin_tpu_torch/serving/
engine.py) against the reference's, f32 on the CPU.

On every trace (Poisson, shared prefixes with SLO tiers, a pressured pool
that preempts and evicts, the zero-progress last resort, int8 KV) the
tokens, first-token ticks, admission ticks, preemption records, total
ticks and ``cache_stats()`` must be exactly equal, and the shape guard
must stay at one shape per program through churn. Drain and restore,
the page export/import, the geometry errors and the trace draws must
agree with the reference too.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving.pages import pages_for

from torch_parity import EOS, configs, params_pair

BASE = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4, eos_id=EOS)
TIERS = [("critical", 0.5, 8.0, 4.0), ("best_effort", 0.5, None, None)]
GUARD = {"prefill": 1, "extend": 1, "decode": 1}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _pair(model, **kw):
    jcfg, tcfg, jp, tp = model
    geo = {**BASE, **kw}
    return JE.PagedSlotEngine(jp, jcfg, **geo), E.PagedSlotEngine(tp, tcfg, **geo, device="cpu")


def _reqs(mod, kind):
    """The same requests, built by the reference module or the port's."""
    if kind == "poisson":
        return mod.poisson_trace(10, seed=7, rate=0.15, vocab=64, prompt_lens=(1, 9),
                                 max_new=(2, 12))
    if kind in ("shared_prefix", "int8"):
        return mod.shared_prefix_trace(10, seed=5, rate=0.3, vocab=64, prefixes=(2, 8),
                                       tail_lens=(1, 12), max_new=[2, 4, 8], tiers=TIERS)
    if kind == "pressured":
        return mod.shared_prefix_trace(12, seed=3, rate=0.6, vocab=64, prefixes=(2, 8),
                                       tail_lens=(4, 12), max_new=[6, 12], tiers=TIERS)
    if kind == "preempt":
        return [
            mod.Request(rid=0, prompt=tuple(range(5, 13)), max_new=16, arrival=0.0,
                        tier="best_effort"),
            mod.Request(rid=1, prompt=tuple(range(20, 26)), max_new=16, arrival=4.0),
        ]
    assert kind == "last_resort"
    return [
        mod.Request(rid=0, prompt=tuple(range(5, 13)), max_new=16, arrival=0.0),
        mod.Request(rid=1, prompt=tuple(range(20, 28)), max_new=16, arrival=1.0),
    ]


GEOMETRY = {
    "poisson": {},
    "shared_prefix": dict(slots=3, total_pages=30, prefill_chunk=8),
    # one zero-progress turn with a request pending, where the port's
    # fallback hands the freed pages to the oldest row: same ticks here
    "pressured": dict(slots=3, total_pages=14),
    "preempt": dict(total_pages=8, radix=False),
    "last_resort": dict(total_pages=pages_for(32, 4), radix=False),
    "int8": dict(slots=3, total_pages=30, prefill_chunk=8, kv_dtype="int8"),
}


def _record(stats):
    return [
        (r.rid, r.tokens, r.first_token_tick, r.admit_tick, r.finish_tick, r.tier,
         r.prefix_tokens, [{k: v for k, v in p.items() if k.endswith("_tick")} for p in r.preemptions])
        for r in stats.results
    ]


@pytest.mark.parametrize("kind", list(GEOMETRY))
def test_engine_equals_reference(model, kind):
    je, te = _pair(model, **GEOMETRY[kind])
    je.warmup()
    te.warmup()
    assert te.cache_stats() == je.cache_stats()
    js, ts = je.run(_reqs(JE, kind)), te.run(_reqs(E, kind))
    assert _record(ts) == _record(js)
    assert ts.ticks == js.ticks
    assert ts.engine_cache == js.engine_cache == te.cache_stats()
    assert ts.summary()["tiers"] == js.summary()["tiers"] if "tiers" in js.summary() else True
    # a second run over the warm radix: more churn, still one shape each
    js2, ts2 = je.run(_reqs(JE, kind)), te.run(_reqs(E, kind))
    assert _record(ts2) == _record(js2) and ts2.engine_cache == js2.engine_cache
    assert te.trace_counts == GUARD
    assert te.allocator.used_pages == (te.radix.cached_pages if te.radix else 0)
    if kind in ("pressured", "preempt", "last_resort"):
        assert js.engine_cache["preemptions"] > 0
    if kind in ("shared_prefix", "int8"):
        assert js.engine_cache["prefix_hit_requests"] > 0
    if kind == "pressured":
        assert js2.engine_cache["prefix_evicted_pages"] > 0
    if kind == "last_resort":
        assert [r.preemptions != [] for r in ts.results] == [False, True]


def test_geometry_and_admission_errors_equal_reference(model):
    jcfg, tcfg, jp, tp = model
    for bad in (dict(page_size=0), dict(page_size=3), dict(total_pages=4),
                dict(slots=0), dict(max_len=1000), dict(prefill_chunk=64)):
        kw = {**BASE, **bad}
        with pytest.raises(ValueError) as jerr:
            JE.PagedSlotEngine(jp, jcfg, **kw)
        with pytest.raises(ValueError) as terr:
            E.PagedSlotEngine(tp, tcfg, **kw, device="cpu")
        assert str(terr.value) == str(jerr.value)
    je, te = _pair(model)
    for req in (dict(rid=3, prompt=tuple(range(1, 30)), max_new=8),
                dict(rid=4, prompt=(1, 2), max_new=1, adapter_id="tenant-a")):
        with pytest.raises(ValueError) as jerr:
            je.validate(JE.Request(**req))
        with pytest.raises(ValueError) as terr:
            te.validate(E.Request(**req))
        assert str(terr.value) == str(jerr.value)


def test_shared_prefix_trace_draws_equal_reference():
    kw = dict(n=9, seed=4, rate=0.7, vocab=500, prefixes=(3, 11), tail_lens=(2, 9))
    for max_new, tiers in (((2, 7), None), ([4, 4, 40], TIERS)):
        want = JE.shared_prefix_trace(**kw, max_new=max_new, tiers=tiers)
        got = E.shared_prefix_trace(**kw, max_new=max_new, tiers=tiers)
        fields = ("rid", "prompt", "max_new", "arrival", "tier", "slo_ttft_ticks",
                  "slo_tpot_ticks", "adapter_id")
        assert [tuple(getattr(r, f) for f in fields) for r in got] == [
            tuple(getattr(r, f) for f in fields) for r in want
        ]
    with pytest.raises(ValueError, match="prefixes"):
        E.shared_prefix_trace(**{**kw, "prefixes": (0, 4)}, max_new=(1, 2))


def _combined(part, rest):
    out = {r.rid: r.tokens for r in part.results}
    out.update({r.rid: r.tokens for r in rest.results})
    return out


@pytest.mark.parametrize("kind,tick", [("shared_prefix", 8), ("preempt", 12), ("int8", 5)])
def test_drain_restore_equals_reference_and_crosses_engines(model, kind, tick):
    """Drain at ``tick`` on both engines: the snapshots are equal; the
    reference's snapshot, through JSON, restores on the port's engine and
    the port's on a fresh port engine, each with the combined tokens of an
    undrained run."""
    geo = GEOMETRY[kind]
    jref, tref = _pair(model, **geo)
    ref = {r.rid: r.tokens for r in jref.run(_reqs(JE, kind)).results}
    assert {r.rid: r.tokens for r in tref.run(_reqs(E, kind)).results} == ref
    jsrc, tsrc = _pair(model, **geo)
    jpart = jsrc.run(_reqs(JE, kind), drain_at_tick=tick)
    tpart = tsrc.run(_reqs(E, kind), drain_at_tick=tick)
    jsnap, tsnap = jsrc.drain_snapshot(), tsrc.drain_snapshot()
    assert tsnap["requests"] and tsnap == jsnap
    assert tsrc.allocator.used_pages == (tsrc.radix.cached_pages if tsrc.radix else 0)
    _, dst = _pair(model, **geo)
    assert _combined(jpart, dst.restore_snapshot(json.loads(json.dumps(jsnap)))) == ref
    _, dst = _pair(model, **geo)
    assert _combined(tpart, dst.restore_snapshot(tsnap)) == ref
    assert dst.trace_counts == GUARD


def test_restore_dedup_mismatch_and_adapter_rows(model):
    _, src = _pair(model)
    reqs = _reqs(E, "poisson")
    ref = {r.rid: r.tokens for r in _pair(model)[1].run(reqs).results}
    part = src.run(reqs, drain_at_tick=9)
    snap = {**src.drain_snapshot(), "snapshot_id": "node-a/default.mv#7"}
    _, dst = _pair(model)
    assert _combined(part, dst.restore_snapshot(snap)) == ref
    assert dst.restore_snapshot(snap).results == []  # the same delivery again: a no-op
    untagged = {k: v for k, v in snap.items() if k != "snapshot_id"}
    assert _combined(part, dst.restore_snapshot(untagged)) == ref  # no id: never deduplicated
    assert dst.restore_snapshot(None).results == [] and dst.restore_snapshot({"requests": []}).results == []
    with pytest.raises(ValueError, match="diverge"):
        _pair(model, kv_dtype="int8")[1].restore_snapshot(snap)
    tenant = {**untagged, "requests": [{**untagged["requests"][0], "adapter_id": "tenant-a"}]}
    with pytest.raises(ValueError, match="no lora_store"):
        _pair(model)[1].restore_snapshot(tenant)


def test_drain_handshake_across_threads(model):
    """A mover thread's wait returns the capture of a concurrent run; a run
    that retires everything answers None; a timed-out wait disarms, so the
    next run serves normally."""
    reqs = _reqs(E, "poisson")
    _, eng = _pair(model)
    ref = {r.rid: r.tokens for r in eng.run(reqs).results}
    assert eng.drain_snapshot() is None
    eng.request_drain()  # between runs: armed for the next one
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("part", eng.run(reqs)))
    t.start()
    snap = eng.wait_drained(timeout=60.0)
    t.join(timeout=60.0)
    assert not t.is_alive() and out["part"].results == [] and len(snap["requests"]) == len(reqs)
    assert {r.rid: r.tokens for r in _pair(model)[1].restore_snapshot(snap).results} == ref
    eng.request_drain()
    with pytest.raises(TimeoutError):
        eng.wait_drained(timeout=0.05)
    assert {r.rid: r.tokens for r in eng.run(reqs).results} == ref


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_page_blobs_equal_reference_and_round_trip(model, kv_dtype):
    je, te = _pair(model, slots=3, total_pages=30, prefill_chunk=8, kv_dtype=kv_dtype)
    je.run(_reqs(JE, "shared_prefix"))
    te.run(_reqs(E, "shared_prefix"))
    pages = te.radix.pages()
    assert pages and pages == je.radix.pages()
    jblobs, tblobs = je.export_kv_pages(pages), te.export_kv_pages(pages)
    assert [sorted(b) for b in tblobs] == [sorted(b) for b in jblobs]
    for tb, jb in zip(tblobs, jblobs):
        for key, jv in jb.items():
            assert tb[key].shape == jv.shape and tb[key].dtype == jv.dtype, key
            if jv.dtype == np.int8:
                assert np.abs(tb[key].astype(np.int32) - jv.astype(np.int32)).max() <= 1, key
            else:
                np.testing.assert_allclose(tb[key], jv, atol=1e-5, rtol=0, err_msg=key)
    # import into another pool: the same bits come back
    _, dst = _pair(model, slots=3, total_pages=30, prefill_chunk=8, kv_dtype=kv_dtype)
    targets = dst.allocator.alloc(len(pages))
    dst.import_kv_pages(targets, tblobs)
    for a, b in zip(dst.export_kv_pages(targets), tblobs):
        assert all(np.array_equal(a[key], b[key]) for key in b)
    if kv_dtype is None:  # a bf16 blob (numpy via ml_dtypes, as JAX exports it) imports exactly
        half = [{k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in b.items()} for b in jblobs]
        dst.import_kv_pages(targets, half)
        for a, b in zip(dst.export_kv_pages(targets), half):
            assert all(np.array_equal(a[key], b[key].astype(np.float32)) for key in b)
    # a geometry mismatch raises before anything is written
    before = {k: v.clone() for k, v in dst.cache.items()}
    bad = [{**b, "k": b["k"][:, :2]} for b in tblobs]
    with pytest.raises(ValueError, match="does not fit"):
        dst.import_kv_pages(targets, bad)
    with pytest.raises(ValueError, match="missing cache buffer"):
        dst.import_kv_pages(targets[:1], [{"k": tblobs[0]["k"]}])
    with pytest.raises(ValueError, match="payloads"):
        dst.import_kv_pages(targets, tblobs[:1])
    assert all(np.array_equal(dst.cache[k].numpy(), v.numpy()) for k, v in before.items())


def _head_of_line(mod):
    """A best-effort request first in line, three critical ones behind it,
    every prompt three chunks long, on a pool of one row of pages."""
    return [mod.Request(rid=0, prompt=tuple(range(1, 21)), max_new=8, tier="best_effort")] + [
        mod.Request(rid=i, prompt=tuple(range(10 * i, 10 * i + 20)), max_new=8, arrival=0.5 * i)
        for i in range(1, 4)
    ]


CYCLES = {
    # the zero-progress fallback's victim takes back the pages it freed
    "victim_readmits": (lambda mod: _reqs(mod, "pressured"),
                        dict(slots=3, total_pages=12, prefill_chunk=8)),
    # the stalled best-effort head starves the critical rows behind it
    "stalled_head": (_head_of_line, dict(slots=4, total_pages=8, prefill_chunk=8, radix=False)),
}


@pytest.mark.parametrize("case", list(CYCLES))
def test_pressured_runs_end_where_the_reference_cycles(model, case):
    """On these pools the reference's run never ends (``ROADMAP.md`` §4).
    The port hands the pages a zero-progress turn frees to the protected
    oldest row, and lets the next mid-prefill row take the turn's chunk
    when the oldest stalls, so every request is served, with the tokens of
    the reference's contiguous engine."""
    jcfg, tcfg, jp, tp = model
    trace, geo = CYCLES[case]
    want = JE.SlotEngine(jp, jcfg, slots=geo["slots"], max_len=32, prefill_chunk=8,
                         eos_id=EOS).run(trace(JE))
    eng = E.PagedSlotEngine(tp, tcfg, **{**BASE, **geo}, device="cpu")
    calls = []
    for name in ("_prefill", "_extend", "_decode", "_fresh_slot"):  # dispatches and preemptions
        method = getattr(eng, name)

        def counted(*args, method=method):
            calls.append(1)
            if len(calls) > 2000:  # a cycle: fail, do not hang
                raise RuntimeError("no end in sight")
            return method(*args)

        setattr(eng, name, counted)
    got = eng.run(trace(E))
    assert [r.tokens for r in got.results] == [r.tokens for r in want.results]
    assert got.engine_cache["preemptions"] > 0 and eng.trace_counts == GUARD
    assert eng.allocator.used_pages == (eng.radix.cached_pages if eng.radix else 0)


DIVERGING = {
    # zero-progress turns with requests pending: the reference leaves the
    # freed pages to the next admission, the port grants them to the oldest
    "zero_progress": (dict(slots=2, total_pages=9), dict(seed=4, rate=0.4)),
    # a stalled oldest prefill row: the port runs the next row's chunk
    "stalled_prefill": (dict(slots=3, total_pages=12, radix=False), dict(seed=5, rate=0.4)),
}


@pytest.mark.parametrize("case", list(DIVERGING))
def test_repaired_schedule_keeps_the_reference_tokens(model, case):
    """Traces the reference finishes, but on which the two repairs of
    ``ROADMAP.md`` §4 fault 2 change the schedule: ticks and preemptions
    differ, every request's tokens are the reference's, and the port ends
    no later."""
    geo, draw = DIVERGING[case]
    je, te = _pair(model, **geo)
    kw = dict(n=10, vocab=64, prefixes=(2, 8), tail_lens=(4, 12), max_new=[6, 12], tiers=TIERS, **draw)
    js, ts = je.run(JE.shared_prefix_trace(**kw)), te.run(E.shared_prefix_trace(**kw))
    assert [(r.rid, r.tokens) for r in ts.results] == [(r.rid, r.tokens) for r in js.results]
    assert len(ts.results) == 10 and ts.ticks < js.ticks
    assert js.engine_cache["preemptions"] > 0 and te.trace_counts == GUARD
    assert te.allocator.used_pages == (te.radix.cached_pages if te.radix else 0)
