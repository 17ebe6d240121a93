"""The port's speculative PagedSlotEngine (gpushare_device_plugin_tpu_torch/
serving/engine.py with ``draft_params`` / ``draft_cfg`` / ``spec_k``)
against the reference's, f32 on the CPU, on the reference engine tests'
target (2 layers, d 32) and draft (1 layer, d 16) decoders.

Exact: tokens, first-token, admission and finish ticks, total ticks, the
shape guard (five programs, one shape each from warmup on) and
``cache_stats()`` with its ``speculative`` row, for an independent draft
(almost every proposal rejected, rollback every round), a self-draft
(every proposal accepted) and a suspended engine; drain snapshots equal
at every boundary, restoring across speculative and plain engines; the
bad-config errors word for word. Where the reference cannot be compared
(it shares prefix pages across LoRA tenants, ``ROADMAP.md`` §3 fault 4),
tokens equal merged-solo's (greedy argmax in f32).
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import to_numpy

EOS = 3
SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT = dict(SHAPE, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=32)
BASE = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4, eos_id=EOS)
FIVE = {"prefill": 1, "extend": 1, "decode": 1, "draft": 1, "verify": 1}
TIERS = [("critical", 0.5, 40.0, 8.0), ("best_effort", 0.5, None, None)]


class Model:
    """One decoder on both sides: configs, reference params, port copy."""

    def __init__(self, shape, seed):
        self.jcfg = JT.TransformerConfig(**shape, compute_dtype=jnp.float32)
        self.tcfg = T.TransformerConfig(**shape, compute_dtype=torch.float32)
        self.jp = JT.init_params(jax.random.key(seed), self.jcfg)
        self.tp = convert.from_jax_numpy(to_numpy(self.jp), self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    return Model(SHAPE, 0), Model(DRAFT, 7)


def _draft_kw(models, draft, side):
    """Engine kwargs for ``draft`` in (None, "indep", "self") on ``side``
    ("j": the reference, "t": the port)."""
    target, indep = models
    if draft is None:
        return {}
    m = indep if draft == "indep" else target
    return {"draft_params": getattr(m, side + "p"), "draft_cfg": getattr(m, side + "cfg")}


def _port(models, draft=None, **kw):
    target = models[0]
    return E.PagedSlotEngine(target.tp, target.tcfg, **{**BASE, **kw},
                             **_draft_kw(models, draft, "t"), device="cpu")


def _ref(models, draft=None, **kw):
    target = models[0]
    return JE.PagedSlotEngine(target.jp, target.jcfg, **{**BASE, **kw},
                              **_draft_kw(models, draft, "j"))


def _reqs(mod, kind):
    """The reference's speculative engine tests' traces, built by the
    reference module or the port's."""
    if kind == "churn":
        return mod.shared_prefix_trace(10, seed=13, rate=0.4, vocab=64, prefixes=(2, 8),
                                       tail_lens=(1, 4), max_new=[3, 6, 12], tiers=TIERS)
    if kind == "self_draft":
        return mod.shared_prefix_trace(8, seed=5, rate=0.3, vocab=64, prefixes=(2, 8),
                                       tail_lens=(1, 4), max_new=(4, 12))
    if kind == "rollback":
        return mod.poisson_trace(6, seed=9, rate=0.5, vocab=64, prompt_lens=(1, 8),
                                 max_new=(4, 10))
    if kind == "suspended":
        return mod.poisson_trace(4, seed=2, rate=0.5, vocab=64, prompt_lens=(2, 6),
                                 max_new=(3, 8))
    if kind == "drain":
        return mod.shared_prefix_trace(6, seed=3, rate=0.4, vocab=64, prefixes=(1, 8),
                                       tail_lens=(1, 4), max_new=[4, 9])
    assert kind == "pressured"
    return mod.shared_prefix_trace(12, seed=3, rate=0.6, vocab=64, prefixes=(2, 8),
                                   tail_lens=(4, 12), max_new=[6, 12], tiers=TIERS)


def _record(stats):
    return [
        (r.rid, r.tokens, r.first_token_tick, r.admit_tick, r.finish_tick, r.tier,
         r.prefix_tokens, [{k: v for k, v in p.items() if k.endswith("_tick")} for p in r.preemptions])
        for r in stats.results
    ]


def _tokens(stats):
    return {r.rid: r.tokens for r in stats.results}


def _leak_free(eng):
    """After a quiesced run only the radix cache (and resident adapters)
    hold pages: every lookahead page came back."""
    held = eng.radix.cached_pages if eng.radix is not None else 0
    if eng.adapters is not None:
        held += eng.adapters.cached_pages
    return eng.allocator.used_pages == held


SPEC = {  # kind: (draft, spec_k)
    "churn": ("indep", 3),
    "self_draft": ("self", 4),
    "rollback": ("indep", 4),
}


@pytest.mark.parametrize("kind", list(SPEC))
def test_spec_engine_equals_reference(models, kind):
    """The reference's three speculative contracts (an independent draft
    through churn, shared prefixes and tiers; a self-draft that accepts
    everything and saves ticks; rollback of every lookahead page), each
    equal to the reference's run and to the plain engine's tokens, twice
    (the second run over the warm radix cache)."""
    draft, k = SPEC[kind]
    je, te = _ref(models, draft, spec_k=k), _port(models, draft, spec_k=k)
    je.warmup()
    te.warmup()
    assert te.trace_counts == dict(je.trace_counts) == FIVE
    assert te.cache_stats() == je.cache_stats()
    plain = _port(models)
    plain.warmup()
    want = plain.run(_reqs(E, kind))
    for _ in range(2):
        js, ts = je.run(_reqs(JE, kind)), te.run(_reqs(E, kind))
        assert _record(ts) == _record(js)
        assert ts.ticks == js.ticks
        assert ts.engine_cache == js.engine_cache == te.cache_stats()
        assert ts.summary().get("tiers") == js.summary().get("tiers")
        assert _tokens(ts) == _tokens(want)
        assert te.trace_counts == FIVE and _leak_free(te)
    row = ts.engine_cache["speculative"]
    assert row["draft_steps"] > 0 and 0 <= row["accepted"] <= row["proposed"] > 0
    if kind == "self_draft":
        assert ts.ticks < want.ticks
        assert row["accepted"] == row["proposed"] and row["rollback_pages"] == 0
        assert any("spec_accepted" in t for t in ts.summary()["tiers"].values())
        assert te.profiler.tokens_per_step() > 1.0
    else:
        assert row["rollback_pages"] > 0 and row["lookahead_high_water_pages"] >= 1


def test_suspended_spec_engine_is_the_plain_engine(models):
    """A suspended speculative engine dispatches no draft or verify and
    serves the plain engine's tokens, as the reference's does."""
    je, te = _ref(models, "indep"), _port(models, "indep")
    for eng in (je, te):
        eng.warmup()
        eng._spec_suspended = True
    js, ts = je.run(_reqs(JE, "suspended")), te.run(_reqs(E, "suspended"))
    assert _record(ts) == _record(js) and ts.engine_cache == js.engine_cache
    assert _tokens(ts) == _tokens(_port(models).run(_reqs(E, "suspended")))
    assert ts.engine_cache["speculative"]["draft_steps"] == 0
    assert te.trace_counts == FIVE


def test_bad_draft_configs_raise_the_reference_errors(models):
    target, indep = models
    bad = dict(DRAFT, vocab=32)
    cases = [
        ("without the other", dict(draft_params=indep.jp), dict(draft_params=indep.tp)),
        ("vocab", dict(draft_params=indep.jp, draft_cfg=JT.TransformerConfig(**bad)),
         dict(draft_params=indep.tp, draft_cfg=T.TransformerConfig(**bad))),
        ("spec_k", dict(draft_params=indep.jp, draft_cfg=indep.jcfg, spec_k=0),
         dict(draft_params=indep.tp, draft_cfg=indep.tcfg, spec_k=0)),
    ]
    for match, jkw, tkw in cases:
        with pytest.raises(ValueError, match=match) as jerr:
            JE.PagedSlotEngine(target.jp, target.jcfg, **BASE, **jkw)
        with pytest.raises(ValueError) as terr:
            E.PagedSlotEngine(target.tp, target.tcfg, **BASE, **tkw, device="cpu")
        assert str(terr.value) == str(jerr.value)


def _combined(part, rest):
    out = _tokens(part)
    out.update(_tokens(rest))
    return out


@pytest.mark.parametrize("tick", list(range(1, 14, 3)))
def test_spec_drain_at_every_boundary(models, tick):
    """Wherever a drain lands mid-speculation, the snapshot equals the
    reference's and carries only verified tokens (a prefix of the plain
    stream), the source frees every draft and lookahead page, and the
    snapshot restores on a plain engine with the plain run's tokens."""
    ref = _tokens(_port(models).run(_reqs(E, "drain")))
    jsrc, tsrc = _ref(models, "self", spec_k=4), _port(models, "self", spec_k=4)
    jsrc.warmup()
    tsrc.warmup()
    jpart = jsrc.run(_reqs(JE, "drain"), drain_at_tick=tick)
    tpart = tsrc.run(_reqs(E, "drain"), drain_at_tick=tick)
    assert _record(tpart) == _record(jpart)
    tsnap = tsrc.drain_snapshot()
    assert tsnap == jsrc.drain_snapshot()
    assert _leak_free(tsrc)
    if tsnap is None:
        assert _tokens(tpart) == ref
        return
    for row in tsnap["requests"]:
        assert row["tokens"] == ref[row["rid"]][: len(row["tokens"])]
    dst = _port(models)
    assert _combined(tpart, dst.restore_snapshot(json.loads(json.dumps(tsnap)))) == ref


def test_plain_drain_restores_on_a_spec_engine(models):
    """The reverse move: a plain engine's snapshot restores on a
    speculative engine, which speculates and ends with every page back."""
    ref = _tokens(_port(models).run(_reqs(E, "drain")))
    src = _port(models)
    part = src.run(_reqs(E, "drain"), drain_at_tick=7)
    snap = src.drain_snapshot()
    assert snap is not None and snap["requests"]
    dst = _port(models, "self", spec_k=4)
    dst.warmup()
    rest = dst.restore_snapshot(snap)
    assert _combined(part, rest) == ref
    assert rest.engine_cache["speculative"]["draft_steps"] > 0
    assert dst.trace_counts == FIVE and _leak_free(dst)


def test_pressured_spec_run_returns_every_page(models):
    """A pool a third the size the traffic wants: rows preempt, radix
    pages evict, drafts take lookahead pages only when they are free, and
    the run ends with the plain engine's tokens and every page back."""
    geo = dict(slots=3, total_pages=14)
    plain = _port(models, **geo).run(_reqs(E, "pressured"))
    eng = _port(models, "indep", spec_k=3, **geo)
    eng.warmup()
    stats = eng.run(_reqs(E, "pressured"))
    assert _tokens(stats) == _tokens(plain)
    cache = stats.engine_cache
    assert cache["preemptions"] > 0 and cache["speculative"]["rollback_pages"] > 0
    assert eng.trace_counts == FIVE and _leak_free(eng)


def _rand_lora(jcfg, jlcfg, seed, scale=0.5):
    """The reference tests' adapters (every leaf normal), at 0.5 rather
    than their 0.02, where a tenant's tokens leave the base model's."""
    tree = JL.init_lora(jax.random.key(seed), jcfg, jlcfg)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(seed + 10_000), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape, x.dtype) * scale for k, x in zip(keys, leaves)])


def test_lora_composes_with_spec_decode(models):
    """Speculation under multi-LoRA: the draft proposes with the base
    model while the verify carries each row's adapter. Tokens equal
    merged-solo's (``merge_lora`` + solo ``generate``) and the plain
    multi-LoRA engine's; without the radix cache, where the reference
    shares no pages across tenants, the run equals the reference's."""
    target = models[0]
    jlcfg, tlcfg = JL.LoraConfig(rank=2, alpha=4.0), L.LoraConfig(rank=2, alpha=4.0)
    jstore = {a: _rand_lora(target.jcfg, jlcfg, 40 + i) for i, a in enumerate(("t0", "t1", "t2"))}
    tstore = {a: convert.lora_from_jax_numpy(to_numpy(t), target.tcfg, tlcfg, device="cpu")
              for a, t in jstore.items()}
    kw = lambda store, lcfg, **more: dict(total_pages=40, lora_store=store, lora_cfg=lcfg,  # noqa: E731
                                          **more)
    reqs = lambda mod: mod.shared_prefix_trace(  # noqa: E731
        8, seed=17, rate=0.4, vocab=64, prefixes=(2, 8), tail_lens=(1, 4), max_new=[3, 6, 10],
        adapters=["t0", "t1", ""])
    plain = _port(models, **kw(tstore, tlcfg)).run(reqs(E))
    spec = _port(models, "indep", spec_k=3, **kw(tstore, tlcfg))
    spec.warmup()
    assert spec.trace_counts == FIVE
    stats = spec.run(reqs(E))
    shows = False  # some tenant's tokens leave the base model's
    for req, res in zip(reqs(E), stats.results):
        solo = lambda params: G.generate(  # noqa: E731
            params, [list(req.prompt)], target.tcfg, max_new=req.max_new, eos_id=EOS,
            device="cpu")[0, len(req.prompt):].tolist()
        merged = L.merge_lora(target.tp, tstore[req.adapter_id], tlcfg) if req.adapter_id \
            else target.tp
        got = res.tokens + [EOS] * (req.max_new - len(res.tokens))
        assert got == solo(merged), req.rid
        shows |= bool(req.adapter_id) and got != solo(target.tp)
    assert shows
    assert _tokens(stats) == _tokens(plain)
    assert stats.engine_cache["speculative"]["draft_steps"] > 0
    assert spec.trace_counts == FIVE and _leak_free(spec)
    je = _ref(models, "indep", spec_k=3, radix=False, **kw(jstore, jlcfg))
    te = _port(models, "indep", spec_k=3, radix=False, **kw(tstore, tlcfg))
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _record(ts) == _record(js) and ts.engine_cache == js.engine_cache
    assert _tokens(ts) == _tokens(stats)
