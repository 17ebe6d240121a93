"""The interference plane through the port's engines
(gpushare_device_plugin_tpu_torch/serving/engine.py: ``metrics_pod``,
``slo_budget``, ``governor``, request spans, ``publish_metrics``) against
the reference's engines, f32 on the CPU, on the reference engine tests'
decoders (target: 2 layers, d 32; draft: 1 layer, d 16).

Exact: tokens, the shape guard, request-span names and counts, every
deterministic metric family of a pod (page gauges, ``alloc_count`` /
``free_count_total``, preemptions, prefix-hit and speculative histogram
lines, speculative and adapter counters), SLO verdicts and the governor's
``stats()`` under a fake clock, whose sleep only moves the clock.
Timing families (step seconds, adapter miss stalls) are checked for
presence and count. A governed engine's tokens equal its ungoverned
ones, and the reference's scrapers read the port's ``/metrics``.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from gpushare_device_plugin_tpu.cli.inspect import parse_engine_metrics
from gpushare_device_plugin_tpu.cluster.interference import step_p99s_from_urls
from gpushare_device_plugin_tpu.serving import StepGovernor as JStepGovernor
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.utils import metrics as JMet
from gpushare_device_plugin_tpu.utils import slo as JSlo
from gpushare_device_plugin_tpu.utils import tracing as JTr
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.serving import StepGovernor
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.utils import metrics as Met
from gpushare_device_plugin_tpu_torch.utils import slo as Slo
from gpushare_device_plugin_tpu_torch.utils import tracing as Tr
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import to_numpy

EOS = 3
SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT = dict(SHAPE, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=32)
PAGED = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4, eos_id=EOS)
SLOT = dict(slots=2, max_len=32, prefill_chunk=4, eos_id=EOS)
REQUEST_SPANS = ["serve.decode", "serve.prefill", "serve.queue", "serve.request", "serve.retire"]


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


@pytest.fixture(autouse=True)
def sampled_traces():
    """Both processes' tracers sample every root, and both stores start
    and end empty."""
    for tr in (JTr, Tr):
        tr.TRACER.configure(sample_ratio=1.0, tier_ratios={})
        tr.STORE.clear()
    yield
    for tr in (JTr, Tr):
        tr.TRACER.configure(sample_ratio=1.0, tier_ratios={})
        tr.STORE.clear()


def _engines(models, kind, draft=None, governors=(None, None), **kw):
    """(reference engine, port engine) of ``kind`` ("slot" or "paged"),
    with the draft ("self" or "indep") and a governor each."""
    target, indep = models
    geo = {**(SLOT if kind == "slot" else PAGED), **kw}
    jkw, tkw = {}, {}
    if draft is not None:
        m = target if draft == "self" else indep
        jkw = dict(draft_params=m.jp, draft_cfg=m.jcfg)
        tkw = dict(draft_params=m.tp, draft_cfg=m.tcfg)
    jcls, tcls = (JE.SlotEngine, E.SlotEngine) if kind == "slot" else (
        JE.PagedSlotEngine, E.PagedSlotEngine)
    return (jcls(target.jp, target.jcfg, **geo, **jkw, governor=governors[0]),
            tcls(target.tp, target.tcfg, **geo, **tkw, governor=governors[1], device="cpu"))


def _tokens(stats):
    return {r.rid: list(r.tokens) for r in stats.results}


class _FakeTime:
    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _governors(burn=lambda: "page", **kw):
    """The same fake-clock governor on both sides."""
    kw = {"throttled_steps_per_s": 50.0, "poll_interval_steps": 1, **kw}
    out = []
    for cls, met in ((JStepGovernor, JMet), (StepGovernor, Met)):
        ft = _FakeTime()
        out.append(cls(burn, registry=met.MetricsRegistry(), clock=ft.clock, sleep=ft.sleep,
                       **kw))
    return tuple(out)


def _pod_lines(text: str, pod: str, *families: str) -> list[str]:
    """The sample lines of ``families`` for one pod, sorted."""
    return sorted(line for line in text.splitlines()
                  if not line.startswith("#") and f'pod="{pod}"' in line
                  and line.split("{")[0].startswith(families))


def _span_record(store, res):
    """Names, parent links and root attributes of one request's trace."""
    spans = {s.name: s for s in store.trace(res.trace_id)}
    root = spans["serve.request"]
    return (sorted(n for n in spans), all(s.parent_id == root.span_id
                                          for n, s in spans.items() if n != "serve.request"),
            root.attributes)


# --------------------------------------------------------------------------
# SlotEngine (tests/test_serving_engine.py:488, :536, :572)
# --------------------------------------------------------------------------


def test_slot_engine_request_spans_equal_reference(models):
    je, te = _engines(models, "slot")
    je.warmup()
    te.warmup()
    assert Tr.STORE.trace_ids() == [] and JTr.STORE.trace_ids() == []  # warmup is untraced
    reqs = lambda mod: [mod.Request(rid=0, prompt=(5, 6, 7, 8, 9), max_new=6, arrival=0.0),  # noqa: E731
                        mod.Request(rid=1, prompt=(10, 11), max_new=4, arrival=2.0)]
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _tokens(ts) == _tokens(js) and ts.trace_counts == dict(js.trace_counts)
    for jr, tr_ in zip(js.results, ts.results):
        assert jr.trace_id and tr_.trace_id
        assert _span_record(Tr.STORE, tr_) == _span_record(JTr.STORE, jr)
        spans = {s.name: s for s in Tr.STORE.trace(tr_.trace_id)}
        assert sorted(spans) == REQUEST_SPANS
        assert spans["serve.queue"].end_ns == spans["serve.prefill"].start_ns
        assert spans["serve.request"].start_ns <= spans["serve.queue"].start_ns
        assert spans["serve.request"].end_ns >= spans["serve.retire"].end_ns
    assert len(Tr.STORE.trace_ids()) == len(JTr.STORE.trace_ids()) == 2
    # unsampled: nothing recorded, results unstamped
    for tr in (JTr, Tr):
        tr.STORE.clear()
        tr.TRACER.configure(sample_ratio=0.0)
    js, ts = je.run([JE.Request(rid=2, prompt=(5, 6), max_new=2)]), te.run(
        [E.Request(rid=2, prompt=(5, 6), max_new=2)])
    assert ts.results[0].trace_id == js.results[0].trace_id == ""
    assert Tr.STORE.trace_ids() == JTr.STORE.trace_ids() == []


def test_slot_engine_step_profile_published(models):
    pod = "t/slot-profiled"
    je, te = _engines(models, "slot", metrics_pod=pod)
    je.warmup()
    te.warmup()
    assert te.profiler.count == 0
    assert Met.REGISTRY.histogram_stats("tpushare_engine_step_seconds", pod=pod) == (0, 0.0)
    reqs = lambda mod: [mod.Request(rid=0, prompt=(5, 6, 7), max_new=6, arrival=0.0),  # noqa: E731
                        mod.Request(rid=1, prompt=(8, 9), max_new=5, arrival=0.0)]
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _tokens(ts) == _tokens(js)
    assert te.profiler.count == je.profiler.count > 0
    count, _ = Met.REGISTRY.histogram_stats("tpushare_engine_step_seconds", pod=pod)
    assert count == te.profiler.count
    assert Met.REGISTRY.gauge_value("tpushare_engine_step_p99_seconds", pod=pod) == \
        te.profiler.p99() > 0
    assert Met.REGISTRY.exemplar("tpushare_engine_step_seconds", pod=pod)
    # a second run exports only its own steps
    te.run(reqs(E))
    assert Met.REGISTRY.histogram_stats("tpushare_engine_step_seconds", pod=pod)[0] == 2 * count


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_governed_engine_tokens_equal_ungoverned_and_reference(models, kind):
    """tests/test_serving_engine.py:572 and test_paged_engine.py:803: a
    governed engine under page severity emits the ungoverned tokens with
    the shape guard unchanged; its governor's ticks equal the
    reference's."""
    mod = JE if kind == "slot" else E
    reqs = lambda mod: mod.poisson_trace(6, seed=5, rate=1.0, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                         max_new=(3, 6))
    plain = _engines(models, kind, **({} if kind == "slot" else dict(total_pages=16)))
    for eng in plain:
        eng.warmup()
    reference = _tokens(plain[1].run(reqs(E)))
    assert reference == _tokens(plain[0].run(reqs(JE)))
    govs = _governors()
    je, te = _engines(models, kind, governors=govs,
                      **({} if kind == "slot" else dict(total_pages=16)))
    je.warmup()
    te.warmup()
    warm = dict(te.trace_counts)
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _tokens(ts) == _tokens(js) == reference
    assert te.trace_counts == warm == dict(js.trace_counts)
    assert govs[1].engaged and govs[1].throttled_steps > 0
    assert govs[1].stats() == govs[0].stats()
    if kind == "paged":
        assert ts.engine_cache["governor"] == js.engine_cache["governor"] == govs[1].stats()
        assert ts.engine_cache == js.engine_cache


def test_paged_drain_mid_throttle_restores_the_ungoverned_tokens(models):
    reqs = lambda mod: mod.poisson_trace(6, seed=5, rate=1.0, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                         max_new=(3, 6))
    plain = _engines(models, "paged", total_pages=16)[1]
    plain.warmup()
    reference = _tokens(plain.run(reqs(E)))
    govs = _governors(throttled_steps_per_s=100.0)
    je, te = _engines(models, "paged", governors=govs, total_pages=16)
    je.warmup()
    te.warmup()
    js, ts = je.run(reqs(JE), drain_at_tick=9), te.run(reqs(E), drain_at_tick=9)
    snap = json.loads(json.dumps(te.drain_snapshot()))
    assert snap == json.loads(json.dumps(je.drain_snapshot()))
    assert snap["requests"] and govs[1].throttled_steps > 0
    assert govs[1].stats() == govs[0].stats()
    restored = plain.restore_snapshot(snap)
    done = {**_tokens(ts), **_tokens(restored)}
    assert done == reference
    assert te.allocator.used_pages == te.radix.cached_pages


# --------------------------------------------------------------------------
# PagedSlotEngine (tests/test_paged_engine.py:257, :366, :763)
# --------------------------------------------------------------------------


def test_paged_preempt_spans_and_tier_summary(models):
    def reqs(mod):
        return [
            mod.Request(rid=0, prompt=tuple(range(5, 13)), max_new=16, arrival=0.0,
                        tier="best_effort", slo_ttft_ticks=500.0, slo_tpot_ticks=500.0),
            mod.Request(rid=1, prompt=tuple(range(20, 26)), max_new=16, arrival=4.0,
                        tier="critical", slo_ttft_ticks=8.0, slo_tpot_ticks=4.0),
        ]

    je, te = _engines(models, "paged", total_pages=8, radix=False)
    je.warmup()
    te.warmup()
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _tokens(ts) == _tokens(js)
    victim = ts.results[0]
    assert victim.preemptions
    for jr, tr_ in zip(js.results, ts.results):
        assert _span_record(Tr.STORE, tr_) == _span_record(JTr.STORE, jr)
    names = [s.name for s in Tr.STORE.trace(victim.trace_id)]
    assert names.count("serve.preempt") == len(victim.preemptions)
    tiers = ts.summary()["tiers"]
    assert tiers == js.summary()["tiers"]
    assert tiers["best_effort"]["preemptions"] == len(victim.preemptions)
    assert tiers["best_effort"]["slo_attainment"] == 1.0


PAGE_FAMILIES = ("tpushare_engine_kv_pages", "tpushare_engine_prefix", "tpushare_engine_preemptions")


@pytest.mark.parametrize("trace", ["shared_prefix", "pressured"])
def test_paged_metrics_published_on_run(models, trace):
    """tests/test_paged_engine.py:366, and a pressured pool that evicts
    and preempts: every page, prefix and preemption line of the pod
    equals the reference's, after one run and after a second."""
    pod = f"ns/serve-{trace}"
    if trace == "shared_prefix":
        geo = dict(slots=3, total_pages=30)
        reqs = lambda mod: mod.shared_prefix_trace(  # noqa: E731
            6, seed=5, rate=0.4, vocab=64, prefixes=(1, 8), tail_lens=(1, 4), max_new=[2, 4])
    else:
        geo = dict(slots=3, total_pages=14)
        reqs = lambda mod: mod.shared_prefix_trace(  # noqa: E731
            12, seed=3, rate=0.6, vocab=64, prefixes=(2, 8), tail_lens=(4, 12), max_new=[6, 12],
            tiers=[("critical", 0.5, 8.0, 4.0), ("best_effort", 0.5, None, None)])
    je, te = _engines(models, "paged", metrics_pod=pod, **geo)
    je.warmup()
    te.warmup()
    for _ in range(2):
        js, ts = je.run(reqs(JE)), te.run(reqs(E))
        assert _tokens(ts) == _tokens(js)
        lines = _pod_lines(Met.REGISTRY.render(), pod, *PAGE_FAMILIES)
        assert lines == _pod_lines(JMet.REGISTRY.render(), pod, *PAGE_FAMILIES)
        assert (te.allocator.alloc_count, te.allocator.free_count_total) == (
            je.allocator.alloc_count, je.allocator.free_count_total)
    text = Met.REGISTRY.render()
    assert f'tpushare_engine_kv_pages_total{{pod="{pod}"}} {geo["total_pages"]}' in text
    assert f'tpushare_engine_prefix_hit_ratio{{pod="{pod}"}}' in text
    count, total = Met.REGISTRY.histogram_stats("tpushare_engine_prefix_hit_tokens", pod=pod)
    assert count >= 1 and total >= 4
    assert Met.REGISTRY.exemplar("tpushare_engine_prefix_hit_tokens", pod=pod)
    if trace == "pressured":
        assert Met.REGISTRY.counter_value("tpushare_engine_preemptions_total", pod=pod) == \
            JMet.REGISTRY.counter_value("tpushare_engine_preemptions_total", pod=pod) > 0
    assert Met.REGISTRY.histogram_stats("tpushare_engine_step_seconds", pod=pod)[0] == \
        te.profiler.count
    prefix_hits = [s for ss in Tr.STORE.snapshot().values() for s in ss
                   if s.name == "serve.prefix_hit"]
    jprefix_hits = [s for ss in JTr.STORE.snapshot().values() for s in ss
                    if s.name == "serve.prefix_hit"]
    assert sorted(tuple(s.attributes.items()) for s in prefix_hits) == sorted(
        tuple(s.attributes.items()) for s in jprefix_hits)


def test_slo_budget_fed_at_retire(models):
    budgets = []
    for slo in (JSlo, Slo):
        t = [0.0]
        budgets.append(slo.SloBudget({tier: slo.SloObjective(tier=tier, goal=0.99)
                                      for tier in ("critical", "best_effort")},
                                     clock=lambda t=t: t[0]))

    def reqs(mod):
        return [
            mod.Request(rid=0, prompt=(5, 6, 7), max_new=4, arrival=0.0, tier="critical",
                        slo_ttft_ticks=1000.0, slo_tpot_ticks=1000.0),
            mod.Request(rid=1, prompt=(8, 9), max_new=4, arrival=0.0, tier="best_effort",
                        slo_ttft_ticks=0.0),
            mod.Request(rid=2, prompt=(10, 11), max_new=3, arrival=0.0, tier="critical"),
        ]

    target = models[0]
    je = JE.PagedSlotEngine(target.jp, target.jcfg, **{**PAGED, "total_pages": 16},
                            slo_budget=budgets[0])
    te = E.PagedSlotEngine(target.tp, target.tcfg, **{**PAGED, "total_pages": 16},
                           slo_budget=budgets[1], device="cpu")
    je.warmup()
    te.warmup()
    assert _tokens(te.run(reqs(E))) == _tokens(je.run(reqs(JE)))
    v = {tier: x.to_dict() for tier, x in budgets[1].evaluate().items()}
    assert v == {tier: x.to_dict() for tier, x in budgets[0].evaluate().items()}
    assert v["critical"]["requests_6h"] == 1 and v["critical"]["burn_6h"] == 0.0
    assert v["best_effort"]["requests_6h"] == 1 and v["best_effort"]["burn_6h"] == 100.0


# --------------------------------------------------------------------------
# speculative decoding (tests/test_paged_engine.py:1027, :1058)
# --------------------------------------------------------------------------


def test_spec_governor_sheds_draft_dispatches_first(models):
    reqs = lambda mod: mod.poisson_trace(6, seed=5, rate=1.0, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                         max_new=(3, 6))
    plain = _engines(models, "paged")[1]
    ref_tokens = _tokens(plain.run(reqs(E)))
    govs = _governors(throttled_steps_per_s=100.0)
    je, te = _engines(models, "paged", draft="indep", governors=govs)
    je.warmup()
    te.warmup()  # runs the draft and verify even while throttled
    assert te.trace_counts == dict(je.trace_counts) == {
        "prefill": 1, "extend": 1, "decode": 1, "draft": 1, "verify": 1}
    warm = dict(te.trace_counts)
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert _tokens(ts) == _tokens(js) == ref_tokens
    assert te.trace_counts == warm
    assert ts.engine_cache["speculative"]["draft_steps"] == 0
    assert ts.engine_cache == js.engine_cache
    assert govs[1].engaged and govs[1].throttled_steps > 0
    assert govs[1].stats() == govs[0].stats()


SPEC_FAMILIES = ("tpushare_engine_spec_",)


@pytest.mark.parametrize("draft", ["self", "indep"])
def test_spec_metrics_published_on_run(models, draft):
    """Spec gauges, delta counters and both acceptance histograms, once per
    run: every line equals the reference's after each of two runs, and
    warmup's draft round publishes nothing."""
    pod = f"ns/spec-{draft}"
    reqs = lambda mod: mod.poisson_trace(4, seed=4, rate=0.5, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                         max_new=(4, 8))
    je, te = _engines(models, "paged", draft=draft, spec_k=4, metrics_pod=pod)
    je.warmup()
    te.warmup()
    assert _pod_lines(Met.REGISTRY.render(), pod, *SPEC_FAMILIES) == []
    for _ in range(2):
        js, ts = je.run(reqs(JE)), te.run(reqs(E))
        assert _tokens(ts) == _tokens(js)
        lines = _pod_lines(Met.REGISTRY.render(), pod, *SPEC_FAMILIES)
        assert lines == _pod_lines(JMet.REGISTRY.render(), pod, *SPEC_FAMILIES)
    text = Met.REGISTRY.render()
    assert f'tpushare_engine_spec_enabled{{pod="{pod}"}} 1' in text
    assert f'tpushare_engine_spec_k{{pod="{pod}"}} 4' in text
    row = parse_engine_metrics(text)[pod]  # the reference's CLI parser
    assert row["spec_enabled"] == 1.0 and row["spec_k"] == 4.0
    # the engine counts across runs; the counter got each run's delta once
    assert row["spec_draft_steps_total"] == ts.engine_cache["speculative"]["draft_steps"] > 0
    assert Met.REGISTRY.histogram_stats("tpushare_engine_spec_acceptance_len", pod=pod)[0] >= 1
    count, total = Met.REGISTRY.histogram_stats("tpushare_engine_spec_accepted_tokens_per_step",
                                                pod=pod)
    assert count >= 1 and total >= 1
    names = lambda store: sorted(s.name for ss in store.snapshot().values() for s in ss  # noqa: E731
                                 if s.name in ("serve.draft", "serve.verify"))
    assert names(Tr.STORE) == names(JTr.STORE) == ["serve.draft"] * 2 + ["serve.verify"] * 2


# --------------------------------------------------------------------------
# multi-LoRA (tests/test_paged_engine.py:1372)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora(models):
    target = models[0]
    jlcfg, tlcfg = JL.LoraConfig(rank=2, alpha=4.0), L.LoraConfig(rank=2, alpha=4.0)
    jstore, tstore = {}, {}
    for i, aid in enumerate(("t0", "t1", "t2")):
        tree = JL.init_lora(jax.random.key(40 + i), target.jcfg, jlcfg)
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        keys = jax.random.split(jax.random.key(40 + i + 10_000), len(leaves))
        jstore[aid] = jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(k, x.shape, x.dtype) * 0.02 for k, x in zip(keys, leaves)])
        tstore[aid] = convert.lora_from_jax_numpy(to_numpy(jstore[aid]), target.tcfg, tlcfg,
                                                  device="cpu")
    return jlcfg, tlcfg, jstore, tstore


ADAPTER_FAMILIES = ("tpushare_engine_adapter_enabled", "tpushare_engine_adapter_resident",
                    "tpushare_engine_adapter_cache_pages", "tpushare_engine_adapter_hits_total",
                    "tpushare_engine_adapter_misses_total",
                    "tpushare_engine_adapter_evictions_total")


@pytest.mark.parametrize("trace", ["reference", "evicting"])
def test_lora_metrics_published_on_run(models, lora, trace):
    """Residency gauges and hit / miss / eviction counters equal the
    reference's after each of two runs; the miss-stall histogram (a
    timing family) counts the same loads. Without radix sharing, which the
    reference does across tenants (``ROADMAP.md`` §3 fault 4)."""
    jlcfg, tlcfg, jstore, tstore = lora
    target = models[0]
    pod = f"ns/lora-{trace}"
    if trace == "reference":
        geo = dict(slots=3, total_pages=32)
        reqs = lambda mod: mod.poisson_trace(5, seed=3, rate=0.5, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                             max_new=(2, 5), adapters=["t0", "t1"])
    else:
        geo = dict(slots=2, total_pages=14)
        reqs = lambda mod: mod.poisson_trace(8, seed=6, rate=0.5, vocab=64, prompt_lens=(2, 6),  # noqa: E731
                                             max_new=(2, 5), adapters=["t0", "t1", "t2", ""])
    kw = {**PAGED, **geo, "radix": False, "metrics_pod": pod}
    je = JE.PagedSlotEngine(target.jp, target.jcfg, **kw, lora_store=jstore, lora_cfg=jlcfg)
    te = E.PagedSlotEngine(target.tp, target.tcfg, **kw, lora_store=tstore, lora_cfg=tlcfg,
                           device="cpu")
    je.warmup()
    te.warmup()
    for _ in range(2):
        js, ts = je.run(reqs(JE)), te.run(reqs(E))
        assert _tokens(ts) == _tokens(js)
        assert ts.engine_cache == js.engine_cache
        lines = _pod_lines(Met.REGISTRY.render(), pod, *ADAPTER_FAMILIES)
        assert lines == _pod_lines(JMet.REGISTRY.render(), pod, *ADAPTER_FAMILIES)
        stall = "tpushare_engine_adapter_miss_stall_seconds"
        assert Met.REGISTRY.histogram_stats(stall, pod=pod)[0] == \
            JMet.REGISTRY.histogram_stats(stall, pod=pod)[0] > 0
    row = parse_engine_metrics(Met.REGISTRY.render())[pod]  # the reference's CLI parser
    assert row["adapter_enabled"] == 1.0 and row["adapter_resident"] >= 1
    assert row["adapter_misses_total"] >= 1 and row["adapter_miss_stall_seconds_count"] >= 1
    if trace == "evicting":
        assert row["adapter_evictions_total"] > 0


# --------------------------------------------------------------------------
# the scrape contract: the reference control plane reads a port pod
# --------------------------------------------------------------------------


def test_reference_scrapers_read_the_port_metrics_server(models):
    target = models[0]
    slot_pod, paged_pod = "scrape/port-slot", "scrape/port-paged"
    slot = E.SlotEngine(target.tp, target.tcfg, **SLOT, metrics_pod=slot_pod, device="cpu")
    paged = E.PagedSlotEngine(target.tp, target.tcfg, **PAGED, metrics_pod=paged_pod,
                              device="cpu")
    reqs = E.poisson_trace(4, seed=2, rate=0.5, vocab=64, prompt_lens=(2, 6), max_new=(3, 6))
    slot.run(reqs)
    paged.run(reqs)
    srv = Met.MetricsServer(host="127.0.0.1", port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        p99s = step_p99s_from_urls([url, "http://127.0.0.1:9/metrics"], timeout_s=5.0)
        # the exposition writes six significant digits (%g)
        assert p99s[slot_pod] == float(f"{slot.profiler.p99():g}") > 0
        assert p99s[paged_pod] == float(f"{paged.profiler.p99():g}") > 0
        with urllib.request.urlopen(f"{url}/metrics", timeout=5) as resp:
            row = parse_engine_metrics(resp.read().decode())[paged_pod]
        assert row["kv_pages_total"] == PAGED["total_pages"]
        assert row["kv_pages_used"] == paged.allocator.used_pages
        assert row["preemptions"] == 0
    finally:
        srv.stop()
