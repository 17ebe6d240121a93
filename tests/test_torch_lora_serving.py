"""Multi-LoRA serving in the port (gpushare_device_plugin_tpu_torch:
``transformer._bgmv_delta``, ``generate.lora_bgmv_views`` and the LoRA
threading of the paged programs, ``serving/adapters.py``,
``pages.paged_plan_for_slice(lora=True)``, the ``adapters=`` traces and
the multi-LoRA ``PagedSlotEngine``) against the reference, f32 on the
CPU, on the reference engine tests' decoder (2 layers, d 32).

Tolerances: the BGMV delta in f32 within 1e-6 of the reference's largest
magnitude; in bf16 within one bf16
step of the reference's output plus one of ``x @ A``'s rounding carried
through ``B`` (2^-7 of the reference's largest magnitude); the slab
gather bit for bit; the paged programs' logits atol 1e-5 and pages
within 1e-5 of their largest magnitude (f32 sums in another order over
two layers; the adapters at this scale grow K/V past 1);
with the null adapter, logits exactly the base model's. Serving: tokens
equal (greedy argmax in f32), the ledgers and traces exactly equal.

Adapters are drawn as the reference's engine tests draw them (every leaf
normal), at scale 0.5 rather than their 0.02: at 0.02 the tenants' tokens
equal the base model's on these traces, and a test could not see an
adapter at all.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu import const as JC
from gpushare_device_plugin_tpu.serving import adapters as JA
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import pages as JP
from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import pages as P
from gpushare_device_plugin_tpu_torch.serving.adapters import AdapterCache
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import assert_cache_close, to_numpy, tokens

SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
EOS = 3
ALL = ("wq", "wkv", "wo", "wi", "wdown")
TENANTS = ("t0", "t1", "t2")
SCALE = 0.5
GUARD = {"prefill": 1, "extend": 1, "decode": 1}
TIERS = [("critical", 0.5, 8.0, 4.0), ("best_effort", 0.5, None, None)]
BASE = dict(slots=2, max_len=32, total_pages=48, page_size=4, prefill_chunk=4, eos_id=EOS)


def rand_lora(jcfg, jlcfg, seed, scale=SCALE):
    tree = JL.init_lora(jax.random.key(seed), jcfg, jlcfg)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(seed + 10_000), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape, x.dtype) * scale for k, x in zip(keys, leaves)]
    )


class Side:
    """One LoRA configuration on both sides: configs, params, stores."""

    def __init__(self, targets, tenants=TENANTS, seed0=40):
        self.jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
        self.tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
        self.jlcfg = JL.LoraConfig(rank=2, alpha=4.0, targets=targets)
        self.tlcfg = L.LoraConfig(rank=2, alpha=4.0, targets=targets)
        self.jp = JT.init_params(jax.random.key(0), self.jcfg)
        self.tp = convert.from_jax_numpy(to_numpy(self.jp), self.tcfg, device="cpu")
        self.jstore = {a: rand_lora(self.jcfg, self.jlcfg, seed0 + i) for i, a in enumerate(tenants)}
        self.tstore = {a: convert.lora_from_jax_numpy(to_numpy(t), self.tcfg, self.tlcfg, device="cpu")
                       for a, t in self.jstore.items()}
        self._solo = {}

    def engines(self, **kw):
        geo = {**BASE, **kw}
        return (JE.PagedSlotEngine(self.jp, self.jcfg, **geo, lora_store=self.jstore,
                                   lora_cfg=self.jlcfg),
                self.port(**kw))

    def port(self, **kw):
        return E.PagedSlotEngine(self.tp, self.tcfg, **{**BASE, **kw}, lora_store=self.tstore,
                                 lora_cfg=self.tlcfg, device="cpu")

    def solo(self, req, kv_dtype=None, side="port"):
        """Merged-solo: greedy ``generate`` of ``merge_lora`` of the
        request's adapter (the base weights for ``""``), cut at EOS."""
        key = (side, req.adapter_id, req.prompt, req.max_new, kv_dtype)
        if key not in self._solo:
            if side == "port":
                params = (L.merge_lora(self.tp, self.tstore[req.adapter_id], self.tlcfg)
                          if req.adapter_id else self.tp)
                out = G.generate(params, [list(req.prompt)], self.tcfg, max_new=req.max_new,
                                 eos_id=EOS, kv_dtype=kv_dtype, device="cpu")[0].tolist()
            else:
                params = (JL.merge_lora(self.jp, self.jstore[req.adapter_id], self.jlcfg)
                          if req.adapter_id else self.jp)
                out = np.asarray(JG.generate(params, jnp.asarray(req.prompt)[None], self.jcfg,
                                             max_new=req.max_new, eos_id=EOS,
                                             kv_dtype=kv_dtype))[0].tolist()
            gen = [int(t) for t in out[len(req.prompt):]]
            self._solo[key] = gen[: gen.index(EOS) + 1] if EOS in gen else gen
        return self._solo[key]

    def base_solo(self, req, kv_dtype=None):
        return self.solo(dataclasses.replace(req, adapter_id=""), kv_dtype)


@pytest.fixture(scope="module")
def every_target():
    return Side(ALL)


@pytest.fixture(scope="module")
def default_targets():
    """The reference's default targets (wq, wo), rank 2, alpha 4."""
    return Side(("wq", "wo"))


def _record(stats):
    return [(r.rid, r.tokens, r.first_token_tick, r.admit_tick, r.finish_tick, r.prefix_tokens,
             [{k: v for k, v in p.items() if k.endswith("_tick")} for p in r.preemptions])
            for r in stats.results]


def _leak_free(eng):
    radix = eng.radix.cached_pages if eng.radix is not None else 0
    return eng.allocator.used_pages == radix + eng.adapters.cached_pages


# --- the layer hooks and the slab gather --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bgmv_delta_equals_reference(dtype):
    rng = np.random.RandomState(0)
    x, a, b = rng.randn(3, 5, 48), rng.randn(3, 48, 4), rng.randn(3, 4, 40)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(JT._bgmv_delta(jnp.asarray(x, jdt), jnp.asarray(a, jnp.float32),
                                     jnp.asarray(b, jnp.float32), 2.0, jdt).astype(jnp.float32))
    got = T._bgmv_delta(torch.tensor(x).to(tdt), torch.tensor(a).float(), torch.tensor(b).float(),
                        2.0, tdt)
    assert got.dtype == tdt and got.shape == (3, 5, 40)
    atol = 1e-6 * np.abs(want).max() if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    # a zero adapter gives an exactly-zero delta
    zero = T._bgmv_delta(torch.tensor(x).to(tdt), torch.zeros(3, 48, 4), torch.zeros(3, 4, 40), 2.0, tdt)
    assert not zero.any()


def _slab(side, n_pages=48):
    """A slab whose rows 1.. hold the store's adapters (stripe order), row
    SCRATCH zero; returns (slab, {tenant: pages}) for both sides' use."""
    pf = BASE["page_size"] * SHAPE["d_model"]
    ppa = -(-L.lora_flat_len(side.tcfg, side.tlcfg) // pf)
    slab = np.zeros((n_pages, pf), np.float32)
    pages = {}
    for i, (aid, tree) in enumerate(side.tstore.items()):
        ids = list(range(1 + i * ppa, 1 + (i + 1) * ppa))[::-1]  # not in id order
        flat = np.zeros((ppa * pf,), np.float32)
        vec = L.flatten_lora(tree, side.tcfg, side.tlcfg).numpy()
        flat[: vec.size] = vec
        slab[ids] = flat.reshape(ppa, pf)
        pages[aid] = ids
    return slab, pages, ppa


def stacked_views(rows, n_layers):
    """The port's per-layer reads (``generate._layer_lora``) stacked into
    the reference's ``{target: (a [L, B, fi, r], b [L, B, r, fo])}``."""
    layers = [G._layer_lora(rows, i) for i in range(n_layers)]
    return {name: tuple(torch.stack([layer[name][j] for layer in layers]) for j in (0, 1))
            for name in layers[0]}


def test_bgmv_views_equal_reference(every_target):
    side = every_target
    slab, pages, ppa = _slab(side)
    tables = np.stack([pages["t1"], np.full((ppa,), P.SCRATCH), pages["t0"]]).astype(np.int32)
    want = JG.lora_bgmv_views(jnp.asarray(slab), jnp.asarray(tables), side.jcfg, side.jlcfg)
    rows = G.lora_bgmv_views(torch.from_numpy(slab), torch.from_numpy(tables), side.tcfg,
                             side.tlcfg)
    got = stacked_views(rows, side.tcfg.n_layers)
    assert list(got) == list(ALL)
    for name in ALL:
        for g, w in zip(got[name], want[name]):
            assert tuple(g.shape) == w.shape and np.array_equal(g.numpy(), np.asarray(w)), name
        # row 1 is the null adapter; row 2 holds t0's adapter in its layout
        assert not got[name][0][:, 1].any() and not got[name][1][:, 1].any()
        assert torch.equal(got[name][1][:, 2].reshape(side.tstore["t0"][name]["b"].shape),
                           side.tstore["t0"][name]["b"])


def _views(side, slab, table_rows, module):
    tables = np.stack(table_rows).astype(np.int32)
    if module is G:
        return G.lora_bgmv_views(torch.from_numpy(slab), torch.from_numpy(tables), side.tcfg,
                                 side.tlcfg)
    return JG.lora_bgmv_views(jnp.asarray(slab), jnp.asarray(tables), side.jcfg, side.jlcfg)


def _table(*pages, width=8):
    out = np.full((width,), P.SCRATCH, np.int32)
    out[: len(pages)] = pages
    return out


def test_paged_programs_with_adapters_equal_reference(every_target):
    """Prefill (t0), extend (t1 over t0's shared pages, as a pool would
    never do across tenants but the math allows), and two pool-wide
    decode steps mixing t1, the null adapter and t2: logits and pages
    against the reference; the null adapter's row gives the base model's
    logits exactly."""
    side = every_target
    slab, pages, ppa = _slab(side)
    null = np.full((ppa,), P.SCRATCH)
    scale = side.tlcfg.scale
    n_pages = 17
    jc = JG.init_paged_cache(side.jcfg, 3, n_pages, 4)
    tc = G.init_paged_cache(side.tcfg, 3, n_pages, 4, device="cpu")
    toks = tokens((3, 8), seed=4)

    def both(jfn, tfn, jkw, tkw, rows_j, rows_t):
        nonlocal jc, tc
        jl, jc = jfn(**jkw, lora=_views(side, slab, rows_j, JG), lora_scale=scale)
        tl, tc = tfn(**tkw, lora=_views(side, slab, rows_t, G), lora_scale=scale)
        return jl, tl

    t0 = _table(9, 3)
    jl, tl = both(
        lambda **kw: JG.paged_prefill_slot(side.jp, jnp.asarray(toks[0]), jc, side.jcfg, slot=0,
                                           page_table=jnp.asarray(t0), n_real=8, **kw),
        lambda **kw: G.paged_prefill_slot(side.tp, torch.from_numpy(toks[0]).long(), tc, side.tcfg,
                                          slot=0, page_table=torch.from_numpy(t0), n_real=8, **kw),
        {}, {}, [pages["t0"]], [pages["t0"]])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    t1 = _table(9, 3, 12, 7)
    jl, tl = both(
        lambda **kw: JG.paged_extend_slot(side.jp, jnp.asarray(toks[1]), jc, side.jcfg, slot=1,
                                          page_table=jnp.asarray(t1), pos=8, n_real=5, **kw),
        lambda **kw: G.paged_extend_slot(side.tp, torch.from_numpy(toks[1]).long(), tc, side.tcfg,
                                         slot=1, page_table=torch.from_numpy(t1), pos=8, n_real=5,
                                         **kw),
        {}, {}, [pages["t1"]], [pages["t1"]])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    tables = np.stack([_table(9, 3, 2), t1, _table(5)])
    lens = [8, 13, 2]
    jc = {**jc, "len": jnp.asarray(lens, jnp.int32)}
    tc = {**tc, "len": torch.tensor(lens, dtype=torch.int32)}
    rows = [pages["t1"], null, pages["t2"]]
    for step in range(2):
        tok = tokens((3,), seed=10 + step)
        base_cache = {k: v.clone() for k, v in tc.items()}
        base_logits, _ = G.paged_decode_step(side.tp, torch.from_numpy(tok).long(), base_cache,
                                             side.tcfg, page_tables=torch.from_numpy(tables))
        jl, tl = both(
            lambda **kw: JG.paged_decode_step(side.jp, jnp.asarray(tok), jc, side.jcfg,
                                              page_tables=jnp.asarray(tables), **kw),
            lambda **kw: G.paged_decode_step(side.tp, torch.from_numpy(tok).long(), tc, side.tcfg,
                                             page_tables=torch.from_numpy(tables), **kw),
            {}, {}, rows, rows)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
        assert torch.equal(tl[1], base_logits[1])  # the null adapter: the base model, exactly
        assert not torch.allclose(tl[0], base_logits[0], atol=1e-3)  # an adapter shows
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    top = max(float(np.abs(np.asarray(v)).max()) for k, v in jc.items() if k != "len")
    assert_cache_close({k: v[:, 1:] for k, v in tc.items() if k != "len"},
                       {k: v[:, 1:] for k, v in jc.items() if k != "len"}, atol=1e-5 * max(top, 1.0))


# --- the residency ledger, the plan, the traces --------------------------------


def test_adapter_cache_equals_reference_step_for_step():
    """One scripted sequence of acquire (both tiers), release, evict,
    evictable, clear and stats through the port's AdapterCache and the
    reference's, each over its own allocator: every answer is equal."""
    t_alloc, j_alloc = P.PageAllocator(10), JP.PageAllocator(10)
    port, ref = AdapterCache(t_alloc, 2), JA.AdapterCache(j_alloc, 2)
    crit, be = const.WORKLOAD_LATENCY_CRITICAL, const.WORKLOAD_BEST_EFFORT
    assert (crit, be) == (JC.WORKLOAD_LATENCY_CRITICAL, JC.WORKLOAD_BEST_EFFORT)
    script = [
        ("acquire", "a", crit), ("acquire", "b", be), ("acquire", "a", be), ("release", "a"),
        ("acquire", "c", be), ("release", "b"), ("acquire", "d", crit), ("release", "c"),
        ("evictable", crit), ("evictable", be), ("acquire", "e", be), ("acquire", "f", be),
        ("release", "a"), ("acquire", "f", be), ("evict", 1, be), ("evict", 3, crit),
        ("release", "e"), ("release", "d"), ("evictable", be), ("acquire", "g", crit),
        ("release", "f"), ("release", "g"), ("clear",), ("acquire", "h", crit), ("reset",),
        ("acquire", "h", be), ("release", "h"), ("evict", 0, crit), ("release", "h"),
        ("release", "h"),
    ]
    for op in script:
        out = []
        for cache in (port, ref):
            try:
                if op[0] == "acquire":
                    res = cache.acquire(op[1], tier=op[2])
                elif op[0] == "release":
                    res = cache.release(op[1])
                elif op[0] == "evictable":
                    res = cache.evictable(tier=op[1])
                elif op[0] == "evict":
                    res = cache.evict(op[1], tier=op[2])
                elif op[0] == "clear":
                    res = cache.clear()
                else:
                    res = cache.reset_stats()
            except ValueError as e:
                res = ("raised", str(e))
            out.append((res, cache.stats(), sorted(cache.pages()), cache.hit_ratio(),
                        {a: (cache.pins(a), cache.pages_of(a)) for a in "abcdefgh"}))
        assert out[0] == out[1], op
        assert t_alloc.free_pages == j_alloc.free_pages
    assert out[0][0][0] == "raised"  # the last op: a release of an unpinned adapter
    msgs = []
    for cache in (port, ref):
        with pytest.raises(ValueError) as err:
            cache.acquire("")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="pages_per_adapter"):
        AdapterCache(P.PageAllocator(4), 0)


def test_lora_plan_equals_reference():
    cfg = T.TransformerConfig(vocab=512, d_model=96, n_layers=3, n_heads=6, n_kv_heads=2, d_ff=192,
                              max_seq=256, compute_dtype=torch.float32)
    jcfg = JT.TransformerConfig(vocab=512, d_model=96, n_layers=3, n_heads=6, n_kv_heads=2,
                                d_ff=192, max_seq=256, compute_dtype=jnp.float32)
    row = E.kv_slot_bytes(cfg, 128)
    n = 0
    for mult in (0.7, 3, 11, 40):
        for n_chips in (1, 2, 3, 4):
            for kv_dtype in (None, "int8"):
                for slots in (None, 3):
                    kw = dict(page_size=8, prefill_chunk=16, weight_bytes=2 * row,
                              kv_dtype=kv_dtype, n_chips=n_chips, slots=slots, lora=True)
                    got = P.paged_plan_for_slice(int(mult * row), cfg, 128, **kw)
                    want = JP.paged_plan_for_slice(int(mult * row), jcfg, 128, **kw)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want), (mult, n_chips)
                    assert got.pool_bytes == want.pool_bytes
                    n += got.total_pages > 0
    assert n > 20  # most of the sweep buys pages
    bare = P.paged_plan_for_slice(11 * row, cfg, 128, page_size=8, prefill_chunk=16,
                                  weight_bytes=2 * row)
    lora = P.paged_plan_for_slice(11 * row, cfg, 128, page_size=8, prefill_chunk=16,
                                  weight_bytes=2 * row, lora=True)
    assert bare.adapter_bytes == 0 and lora.total_pages < bare.total_pages
    assert lora.adapter_bytes == (lora.total_pages + 1) * 8 * 96 * 4


def test_adapter_traces_equal_reference():
    fields = ("rid", "prompt", "max_new", "arrival", "tier", "slo_ttft_ticks", "slo_tpot_ticks",
              "adapter_id")
    rows = lambda reqs: [tuple(getattr(r, f) for f in fields) for r in reqs]  # noqa: E731
    kw = dict(seed=4, rate=0.7, vocab=500, max_new=[4, 4, 40])
    for adapters in (None, ["t0", "t1", ""], ["only"]):
        want = JE.poisson_trace(9, **kw, prompt_lens=(2, 9), adapters=adapters)
        got = E.poisson_trace(9, **kw, prompt_lens=(2, 9), adapters=adapters)
        assert rows(got) == rows(want)
        want = JE.shared_prefix_trace(9, **kw, prefixes=(3, 11), tail_lens=(2, 9), tiers=TIERS,
                                      adapters=adapters)
        got = E.shared_prefix_trace(9, **kw, prefixes=(3, 11), tail_lens=(2, 9), tiers=TIERS,
                                    adapters=adapters)
        assert rows(got) == rows(want)
        if adapters == ["t0", "t1", ""]:
            assert len({r.adapter_id for r in got}) == 3


# --- the engine -----------------------------------------------------------------


def test_engine_checks_equal_reference(default_targets):
    side = default_targets
    for kw in (dict(lora_store=side.jstore), dict(lora_cfg=side.jlcfg)):
        with pytest.raises(ValueError) as jerr:
            JE.PagedSlotEngine(side.jp, side.jcfg, **BASE, **kw)
        tkw = {k: (side.tstore if k == "lora_store" else side.tlcfg) for k in kw}
        with pytest.raises(ValueError) as terr:
            E.PagedSlotEngine(side.tp, side.tcfg, **BASE, **tkw, device="cpu")
        assert str(terr.value) == str(jerr.value)
    je, te = side.engines()
    for req in (dict(rid=5, prompt=(1, 2), max_new=1, adapter_id="tenant-x"),
                dict(rid=6, prompt=tuple(range(1, 30)), max_new=8, adapter_id="t0")):
        with pytest.raises(ValueError) as jerr:
            je.validate(JE.Request(**req))
        with pytest.raises(ValueError) as terr:
            te.validate(E.Request(**req))
        assert str(terr.value) == str(jerr.value)
    te.validate(E.Request(rid=7, prompt=(1, 2), max_new=1, adapter_id="t1"))
    assert te.cache_stats()["adapters"] == je.cache_stats()["adapters"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_mixed_tenant_run_equals_merged_solo(every_target, kv_dtype):
    """Three tenants and base rows in one batch, every hook on: each
    request's tokens are merged-solo's, the port's and the reference's;
    every tenant differs from the base model somewhere; the shape guard
    holds; a second run is all hits with the same tokens."""
    side = every_target
    reqs = E.shared_prefix_trace(10, seed=13, rate=0.4, vocab=64, prefixes=(2, 8), tail_lens=(1, 4),
                                 max_new=[2, 6, 10], adapters=[*TENANTS, ""])
    assert {r.adapter_id for r in reqs} == {*TENANTS, ""}
    eng = side.port(slots=3, total_pages=96, kv_dtype=kv_dtype)  # every adapter stays resident
    eng.warmup()
    assert eng.trace_counts == GUARD and eng.cache_stats()["adapters"]["misses"] == 0
    stats = eng.run(reqs)
    differs = set()
    for req, res in zip(reqs, stats.results):
        assert res.tokens == side.solo(req, kv_dtype), (req.rid, req.adapter_id)
        assert res.tokens == side.solo(req, kv_dtype, side="reference"), req.rid
        if req.adapter_id and res.tokens != side.base_solo(req, kv_dtype):
            differs.add(req.adapter_id)
    assert differs == set(TENANTS)
    first = stats.engine_cache["adapters"]
    assert first["misses"] == len(TENANTS) and first["hits"] > 0
    assert eng.trace_counts == GUARD and _leak_free(eng)
    again = eng.run(reqs)
    assert [r.tokens for r in again.results] == [r.tokens for r in stats.results]
    row = again.engine_cache["adapters"]
    assert row["misses"] == first["misses"] and row["hits"] > first["hits"]
    assert eng.trace_counts == GUARD and _leak_free(eng)
    assert again.engine_cache["prefix_hit_requests"] > stats.engine_cache["prefix_hit_requests"]


def test_engine_equals_reference_without_cross_tenant_hits(every_target):
    """A trace whose prompts share no page across tenants: the reference's
    tree keyed by tokens alone and the port's per-adapter trees make the
    same matches, so ticks, tokens and every counter are equal."""
    side = every_target
    kw = dict(n=8, seed=7, rate=0.3, vocab=64, prompt_lens=(1, 9), max_new=(2, 10),
              adapters=[*TENANTS, ""])
    je, te = side.engines(slots=3, total_pages=96)
    je.warmup()
    te.warmup()
    js, ts = je.run(JE.poisson_trace(**kw)), te.run(E.poisson_trace(**kw))
    assert _record(ts) == _record(js) and ts.ticks == js.ticks
    assert ts.engine_cache == js.engine_cache
    assert ts.engine_cache["adapters"]["misses"] == len(TENANTS)
    js, ts = je.run(JE.poisson_trace(**kw)), te.run(E.poisson_trace(**kw))  # warm: hits
    assert _record(ts) == _record(js) and ts.engine_cache == js.engine_cache
    assert te.trace_counts == GUARD and _leak_free(te)


def _fault4_trace(mod):
    pre = tuple(range(10, 22))  # a 12-token prefix, three pages
    return [mod.Request(rid=0, prompt=pre + (5, 6), max_new=6, arrival=0.0, adapter_id="t0"),
            mod.Request(rid=1, prompt=pre + (7, 8, 9), max_new=6, arrival=10.0, adapter_id="t1"),
            mod.Request(rid=2, prompt=pre + (1,), max_new=6, arrival=20.0)]


def test_fault4_prefix_pages_are_shared_only_within_an_adapter(default_targets):
    """``ROADMAP.md`` §3 fault 4: three requests share a 12-token prefix,
    one each for t0, t1 and the base model. The reference's radix tree,
    keyed by tokens alone, hands t1 and the base request the pages t0's
    adapter computed, and their tokens leave merged-solo; the port's
    per-adapter trees match nothing across tenants, and every request is
    merged-solo's. With the radix cache off both engines agree."""
    side = default_targets
    reqs = _fault4_trace(E)
    want = [side.solo(r) for r in reqs]
    assert [side.solo(r, side="reference") for r in reqs] == want
    je, te = side.engines()
    js, ts = je.run(_fault4_trace(JE)), te.run(reqs)
    assert [r.tokens for r in ts.results] == want
    ref = [r.tokens for r in js.results]
    assert ref[0] == want[0] and ref[1] != want[1] and ref[2] != want[2]
    assert [r.prefix_tokens for r in js.results] == [0, 12, 12]
    assert [r.prefix_tokens for r in ts.results] == [0, 0, 0]
    je, te = side.engines(radix=False)
    assert [r.tokens for r in je.run(_fault4_trace(JE)).results] == want
    assert [r.tokens for r in te.run(reqs).results] == want
    # within one adapter the prefix is still shared
    _, te = side.engines()
    same = [dataclasses.replace(r, adapter_id="t1") for r in reqs]
    got = te.run(same)
    assert [r.prefix_tokens for r in got.results] == [0, 12, 12]
    assert [r.tokens for r in got.results] == [side.solo(r) for r in same]


def test_drain_restore_carries_adapter_rows(default_targets):
    """A mixed-tenant run drained mid-decode: the snapshot (equal to the
    reference's) carries each row's ``adapter_id``, the source drops every
    pin, and a fresh engine restores it, through JSON, to the tokens of an
    undrained run; the reference's snapshot restores on the port too."""
    side = default_targets
    reqs = lambda mod: [  # noqa: E731
        mod.Request(rid=0, prompt=tuple(range(1, 7)), max_new=8, arrival=0.0, adapter_id="t0"),
        mod.Request(rid=1, prompt=(7, 8, 9), max_new=8, arrival=0.0, adapter_id="t1"),
        mod.Request(rid=2, prompt=(11, 12), max_new=6, arrival=0.0),
    ]
    ref = {r.rid: r.tokens for r in side.port().run(reqs(E)).results}
    assert ref == {r.rid: side.solo(r) for r in reqs(E)}
    jsrc, tsrc = side.engines()
    jpart, tpart = jsrc.run(reqs(JE), drain_at_tick=3), tsrc.run(reqs(E), drain_at_tick=3)
    tsnap, jsnap = tsrc.drain_snapshot(), jsrc.drain_snapshot()
    assert tsnap == jsnap and tsnap["requests"]
    assert {r["rid"]: r["adapter_id"] for r in tsnap["requests"]} == {0: "t0", 1: "t1", 2: ""}
    assert all(tsrc.adapters.pins(a) == 0 for a in TENANTS) and _leak_free(tsrc)
    for part, snap in ((tpart, tsnap), (jpart, jsnap)):
        dst = side.port()
        rest = dst.restore_snapshot(json.loads(json.dumps(snap)))
        out = {r.rid: r.tokens for r in part.results}
        out.update({r.rid: r.tokens for r in rest.results})
        assert out == ref
        assert dst.trace_counts == GUARD and _leak_free(dst)


def _capped(eng, limit=3000):
    """Fail instead of hanging when a run never ends (the reference can
    cycle under page pressure, ``ROADMAP.md`` §3 fault 2)."""
    calls = []
    for name in ("_prefill", "_extend", "_decode", "_fresh_slot"):
        method = getattr(eng, name)

        def counted(*args, method=method, **kw):
            calls.append(1)
            if len(calls) > limit:
                raise RuntimeError("no end in sight")
            return method(*args, **kw)

        setattr(eng, name, counted)
    return eng


def test_idle_adapters_are_evicted_before_radix_pages(default_targets):
    """Five tenants through one row on a pool that holds two adapters
    beside the row's KV: each new tenant evicts the least recently used
    idle adapter, and KV grants reclaim idle adapters before the radix
    cache's pages. Tokens are merged-solo's and equal the reference's,
    and the pool ends with every page accounted for."""
    side = Side(("wq", "wo"), tenants=("t0", "t1", "t2", "t3", "t4"))
    order = []
    reqs = lambda mod: [  # noqa: E731
        mod.Request(rid=i, prompt=tuple(range(3 + i, 12 + i)), max_new=4, arrival=float(3 * i),
                    adapter_id=f"t{i}") for i in range(5)]
    je, te = side.engines(slots=1, total_pages=18)
    for name in ("adapters", "radix"):
        ledger = getattr(te, name)
        evict = ledger.evict
        ledger.evict = lambda n, *a, _f=evict, _n=name, **kw: (order.append(_n), _f(n, *a, **kw))[1]
    js, ts = je.run(reqs(JE)), te.run(reqs(E))
    assert [r.tokens for r in ts.results] == [side.solo(r) for r in reqs(E)]
    assert _record(ts) == _record(js) and ts.engine_cache == js.engine_cache
    row = ts.engine_cache["adapters"]
    assert row["evictions"] >= 3 and row["misses"] == 5
    assert order and order[0] == "adapters"
    assert ts.engine_cache["prefix_cached_pages"] > 0 and _leak_free(te)


PRESSURED = {
    # the reference cycles on both (fault 2); the port ends
    "cycles": (dict(slots=3, total_pages=20), dict(seed=0)),
    # the reference cycles; the port needs the zero-progress reclaim rung
    # (fault 5) to end
    "wedges": (dict(slots=3, total_pages=16), dict(seed=2)),
}


@pytest.mark.parametrize("case", list(PRESSURED))
def test_pressured_mixed_tenant_runs_end_with_merged_solo_tokens(default_targets, case):
    """Four tenants and base rows, half best-effort, on pools a third the
    size the traffic wants: rows preempt, adapters evict and reload, and
    every request still ends with merged-solo's tokens, the shape guard
    at one shape and the pool's pages all accounted for."""
    side = Side(("wq", "wo"), tenants=("t0", "t1", "t2", "t3"))
    geo, draw = PRESSURED[case]
    kw = dict(n=12, vocab=64, rate=0.6, prefixes=(2, 8), tail_lens=(4, 12), max_new=[6, 12],
              tiers=TIERS, adapters=["t0", "t1", "t2", "t3", ""], **draw)
    with pytest.raises(RuntimeError, match="no end in sight"):
        _capped(side.engines(**geo)[0]).run(JE.shared_prefix_trace(**kw))
    eng = side.port(**geo)
    reqs = E.shared_prefix_trace(**kw)
    stats = _capped(eng).run(reqs)
    assert [r.tokens for r in stats.results] == [side.solo(r) for r in reqs]
    cache = stats.engine_cache
    assert cache["preemptions"] > 0 and cache["adapters"]["evictions"] > 0
    assert eng.trace_counts == GUARD and _leak_free(eng)
    assert all(eng.adapters.pins(a) == 0 for a in side.tstore)


def test_fault5_shielded_idle_adapters_no_longer_wedge_the_pool(default_targets):
    """``ROADMAP.md`` §3 fault 5: two critical tenants leave their
    adapters idle but shielded from best-effort eviction, and a
    best-effort tenant's KV grant finds no page it may reclaim. No row is
    left to preempt, so the reference raises; the port's zero-progress
    turn evicts one idle adapter past the shield, and the request is
    served with merged-solo's tokens."""
    side = default_targets
    reqs = lambda mod: [  # noqa: E731
        mod.Request(rid=0, prompt=tuple(range(1, 7)), max_new=4, arrival=0.0, adapter_id="t0"),
        mod.Request(rid=1, prompt=tuple(range(7, 13)), max_new=4, arrival=20.0, adapter_id="t1"),
        mod.Request(rid=2, prompt=tuple(range(13, 19)), max_new=4, arrival=40.0,
                    tier="best_effort", adapter_id="t2"),
    ]
    je, te = side.engines(slots=1, total_pages=12, radix=False)
    with pytest.raises(RuntimeError, match="paged pool wedged"):
        je.run(reqs(JE))
    stats = te.run(reqs(E))
    assert [r.tokens for r in stats.results] == [side.solo(r) for r in reqs(E)]
    assert stats.engine_cache["adapters"]["evictions"] >= 1 and _leak_free(te)
