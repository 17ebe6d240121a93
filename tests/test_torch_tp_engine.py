"""Tensor-parallel serving in the port (``SlotEngine(mesh=...)`` and
``PagedSlotEngine(mesh=...)`` over a gang's tp mesh, with the sharded
cache, adapter slab and draft pool) on gloo ranks, against the port's
solo engines and the reference's tp engines on host devices: the
reference's ``tests/test_serving_engine.py`` tp tests and
``tests/test_paged_engine.py``'s tp paged, tp restore and
``test_lora_tp2_tokens_identical``, at tp 2 and 4, plus a speculative
engine whose draft pool is sharded and a paged engine whose int8 cache
splits its K, V and scales by kv head.

Two spawns, started together, run every case: two ranks (tp=2) and four
(tp=4). Tolerances: none. f32, so every rank's tokens equal the solo
engine's and the reference tp engine's exactly; the shape guard is the
solo engine's; a rank's cache, slab and draft bytes equal the per-chip
charge of ``kv_slot_bytes`` and ``paged_plan_for_slice(n_chips=tp)``,
and its weight bytes the sum of its shards' sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel.podenv import PodTpuEnv as JPodTpuEnv
from gpushare_device_plugin_tpu.parallel.podenv import gang_mesh as jgang_mesh
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.mesh import Mesh, MeshSpec
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving.pages import paged_plan_for_slice
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

import torch_ranks
from torch_parity import to_numpy

EOS = 3
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
KV4 = dict(BASE, n_kv_heads=4)
DRAFT = dict(BASE, d_model=16, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=32)
LORA = dict(rank=2, alpha=4.0, targets=("wq", "wkv", "wo", "wi", "wdown"))
SLOT_KW = dict(slots=3, max_len=48, prefill_chunk=8, eos_id=EOS)
PAGED_KW = dict(slots=3, max_len=48, total_pages=40, page_size=8, prefill_chunk=8, eos_id=EOS)
POISSON = ("poisson_trace", dict(n=10, seed=7, rate=0.3, vocab=64, prompt_lens=(2, 10),
                                 max_new=[3, 4, 5, 20]))
# Tenants on prompts that share no page: the reference shares radix pages
# across adapters (ROADMAP.md fault 4), so a cross-tenant prefix hit would
# part its tokens from the port's.
TENANTS = ("poisson_trace", dict(n=8, seed=7, rate=0.3, vocab=64, prompt_lens=(2, 12),
                                 max_new=[3, 4, 10], adapters=["t0", "t1", ""]))
SHARED = ("shared_prefix_trace", dict(n=8, seed=7, rate=0.3, vocab=64, prefixes=(1, 8),
                                      tail_lens=(1, 6), max_new=[3, 4, 12]))

# name: (tp, kind, config, params seed, engine kwargs, trace, lora, draft)
CASES = {
    "slot_tp2": (2, "slot", KV4, 1, SLOT_KW, POISSON, False, False),
    "slot_tp4": (4, "slot", KV4, 1, SLOT_KW, POISSON, False, False),
    "slot_int8_tp2": (2, "slot", KV4, 2, dict(SLOT_KW, slots=2, kv_dtype="int8"),
                      ("poisson_trace", dict(n=6, seed=9, rate=0.4, vocab=64, prompt_lens=(2, 8),
                                             max_new=[3, 8])), False, False),
    "slot_replicated_kv_tp4": (4, "slot", BASE, 3, dict(SLOT_KW, slots=2, max_len=32),
                               ("poisson_trace", dict(n=4, seed=5, rate=0.5, vocab=64,
                                                      prompt_lens=(2, 6), max_new=[3, 6])),
                               False, False),
    "paged_tp2": (2, "paged", KV4, 1, PAGED_KW, SHARED, False, False),
    "paged_tp4": (4, "paged", KV4, 1, PAGED_KW, SHARED, False, False),
    "paged_replicated_kv_tp4": (4, "paged", BASE, 1, PAGED_KW, SHARED, False, False),
    "paged_int8_tp2": (2, "paged", KV4, 2, dict(PAGED_KW, kv_dtype="int8"), SHARED, False, False),
    "lora_tp2": (2, "paged", KV4, 1, dict(PAGED_KW, total_pages=64), TENANTS, True, False),
    "lora_tp4": (4, "paged", KV4, 1, dict(PAGED_KW, total_pages=64), TENANTS, True, False),
    "spec_tp2": (2, "paged", KV4, 1, dict(PAGED_KW, spec_k=3), SHARED, False, True),
}


def _jcfg(shape):
    return JT.TransformerConfig(**shape, compute_dtype=jnp.float32)


def _tcfg(shape):
    return T.TransformerConfig(**shape, compute_dtype=torch.float32)


@functools.cache
def _params(shape_items, seed):
    return to_numpy(JT.init_params(jax.random.key(seed), _jcfg(dict(shape_items))))


def _rand_lora(seed, scale=0.5):
    tree = JL.init_lora(jax.random.key(seed), _jcfg(KV4), JL.LoraConfig(**LORA))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(seed + 10_000), len(leaves))
    return to_numpy(jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape, x.dtype) * scale for k, x in zip(keys, leaves)]))


@functools.cache
def _store():
    return {aid: _rand_lora(60 + i) for i, aid in enumerate(("t0", "t1"))}


@functools.cache
def _draft_params():
    return to_numpy(JT.init_params(jax.random.key(11), _jcfg(DRAFT)))


def _job(name):
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    return dict(tp=tp, kind=kind, cfg=shape, params=_params(tuple(shape.items()), seed),
                engine=kw, trace=trace, lora=(LORA, _store()) if lora else None,
                draft=(DRAFT, _draft_params()) if draft else None)


def _port_kw(name):
    """The port's solo engine kwargs of a case (the whole weights)."""
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    tcfg = _tcfg(shape)
    out = dict(kw, device="cpu")
    if lora:
        lcfg = L.LoraConfig(**LORA)
        out.update(lora_cfg=lcfg, lora_store={
            aid: convert.lora_from_jax_numpy(t, tcfg, lcfg, device="cpu")
            for aid, t in _store().items()})
    if draft:
        dcfg = _tcfg(DRAFT)
        out.update(draft_cfg=dcfg, draft_params=convert.from_jax_numpy(_draft_params(), dcfg,
                                                                      device="cpu"))
    params = convert.from_jax_numpy(_params(tuple(shape.items()), seed), tcfg, device="cpu")
    return params, tcfg, out


@functools.cache
def _solo(name):
    """The port's solo engine: tokens, shape guard, cache/slab/draft bytes."""
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    params, tcfg, kw = _port_kw(name)
    eng = (E.SlotEngine if kind == "slot" else E.PagedSlotEngine)(params, tcfg, **kw)
    eng.warmup()
    stats = eng.run(getattr(E, trace[0])(**trace[1]))
    return {"tokens": {r.rid: list(r.tokens) for r in stats.results},
            "after": dict(eng.trace_counts), "cache": torch_ranks.nbytes(eng.cache)}


def _solo_pages():
    """Pages 1-3 of a solo paged engine after the case's run, exported."""
    params, tcfg, kw = _port_kw("paged_tp2")
    eng = E.PagedSlotEngine(params, tcfg, **kw)
    eng.run(E.shared_prefix_trace(**SHARED[1]))
    return [1, 2, 3], eng.export_kv_pages([1, 2, 3])


def _restore_snapshot():
    """A solo paged engine drained at tick 6 (the reference's
    ``test_drain_restore_across_tp2_destination``), its tokens so far, and
    the undrained run's tokens."""
    params, tcfg, kw = _port_kw("paged_tp2")
    reqs = E.shared_prefix_trace(**SHARED[1])
    ref = {r.rid: list(r.tokens) for r in E.PagedSlotEngine(params, tcfg, **kw).run(reqs).results}
    src = E.PagedSlotEngine(params, tcfg, **kw)
    part = src.run(reqs, drain_at_tick=6)
    return src.drain_snapshot(), {r.rid: list(r.tokens) for r in part.results}, ref


@pytest.fixture(scope="module")
def restore():
    return _restore_snapshot()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, restore):
    """Both spawns' results, each rank's by case name, by world size."""
    handles = {}
    for world in (2, 4):
        jobs = [(name, "tp_serve", _job(name)) for name in CASES if CASES[name][0] == world]
        if world == 2:
            snap = restore[0]
            jobs.append(("restore_tp2", "tp_serve", dict(_job("paged_tp2"), snapshot=snap,
                                                         pages=_solo_pages())))
        handles[world] = torch_ranks.start(world, jobs, tmp_path_factory.mktemp(f"tpe{world}"))
    try:
        # The solo engines' and the reference's side (cached for the tests)
        # while the ranks run.
        for name in CASES:
            _solo(name)
            _reference_tp(name)
    finally:
        out = {world: torch_ranks.collect(h) for world, h in handles.items()}
    return out


def _by_rank(ranks, name):
    return ranks[CASES[name][0]] if name in CASES else ranks[2]


@functools.cache
def _reference_tp(name):
    """The reference's tp engine of a case on host devices: tokens by rid."""
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    cfg = _jcfg(shape)
    env = JPodTpuEnv.from_env(torch_ranks.gang_env(tp))
    mesh = jgang_mesh(env, devices=jax.devices()[:tp])
    jkw = dict(kw, mesh=mesh)
    if lora:
        jkw.update(lora_cfg=JL.LoraConfig(**LORA),
                   lora_store={a: jax.tree.map(jnp.asarray, t) for a, t in _store().items()})
    if draft:
        jkw.update(draft_cfg=_jcfg(DRAFT), draft_params=jax.tree.map(jnp.asarray, _draft_params()))
    params = jax.tree.map(jnp.asarray, _params(tuple(shape.items()), seed))
    eng = (JE.SlotEngine if kind == "slot" else JE.PagedSlotEngine)(params, cfg, **jkw)
    eng.warmup()
    stats = eng.run(getattr(JE, trace[0])(**trace[1]))
    return {r.rid: list(r.tokens) for r in stats.results}


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_emits_the_solo_engines_tokens(ranks, name):
    want = _solo(name)["tokens"]
    assert any(len(t) > 1 for t in want.values())
    for r in _by_rank(ranks, name):
        assert r[name]["tokens"] == want


@pytest.mark.parametrize("name", ["slot_tp2", "slot_replicated_kv_tp4", "paged_tp2",
                                  "paged_int8_tp2", "lora_tp2", "spec_tp2"])
def test_every_rank_emits_the_reference_tp_engines_tokens(ranks, name):
    want = _reference_tp(name)
    for r in _by_rank(ranks, name):
        assert r[name]["tokens"] == want


@pytest.mark.parametrize("name", list(CASES))
def test_shape_guard_is_the_solo_engines(ranks, name):
    for r in _by_rank(ranks, name):
        assert r[name]["warm"] == r[name]["after"] == _solo(name)["after"]
        assert set(r[name]["after"].values()) == {1}


def _plan(name):
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    return paged_plan_for_slice(1 << 30, _tcfg(shape), kw["max_len"], page_size=kw["page_size"],
                                prefill_chunk=kw["prefill_chunk"], weight_bytes=0, n_chips=tp,
                                lora=lora, draft_cfg=_tcfg(DRAFT) if draft else None,
                                kv_dtype=kw.get("kv_dtype"))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_the_per_chip_charge(ranks, name):
    tp, kind, shape, seed, kw, trace, lora, draft = CASES[name]
    tcfg = _tcfg(shape)
    mesh = _tp_mesh(tp)
    specs = T.param_shardings(mesh, tcfg)
    weights = sum(int(np.prod(T.local_shape(shp, spec, mesh))) * 4
                  for shp, spec in zip(_leaves(T.param_shapes(tcfg)), _leaves(specs)))
    for r in _by_rank(ranks, name):
        res = r[name]
        assert res["weights"] == weights
        if kind == "slot":
            per = E.kv_slot_bytes(tcfg, kw["max_len"], kw.get("kv_dtype"))
            assert res["cache"] * (tp if tcfg.kv_heads % tp == 0 else 1) == kw["slots"] * per
            continue
        plan = _plan(name)
        assert res["cache"] == (kw["total_pages"] + 1) * plan.page_bytes
        assert res["slab"] == (kw["total_pages"] + 1) * plan.adapter_page_bytes
        assert res["draft"] == (kw["total_pages"] + 1) * plan.draft_page_bytes
        assert res["leak_free"]
        if lora:
            flat = L.lora_flat_len(tcfg, L.LoraConfig(**LORA), mesh)
            row = kw["page_size"] * tcfg.d_model // tp
            assert res["pages_per_adapter"] == -(-flat // row)


def test_a_tp_rank_holds_its_share_of_the_solo_cache(ranks):
    for name in ("slot_tp2", "slot_tp4", "paged_tp2", "paged_tp4"):
        tp = CASES[name][0]
        for r in _by_rank(ranks, name):
            assert r[name]["cache"] * tp == _solo(name)["cache"]


def test_restore_onto_tp2_equals_the_undrained_run(ranks, restore):
    snap, part, ref = restore
    assert snap["requests"]
    for r in ranks[2]:
        assert {**part, **r["restore_tp2"]["tokens"]} == ref


def _tp_mesh(tp):
    """Rank 0 of a tp mesh, with no groups: the spec arithmetic needs only
    its shape."""
    return Mesh(MeshSpec(tp=tp), rank=0, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})


def _leaves(tree):
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]


def test_single_chip_pages_import_as_each_ranks_heads(ranks):
    """A single-chip engine's exported pages (all four kv heads) land in a
    tp=2 rank's pool as that rank's two heads."""
    ids, pages = _solo_pages()
    for rank, r in enumerate(ranks[2]):
        got = r["restore_tp2"]["imported"]
        for mine, whole in zip(got, pages):
            for key in ("k", "v"):
                np.testing.assert_array_equal(mine[key], whole[key][:, :, rank * 2:(rank + 1) * 2])
