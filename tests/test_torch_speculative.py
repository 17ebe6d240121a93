"""Speculative decoding's functions in the port (gpushare_device_plugin_tpu_
torch/workloads/generate.py ``paged_verify_block``, ``speculative_generate``,
``make_speculative_generate``; serving/pages.py ``paged_plan_for_slice``
and serving/engine.py ``paged_plan_from_pod_env`` with a draft;
serving/profiler.py's per-step token counts) against the reference's, f32
on the CPU.

Tolerances: the verify block's logits atol 1e-5, and every page but the
scratch page within ``assert_cache_close`` (1e-5, int8 within one
quantization step); its logits at position t equal t sequential
``paged_decode_step`` calls within 1e-5. With adapters (normal x 0.5,
which grow logits and K/V past 1) both are 1e-5 of the largest
magnitude: f32 sums in another order. Tokens, round counts and plans
exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel.podenv import PodTpuEnv as JPod
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import pages as JPG
from gpushare_device_plugin_tpu.serving import profiler as JPR
from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.podenv import PodTpuEnv
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import pages as PG
from gpushare_device_plugin_tpu_torch.serving import profiler as PR
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import assert_cache_close, configs, params_pair, to_numpy, tokens

PS, C, SLOTS, PAGES = 4, 8, 3, 13  # page size, chunk width, rows, physical pages
ROW_PAGES = 4  # a 16-position row span
K = 3  # proposals: a verify block of K + 1 tokens


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _table(*pages):
    out = np.full((ROW_PAGES,), PG.SCRATCH, np.int32)
    out[: len(pages)] = pages
    return out


def _adapter_views(jcfg, tcfg, rows):
    """One adapter on every target (leaves normal x 0.5) striped into slab
    pages 1..; ``rows`` says which rows run it (the others the null
    adapter). Returns the reference's and the port's views and the
    scale."""
    targets = ("wq", "wkv", "wo", "wi", "wdown")
    jlcfg, tlcfg = JL.LoraConfig(rank=2, alpha=4.0, targets=targets), \
        L.LoraConfig(rank=2, alpha=4.0, targets=targets)
    tree = JL.init_lora(jax.random.key(3), jcfg, jlcfg)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(4), len(leaves))
    tree = jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape, x.dtype) * 0.5 for k, x in zip(keys, leaves)])
    flat = np.asarray(JL.flatten_lora(tree, jcfg, jlcfg), np.float32)
    pf = PS * jcfg.d_model
    ppa = -(-flat.size // pf)
    slab = np.zeros((ppa + 1, pf), np.float32)
    slab.reshape(-1)[pf : pf + flat.size] = flat
    tables = np.stack([np.arange(1, ppa + 1) if r else np.zeros(ppa) for r in rows]).astype(np.int32)
    jv = JG.lora_bgmv_views(jnp.asarray(slab), jnp.asarray(tables), jcfg, jlcfg)
    tv = G.lora_bgmv_views(torch.from_numpy(slab), torch.from_numpy(tables), tcfg, tlcfg)
    return jv, tv, tlcfg.scale


@pytest.mark.parametrize("case", ["f32", "int8", "lora"])
def test_paged_verify_block_equals_reference(model, case):
    """Rows 0 and 1 (row 1 over row 0's shared prefix pages) verify a
    K+1-token block through their tables; row 2 idles at ``len ==
    row_span`` on an all-scratch table. Logits and pages against the
    reference, and against K+1 sequential decode steps of the port."""
    jcfg, tcfg, jp, tp = model
    kv_dtype = "int8" if case == "int8" else None
    jc = JG.init_paged_cache(jcfg, SLOTS, PAGES, PS, kv_dtype=kv_dtype)
    tc = G.init_paged_cache(tcfg, SLOTS, PAGES, PS, kv_dtype=kv_dtype, device="cpu")
    prompt = tokens((C,), seed=4)
    jl, jc = JG.paged_prefill_slot(jp, jnp.asarray(prompt), jc, jcfg, slot=0,
                                   page_table=jnp.asarray(_table(9, 3)), n_real=C)
    _, tc = G.paged_prefill_slot(tp, torch.from_numpy(prompt).long(), tc, tcfg, slot=0,
                                 page_table=torch.from_numpy(_table(9, 3)), n_real=C)
    lens = [C, 6, ROW_PAGES * PS]  # row 1 reads 6 positions of row 0's pages
    tables = np.stack([_table(9, 3, 2), _table(9, 12, 7), _table()])
    jc = {**jc, "len": jnp.asarray(lens, jnp.int32)}
    tc = {**tc, "len": torch.tensor(lens, dtype=torch.int32)}
    block = tokens((SLOTS, K + 1), seed=5)
    jkw, tkw = {}, {}
    if case == "lora":
        jv, tv, scale = _adapter_views(jcfg, tcfg, rows=[True, False, True])
        jkw, tkw = dict(lora=jv, lora_scale=scale), dict(lora=tv, lora_scale=scale)
    seq_cache = {k: v.clone() for k, v in tc.items()}
    jl, jc = JG.paged_verify_block(jp, jnp.asarray(block), jc, jcfg,
                                   page_tables=jnp.asarray(tables), **jkw)
    tl, tc = G.paged_verify_block(tp, torch.from_numpy(block).long(), tc, tcfg,
                                  page_tables=torch.from_numpy(tables), **tkw)
    assert tuple(tl.shape) == jl.shape == (SLOTS, K + 1, tcfg.vocab)
    ltol = 1e-5 * (max(float(np.abs(np.asarray(jl)[:2]).max()), 1.0) if case == "lora" else 1.0)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ltol, rtol=0)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == [n + K + 1 for n in lens]
    top = max(float(np.abs(np.asarray(v)).max()) for k, v in jc.items() if k != "len")
    pages = lambda c: {k: v[:, PG.SCRATCH + 1 :] for k, v in c.items() if k != "len"}  # noqa: E731
    assert_cache_close(pages(tc), pages(jc), atol=1e-5 * max(top, 1.0))
    # position t's logits are those of t sequential decode steps
    for t in range(K + 1):
        step, seq_cache = G.paged_decode_step(tp, torch.from_numpy(block[:, t]).long(), seq_cache,
                                              tcfg, page_tables=torch.from_numpy(tables), **tkw)
        np.testing.assert_allclose(step.numpy()[:2], tl.numpy()[:2, t], atol=ltol, rtol=0)
    assert_cache_close(pages(seq_cache), {k: v.numpy() for k, v in pages(tc).items()},
                       atol=1e-5 * max(top, 1.0))


@pytest.fixture(scope="module")
def spec_model():
    """The reference's speculative tests' target and weak draft, and its
    6-token prompt (``tests/test_generate.py``'s spec_setup)."""
    base = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=96)
    draft = {**base, "d_model": 16, "n_heads": 2, "n_kv_heads": 1, "d_ff": 32}
    out = {}
    for name, shape, seed in (("target", base, 0), ("draft", draft, 9)):
        jcfg = JT.TransformerConfig(**shape, compute_dtype=jnp.float32)
        tcfg = T.TransformerConfig(**shape, compute_dtype=torch.float32)
        jp = JT.init_params(jax.random.key(seed), jcfg)
        out[name] = (jcfg, tcfg, jp, convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu"))
    prompt = np.array(JT.demo_batch(jax.random.key(1), 1, 6, base["vocab"]))
    return out, prompt


def _both(spec_model, prompt, draft, **kw):
    """speculative_generate on both sides; returns (reference, port)
    tokens and stats."""
    m, _ = spec_model
    jt, tt = m[draft], m[draft]
    want = JG.speculative_generate(m["target"][2], jt[2], jnp.asarray(prompt), m["target"][0],
                                   jt[0], return_stats=True, **kw)
    got = G.speculative_generate(m["target"][3], tt[3], prompt, m["target"][1], tt[1],
                                 return_stats=True, device="cpu", **kw)
    return (np.asarray(want[0]).tolist(), {k: int(v) for k, v in want[1].items()}), \
        (got[0].tolist(), got[1])


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_weak_draft_equals_reference(spec_model, k):
    """Whatever the draft proposes, the tokens are the target's greedy
    ones: the port's equal the reference's and its ``generate``'s, and so
    do the round counts."""
    m, prompt = spec_model
    want, got = _both(spec_model, prompt, "draft", max_new=12, k=k)
    assert got == want
    greedy = G.generate(m["target"][3], prompt, m["target"][1], max_new=12, device="cpu")
    assert got[0] == greedy.tolist()


@pytest.mark.parametrize("max_new,k", [(10, 4), (13, 3), (9, 1)])
def test_speculative_perfect_draft_round_bound(spec_model, max_new, k):
    """Draft == target accepts every proposal and finishes in
    ceil((max_new - 1) / (k + 1)) rounds, as the reference does: an
    unwritten draft entry after a full acceptance would show here as
    extra rounds while the tokens stay right."""
    _, prompt = spec_model
    want, got = _both(spec_model, prompt, "target", max_new=max_new, k=k)
    assert got == want
    rounds = got[1]["rounds"]
    assert rounds == -(-(max_new - 1) // (k + 1))
    assert got[1]["accepted"] == got[1]["drafted"] == rounds * k


def test_make_speculative_generate_is_the_function(spec_model):
    m, prompt = spec_model
    ref = JG.generate(m["target"][2], jnp.asarray(prompt), m["target"][0], max_new=10)
    gen = G.make_speculative_generate(m["target"][1], m["draft"][1], max_new=10, k=3,
                                      device="cpu")
    assert gen(m["target"][3], m["draft"][3], prompt).tolist() == np.asarray(ref).tolist()


def test_speculative_eos_masking_equals_reference(spec_model):
    m, prompt = spec_model
    want, got = _both(spec_model, prompt, "draft", max_new=10, k=3, eos_id=2)
    assert got == want
    ref = JG.generate(m["target"][2], jnp.asarray(prompt), m["target"][0], max_new=10, eos_id=2)
    assert got[0] == np.asarray(ref).tolist()


def test_speculative_first_token_eos_equals_reference(spec_model):
    """With the first token as EOS, every position after it is EOS, as
    greedy ``generate`` masks it."""
    m, prompt = spec_model
    cache = G.init_cache(m["target"][1], 1, 16, device="cpu")
    logits, _ = G.prefill(m["target"][3], torch.from_numpy(prompt).long(), cache, m["target"][1])
    first = int(torch.argmax(logits, -1)[0])
    want, got = _both(spec_model, prompt, "draft", max_new=8, k=3, eos_id=first)
    assert got == want
    assert got[0][0][prompt.shape[1]:] == [first] * 8


def test_speculative_validation_errors_equal_reference(spec_model):
    m, prompt = spec_model
    bad = dict(vocab=32, d_model=16, n_layers=1, n_heads=2, d_ff=32, max_seq=32)
    cases = [
        (np.ones((2, 4), np.int32), "draft", {}),
        (prompt, "draft", {"k": 0}),
        (prompt, "bad", {}),
    ]
    for p, draft, kw in cases:
        jd = (JT.TransformerConfig(**bad), m["draft"][2]) if draft == "bad" else \
            (m[draft][0], m[draft][2])
        td = (T.TransformerConfig(**bad), m["draft"][3]) if draft == "bad" else \
            (m[draft][1], m[draft][3])
        with pytest.raises(ValueError) as jerr:
            JG.speculative_generate(m["target"][2], jd[1], jnp.asarray(p), m["target"][0], jd[0],
                                    max_new=4, **kw)
        with pytest.raises(ValueError) as terr:
            G.speculative_generate(m["target"][3], td[1], p, m["target"][1], td[0], max_new=4,
                                   device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)


def _plan_cfgs(**kw):
    """tests/test_pages_radix.py's decoder on both sides."""
    return configs(**{"d_model": 32, "d_ff": 64, "max_seq": 64, **kw})


def test_paged_plan_with_draft_equals_reference():
    """The reference's budget sweep with a draft (tests/test_pages_radix.py
    ``test_exact_budget_accounting_sweep_with_draft``) over gang sizes,
    field for field: target and draft weights plus both pools, scratch
    pages included, never exceed the slice, and the draft rides by
    shrinking the page count."""
    jcfg, tcfg = _plan_cfgs()
    for n_kv in (1, 2):
        jd, td = _plan_cfgs(d_model=16, n_layers=1, n_heads=2, n_kv_heads=n_kv, d_ff=32)
        row_b = E.kv_slot_bytes(tcfg, 64)
        w, dw = 3 * row_b, row_b // 2
        for n_chips in (1, 2, 3, 4):
            for budget in range(int(0.5 * row_b), 40 * row_b, row_b // 3):
                for headroom in (1.0, 0.9):
                    kw = dict(page_size=8, prefill_chunk=8, weight_bytes=w, headroom=headroom,
                              draft_weight_bytes=dw, n_chips=n_chips)
                    want = JPG.paged_plan_for_slice(budget, jcfg, 64, draft_cfg=jd, **kw)
                    got = PG.paged_plan_for_slice(budget, tcfg, 64, draft_cfg=td, **kw)
                    assert got.__dict__ == want.__dict__, (budget, kw)
                    if got.total_pages == 0 or n_chips > 1:
                        continue
                    assert got.draft_page_bytes == E.kv_slot_bytes(td, 8)
                    assert got.draft_bytes == (got.total_pages + 1) * got.draft_page_bytes
                    assert w + dw + got.pool_bytes <= int(budget * headroom)
                    bare = PG.paged_plan_for_slice(budget, tcfg, 64, page_size=8,
                                                   prefill_chunk=8, weight_bytes=w,
                                                   headroom=headroom)
                    assert got.total_pages <= bare.total_pages
    # the draft's page bytes shard on a gang when its kv heads divide
    jd, td = _plan_cfgs(d_model=16, n_layers=1, n_kv_heads=2)
    row_b = E.kv_slot_bytes(tcfg, 64)
    kw = dict(page_size=8, prefill_chunk=8, weight_bytes=row_b, draft_weight_bytes=0)
    solo = PG.paged_plan_for_slice(20 * row_b, tcfg, 64, draft_cfg=td, **kw)
    gang = PG.paged_plan_for_slice(20 * row_b, tcfg, 64, draft_cfg=td, n_chips=2, **kw)
    assert gang.draft_page_bytes == -(-solo.draft_page_bytes // 2)
    assert gang.total_pages > solo.total_pages
    for bad in (dict(draft_weight_bytes=-1),):
        with pytest.raises(ValueError) as jerr:
            JPG.paged_plan_for_slice(10**6, jcfg, 64, page_size=8, weight_bytes=0, draft_cfg=jd,
                                     **bad)
        with pytest.raises(ValueError) as terr:
            PG.paged_plan_for_slice(10**6, tcfg, 64, page_size=8, weight_bytes=0, draft_cfg=td,
                                    **bad)
        assert str(terr.value) == str(jerr.value)


def test_paged_plan_from_pod_env_with_draft_equals_reference():
    """A speculative engine's pool from the plugin's env, on a single-chip
    slice and over a gang's per-chip share."""
    jcfg, tcfg = _plan_cfgs()
    jd, td = _plan_cfgs(d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=32)
    envs = [
        {"TPU_VISIBLE_CHIPS": "0", "ALIYUN_COM_TPU_MEM_IDX": "0",
         "ALIYUN_COM_TPU_MEM_CONTAINER": "1", "ALIYUN_COM_TPU_MEM_DEV": "16"},
        {"TPU_VISIBLE_CHIPS": "0,1", "ALIYUN_COM_TPU_GANG_CHIPS": "0,1",
         "ALIYUN_COM_TPU_GANG_SHAPE": "2x1x1", "ALIYUN_COM_TPU_GANG_PER_CHIP": "1",
         "ALIYUN_COM_TPU_MEM_CONTAINER": "2", "ALIYUN_COM_TPU_MEM_DEV": "16"},
    ]
    row_b = E.kv_slot_bytes(tcfg, 64)
    for env in envs:
        for dw in (0, row_b, 1 << 29):
            kw = dict(weight_bytes=4 * row_b, page_size=8, prefill_chunk=8,
                      draft_weight_bytes=dw)
            try:
                want = ("ok", JE.paged_plan_from_pod_env(jcfg, 64, env=JPod.from_env(env),
                                                         draft_cfg=jd, **kw).__dict__)
            except ValueError as e:
                want = ("error", str(e))
            try:
                got = ("ok", E.paged_plan_from_pod_env(tcfg, 64, env=PodTpuEnv.from_env(env),
                                                       draft_cfg=td, **kw).__dict__)
            except ValueError as e:
                got = ("error", str(e))
            assert got == want, (env, dw)
            if got[0] == "ok":
                assert got[1]["draft_bytes"] > 0


def test_profiler_tokens_per_step_equals_reference():
    """Each step's tokens per row: 1 for a plain step, the round's mean
    for a speculative one; the rolling mean over the window."""
    jprof, tprof = JPR.StepProfiler(capacity=3), PR.StepProfiler(capacity=3)
    assert np.isnan(tprof.tokens_per_step()) and np.isnan(jprof.tokens_per_step())
    for seconds, toks in ((0.5, 1.0), (0.25, 4.5), (0.125, 2.0), (0.75, 1.0)):
        jprof.record(seconds, tokens=toks)
        tprof.record(seconds, tokens=toks)
        assert tprof.tokens_per_step() == jprof.tokens_per_step()
        assert tprof.p50() == jprof.p50()
    tprof.record(0.1)
    assert tprof.count == 5
