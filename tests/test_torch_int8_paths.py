"""int8 weights and the int8 KV cache on every serving path the reference
gives them, in the port (gpushare_device_plugin_tpu_torch: the multi-LoRA
``PagedSlotEngine`` and ``paged_plan_from_pod_env(lora=True)``, the
speculative engine's int8 draft and its draft pool, ``DisaggServer`` and
the wire pages of ``serving/handoff.py``, drain and restore) against the
reference's, f32 on the CPU.

Both sides start from the same float tree (the reference's, crossed by
value) and quantize it with their own ``quantize_decoder``. The decoder is
the reference engine tests' (2 layers, d 32), pages of 4 positions.
Exact: tokens (greedy argmax in f32), ticks, the adapter and speculative
rows of ``cache_stats()``, the plans, the handoff outcomes and paths, each
page's wire length and header, the drained snapshot's rows and the
refusals' messages. The tensor-parallel int8 paged engine is
``tests/test_torch_tp_engine.py``'s ``paged_int8_tp2``. Port-only: the
adapter slab read a layer at a time, and a paged decode step's skip of
idle row blocks.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpushare_device_plugin_tpu.const import MemoryUnit
from gpushare_device_plugin_tpu.parallel.podenv import PodTpuEnv as JPod
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import handoff as JH
from gpushare_device_plugin_tpu.serving import pages as JP
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.mesh import Mesh, MeshSpec
from gpushare_device_plugin_tpu_torch.parallel.podenv import PodTpuEnv
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import handoff as H
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import quant as Q
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from test_torch_lora_serving import rand_lora
from test_torch_pod_sizing import POD_16_OF_79, _8b_param_bytes
from torch_parity import to_numpy

EOS = 3
SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
DRAFT = dict(SHAPE, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=32)
TARGETS = ("wq", "wkv", "wo", "wi", "wdown")
TENANTS = ("t0", "t1", "t2")
GUARD = {"prefill": 1, "extend": 1, "decode": 1}
ENVS = [
    {"TPU_VISIBLE_CHIPS": "0", "ALIYUN_COM_TPU_MEM_IDX": "0",
     "ALIYUN_COM_TPU_MEM_CONTAINER": "1", "ALIYUN_COM_TPU_MEM_DEV": "16"},
    {"TPU_VISIBLE_CHIPS": "0,1", "ALIYUN_COM_TPU_GANG_CHIPS": "0,1",
     "ALIYUN_COM_TPU_GANG_SHAPE": "2x1x1", "ALIYUN_COM_TPU_GANG_PER_CHIP": "1",
     "ALIYUN_COM_TPU_MEM_CONTAINER": "2", "ALIYUN_COM_TPU_MEM_DEV": "16"},
]


class Model:
    """One decoder on both sides, int8: each package's ``quantize_decoder``
    of the same float tree (its first ``layers`` layers when given: an
    early-exit draft of the decoder ``shape`` and ``seed`` draw)."""

    def __init__(self, shape, seed, layers=None):
        self.jcfg = JT.TransformerConfig(**shape, compute_dtype=jnp.float32)
        jp = JT.init_params(jax.random.key(seed), self.jcfg)
        if layers is not None:
            self.jcfg = dataclasses.replace(self.jcfg, n_layers=layers)
            jp = {**jp, "layers": jax.tree_util.tree_map(lambda x: x[:layers], jp["layers"])}
        self.tcfg = T.TransformerConfig(**{**shape, "n_layers": self.jcfg.n_layers},
                                        compute_dtype=torch.float32)
        self.jp = JQ.quantize_decoder(jp)
        self.tp = Q.quantize_decoder(convert.from_jax_numpy(to_numpy(jp), self.tcfg,
                                                            device="cpu"))

    def side(self, side):
        return (self.jp, self.jcfg) if side == "ref" else (self.tp, self.tcfg)


@pytest.fixture(scope="module")
def target():
    return Model(SHAPE, 0)


@pytest.fixture(scope="module")
def draft():
    return Model(DRAFT, 7)


@pytest.fixture(scope="module")
def early_exit():
    """The target's first layer as its draft: it agrees with the target
    often, but not always."""
    return Model(SHAPE, 0, layers=1)


@pytest.fixture(scope="module")
def tenants(target):
    jlcfg = JL.LoraConfig(rank=2, alpha=4.0, targets=TARGETS)
    tlcfg = L.LoraConfig(rank=2, alpha=4.0, targets=TARGETS)
    jstore = {a: rand_lora(target.jcfg, jlcfg, 40 + i) for i, a in enumerate(TENANTS)}
    tstore = {a: convert.lora_from_jax_numpy(to_numpy(t), target.tcfg, tlcfg, device="cpu")
              for a, t in jstore.items()}
    return {"ref": (jstore, jlcfg), "port": (tstore, tlcfg)}


def _mod(side):
    return JE if side == "ref" else E


def _engine(model, side, **kw):
    params, cfg = model.side(side)
    extra = {} if side == "ref" else {"device": "cpu"}
    return _mod(side).PagedSlotEngine(params, cfg, eos_id=EOS, kv_dtype="int8", **kw, **extra)


def _tokens(stats):
    return {r.rid: list(r.tokens) for r in stats.results}


def _leak_free(eng):
    held = eng.radix.cached_pages
    if eng.adapters is not None:
        held += eng.adapters.cached_pages
    return eng.allocator.used_pages == held


# --- plans ------------------------------------------------------------------


def _ref_pod_plan(jcfg, max_len, env, **kw):
    """The reference's plan for a pod's slice: ``paged_plan_for_slice``
    over the bytes its ``paged_plan_from_pod_env`` reads from the env (a
    gang's per-chip share), which ``lora=True`` also reaches there (its
    pod-env entry takes no ``lora``). Raises the port's refusal when the
    plan cannot hold one ``max_len`` row, as both entries do."""
    pod = JPod.from_env(env)
    if pod.is_gang:
        nbytes, n_chips = pod.gang_container_per_chip_bytes(MemoryUnit.GiB), len(pod.gang_chips)
    else:
        nbytes, n_chips = pod.mem_bytes(MemoryUnit.GiB), 1
    plan = JP.paged_plan_for_slice(nbytes, jcfg, max_len, n_chips=n_chips, **kw)
    if plan.total_pages < JP.pages_for(max_len, kw["page_size"]):
        raise ValueError("cannot hold one max_len row")
    return plan


def _llama32_1b(module):
    """Llama-3.2-1B's published shape (chip_smoke's phase 15 draft)."""
    return module.TransformerConfig(vocab=128256, d_model=2048, n_layers=16, n_heads=32,
                                    n_kv_heads=8, d_ff=8192, max_seq=131072, rope_theta=500000.0)


def _int8_bytes_from_shapes(cfg):
    """``param_bytes`` of the port's int8 tree of ``cfg``, on meta tensors."""

    def meta(shapes, name=None):
        if isinstance(shapes, dict):
            return {k: meta(v, k) for k, v in shapes.items()}
        dtype = torch.float32 if name in ("ln1", "ln2", "final_norm") else torch.bfloat16
        return torch.empty(shapes, dtype=dtype, device="meta")

    return Q.param_bytes(Q.quantize_decoder(meta(T.param_shapes(cfg))))


@pytest.mark.parametrize("case", ["lora", "draft", "lora_8b_pod", "draft_8b_pod"])
def test_int8_plans_equal_reference(case, target, draft):
    """``paged_plan_from_pod_env`` with int8 KV and int8 weights' bytes, with
    ``lora=True`` (against the reference's ``paged_plan_for_slice`` over the
    slice its pod-env entry reads) or an int8 draft (against the
    reference's ``paged_plan_from_pod_env``): the small decoder on a
    one-chip slice and a gang's per-chip share at several weight sizes, and
    Llama-3-8B in a 16-GiB pod (chip_smoke's phase 28 (a) at full depth;
    with a Llama-3.2-1B-shaped int8 draft), counted from shapes."""
    if case.endswith("8b_pod"):
        (int8_bytes, _), _ = _8b_param_bytes()
        jcfg, tcfg = JT.llama3_8b(), T.llama3_8b()
        envs, sizes = [POD_16_OF_79], [int8_bytes]
        geo = dict(page_size=16, prefill_chunk=512, slots=16)
        max_len = 2048
        drafts = [(_llama32_1b(T), _llama32_1b(JT), _int8_bytes_from_shapes(_llama32_1b(T)))]
    else:
        jcfg, tcfg = target.jcfg, target.tcfg
        envs = ENVS
        w = Q.param_bytes(target.tp)
        assert w == JQ.param_bytes(target.jp)
        sizes = [w, 1 << 27, 1 << 29]
        geo = dict(page_size=8, prefill_chunk=8)
        max_len = 64
        dw = Q.param_bytes(draft.tp)
        assert dw == JQ.param_bytes(draft.jp)
        drafts = [(draft.tcfg, draft.jcfg, b) for b in (dw, 1 << 26)]
    outcomes = []
    for env in envs:
        for nbytes in sizes:
            kws = [{}] if case.startswith("lora") else drafts
            for extra in kws:
                kw = dict(weight_bytes=nbytes, kv_dtype="int8", **geo)
                pair = []
                for side in ("port", "ref"):
                    try:
                        if case.startswith("lora"):
                            plan = (E.paged_plan_from_pod_env(tcfg, max_len,
                                                              env=PodTpuEnv.from_env(env),
                                                              lora=True, **kw)
                                    if side == "port" else
                                    _ref_pod_plan(jcfg, max_len, env, lora=True, **kw))
                        else:
                            tdc, jdc, db = extra
                            plan = (E.paged_plan_from_pod_env if side == "port" else
                                    JE.paged_plan_from_pod_env)(
                                tcfg if side == "port" else jcfg, max_len,
                                env=(PodTpuEnv if side == "port" else JPod).from_env(env),
                                draft_cfg=tdc if side == "port" else jdc,
                                draft_weight_bytes=db, **kw)
                        pair.append(("ok", dict(plan.__dict__)))
                    except ValueError as e:
                        pair.append(("ValueError", str(e) if not case.startswith("lora")
                                     else "refused"))
                got, want = pair
                if want[0] == "ok":
                    want = ("ok", {k: v for k, v in want[1].items() if k in got[1]})
                assert got == want, (env, nbytes, extra)
                outcomes.append(got)
    planned = [o[1] for o in outcomes if o[0] == "ok"]
    assert planned, outcomes
    for plan in planned:
        assert plan["adapter_bytes" if case.startswith("lora") else "draft_bytes"] > 0
    if case.endswith("8b_pod"):
        # the pod buys more than 8 max_len rows of pages beside its slab or draft
        assert planned[0]["total_pages"] >= 8 * 128


# --- serving paths ----------------------------------------------------------


def _lora_run(model, tenants, side):
    store, lcfg = tenants[side]
    eng = _engine(model, side, slots=3, max_len=32, total_pages=96, page_size=4,
                  prefill_chunk=4, lora_store=store, lora_cfg=lcfg)
    eng.warmup()
    # prompts that share no page across tenants: the reference shares radix
    # pages across adapters (ROADMAP.md §3 fault 4)
    stats = eng.run(_mod(side).poisson_trace(8, seed=7, rate=0.3, vocab=64, prompt_lens=(2, 12),
                                             max_new=[3, 4, 10],
                                             adapters=[*TENANTS, ""]))
    return eng, stats, {"adapters": stats.engine_cache["adapters"]}


def _spec_run(model, draft, side):
    dparams, dcfg = draft.side(side)
    eng = _engine(model, side, slots=2, max_len=32, total_pages=24, page_size=4,
                  prefill_chunk=4, draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    eng.warmup()
    stats = eng.run(_mod(side).poisson_trace(6, seed=9, rate=0.5, vocab=64, prompt_lens=(1, 8),
                                             max_new=(4, 10)))
    return eng, stats, {"speculative": stats.engine_cache["speculative"]}


DISAGG_GEO = dict(max_len=32, total_pages=16, page_size=4, prefill_chunk=4)
DISAGG_TRACE = dict(n=8, seed=3, rate=0.3, vocab=64, prompt_lens=(2, 10), max_new=[2, 4, 9])


def _wire_header(wire):
    (n,) = struct.unpack_from("<I", wire, 0)
    return json.loads(wire[4:4 + n].decode("utf-8"))


def _disagg_run(model, side, monkeypatch, decode_kv="int8"):
    """The reference disagg fixture's two tiers over int8 weights, the
    prefill tier's cache int8 and the decode tier's ``decode_kv``; records
    each delivered page's wire bytes as the decode tier reads them."""
    params, cfg = model.side(side)
    mod, hmod = (JE, JH) if side == "ref" else (E, H)
    extra = {} if side == "ref" else {"device": "cpu"}
    pre = mod.PagedSlotEngine(params, cfg, slots=2, eos_id=EOS, kv_dtype="int8", **DISAGG_GEO,
                              **extra)
    dec = mod.PagedSlotEngine(params, cfg, slots=4, eos_id=EOS, kv_dtype=decode_kv,
                              **DISAGG_GEO, **extra)
    wires = []
    decode = hmod.decode_page

    def recorded(wire):
        wires.append((len(wire), _wire_header(wire)))
        return decode(wire)

    monkeypatch.setattr(hmod, "decode_page", recorded)
    ds = hmod.DisaggServer(pre, dec, node="node-int8")
    ds.warmup()
    out = ds.serve(mod.poisson_trace(**DISAGG_TRACE))
    stats = {k: (out[k].ticks, out[k].engine_cache) for k in ("prefill", "decode")}
    view = {"results": out["results"], "outcomes": out["outcomes"], "dropped": out["dropped"],
            "stats": stats, "in_flight": ds.ledger.pages_in_flight, "wires": wires}
    return ds, out, view


@pytest.mark.parametrize("case", ["lora", "spec", "spec_early_exit_draft", "disagg",
                                  "disagg_float_decode_tier"])
def test_int8_serving_path_equals_reference(case, target, draft, early_exit, tenants,
                                            monkeypatch):
    """(1) Three tenants and base rows in one batch over int8 weights and
    int8 KV: tokens, ticks and the adapter row the reference's, and every
    tenant off the base model somewhere. (2) An int8 target with an int8
    draft (independent, so nearly every proposal is rejected): tokens,
    ticks and the accepted, proposed and rollback counts the reference's;
    with the target's first layer as the draft, some proposals are
    accepted and some rolled back, so verify's int8 codes and scales stay
    for the accepted positions and a round rolls back part-way. (3) ``DisaggServer`` over int8 weights and KV: results, outcomes and
    both tiers' stats the reference's, every page's wire length and header
    equal, and the tokens a unified int8 engine's. (4) A decode tier whose
    cache is not int8 refuses every int8 export as the reference's does:
    the import raises and the row re-prefills there."""
    if case in ("lora", "spec", "spec_early_exit_draft"):
        run = (lambda side: _lora_run(target, tenants, side)) if case == "lora" else \
            (lambda side: _spec_run(target, draft if case == "spec" else early_exit, side))
        (jeng, jstats, jrow), (teng, tstats, trow) = run("ref"), run("port")
        assert _tokens(tstats) == _tokens(jstats)
        assert tstats.ticks == jstats.ticks
        assert trow == jrow
        assert teng.trace_counts == {**GUARD, **({"draft": 1, "verify": 1}
                                                  if case != "lora" else {})}
        assert _leak_free(teng)
        if case == "lora":
            assert trow["adapters"]["misses"] == len(TENANTS)
            base = E.PagedSlotEngine(target.tp, target.tcfg, slots=3, max_len=32,
                                     total_pages=96, page_size=4, prefill_chunk=4, eos_id=EOS,
                                     kv_dtype="int8", device="cpu")
            reqs = E.poisson_trace(8, seed=7, rate=0.3, vocab=64, prompt_lens=(2, 12),
                                   max_new=[3, 4, 10], adapters=[*TENANTS, ""])
            plain = _tokens(base.run([E.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                                                arrival=r.arrival) for r in reqs]))
            got = _tokens(tstats)
            assert {r.adapter_id for r in reqs if got[r.rid] != plain[r.rid]} == set(TENANTS)
            assert all(got[r.rid] == plain[r.rid] for r in reqs if not r.adapter_id)
        else:
            row = trow["speculative"]
            assert row["proposed"] > 0 and row["rollback_pages"] > 0
            if case == "spec_early_exit_draft":
                assert 0 < row["accepted"] < row["proposed"]
        return
    decode_kv = "int8" if case == "disagg" else None
    jds, jout, jview = _disagg_run(target, "ref", monkeypatch, decode_kv)
    tds, tout, tview = _disagg_run(target, "port", monkeypatch, decode_kv)
    assert tview == jview
    assert tout["dropped"] == [] and tds.ledger.pages_in_flight == 0
    for eng in (tds.prefill, tds.decode):
        assert eng.allocator.used_pages == eng.radix.cached_pages
    paths = {e["path"] for rid, e in tout["results"].items()}
    if case == "disagg":
        assert tds.outcomes.get("delivered", 0) == DISAGG_TRACE["n"] and paths == {"handoff"}
        # an int8 page ships its codes and f32 scales: about half a float page
        assert tview["wires"] and {tuple(e[0] for e in h) for _, h in tview["wires"]} == \
            {("k", "k_scale", "v", "v_scale")}
        unified = E.PagedSlotEngine(target.tp, target.tcfg, slots=4, eos_id=EOS,
                                    kv_dtype="int8", **{**DISAGG_GEO, "total_pages": 32},
                                    device="cpu")
        want = _tokens(unified.run(E.poisson_trace(**DISAGG_TRACE)))
        assert {rid: e["tokens"] for rid, e in tout["results"].items()} == want
    else:
        assert tview["wires"] == []  # nothing adopted: the meta check refused first
        assert "handoff" not in paths and "reprefill" in paths


def test_int8_engine_drains_and_restores_as_the_reference(target):
    """An int8 engine drained mid-run and restored on a fresh int8 engine:
    the snapshot's rows and engine doc, the restored tokens and the
    combined tokens (the undrained run's) the reference's; a float
    engine's snapshot is refused by the int8 engine with the reference's
    ``ValueError``."""
    out = {}
    for side in ("ref", "port"):
        mod = _mod(side)
        geo = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4)
        reqs = mod.shared_prefix_trace(6, seed=3, rate=0.4, vocab=64, prefixes=(1, 8),
                                       tail_lens=(1, 4), max_new=[4, 9])
        full = _tokens(_engine(target, side, **geo).run(reqs))
        src = _engine(target, side, **geo)
        part = src.run(reqs, drain_at_tick=14)
        snap = json.loads(json.dumps(src.drain_snapshot()))
        rest = _engine(target, side, **geo).restore_snapshot(snap)
        combined = {**_tokens(part), **_tokens(rest)}
        params, cfg = target.side(side)
        extra = {} if side == "ref" else {"device": "cpu"}
        floating = mod.PagedSlotEngine(params, cfg, eos_id=EOS, **geo, **extra)
        floating.run(reqs, drain_at_tick=14)
        with pytest.raises(ValueError) as err:
            _engine(target, side, **geo).restore_snapshot(floating.drain_snapshot())
        out[side] = (full, snap["engine"], snap["requests"], _tokens(part), _tokens(rest),
                     combined, str(err.value))
    assert out["port"] == out["ref"]
    full, doc, rows, part, rest, combined = out["port"][:6]
    assert doc["kv_dtype"] == "int8" and rows and part and rest
    assert combined == full
    assert "kv_dtype=int8" in out["port"][6]


# --- the adapter views a layer at a time --------------------------------------


def _tp_mesh(tp):
    return Mesh(MeshSpec(tp=tp), rank=0, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})


class _Largest(TorchDispatchMode):
    """The most elements any tensor an op makes holds, while active."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def _striped(cfg, lcfg, store, mesh, tp):
    """Two tenants' flat vectors striped into slab pages (4 positions of
    ``d_model / tp`` floats a page); rows: the second tenant, the null
    adapter, the first. Returns the slab, the tables and the pages an
    adapter takes."""
    pf = 4 * cfg.d_model // tp
    ppa = -(-L.lora_flat_len(cfg, lcfg, mesh) // pf)
    slab = torch.zeros((2 * ppa + 1, pf))
    for i, tree in enumerate(store):
        vec = L.flatten_lora(tree, cfg, lcfg, mesh)
        slab.view(-1)[(1 + i * ppa) * pf:(1 + i * ppa) * pf + vec.numel()] = vec
    tables = torch.tensor([list(range(1 + ppa, 1 + 2 * ppa)), [0] * ppa,
                           list(range(1, 1 + ppa))], dtype=torch.int32)
    return slab, tables, ppa


@pytest.mark.parametrize("tp", [1, 2])
def test_layer_views_are_the_whole_slab_read(target, tenants, tp):
    """``lora_bgmv_views`` reads one layer's slices when a program reaches
    that layer: each layer's (a, b) equal, bit for bit, the same layer of
    one whole read of every row's adapter pages (unflattened), on one chip
    and as a tp rank's view, and a SCRATCH row reads zeros. The guard on
    the transient: on an 8-layer decoder, no tensor a layer's read makes
    holds more than the rows' pages of that layer, under a quarter of
    their whole adapters (a whole read per dispatch, sliced, fails)."""
    store, lcfg = tenants["port"]
    mesh = None if tp == 1 else _tp_mesh(tp)
    deep = dataclasses.replace(target.tcfg, n_layers=8)
    gen = torch.Generator().manual_seed(5)
    deep_store = [{name: {k: torch.randn(shape, generator=gen) for k, shape in shp.items()}
                   for name, shp in L.target_shapes(deep, lcfg).items()} for _ in range(2)]
    for cfg, trees in ((target.tcfg, [store[a] for a in TENANTS[:2]]), (deep, deep_store)):
        slab, tables, ppa = _striped(cfg, lcfg, trees, mesh, tp)
        flat_len = L.lora_flat_len(cfg, lcfg, mesh)
        rows = G.lora_bgmv_views(slab, tables, cfg, lcfg, mesh)
        whole = slab.index_select(0, tables.reshape(-1).long()).reshape(3, -1)[:, :flat_len]
        want = L.unflatten_lora(whole, cfg, lcfg, mesh)
        for i in range(cfg.n_layers):
            with _Largest() as seen:
                got = G._layer_lora(rows, i)
            assert list(got) == list(lcfg.targets)
            for name, (a, b) in got.items():
                assert torch.equal(a, want[name][0][:, i]) and torch.equal(b, want[name][1][:, i])
                assert not a[1].any() and not b[1].any()
            cols = rows.reads[i][0].numel()
            assert seen.numel == 3 * cols * slab.shape[1]
            if cfg is deep:
                # the layer's floats, plus a page where each of its 2 runs a
                # target starts part-way into one
                layer_floats = sum(fi * r + r * fo for fi, r, fo in (
                    (a.shape[1], a.shape[2], b.shape[2]) for a, b in got.values()))
                assert cols <= -(-layer_floats // slab.shape[1]) + 2 * len(got)
                assert 4 * cols < ppa


# --- idle rows of a paged decode step ------------------------------------------


def _one_row_blocks(n_rows, row_elems):
    return [(lo, lo + 1) for lo in range(n_rows)]


def test_idle_row_blocks_are_not_attended(target, monkeypatch):
    """With cache reads a row at a time (a large pool's row blocks, here
    forced), the paged decode step skips the blocks past ``live_rows``:
    the live rows' logits and the pool (but the SCRATCH page idle rows
    write) are those of the step that attends every row, bit for bit; and an int8 engine of 4 slots, which passes
    its highest decoding row, reads fewer blocks and serves the
    reference's tokens."""
    monkeypatch.setattr(G, "_row_blocks", _one_row_blocks)
    params, cfg = target.tp, target.tcfg
    cache = G.init_paged_cache(cfg, 4, 16, 4, kv_dtype="int8", device="cpu")
    tables = torch.zeros((4, 4), dtype=torch.int32)
    for slot, pages in enumerate(([1, 2], [3, 4])):
        prompt = torch.arange(5 + slot, 11 + slot) % cfg.vocab
        tables[slot, :2] = torch.tensor(pages)
        _, cache = G.paged_prefill_slot(params, prompt, cache, cfg, slot=slot,
                                        page_table=tables[slot], n_real=6)
    token = torch.tensor([7, 9, 0, 0])
    out = {}
    for live in (None, 2):
        c = {key: val.clone() for key, val in cache.items()}
        logits, c = G.paged_decode_step(params, token, c, cfg, page_tables=tables,
                                        live_rows=live)
        out[live] = (logits, c)
    assert torch.equal(out[2][0][:2], out[None][0][:2])
    # every page but SCRATCH, where idle rows park their writes
    for key in cache:
        got, want = out[2][1][key], out[None][1][key]
        assert torch.equal(got, want) if key == "len" else torch.equal(got[:, 1:], want[:, 1:])

    gathers = {}
    for skip in (True, False):
        calls = []
        gather = G._gather_paged
        monkeypatch.setattr(G, "_gather_paged", lambda *a: calls.append(1) or gather(*a))
        eng = _engine(target, "port", slots=4, max_len=32, total_pages=40, page_size=4,
                      prefill_chunk=4)
        if not skip:
            decode = eng._decode
            eng._decode = lambda tokens, tables, active, atab=None, live_rows=None: \
                decode(tokens, tables, active, atab)
        reqs = E.poisson_trace(8, seed=11, rate=0.4, vocab=64, prompt_lens=(2, 9),
                               max_new=[3, 12])
        gathers[skip] = (_tokens(eng.run(reqs)), len(calls))
        monkeypatch.setattr(G, "_gather_paged", gather)
    want = _tokens(_engine(target, "ref", slots=4, max_len=32, total_pages=40, page_size=4,
                           prefill_chunk=4).run(JE.poisson_trace(8, seed=11, rate=0.4, vocab=64,
                                                                 prompt_lens=(2, 9),
                                                                 max_new=[3, 12])))
    assert gathers[True][0] == gathers[False][0] == want
    assert gathers[True][1] < gathers[False][1]
