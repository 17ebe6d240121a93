"""The port's disaggregated serving (gpushare_device_plugin_tpu_torch/
serving/handoff.py ``DisaggServer`` over two ``PagedSlotEngine`` tiers,
and the engine's handoff half) against the reference's, f32 on the CPU.

On the reference's disagg fixture (``tests/test_handoff.py``: the decoder
of 2 layers at d 32, 8 Poisson requests, a prefill tier of 2 slots and a
decode tier of 4, 16 pages each, page size 4, chunk 4) every scenario
must give exactly the reference's per-request tokens, paths and
``ttft_ticks`` / ``tpot_ticks``, the same mover outcomes, ledger and peer
docs, the same ticks and ``cache_stats()`` on both tiers, and (where the
run is journaled) byte-identical WAL files. The scenarios: the live
handoff, a dead transport (``BrokenTransport``), a prefill-tier outage, a
speculative decode tier (imported rows are ``draft_stale``: they never
speculate and never adopt into the radix tree), a page-size mismatch that
degrades to re-prefill, and int8 KV. Every run also equals a unified
engine's tokens, keeps the shape guard, and returns every page.

Fault 6 (``ROADMAP.md`` §3): a LoRA tenant's handed-off row loses its
adapter in the reference's decode tier; the port's keeps it and matches
merged-solo (``merge_lora`` + solo ``generate``; greedy tokens equal in
f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.allocator.assume import AssumeCache as JAssume
from gpushare_device_plugin_tpu.allocator.checkpoint import AllocationCheckpoint as JCkpt
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import handoff as JH
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import handoff as H
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from test_torch_lora_serving import Side
from torch_parity import to_numpy

SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
EOS = 3
NODE = "node-handoff"
GEO = dict(max_len=32, total_pages=16, page_size=4, prefill_chunk=4, eos_id=EOS)
GUARD = {"prefill": 1, "extend": 1, "decode": 1}
TRACE = dict(n=8, seed=3, rate=0.3, vocab=64, prompt_lens=(2, 10), max_new=[2, 4, 9])


@pytest.fixture(scope="module")
def model():
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    jp = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu")


def _engines(model, side, *, decode_kw=None, **kw):
    """(prefill, decode) tiers of one side: 2 and 4 slots, 16 pages each."""
    jcfg, tcfg, jp, tp = model
    dkw = {**kw, **(decode_kw or {})}
    if side == "ref":
        if dkw.pop("spec", False):
            dkw.update(draft_params=jp, draft_cfg=jcfg, spec_k=3)
        return (JE.PagedSlotEngine(jp, jcfg, slots=2, **{**GEO, **kw}),
                JE.PagedSlotEngine(jp, jcfg, slots=4, **{**GEO, **dkw}))
    if dkw.pop("spec", False):
        dkw.update(draft_params=tp, draft_cfg=tcfg, spec_k=3)
    return (E.PagedSlotEngine(tp, tcfg, slots=2, **{**GEO, **kw}, device="cpu"),
            E.PagedSlotEngine(tp, tcfg, slots=4, **{**GEO, **dkw}, device="cpu"))


SCENARIOS = {
    "live": dict(journal=True),
    "broken_transport": dict(broken=True),
    "prefill_down": dict(prefill_down=True),
    "spec_decode_tier": dict(decode_kw={"spec": True}),
    "geometry_mismatch": dict(decode_kw={"page_size": 8, "prefill_chunk": 8}),
    "int8_kv": dict(engine_kw={"kv_dtype": "int8"}),
}


def _serve(model, side, tmp_path, *, journal=False, broken=False, prefill_down=False,
           decode_kw=None, engine_kw=None):
    pre, dec = _engines(model, side, decode_kw=decode_kw, **(engine_kw or {}))
    mods = (JH, JCkpt, JAssume, JE) if side == "ref" else (H, AllocationCheckpoint, AssumeCache, E)
    hmod, ckpt_cls, assume_cls, emod = mods
    kw = {}
    if journal:
        kw.update(checkpoint=ckpt_cls(str(tmp_path / f"{side}.wal"), fsync="always"),
                  assume=assume_cls())
    if broken:
        # a frozen clock: the breaker, once open, stays open (on the wall
        # clock its reset window would fall wherever each side's speed put it)
        kw.update(transport=hmod.BrokenTransport(),
                  peer_kwargs={"attempts": 2, "clock": lambda: 0.0})
    ds = hmod.DisaggServer(pre, dec, node=NODE, **kw)
    ds.warmup()
    warm = (dict(pre.trace_counts), dict(dec.trace_counts))
    out = ds.serve(emod.poisson_trace(**TRACE), prefill_down=prefill_down)
    return ds, out, warm


def _view(ds, out):
    """Everything that must equal the reference's."""
    stats = {k: (None if out[k] is None else (out[k].ticks, out[k].engine_cache))
             for k in ("prefill", "decode")}
    return (out["results"], out["outcomes"], out["dropped"], out["peer"], ds.ledger.doc(),
            stats, ds.ledger.pages_in_flight)


def _unified_tokens(model):
    _, tcfg, _, tp = model
    eng = E.PagedSlotEngine(tp, tcfg, slots=4, **{**GEO, "total_pages": 32}, device="cpu")
    return {r.rid: list(r.tokens) for r in eng.run(E.poisson_trace(**TRACE)).results}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_disagg_server_equals_reference(model, name, tmp_path):
    sc = SCENARIOS[name]
    jds, jout, _ = _serve(model, "ref", tmp_path, **sc)
    tds, tout, warm = _serve(model, "port", tmp_path, **sc)
    assert _view(tds, tout) == _view(jds, jout)
    # the run itself: nothing dropped, the unified engine's tokens, one
    # shape per program, every page home
    assert tout["dropped"] == []
    assert {rid: e["tokens"] for rid, e in tout["results"].items()} == _unified_tokens(model)
    assert (dict(tds.prefill.trace_counts), dict(tds.decode.trace_counts)) == warm
    assert tds.ledger.pages_in_flight == 0
    for eng in (tds.prefill, tds.decode):
        assert eng.allocator.used_pages == eng.radix.cached_pages
    paths = {e["path"] for e in tout["results"].values()}
    if name == "live":
        assert tds.outcomes["delivered"] == 8 and paths == {"handoff"}
        assert tds.mover._ckpt.pending() == {}
        tds.mover._ckpt.close()
        jds.mover._ckpt.close()
        # the same journal records, byte for byte
        assert (tmp_path / "port.wal").read_bytes() == (tmp_path / "ref.wal").read_bytes()
    elif name == "broken_transport":
        assert tds.outcomes == {"fallback": 8} and paths == {"reprefill"}
        assert tout["peer"]["retries"] >= 1
    elif name == "prefill_down":
        assert paths == {"prefill_down"} and tout["prefill"] is None
    elif name == "spec_decode_tier":
        # every row arrived by import and plain-decodes, its pages kept out
        # of the radix tree; only a preempted import, prefilled again on
        # both pools, speculates and adopts its prompt
        assert paths == {"handoff"}
        spec = tout["decode"].engine_cache["speculative"]
        again = [r for r in tout["decode"].results if r.preemptions]
        assert bool(spec["proposed"]) == bool(again)
        assert tds.decode.radix.cached_pages <= sum(r.prompt_len // 4 for r in again)
        assert tds.decode.trace_counts == {**GUARD, "draft": 1, "verify": 1}
    elif name == "geometry_mismatch":
        assert paths == {"reprefill"} and tds.outcomes == {"delivered": 8}
    else:
        assert paths == {"handoff"}


def test_draft_stale_rows_plain_decode_beside_speculating_rows(model, tmp_path):
    """A speculative decode tier serving imported rows and locally
    prefilled ones in one run: the imports stay on the plain decode path
    and out of the radix tree, the re-prefilled rows speculate, and the
    tokens are the unified engine's. The odd rids' handoffs fall back: the
    transport refuses to stage them."""
    _, tcfg, _, tp = model
    pre = E.PagedSlotEngine(tp, tcfg, slots=2, **GEO, device="cpu")
    dec = E.PagedSlotEngine(tp, tcfg, slots=4, **{**GEO, "total_pages": 8}, device="cpu",
                            draft_params=tp, draft_cfg=tcfg, spec_k=3)
    ds = H.DisaggServer(pre, dec, node=NODE)
    reqs = E.poisson_trace(**TRACE)
    flaky = _FailEvery(ds.sink)
    ds.peer._t = flaky
    out = ds.serve(reqs)
    paths = [out["results"][r.rid]["path"] for r in reqs]
    assert {"handoff", "reprefill"} <= set(paths)
    assert {rid: e["tokens"] for rid, e in out["results"].items()} == _unified_tokens(model)
    spec = out["decode"].engine_cache["speculative"]
    assert spec["proposed"] > 0
    # only re-prefilled rows' prompts were adopted into the radix tree
    adopted = sum(len(r.prompt) // GEO["page_size"] for r in reqs
                  if out["results"][r.rid]["path"] == "reprefill")
    assert dec.radix.cached_pages <= adopted
    assert dec.allocator.used_pages == dec.radix.cached_pages


class _FailEvery:
    """A transport whose every other ``stage`` fails for good (the peer's
    retries see the same answer), so those handoffs fall back."""

    def __init__(self, inner):
        self._inner = inner
        self._n = 0

    def stage(self, hid, n_pages, meta):
        if int(hid.rsplit("r", 1)[1]) % 2:
            raise ConnectionError("stage refused")
        return self._inner.stage(hid, n_pages, meta)

    def put_page(self, *a):
        return self._inner.put_page(*a)

    def deliver(self, *a):
        return self._inner.deliver(*a)

    def abort(self, *a):
        return self._inner.abort(*a)


def test_engine_export_carries_the_cache_dtype_and_the_references_meta(model):
    """The prefill tier's export: the reference's request row and meta
    (``kv_dtype`` spelled as the reference spells it), and host pages in the
    cache's own dtype whose wire header equals the reference's and whose
    values are the reference's within 1e-5 (f32 sums in another order)."""
    jpre, _ = _engines(model, "ref")
    tpre, _ = _engines(model, "port")
    got = {}
    for side, eng in (("ref", jpre), ("port", tpre)):
        exports = []
        eng.set_handoff_sink(exports.append)
        eng.run((JE if side == "ref" else E).poisson_trace(**TRACE))
        got[side] = exports
    assert len(got["port"]) == len(got["ref"]) == 8
    for je, te in zip(got["ref"], got["port"]):
        assert te["request"] == je["request"] and te["meta"] == je["meta"]
        assert (te["pos"], te["first_token"], te["first_token_tick"]) == (
            je["pos"], je["first_token"], je["first_token_tick"])
        assert all(isinstance(t, torch.Tensor) for p in te["pages"] for t in p.values())
        for tp_, jp_ in zip(te["pages"], je["pages"]):
            # the same header (keys, dtypes, shapes) and length; the values
            # are the two engines' f32 KV, equal within 1e-5
            tw, jw = H.encode_page(tp_), JH.encode_page(jp_)
            assert len(tw) == len(jw) and tw[:4] == jw[:4]
            assert tw[:4 + int.from_bytes(tw[:4], "little")] == jw[:4 + int.from_bytes(jw[:4], "little")]
            for key, jv in JH.decode_page(jw).items():
                np.testing.assert_allclose(H.decode_page(tw)[key].numpy(), jv, atol=1e-5, rtol=0)


# --- fault 6: a LoRA tenant's handed-off row keeps its adapter ----------------


def _tenant_trace(mod):
    pre = tuple(range(10, 22))
    return [mod.Request(rid=0, prompt=pre + (5, 6), max_new=8, arrival=0.0, adapter_id="t0"),
            mod.Request(rid=1, prompt=tuple(range(40, 53)), max_new=7, arrival=2.0,
                        adapter_id="t1"),
            mod.Request(rid=2, prompt=(30, 31, 32, 33, 34), max_new=6, arrival=4.0)]


@pytest.fixture(scope="module")
def lora_side():
    return Side(("wq", "wo"))


@pytest.mark.parametrize("transport", ["live", "broken"])
def test_fault6_handed_off_tenant_rows_keep_their_adapter(lora_side, transport):
    """``ROADMAP.md`` §3 fault 6. Both tiers hold the same ``lora_store``;
    t0's and t1's requests go through the handoff (imported, or
    re-prefilled when the transport is dead). The reference's decode tier
    builds the request without ``adapter_id``, so the tenants' rows decode
    under the base model and leave merged-solo's tokens; the port's keep
    their adapter, give merged-solo's tokens, and on retire adopt their
    pages into their own adapter's radix tree, never the base model's."""
    side = lora_side
    geo = dict(max_len=32, total_pages=48, page_size=4, prefill_chunk=4, eos_id=EOS)

    def extra(hmod):
        if transport == "live":
            return {}
        return dict(transport=hmod.BrokenTransport(), peer_kwargs={"attempts": 2})

    jpre = JE.PagedSlotEngine(side.jp, side.jcfg, slots=2, **geo, lora_store=side.jstore,
                              lora_cfg=side.jlcfg)
    jdec = JE.PagedSlotEngine(side.jp, side.jcfg, slots=4, **geo, lora_store=side.jstore,
                              lora_cfg=side.jlcfg)
    tpre = E.PagedSlotEngine(side.tp, side.tcfg, slots=2, **geo, lora_store=side.tstore,
                             lora_cfg=side.tlcfg, device="cpu")
    tdec = E.PagedSlotEngine(side.tp, side.tcfg, slots=4, **geo, lora_store=side.tstore,
                             lora_cfg=side.tlcfg, device="cpu")
    jds = JH.DisaggServer(jpre, jdec, node=NODE, **extra(JH))
    tds = H.DisaggServer(tpre, tdec, node=NODE, **extra(H))
    reqs = _tenant_trace(E)
    want = [side.solo(r) for r in reqs]
    assert [side.solo(r, side="reference") for r in reqs] == want
    assert want[0] != side.base_solo(reqs[0]) and want[1] != side.base_solo(reqs[1])
    jout, tout = jds.serve(_tenant_trace(JE)), tds.serve(reqs)
    path = "handoff" if transport == "live" else "reprefill"
    for out in (jout, tout):
        assert [out["results"][r.rid]["path"] for r in reqs] == [path] * 3
    ref = [jout["results"][r.rid]["tokens"] for r in reqs]
    got = [tout["results"][r.rid]["tokens"] for r in reqs]
    assert got == want
    # the reference: the first token (the prefill tier's, under the
    # adapter) is right, the decode tier's are the base model's
    assert ref[0] != want[0] and ref[1] != want[1] and ref[2] == want[2]
    assert ref[0][0] == want[0][0] and ref[1][0] == want[1][0]
    # the port's decode tier: each tenant's prompt pages sit in its own tree
    for r in reqs:
        for aid in ("", "t0", "t1"):
            matched, pages = tdec.radix.match(r.prompt, count=False, adapter_id=aid)
            tdec.allocator.release(pages)
            assert (matched > 0) == (aid == r.adapter_id), (r.rid, aid)
    assert tdec.allocator.used_pages == tdec.radix.cached_pages + tdec.adapters.cached_pages
