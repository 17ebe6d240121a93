"""The port's ``FleetServer`` (gpushare_device_plugin_tpu_torch/serving/
fleet.py over ``PagedSlotEngine``s) against the reference's, f32 on the
CPU.

On the reference fleet tests' decoder (``tests/test_fleet.py``: 2 layers
at d 32, EOS 3, ``poisson_trace(8, seed=3, ...)``, engines of 2 slots over
16 pages of 4) and on the reference bench's smoke fleet (three engines of
6 slots over a shared-prefix trace), every drill must give exactly the
reference's result doc: per-request tokens, engine, path, ``ttft_ticks``
and ``tpot_ticks``, the shed, dropped and double-served lists, the router
and replica docs and the prefix-hit ratio; and the same ``fleet_doc``,
decision records and router/fleet samples. The drills: a plain serve under
``prefix-affinity`` and under ``spread``, a scale-down on a WAL, an engine
death and a router restart. Every fleet's tokens also equal one unified
engine's, keep the shape guard and return every page. Each side has its
own ``DecisionLog`` and ``MetricsRegistry``.

Fault 7 (``ROADMAP.md`` §3): a LoRA tenant's request that outlives its
engine is re-queued without its adapter in the reference, and decodes
under the base model; the port's re-queue keeps it, on each of the three
re-queue paths, and matches merged-solo (``merge_lora`` + solo
``generate``; greedy tokens equal in f32).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from gpushare_device_plugin_tpu.allocator.assume import AssumeCache as JAssume
from gpushare_device_plugin_tpu.allocator.checkpoint import AllocationCheckpoint as JCkpt
from gpushare_device_plugin_tpu.cli.display import render_fleet
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import fleet as JFl
from gpushare_device_plugin_tpu.serving import router as JR
from gpushare_device_plugin_tpu.utils import decisions as JD
from gpushare_device_plugin_tpu.utils import faults as JF
from gpushare_device_plugin_tpu.utils import metrics as JM
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
from gpushare_device_plugin_tpu_torch.serving import FleetServer
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import fleet as TFl
from gpushare_device_plugin_tpu_torch.serving import router as TR
from gpushare_device_plugin_tpu_torch.utils import decisions as TD
from gpushare_device_plugin_tpu_torch.utils import faults as TF
from gpushare_device_plugin_tpu_torch.utils import metrics as TM
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from test_torch_fleet import fleet_samples, records
from test_torch_lora_serving import Side
from torch_parity import to_numpy

SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
EOS = 3
NODE = "node-fleet"
GUARD = {"prefill": 1, "extend": 1, "decode": 1}
GEO = dict(slots=2, max_len=32, total_pages=16, page_size=4, prefill_chunk=4, eos_id=EOS)
POISSON = dict(n=8, seed=3, rate=0.3, vocab=64, prompt_lens=(2, 10), max_new=[2, 4, 9])
# the reference bench's smoke fleet: capacity covers the trace, so every
# placement is affinity-aware
SHARED_GEO = dict(slots=6, max_len=32, total_pages=48, page_size=4, prefill_chunk=4, eos_id=EOS)
SHARED = dict(n=16, seed=23, rate=0.3, vocab=64, prefixes=(3, 12), tail_lens=(1, 4),
              max_new=[2, 4, 8])

# name -> (engines, geometry, trace, FleetServer kwargs, serve kwargs)
DRILLS = {
    "affinity": (2, GEO, "poisson", {}, {}),
    "spread": (2, GEO, "poisson", {"policy": "spread"}, {}),
    "affinity_shared_prefix": (3, SHARED_GEO, "shared", {}, {}),
    "spread_shared_prefix": (3, SHARED_GEO, "shared", {"policy": "spread"}, {}),
    "scale_down": (3, GEO, "poisson", {"journal": True}, {"scale_down": ("e0", 3)}),
    "kill_engine": (2, GEO, "poisson", {}, {"kill_engine": ("e0", 3)}),
    "restart_router": (2, GEO, "poisson", {}, {"restart_router_after": 4}),
}
PATHS = {"scale_down": {"fleet", "drained", "migrated"}, "kill_engine": {"fleet", "requeued"}}


@pytest.fixture(scope="module")
def model():
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    jp = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu")


def _trace(mod, kind):
    if kind == "poisson":
        return mod.poisson_trace(**POISSON)
    return mod.shared_prefix_trace(**SHARED)


def _serve(model, side, name, tmp_path):
    """One drill on one side: (fleet, result doc, WAL path or None)."""
    jcfg, tcfg, jp, tp = model
    n, geo, trace, fkw, skw = DRILLS[name]
    fkw = dict(fkw)
    ref = side == "ref"
    wal = None
    if fkw.pop("journal", False):
        wal = tmp_path / f"{side}.wal"
        fkw.update(checkpoint=(JCkpt if ref else AllocationCheckpoint)(str(wal)),
                   assume=(JAssume if ref else AssumeCache)())
    if ref:
        engines = {f"e{i}": JE.PagedSlotEngine(jp, jcfg, **geo) for i in range(n)}
        fleet = JFl.FleetServer(engines, node=NODE, decisions=JD.DecisionLog(),
                                registry=JM.MetricsRegistry(), pod="ns/fleet", **fkw)
        out = fleet.serve(_trace(JE, trace), **skw)
    else:
        engines = {f"e{i}": E.PagedSlotEngine(tp, tcfg, **geo, device="cpu") for i in range(n)}
        fleet = TFl.FleetServer(engines, node=NODE, decisions=TD.DecisionLog(),
                                registry=TM.MetricsRegistry(), pod="ns/fleet", **fkw)
        out = fleet.serve(_trace(E, trace), **skw)
    if wal is not None:
        fkw["checkpoint"].close()
    return fleet, out, wal, engines


@pytest.fixture(scope="module")
def reference(model, tmp_path_factory):
    """Each reference drill, built once (its paged engines compile per
    instance)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _serve(model, "ref", name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


def _unified(model, geo, trace):
    _, tcfg, _, tp = model
    eng = E.PagedSlotEngine(tp, tcfg, **{**geo, "slots": 4, "total_pages": 64}, device="cpu")
    return {r.rid: list(r.tokens) for r in eng.run(_trace(E, trace)).results}


@pytest.mark.parametrize("name", list(DRILLS))
def test_fleet_serve_equals_the_reference(model, reference, name, tmp_path):
    jfleet, jout, jwal, _ = reference(name)
    tfleet, tout, twal, engines = _serve(model, "port", name, tmp_path)
    assert tout == jout
    assert tfleet.fleet_doc() == jfleet.fleet_doc()
    assert records(tfleet._decisions) == records(jfleet._decisions)
    assert fleet_samples(tfleet._registry) == fleet_samples(jfleet._registry)
    # the run itself: nothing lost or served twice, the unified engine's
    # tokens, one shape per program, every page home
    n, geo, trace, _, skw = DRILLS[name]
    assert tout["dropped"] == [] and tout["shed"] == [] and tout["double_served"] == []
    assert {rid: e["tokens"] for rid, e in tout["results"].items()} == _unified(model, geo, trace)
    assert {e["path"] for e in tout["results"].values()} <= PATHS.get(name, {"fleet"})
    assert tout["router"]["inflight"] == 0
    for eng in engines.values():  # an engine that served nothing traced nothing
        assert eng.trace_counts in (GUARD, dict.fromkeys(GUARD, 0))
        assert eng.allocator.used_pages == eng.radix.cached_pages
    if name == "scale_down":
        assert "e0" not in tfleet.engines and tfleet.executor.completed_ops == 1
        assert tfleet.executor.migrated_requests >= 1
        assert tout["replicas"]["e0"]["state"] == "dead"
        # the same records as the reference's journal, but for the port's
        # request rows, which carry adapter_id (fault 7)
        assert _journal(twal, strip_adapter=True) == _journal(jwal)
        assert all(r.get("adapter_id") == "" for r in _journal(twal)[1]["rows"])
    elif name == "kill_engine":
        assert "e0" not in tfleet.engines and tout["replicas"]["e0"]["state"] == "dead"
        assert any(e["path"] == "requeued" for e in tout["results"].values())
    elif name.endswith("shared_prefix"):
        assert len({e["engine"] for e in tout["results"].values()}) > 1


def _journal(path, strip_adapter=False):
    """The WAL's begin records' data, in order (rows without adapter_id
    when ``strip_adapter``)."""
    import json

    out = []
    for line in path.read_bytes().splitlines():
        rec = json.loads(line)
        data = rec.get("data")
        if rec.get("op") != "begin" or data is None:
            continue
        if strip_adapter and data.get("rows"):
            data["rows"] = [{k: v for k, v in r.items() if k != "adapter_id"}
                            for r in data["rows"]]
        out.append(data)
    return out


def test_affinity_beats_spread_on_the_shared_prefix_trace(reference, model, tmp_path):
    """The reference bench's gate: affinity's fleet prefix-hit ratio strictly
    above spread's (routing is deterministic, so this checks the router)."""
    _, aff, _, _ = _serve(model, "port", "affinity_shared_prefix", tmp_path)
    _, spr, _, _ = _serve(model, "port", "spread_shared_prefix", tmp_path)
    assert aff["prefix_hit_ratio"] > spr["prefix_hit_ratio"]
    assert aff["router"]["affinity_hits"] > 0
    assert reference("affinity_shared_prefix")[1]["prefix_hit_ratio"] == aff["prefix_hit_ratio"]


def test_the_reference_cli_renders_the_ports_fleet_doc(reference, model, tmp_path):
    jfleet = reference("scale_down")[0]
    tfleet = _serve(model, "port", "scale_down", tmp_path)[0]
    text = render_fleet(tfleet.fleet_doc())
    assert text == render_fleet(jfleet.fleet_doc())
    assert "policy prefix-affinity" in text and "migrated_requests=" in text
    assert all(f"e{i}" in text for i in range(3))


def test_fleet_refuses_an_empty_pool():
    with pytest.raises(ValueError):
        FleetServer({})


# --- fault 7: a LoRA tenant's re-queued row keeps its adapter ---------------


@pytest.fixture(scope="module")
def lora_side():
    return Side(("wq", "wo"))


LORA_GEO = dict(slots=2, max_len=32, total_pages=48, page_size=4, prefill_chunk=4, eos_id=EOS)


def _tenant_trace(mod):
    return [mod.Request(rid=0, prompt=tuple(range(10, 24)), max_new=8, arrival=0.0,
                        adapter_id="t0"),
            mod.Request(rid=1, prompt=tuple(range(30, 37)), max_new=6, arrival=1.0)]


def _lora_fleet(side, which, **kw):
    if which == "ref":
        engines = {f"e{i}": JE.PagedSlotEngine(side.jp, side.jcfg, **LORA_GEO,
                                               lora_store=side.jstore, lora_cfg=side.jlcfg)
                   for i in range(2)}
        return JFl.FleetServer(engines, node=NODE, decisions=JD.DecisionLog(),
                               registry=JM.MetricsRegistry(), **kw)
    engines = {f"e{i}": E.PagedSlotEngine(side.tp, side.tcfg, **LORA_GEO, lora_store=side.tstore,
                                          lora_cfg=side.tlcfg, device="cpu")
               for i in range(2)}
    return TFl.FleetServer(engines, node=NODE, decisions=TD.DecisionLog(),
                           registry=TM.MetricsRegistry(), **kw)


def _requeue_by_kill(side, which, tmp_path):
    """The victim dies mid-decode; the router's table re-queues its rows."""
    fleet = _lora_fleet(side, which)
    return fleet.serve(_tenant_trace(JE if which == "ref" else E), kill_engine=("e0", 7))


def _requeue_by_rollback(side, which, tmp_path):
    """A scale-down dies at ``scale.drain`` and takes its victim with it;
    the reconciler's rollback re-queues the journaled rows on the
    survivor (``scale_requeue``), then the survivor serves its own."""
    R, F = (JR, JF) if which == "ref" else (TR, TF)
    ckpt_cls, assume_cls = (JCkpt, JAssume) if which == "ref" else (AllocationCheckpoint,
                                                                    AssumeCache)
    path = str(tmp_path / f"{which}.wal")
    fleet = _lora_fleet(side, which, checkpoint=ckpt_cls(path), assume=assume_cls())
    with F.FAULTS.injected("scale.drain", "crash", times=1):
        with pytest.raises(F.SimulatedCrash):
            fleet.serve(_tenant_trace(JE if which == "ref" else E), scale_down=("e0", 7))
    fleet.executor._ckpt.abandon()
    fleet.engines.pop("e0")
    fleet._buckets.pop("e0", None)
    fleet.membership.mark_dead("e0")
    ckpt = ckpt_cls(path)
    pending = ckpt.pending()
    outs = [R.resolve_scale(ckpt, assume_cls(), key, data, deliver_fn=fleet.scale_deliver,
                            requeue_fn=fleet.scale_requeue) for key, data in pending.items()]
    assert outs == ["rollback"] and ckpt.pending() == {}
    ckpt.close()
    return fleet.serve([])


def _requeue_released_bucket(side, which, tmp_path):
    """A bucket whose engine was released before it ran (a scale-down raced
    a late bucket) re-queues on the survivors."""
    fleet = _lora_fleet(side, which)
    for r in _tenant_trace(JE if which == "ref" else E):
        fleet._requests[r.rid] = r
        d = fleet.router.route(str(r.rid), r.prompt, r.tier)
        fleet._buckets.setdefault(d.engine, []).append(r)
    assert [r.rid for r in fleet._buckets["e0"]] == [0]
    fleet._release_victim("e0")
    return fleet.serve([])


@pytest.mark.parametrize("path", [_requeue_by_kill, _requeue_by_rollback,
                                  _requeue_released_bucket],
                         ids=["kill_engine", "scale_rollback", "released_bucket"])
def test_fault7_requeued_tenant_rows_keep_their_adapter(lora_side, path, tmp_path):
    """``ROADMAP.md`` §3 fault 7. t0's request is re-queued from e0 onto e1
    by each of the three paths. The reference's row carries no adapter, so
    the request re-prefills and decodes under the base model and leaves
    merged-solo's tokens; the port's keeps its adapter and gives them."""
    side = lora_side
    reqs = _tenant_trace(E)
    want = [side.solo(r) for r in reqs]
    assert [side.solo(r, side="reference") for r in reqs] == want
    assert want[0] != side.base_solo(reqs[0])
    jout = path(side, "ref", tmp_path)
    tout = path(side, "port", tmp_path)
    for out in (jout, tout):
        assert out["dropped"] == [] and out["double_served"] == []
        assert out["results"][0]["path"] == "requeued" and out["results"][0]["engine"] == "e1"
    assert [tout["results"][r.rid]["tokens"] for r in reqs] == want
    # the reference: t0's tokens are the base model's; the base request's right
    assert jout["results"][0]["tokens"] == side.base_solo(reqs[0]) != want[0]
    assert jout["results"][1]["tokens"] == want[1]


def test_fleet_rows_carry_the_adapter_and_the_reference_loads_them(lora_side):
    """The port's request row is the reference's plus ``adapter_id``; the
    reference's re-queue reads such a row (it ignores the key)."""
    fleet = _lora_fleet(lora_side, "port")
    req = _tenant_trace(E)[0]
    row = fleet._row_of(req)
    jrow = _lora_fleet(lora_side, "ref")._row_of(_tenant_trace(JE)[0])
    assert row == {**jrow, "adapter_id": "t0"}
