"""Live slice defragmentation, the port against the reference.

The reference's ``tests/test_defrag.py`` runs on each package through
``torch_cluster_mirror`` (every case but the engine-level chaos drill,
which builds a JAX engine), and the wire records (PATCH bodies, pod and
node annotations, the defrag-status document) must be equal. That drill
gets a counterpart here: the port's ``PagedSlotEngine`` (f32, 2 layers,
d 32, on the CPU, the JAX engine's weights through ``from_jax_numpy``)
drains mid-run, its snapshot rides the port's move journal, the mover is
crashed at every move site, and a fresh reconciler resolves the entry;
the combined tokens (pre-drain plus restored) must equal the JAX engine's
undrained run exactly. A ``"move"`` entry journaled by either package
resolves in the other's reconciler as it does in its own.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from gpushare_device_plugin_tpu import const as JConst
from gpushare_device_plugin_tpu.allocator import assume as JA
from gpushare_device_plugin_tpu.allocator import checkpoint as JC
from gpushare_device_plugin_tpu.allocator import defrag as JD
from gpushare_device_plugin_tpu.cluster import apiserver as JApi
from gpushare_device_plugin_tpu.cluster import podsource as JSrc
from gpushare_device_plugin_tpu.cluster import reconciler as JRec
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.utils import faults as JF
from gpushare_device_plugin_tpu.utils import lockrank as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator import assume as TA
from gpushare_device_plugin_tpu_torch.allocator import checkpoint as TC
from gpushare_device_plugin_tpu_torch.allocator import defrag as TD
from gpushare_device_plugin_tpu_torch.cluster import apiserver as TApi
from gpushare_device_plugin_tpu_torch.cluster import pods as P
from gpushare_device_plugin_tpu_torch.cluster import podsource as TSrc
from gpushare_device_plugin_tpu_torch.cluster import reconciler as TRec
from gpushare_device_plugin_tpu_torch.serving import engine as TE
from gpushare_device_plugin_tpu_torch.utils import faults as TF
from gpushare_device_plugin_tpu_torch.utils import lockrank as TL
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

import fake_apiserver
from fake_apiserver import FakeApiServer
from k8s_fixtures import assigned_running_pod
from torch_cluster_mirror import _FastServer, cases, mirror_case

DEFRAG = [
    "test_stranded_units_accounting",
    "test_plan_moves_strictly_improves",
    "test_plan_moves_never_regresses_or_loops",
    "test_plan_moves_respects_excluded_chips",
    "test_planner_counts_gang_usage_on_chips",
    "test_movable_placements_keeps_gangs_whole",
    "test_planner_scan_auto_quantum_and_report",
    "test_planner_outage_keeps_last_stranded_gauges",
    "test_move_completes_end_to_end",
    "test_move_aborts_cleanly_when_plan_raced_reality",
    "test_move_rolls_back_when_pod_deleted_mid_move",
    "test_kill_at_every_move_step",
    "test_move_for_deleted_pod_rolls_back_in_any_phase",
    "test_stale_daemon_cannot_finish_anothers_move",
    "test_live_move_is_claimed_against_concurrent_reconcile",
    "test_move_aborts_when_destination_filled_since_planning",
    "test_resolve_move_restore_failure_leaves_entry_pending",
    "test_status_from_node_coerces_garbled_numerics",
    "test_defrag_loop_heals_stranded_and_publishes_status",
    "test_defrag_loop_excludes_core_held_chips",
    "test_move_aborts_when_destination_core_held_since_scan",
    "test_move_aborts_when_reservation_expired_and_dst_filled_mid_drain",
    "test_pre_switch_gate_renews_a_live_claim",
    "test_switch_rewrites_extender_allocation_map",
    "test_run_once_counts_propagating_failure_in_status",
    "test_fenced_pass_publishes_no_status",
]

NODE = "node-defrag"
CAP = {0: 8, 1: 8}
SITES = ["defrag.plan", "defrag.drain", "defrag.copy", "defrag.switch", "defrag.resume"]
ROLLED_FORWARD = {"defrag.switch", "defrag.resume"}
SNAP = {"requests": [{"rid": 7, "prompt": [1, 2], "tokens": [5]}]}


@pytest.fixture(autouse=True)
def _fast_apiserver_teardown(monkeypatch):
    monkeypatch.setattr(fake_apiserver, "ThreadingHTTPServer", _FastServer)


@pytest.mark.parametrize("name, params", cases("test_defrag", DEFRAG))
def test_defrag_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_defrag", name, params, tmp_path_factory)


def test_move_protocol_constants_are_the_references():
    assert (TD.MOVE_PHASES, TD.MOVE_KIND, TD.DEFRAG_NS) == (
        JD.MOVE_PHASES, JD.MOVE_KIND, JD.DEFRAG_NS)
    assert [p for p in TF.POINTS if p.startswith("defrag.")] == [
        p for p in JF.POINTS if p.startswith("defrag.")] == SITES
    for name in ("defrag.planner", "defrag.moves", "cluster.interference"):
        port, ref = TL.RANKS[name], JL.RANKS[name]
        assert (port.name, port.rank, port.kind, port.io_ok, port.doc) == (
            ref.name, ref.rank, ref.kind, ref.io_ok, ref.doc)
    for name in ("ANN_DEFRAG_STATUS", "ANN_INTERFERENCE", "ANN_EXTENDER_ALLOCATION"):
        assert getattr(const, name) == getattr(JConst, name)
    assert (TD.MOVES_HELP, TD.MOVE_SECONDS_HELP, TD.STRANDED_GAUGE_HELP,
            TD.STRANDED_PCT_GAUGE_HELP) == (JD.MOVES_HELP, JD.MOVE_SECONDS_HELP,
                                            JD.STRANDED_GAUGE_HELP, JD.STRANDED_PCT_GAUGE_HELP)


# --- a move journaled by one package, resolved by the other ------------------

SIDES = {
    "ref": dict(D=JD, A=JA, C=JC, Api=JApi, Src=JSrc, Rec=JRec, F=JF),
    "port": dict(D=TD, A=TA, C=TC, Api=TApi, Src=TSrc, Rec=TRec, F=TF),
}


def _crash_a_move(side, api, path, site):
    """``side``'s mover drains ``mv`` and dies at ``site``; -> the WAL's
    pending records as JSON (what a restart finds on disk)."""
    s = SIDES[side]
    client = s["Api"].ApiServerClient(api.url)
    ckpt = s["C"].AllocationCheckpoint(str(path), fsync="always")
    mover = s["D"].SliceMover(
        client, s["Src"].ApiServerPodSource(client, NODE), s["A"].AssumeCache(), ckpt, NODE,
        lambda: dict(CAP), drain_fn=lambda key: dict(SNAP),
    )
    plan = s["D"].MovePlan(pod=("default", "mv"), src=0, dst=1, units=2)
    with s["F"].FAULTS.injected(site, "crash", times=1):
        with pytest.raises(s["F"].SimulatedCrash):
            mover.execute(plan)
    ckpt.abandon()
    return {k[1]: v for k, v in ckpt.pending().items()}


def _resolve(side, api, path):
    """A fresh incarnation of ``side`` replays the WAL and runs one
    reconcile pass; -> (drift, the restores, the pod's card, what is left
    pending, the ledger)."""
    s = SIDES[side]
    client = s["Api"].ApiServerClient(api.url)
    ckpt = s["C"].AllocationCheckpoint(str(path), fsync="always")
    assume = s["A"].AssumeCache()
    replayed = s["C"].replay_checkpoint(ckpt, assume)
    restores = []
    rec = s["Rec"].DriftReconciler(
        api=client, pod_source=s["Src"].ApiServerPodSource(client, NODE), assume=assume,
        checkpoint=ckpt, node_name=NODE,
        move_restore_fn=lambda k, snap: restores.append((list(k), snap)),
    )
    drift = rec.reconcile_once()
    pod = client.get_pod("default", "mv")
    out = (replayed, drift, restores, P.chip_idx_from_annotation(pod), ckpt.pending(),
           assume.snapshot())
    ckpt.close()
    return out


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_move_journaled_by_one_package_resolves_in_the_other(writer, site, tmp_path):
    resolver = "port" if writer == "ref" else "ref"
    got = {}
    records = {}
    for label, res_side in (("cross", resolver), ("same", writer)):
        api = FakeApiServer()
        api.add_node(NODE)
        api.add_pod(assigned_running_pod("mv", 2, chip_idx=0, node=NODE))
        api.add_pod(assigned_running_pod("anchor", 6, chip_idx=1, node=NODE))
        api.start()
        try:
            path = tmp_path / label / "wal.ckpt"
            path.parent.mkdir()
            records[label] = _crash_a_move(writer, api, path, site)
            got[label] = _resolve(res_side, api, path)
        finally:
            api.stop()
    assert got["cross"] == got["same"]
    replayed, drift, restores, chip, pending, ledger = got["cross"]
    assert replayed == 1 and pending == {} and ledger == ({}, {}, {})
    if site in ROLLED_FORWARD:
        assert drift == {"move_rollforward": 1} and chip == 1
        (key, snap), = restores
        assert key == ["default", "mv"] and snap["requests"] == SNAP["requests"]
        assert snap["snapshot_id"].startswith(f"{NODE}/default.mv#")
    else:
        assert drift == {"move_rollback": 1} and chip == 0 and restores == []
    # the journaled record itself (phase, pod, annotations, snapshot) has
    # the same fields whichever package wrote it
    rec, = records["cross"].values()
    assert rec["kind"] == "move" and rec["phase"] == site.split(".")[1]


def test_both_packages_journal_the_same_move_record(tmp_path):
    """Crashed at ``defrag.resume``, each package's WAL holds one record
    with the same fields and values (the assume time and the journal
    sequence aside)."""
    docs = {}
    for side in ("ref", "port"):
        api = FakeApiServer()
        api.add_node(NODE)
        api.add_pod(assigned_running_pod("mv", 2, chip_idx=0, node=NODE))
        api.start()
        try:
            path = tmp_path / side / "wal.ckpt"
            path.parent.mkdir()
            rec, = _crash_a_move(side, api, path, "defrag.resume").values()
        finally:
            api.stop()
        rec = json.loads(json.dumps(rec))
        rec.pop("_seq", None)
        rec["annotations"].pop(const.ENV_ASSUME_TIME)
        sid = rec["snapshot"].pop("snapshot_id")
        assert sid.startswith(f"{NODE}/default.mv#")
        docs[side] = rec
    assert docs["port"] == docs["ref"]
    assert docs["port"]["annotations"][const.ENV_MEM_IDX] == "1"


# --- the engine-level drill on the port's engine ------------------------------

EOS = 3
SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
ENGINE = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4, eos_id=EOS)
TRACE = dict(seed=11, rate=0.3, vocab=SHAPE["vocab"], prompt_lens=(1, 9), max_new=(2, 10))


@pytest.fixture(scope="module")
def engines():
    """The JAX engine's undrained tokens, and a source and a destination
    port engine on the same weights."""
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    jparams = JT.init_params(jax.random.key(0), jcfg)
    tparams = convert.from_jax_numpy(jax.tree.map(lambda x: x.__array__(), jparams), tcfg,
                                     device="cpu")
    jreqs = JE.poisson_trace(6, **TRACE)
    treqs = TE.poisson_trace(6, **TRACE)
    assert [(r.rid, tuple(r.prompt), r.max_new) for r in treqs] == [
        (r.rid, tuple(r.prompt), r.max_new) for r in jreqs]
    ref = {r.rid: list(r.tokens) for r in JE.PagedSlotEngine(jparams, jcfg, **ENGINE)
           .run(jreqs).results}

    def engine():
        return TE.PagedSlotEngine(tparams, tcfg, device="cpu", **ENGINE)

    return ref, treqs, engine(), engine()


@pytest.mark.parametrize("site", [None, *SITES])
def test_port_engine_move_keeps_the_jax_engines_tokens(site, engines, tmp_path):
    """The port's counterpart of the reference's
    ``test_chaos_move_engine_snapshot_bit_identical``: a move crashed at
    ``site`` (None: never crashed) rolls forward (the destination restores
    the journaled snapshot, and a second delivery serves nothing) or back
    (the source's own snapshot is re-served); every request's combined
    tokens equal the JAX engine's undrained run."""
    ref, reqs, src, dst = engines
    # one pod name a site: the destination engine is shared, and it refuses
    # a snapshot id (node, pod, journal sequence) it already restored
    name = f"mv-{[None, *SITES].index(site)}"
    api = FakeApiServer()
    api.add_node(NODE)
    api.start()
    try:
        api.add_pod(assigned_running_pod(name, 2, chip_idx=0, node=NODE))
        part = src.run(reqs, drain_at_tick=4)
        pre = {r.rid: list(r.tokens) for r in part.results}
        snap = src.drain_snapshot()
        assert snap is not None and snap["requests"], site

        path = tmp_path / "wal.ckpt"
        restored = []
        client = TApi.ApiServerClient(api.url)
        ckpt = TC.AllocationCheckpoint(str(path), fsync="always")
        mover = TD.SliceMover(
            client, TSrc.ApiServerPodSource(client, NODE), TA.AssumeCache(), ckpt, NODE,
            lambda: dict(CAP), drain_fn=lambda key: snap,
            restore_fn=lambda k, s: restored.append(s),
        )
        plan = TD.MovePlan(pod=("default", name), src=0, dst=1, units=2)
        if site is None:
            assert mover.execute(plan) is True
            ckpt.close()
        else:
            with TF.FAULTS.injected(site, "crash", times=1):
                with pytest.raises(TF.SimulatedCrash):
                    mover.execute(plan)
            ckpt.abandon()
            client2 = TApi.ApiServerClient(api.url)
            ckpt2 = TC.AllocationCheckpoint(str(path))
            assume2 = TA.AssumeCache()
            TC.replay_checkpoint(ckpt2, assume2)
            TRec.DriftReconciler(
                api=client2, pod_source=TSrc.ApiServerPodSource(client2, NODE),
                assume=assume2, checkpoint=ckpt2, node_name=NODE,
                move_restore_fn=lambda k, s: restored.append(s),
            ).reconcile_once()
            assert ckpt2.pending() == {}
            ckpt2.close()
        pod = client.get_pod("default", name)
        forward = site is None or site in ROLLED_FORWARD
        assert P.chip_idx_from_annotation(pod) == (1 if forward else 0)
        if forward:
            assert len(restored) == 1
            rest = dst.restore_snapshot(json.loads(json.dumps(restored[0])))
            assert dst.restore_snapshot(restored[0]).results == []  # delivered twice
        else:
            assert restored == []
            rest = dst.restore_snapshot(snap)
        combined = dict(pre)
        for r in rest.results:
            combined[r.rid] = list(r.tokens)
        assert combined == ref, f"site {site}: tokens diverged or requests lost"
    finally:
        TF.FAULTS.clear()
        api.stop()
