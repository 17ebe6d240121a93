"""The sharded extender: the port's against the reference's.

Every case of the reference's ``tests/test_shards.py`` (the ring, the
router's fan-out, the cross-shard gang 2PC with a kill at each of its six
journal steps, fencing, partitions, the webhook front) runs on each
package through ``torch_cluster_mirror`` with equal apiserver records, but
for the threaded churn storm, whose bindings are the scheduler's: it holds
the reference's own audits on the port (the reference's column is
``tests/test_shards.py`` itself, which fails its audit in about one run of
25: the race of ``ROADMAP.md`` §3 fault 9, which the port repairs).

Then the state that crosses packages, both ways: the two rings give every
node of a ``make_cluster`` catalog the same owner; a gang group crashed at
each ``gang2pc.*`` site by one package's shards is resolved by the other's
``resolve_gang2pc`` over the same WALs with no partial gang; the two
routers' ``shards_doc`` are equal on the same inputs. And a churn drill at
the reference bench's ``--scale-smoke`` settings (seed 0, 16 nodes, 1 and 2
shards, 80 events, 4 workers, a gang group every 12 arrivals) over the
port's router: the audits empty and no gang2pc entry left after the
reconciler pass, with the lock witness on.
"""

from __future__ import annotations

import copy
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from torch_cluster_mirror import PORT, REF, cases, load, mirror_case, run_case

NAMES = re.findall(r"^def (test_\w+)",
                   (Path(__file__).parent / "test_shards.py").read_text(), re.M)
THREADED = ["test_concurrent_churn_storm_with_gangs"]
SITES = ["gang2pc.prepare", "gang2pc.reserve", "gang2pc.decide", "gang2pc.patch",
         "gang2pc.commit", "gang2pc.done"]
DECIDED = {"gang2pc.decide", "gang2pc.patch", "gang2pc.commit", "gang2pc.done"}


@pytest.mark.parametrize("name, params",
                         cases("test_shards", [n for n in NAMES if n not in THREADED]))
def test_shards_match_reference(name, params, tmp_path_factory):
    mirror_case("test_shards", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_shards", THREADED))
def test_churn_storm_audits_hold_on_the_port(name, params, tmp_path_factory):
    run_case(PORT, "test_shards", name, params, tmp_path_factory)


def test_mirror_covers_every_reference_case():
    assert len(NAMES) == 30 and load("test_shards", REF).GANG2PC_SITES == SITES


# --- state across packages --------------------------------------------------


def _sim(pkg):
    return importlib.import_module(f"{pkg}.extender.simcluster")


def _shards(pkg):
    return importlib.import_module(f"{pkg}.extender.shards")


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_rings_give_every_node_the_same_owner(n_shards):
    ref_nodes = _sim(REF).make_cluster(1000, seed=0)
    port_nodes = _sim(PORT).make_cluster(1000, seed=0)
    assert port_nodes == ref_nodes  # the same draws: the same catalog
    names = [n["metadata"]["name"] for n in ref_nodes]
    ids = [f"shard-{i}" for i in range(n_shards)]
    ref_ring, port_ring = _shards(REF).HashRing(ids), _shards(PORT).HashRing(ids)
    owners = [port_ring.owner(n) for n in names]
    assert owners == [ref_ring.owner(n) for n in names]
    assert len(set(owners)) == n_shards
    assert port_ring.doc(names) == ref_ring.doc(names)
    assert _shards(PORT)._h64("gang/xg") == _shards(REF)._h64("gang/xg")


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("crash_pkg, resolve_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["reference-crashes", "port-crashes"])
def test_gang2pc_crash_resolves_in_the_other_package(tmp_path, site, crash_pkg, resolve_pkg):
    """One package's shards die at ``site`` in a cross-shard gang group;
    the other package's shards, rebuilt over the same WAL files and
    apiserver, resolve it: forward from a durable decision, back before
    one, no partial gang, ledgers and journals drained."""
    a, b = load("test_shards", crash_pkg), load("test_shards", resolve_pkg)
    with a.cross_shard_group_env(tmp_path) as env:
        pods = a.make_group(env, "xg-cross", n_members=2)
        with a.FAULTS.injected(site, "crash", times=1):
            with pytest.raises(a.SimulatedCrash):
                env.router.admit_gang_group(pods)
        for ck in env.ckpts:
            ck.abandon()
        client = b.ApiServerClient(env.api.url)
        informer = b.PodInformer(client).start(sync_timeout_s=30)
        try:
            other = SimpleNamespace(api=env.api, client=client, informer=informer,
                                    nodes=env.nodes, tmp=tmp_path, n_shards=env.n_shards,
                                    fanout=env.fanout, wal=True, lease=b.LeaderLease())
            b._build_shards(other)
            pending = sum(len(s.twopc_pending()) for s in other.shards)
            # "done" fires after the decision resolved: nothing left to do
            assert (pending == 0) == (site == "gang2pc.done"), pending
            b.resolve_gang2pc(other.shards, client, lease=other.lease)
            states = b.group_states(client, "xg-cross")
            if site in DECIDED:
                assert states and all(states), f"{site}: decision did not roll forward"
            else:
                assert not any(states), f"{site}: undecided prepare rolled forward"
            b.assert_2pc_drained(other)
            assert b.S.audit_cluster(env.nodes, client.list_pods()) == []
        finally:
            informer.stop()


def _shards_doc_after_admissions(pkg, tmp_path):
    mod = load("test_shards", pkg)
    with mod.cross_shard_group_env(tmp_path) as env:
        for i in range(3):
            pod = mod.share_pod(f"solo-{i}", 4)
            env.api.add_pod(pod)
            assert env.router.admit(pod)["error"] == ""
        pods = mod.make_group(env, "xg-doc", n_members=2)
        plan, err = env.router._plan_group(pods)
        assert err == ""
        epoch = env.lease.acquire("xg-doc", "shard-0")
        member = plan[0]
        shard = env.router.shard(member["shard"])
        ok, reason = shard.prepare_gang(
            "xg-doc", member["ns"], member["name"], member["node"], member["chips"],
            member["units"], member["shape"], epoch, "shard-0")
        assert ok, reason
        doc = copy.deepcopy(env.router.shards_doc())
        shard.abort_gang("xg-doc", member["ns"], member["name"], epoch)
        mod.assert_2pc_drained(env)
        return doc


def test_shards_docs_are_equal(tmp_path):
    ref = _shards_doc_after_admissions(REF, tmp_path / "ref")
    port = _shards_doc_after_admissions(PORT, tmp_path / "port")
    assert port == ref
    assert [g["phase"] for g in ref["gangs_2pc"]] == ["prepare"]
    assert sum(r["wal_seq"] for r in ref["shards"]) > 0


# --- the churn drill ----------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2])
def test_churn_drill_at_scale_smoke_settings(tmp_path, n_shards):
    """The port's router only: over the reference's, the same drill fails
    its audit now and then (fault 9's double-booking; once in a parallel
    run of the test suite, with the witness on)."""
    mod = load("test_shards", PORT)
    lockrank = importlib.import_module(f"{PORT}.utils.lockrank")
    lockrank.set_witness(True)
    lockrank.reset_violations()
    try:
        nodes = mod.S.make_cluster(16, seed=0)
        with mod.sharded_env(tmp_path, n_shards=n_shards, nodes=nodes, fanout=2) as env:
            driver = mod.S.ChurnDriver(
                create_pod_fn=env.api.add_pod, delete_pod_fn=env.api.delete_pod,
                admit_fn=env.router.admit, admit_gang_fn=env.router.admit_gang_group,
                seed=0, gang_every=12, workers=4)
            stats = driver.run(80)
            assert stats.admitted > 0 and stats.gang_groups > 0, mod.S.summarize(stats)
            pods = env.client.list_pods()
            assert mod.S.audit_cluster(env.nodes, pods) == []
            assert mod.S.audit_no_cross_shard_double_booking(env.nodes, pods) == []
            mod.resolve_gang2pc(env.shards, env.client, lease=env.lease)
            assert sum(len(s.twopc_pending()) for s in env.shards) == 0
            mod.assert_2pc_drained(env)
        lockrank.assert_clean(f"churn drill, {n_shards} shard(s)")
    finally:
        lockrank.set_witness(None)
        lockrank.reset_violations()


def test_lock_ranks_fault_points_and_wal_namespace_are_the_references():
    import dataclasses

    ref_lr = importlib.import_module(f"{REF}.utils.lockrank")
    port_lr = importlib.import_module(f"{PORT}.utils.lockrank")
    for name in ("extender.core", "extender.lease", "extender.router", "extender.simchurn",
                 "extender.twopc", "extender.usageindex", "tracing.admissions"):
        assert dataclasses.astuple(port_lr.RANKS[name]) == dataclasses.astuple(ref_lr.RANKS[name])
    assert _shards(PORT).GANG2PC_NS == _shards(REF).GANG2PC_NS
    # the port lists the six sites, so TPUSHARE_FAULTS arms them in a router
    faults = importlib.import_module(f"{PORT}.utils.faults")
    assert [p for p in faults.POINTS if p.startswith("gang2pc.")] == SITES
    registry = faults.FaultRegistry()
    assert registry.install_from_env("gang2pc.commit=crash:1") == 1
    with pytest.raises(faults.SimulatedCrash):
        registry.fire("gang2pc.commit")
    registry.fire("gang2pc.commit")  # once: disarmed
