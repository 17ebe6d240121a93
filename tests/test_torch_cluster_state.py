"""State carried across packages: a node's WAL and annotations written by
one package's allocator are taken up by the other's after a restart.

A DaemonSet upgrade replaces one daemon with the other in place, on the
same plugin dir (the WAL) and the same apiserver (the annotations and the
fence). Each case seeds a ``FakeApiServer`` from numpy with pending share
pods and running assigned ones, lets the writer package admit some pods,
die in one admission after its PATCH landed (``allocator.post_persist``)
and in another after its begin was durable but before the PATCH left
(``checkpoint.begin``), then restarts as the reader package: it claims the
fence, replays the WAL and reconciles, and admits the rest. Every
(writer, reader) pair gives the same replay count, fence generations,
ledger after replay and after reconcile, reconcile drift, envs and
annotations as the reference restarting into itself.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from fake_apiserver import FakeApiServer
from k8s_fixtures import assigned_running_pod, make_pod
from torch_cluster_mirror import PORT, REF, normalize

NODE = "node-up"
CHIPS, UNITS = 4, 16


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _seed_pods(api: FakeApiServer, seed: int) -> list[int]:
    """Running pods on every chip, then pending pods; -> the pending sizes
    in admission (creation) order."""
    rng = np.random.default_rng(seed)
    for i in range(CHIPS):
        api.add_pod(assigned_running_pod(
            f"run{i}", int(rng.integers(1, 5)), chip_idx=i, node=NODE,
        ))
    sizes = [int(rng.integers(1, 7)) for _ in range(6)]
    for i, units in enumerate(sizes):
        api.add_pod(make_pod(f"p{i}", units, node=NODE,
                             created=f"2026-01-01T00:00:{i:02d}Z"))
    return sizes


def _granted(units: int) -> list[list[str]]:
    return [[f"fake-{i}" for i in range(units)]]


def _stack(pkg: str, api: FakeApiServer, path: str):
    client = _m(pkg, "cluster.apiserver").ApiServerClient(api.url)
    source = _m(pkg, "cluster.podsource").ApiServerPodSource(client, NODE)
    inv = _m(pkg, "device.fanout").DeviceInventory(
        _m(pkg, "discovery.mock").MockBackend(num_chips=CHIPS, hbm_bytes=UNITS << 30).chips()
    )
    assume = _m(pkg, "allocator.assume").AssumeCache()
    ckpt = _m(pkg, "allocator.checkpoint").AllocationCheckpoint(path)
    cluster = _m(pkg, "allocator.cluster")
    alloc = cluster.ClusterAllocator(inv, client, source, NODE, assume=assume, checkpoint=ckpt)
    return client, source, inv, assume, ckpt, cluster, alloc


def _ledger(cluster, source, assume):
    mem, held = cluster.cluster_chip_state(source, assume=assume)()
    return {"mem": dict(sorted(mem.items())), "held": sorted(held)}


def _fence(api) -> int:
    """The node's fence generation; its token must have the form."""
    value = api.nodes[NODE]["metadata"]["annotations"]["tpushare.aliyun.com/fence-generation"]
    gen, _, token = value.partition(":")
    assert len(token) >= 8 and token.isalnum(), value
    return int(gen)


def _run(writer: str, reader: str, seed: int, tmp_path) -> dict:
    api = FakeApiServer()
    api.add_node(NODE)
    sizes = _seed_pods(api, seed)
    api.start()
    path = str(tmp_path / f"{writer[-5:]}-{reader[-5:]}-{seed}.ckpt")
    out: dict = {"writer": [], "reader": []}
    try:
        # --- the writer's incarnation: two admissions, then two deaths
        client, source, inv, assume, ckpt, cluster, alloc = _stack(writer, api, path)
        faults = _m(writer, "utils.faults")
        ckpt.acquire_fence(client, NODE)
        out["writer_fence"] = _fence(api)
        for units in sizes[:2]:
            out["writer"].append(alloc.allocate(_granted(units))[0].envs)
        for site, units in (("allocator.post_persist", sizes[2]),
                            ("checkpoint.begin", sizes[3])):
            with faults.FAULTS.injected(site, "crash", times=1):
                with pytest.raises(faults.SimulatedCrash):
                    alloc.allocate(_granted(units))
        out["wal_pending"] = sorted("/".join(k) for k in ckpt.pending())
        # --- the reader's incarnation, on the same WAL and apiserver
        client2, source2, inv2, assume2, ckpt2, cluster2, alloc2 = _stack(reader, api, path)
        ckpt2.acquire_fence(client2, NODE)
        out["reader_fence"] = _fence(api)
        out["writer_fenced_after"] = not ckpt.verify_fence(client, NODE)
        out["replayed"] = _m(reader, "allocator.checkpoint").replay_checkpoint(ckpt2, assume2)
        out["ledger_after_replay"] = _ledger(cluster2, source2, assume2)
        reconciler = _m(reader, "cluster.reconciler").DriftReconciler(
            api=client2, pod_source=source2, assume=assume2, checkpoint=ckpt2,
            node_name=NODE, inventory=inv2,
        )
        out["drift"] = reconciler.reconcile_once()
        out["ledger_after_reconcile"] = _ledger(cluster2, source2, assume2)
        out["wal_pending_after"] = sorted("/".join(k) for k in ckpt2.pending())
        # kubelet retries what never completed, then the rest
        for units in sizes[3:]:
            try:
                out["reader"].append(alloc2.allocate(_granted(units))[0].envs)
            except cluster2.AllocationFailure as e:
                out["reader"].append(f"refused: {e}")
        out["ledger_final"] = _ledger(cluster2, source2, assume2)
        out["annotations"] = {
            k[1]: p["metadata"].get("annotations") or {} for k, p in sorted(api.pods.items())
        }
        ckpt2.close()
    finally:
        api.stop()
    return normalize(out)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF), (PORT, PORT)],
                         ids=["ref-to-port", "port-to-ref", "port-to-port"])
def test_a_node_written_by_one_package_restarts_into_the_other(writer, reader, seed, tmp_path):
    want = _run(REF, REF, seed, tmp_path)
    got = _run(writer, reader, seed, tmp_path)
    assert got == want
    # what the baseline shows: one entry crashed after its PATCH (commit),
    # one before it (abort), both replayed and both resolved
    assert want["replayed"] == 2
    assert want["wal_pending"] == ["default/p2", "default/p3"]
    assert want["drift"].get("replayed_commit") == 1
    assert want["drift"].get("replayed_abort") == 1
    assert want["wal_pending_after"] == []
    assert want["writer_fenced_after"] is True
    assert want["reader_fence"] == want["writer_fence"] + 1
