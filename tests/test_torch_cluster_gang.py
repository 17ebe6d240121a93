"""Gang admission: the port's ClusterAllocator against the reference's.

The reference's ``tests/test_gang_alloc.py`` cases run on each package
(``torch_cluster_mirror``), its extender cases on each package's own
``ExtenderCore``. Then one package's ``extender.server.ExtenderCore`` binds
gangs on a ``FakeApiServer``, and each package's allocator admits what it
assumed, from the same state: the same member chips, envs, PATCH bodies and
ledger (``cluster_chip_state``); the reference's extender first, then the
port's.
"""

import copy
import importlib

import numpy as np
import pytest

from gpushare_device_plugin_tpu import const

from fake_apiserver import FakeApiServer
from k8s_fixtures import make_pod
from torch_cluster_mirror import PORT, REF, cases, mirror_case, normalize

GANG = [
    "test_gang_reservation_is_one_atomic_entry",
    "test_gang_ttl_expiry_releases_every_member_in_one_pass",
    "test_gang_checkpoint_replay_reinstalls_whole_gang",
    "test_gang_allocate_places_scored_slice_and_persists",
    "test_gang_units_must_divide_over_shape",
    "test_gang_rejected_when_no_slice_fits",
    "test_gang_excludes_core_held_chips",
    "test_assumed_gang_is_honored",
    "test_assumed_gang_with_conflicting_member_fails_whole_gang",
    "test_assumed_gang_rejects_truncated_or_duplicated_member_list",
    "test_gang_per_chip_units_prefers_immutable_spec",
    "test_assumed_gang_degrades_mismatched_shape_annotation",
]


EXTENDER = [
    "test_extender_gang_bind_persists_whole_gang",
    "test_extender_inflight_gang_blocks_double_booking",
    "test_extender_filter_rejects_unfittable_gang",
    "test_extender_gang_scores_rank_packing",
    "test_extender_batch_verb_uses_gang_semantics",
]


@pytest.mark.parametrize("name, params", cases("test_gang_alloc", GANG + EXTENDER))
def test_gang_alloc_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_gang_alloc", name, params, tmp_path_factory)


NODE = "xg"


def _node(chips: int, units: int, label: str) -> dict:
    cap = {const.RESOURCE_MEM: str(chips * units), const.RESOURCE_COUNT: str(chips)}
    return {
        "metadata": {"name": NODE, "labels": {const.LABEL_NODE_TOPOLOGY: label}},
        "status": {"capacity": dict(cap), "allocatable": dict(cap)},
    }


def _admit(pkg: str, pods: dict, node: dict, chips: int, units: int, order: list):
    """One package's allocator admits ``order`` from a fresh apiserver
    holding ``pods`` (what the extender bound). -> (envs or refusals, the
    pods' annotations, the PATCH bodies, the ledger)."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    api = FakeApiServer()
    api.nodes[NODE] = copy.deepcopy(node)
    for pod in pods.values():
        api.add_pod(copy.deepcopy(pod))
    api.start()
    try:
        client = m("cluster.apiserver").ApiServerClient(api.url)
        src = m("cluster.podsource").ApiServerPodSource(client, NODE)
        inv = m("device.fanout").DeviceInventory(
            m("discovery.mock").MockBackend(num_chips=chips, hbm_bytes=units << 30).chips()
        )
        topo = m("topology").ChipTopology.from_node(node, chips)
        cl = m("allocator.cluster")
        alloc = cl.ClusterAllocator(inv, client, src, NODE, chip_topology=topo)
        out = []
        for name in order:
            total = int(pods[name]["spec"]["containers"][0]["resources"]["limits"][const.RESOURCE_MEM])
            try:
                res = alloc.allocate([[f"fake-{i}" for i in range(total)]])
                out.append(("ok", res[0].envs))
            except cl.AllocationFailure as e:
                out.append(("refused", str(e)))
        anns = {k[1]: p["metadata"].get("annotations") for k, p in api.pods.items()}
        state = cl.cluster_chip_state(src)()
        return normalize({"admitted": out, "annotations": anns, "patches": copy.deepcopy(api.patch_log),
                          "ledger": [state[0], sorted(state[1])]})
    finally:
        api.stop()


def _extender_binds(pkg: str, rng, node: dict) -> tuple[list, dict]:
    """``pkg``'s ExtenderCore binds six random gangs on a fresh apiserver;
    -> (the names bound, their pods as the extender left them)."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    api = FakeApiServer()
    api.nodes[NODE] = node
    api.start()
    bound = []
    try:
        client = m("cluster.apiserver").ApiServerClient(api.url)
        informer = m("cluster.informer").PodInformer(client).start(sync_timeout_s=10)
        core = m("extender.server").ExtenderCore(client, informer=informer)
        shapes = ["2x1x1", "1x2x1", "2x2x1", "2", "4", "1"]
        for i in range(6):
            shape = shapes[int(rng.integers(len(shapes)))]
            size = int(np.prod([int(x) for x in shape.split("x")]))
            per = int(rng.choice([2, 4, 8]))
            name = f"g{i}"
            pod = make_pod(name, per * size, node="",
                           annotations={const.ANN_GANG_SHAPE: shape})
            api.add_pod(pod)
            if core.bind({"podNamespace": "default", "podName": name, "node": NODE}) == {"error": ""}:
                bound.append(name)
        informer.stop()
        pods = {k[1]: copy.deepcopy(p) for k, p in api.pods.items() if k[1] in bound}
    finally:
        api.stop()
    return bound, pods


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_admits_what_the_reference_extender_assumed(seed):
    rng = np.random.default_rng(seed)
    chips, units, label = 8, 32, "2x2x2"
    node = _node(chips, units, label)
    api = FakeApiServer()
    api.nodes[NODE] = node
    api.start()
    bound = []
    try:
        from gpushare_device_plugin_tpu.cluster.apiserver import ApiServerClient
        from gpushare_device_plugin_tpu.cluster.informer import PodInformer
        from gpushare_device_plugin_tpu.extender.server import ExtenderCore

        client = ApiServerClient(api.url)
        informer = PodInformer(client).start(sync_timeout_s=10)
        core = ExtenderCore(client, informer=informer)
        shapes = ["2x1x1", "1x2x1", "2x2x1", "2", "4", "1"]
        for i in range(6):
            shape = shapes[int(rng.integers(len(shapes)))]
            size = int(np.prod([int(x) for x in shape.split("x")]))
            per = int(rng.choice([2, 4, 8]))
            name = f"g{i}"
            pod = make_pod(name, per * size, node="",
                           annotations={const.ANN_GANG_SHAPE: shape})
            api.add_pod(pod)
            if core.bind({"podNamespace": "default", "podName": name, "node": NODE}) == {"error": ""}:
                bound.append(name)
        informer.stop()
        pods = {k[1]: copy.deepcopy(p) for k, p in api.pods.items() if k[1] in bound}
    finally:
        api.stop()
    assert bound, "the extender bound no gang"
    for p in pods.values():
        assert p["metadata"]["annotations"].get(const.ENV_GANG_CHIPS)
    order = list(rng.permutation(bound))
    ref = _admit(REF, pods, node, chips, units, order)
    port = _admit(PORT, pods, node, chips, units, order)
    assert port == ref
    assert all(kind == "ok" for kind, _ in ref["admitted"])
    # kubelet names only a unit count, so a grant matches the oldest pod
    # of that size: the member sets granted are the ones the extender bound
    granted = sorted(envs[const.ENV_GANG_CHIPS] for _, envs in ref["admitted"])
    assumed = sorted(p["metadata"]["annotations"][const.ENV_GANG_CHIPS] for p in pods.values())
    assert granted == assumed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_admits_what_the_port_extender_assumed(seed):
    """The reverse: the port's extender binds the gangs, each package's
    allocator admits them with the same member chips, envs, PATCH bodies and
    ledger, and the port's extender wrote what the reference's writes from
    the same draws."""
    chips, units, label = 8, 32, "2x2x2"
    node = _node(chips, units, label)
    bound, pods = _extender_binds(PORT, np.random.default_rng(seed), node)
    ref_bound, ref_pods = _extender_binds(REF, np.random.default_rng(seed), _node(chips, units, label))
    assert bound, "the extender bound no gang"
    assert bound == ref_bound
    assert normalize({k: p["metadata"]["annotations"] for k, p in pods.items()}) == normalize(
        {k: p["metadata"]["annotations"] for k, p in ref_pods.items()})
    rng = np.random.default_rng(seed + 100)
    order = list(rng.permutation(bound))
    ref = _admit(REF, pods, node, chips, units, order)
    port = _admit(PORT, pods, node, chips, units, order)
    assert port == ref
    assert all(kind == "ok" for kind, _ in ref["admitted"])
    granted = sorted(envs[const.ENV_GANG_CHIPS] for _, envs in ref["admitted"])
    assumed = sorted(p["metadata"]["annotations"][const.ENV_GANG_CHIPS] for p in pods.values())
    assert granted == assumed
