"""The extender's ``ClusterUsageIndex``: the port's against the reference's.

The reference's ``tests/test_index_property.py`` runs on each package
through ``torch_cluster_mirror`` at its own seed count (200 seeded random
watch-event sequences, every index held to a full scan after each). Then
both packages' informers and indexes take the same sequences, seed by seed,
and must hold the same per-node usage, core-held chips, chip classes and
pending pods.
"""

import random

import pytest

from torch_cluster_mirror import PORT, REF, cases, load, mirror_case

PROPERTY = [
    "test_indexes_equal_full_scan_after_random_event_sequences",
    "test_revalidate_indexes_is_idempotent_on_coherent_state",
]


@pytest.mark.parametrize("name, params", cases("test_index_property", PROPERTY))
def test_index_property_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_index_property", name, params, tmp_path_factory)


def _state_after(pkg: str, seed: int) -> dict:
    mod = load("test_index_property", pkg)
    rng = random.Random(seed)
    shadow = mod._Shadow()
    inf = mod.PodInformer(client=None, node_name="prop-a")
    index = mod.ClusterUsageIndex()
    inf.add_index(index)
    inf._synced.set()
    for _ in range(mod.EVENTS_PER_ITERATION):
        mod._apply_random_event(rng, shadow, inf)
    return {
        "nodes": {
            node: {res: [sorted(used.items()), sorted(core)]
                   for res in (mod.const.RESOURCE_MEM, mod.const.RESOURCE_GPU_MEM)
                   for used, core in [index.node_state(node, res)]}
            for node in mod.NODES
        },
        "classes": {node: index.chip_classes(node) for node in mod.NODES},
        "chip_state": inf.chip_state(),
        "pending": sorted(mod.P.name(p) for p in inf.pending_pods()),
    }


@pytest.mark.parametrize("block", range(4))
def test_both_indexes_agree_on_the_same_events(block):
    for seed in range(block * 50, block * 50 + 50):
        assert _state_after(PORT, seed) == _state_after(REF, seed), f"seed {seed}"
