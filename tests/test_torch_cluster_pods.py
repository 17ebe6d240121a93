"""Pod predicates and the chip topology: the port against the reference.

The reference's ``tests/test_pods.py`` and ``tests/test_topology.py`` run on
each package (``torch_cluster_mirror``), and ``best_slice_scored`` is held to
the reference's choice on seeded random grids, occupancies and requests.
"""

import re

import numpy as np
import pytest

from gpushare_device_plugin_tpu import topology as RT
from gpushare_device_plugin_tpu.cluster import pods as RP
from gpushare_device_plugin_tpu_torch import topology as TT
from gpushare_device_plugin_tpu_torch.cluster import pods as TP

from k8s_fixtures import assigned_running_pod, make_pod
from torch_cluster_mirror import cases, mirror_case

PODS = [
    "test_mem_units_sums_container_limits",
    "test_mem_units_garbled_quantity_is_zero",
    "test_is_tpu_share_pod",
    "test_assumed_and_assigned_predicates",
    "test_chip_idx_annotation_parse",
    "test_candidate_pods_filter_and_order",
    "test_candidate_pods_dedup_by_uid",
    "test_candidate_same_timestamp_deterministic",
    "test_used_units_by_chip_counts_only_running_labeled",
    "test_used_chips_from_core_pods",
    "test_used_units_counts_assigned_pending_reservations",
]

TOPOLOGY = [
    "test_parse_shape_forms",
    "test_parse_shape_rejects_garbage",
    "test_default_grids_are_v4_style",
    "test_from_label_validates_against_chip_count",
    "test_coords_round_trip_and_distance",
    "test_candidates_enumerate_all_orientations",
    "test_count_request_enumerates_factorizations",
    "test_count_request_prefers_compact_shapes",
    "test_explicit_shape_must_fit",
    "test_best_slice_minimizes_stranded_slivers",
    "test_best_slice_prefers_not_cracking_whole_chips",
    "test_best_slice_respects_exclusions_and_capacity",
    "test_best_slice_all_excluded_returns_none",
    "test_from_node_reads_the_label_rule",
]


@pytest.mark.parametrize("name, params", cases("test_pods", PODS))
def test_pods_match_reference(name, params, tmp_path_factory):
    mirror_case("test_pods", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_topology", TOPOLOGY))
def test_topology_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_topology", name, params, tmp_path_factory)


def _scored(res):
    if res is None:
        return None
    cand, score = res
    return tuple(cand.chips), tuple(cand.shape), cand.hops, score.to_dict()


@pytest.mark.parametrize("grid", ["2x2x1", "2x2x2", "4x2x1"])
def test_best_slice_scored_picks_the_references_slice(grid):
    """The same grids, free units, capacities, exclusions and requests give
    the same slice and score in both packages."""
    rng = np.random.default_rng(16)
    dims = tuple(int(x) for x in grid.split("x"))
    n = int(np.prod(dims))
    rt, tt = RT.ChipTopology(dims), TT.ChipTopology(dims)
    requests = ["1", "2", "4", "8", "2x1x1", "1x2x1", "2x2x1", "2x2x2", "3", "bogus"]
    for _ in range(60):
        cap = {i: 32 for i in range(n)}
        free = {i: 32 - int(rng.choice([0, 0, 4, 8, 16, 32])) for i in range(n)}
        excluded = {i for i in range(n) if rng.random() < 0.1}
        req = requests[int(rng.integers(len(requests)))]
        per_chip = int(rng.choice([2, 4, 8, 16, 32]))
        try:
            want = rt.best_slice_scored(req, free, per_chip, capacity=cap, excluded=excluded)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tt.best_slice_scored(req, free, per_chip, capacity=cap, excluded=excluded)
            continue
        got = tt.best_slice_scored(req, free, per_chip, capacity=cap, excluded=excluded)
        assert _scored(got) == _scored(want), (req, per_chip, free, excluded)


def test_seeded_pods_read_the_same_in_both_packages():
    """Units, chip indices, candidates and usage over seeded pod dicts."""
    rng = np.random.default_rng(7)
    pods = []
    for i in range(60):
        kind = rng.integers(3)
        mem = int(rng.integers(1, 17))
        if kind == 0:
            pods.append(make_pod(f"p{i}", mem, created=f"2026-01-01T00:00:{i % 60:02d}Z"))
        elif kind == 1:
            pods.append(assigned_running_pod(f"r{i}", mem, chip_idx=int(rng.integers(4))))
        else:
            pods.append(make_pod(f"c{i}", 0, tpu_core=1))
    for p in pods:
        assert TP.mem_units_of_pod(p) == RP.mem_units_of_pod(p)
        assert TP.is_assumed(p) == RP.is_assumed(p)
        assert TP.is_assigned(p) == RP.is_assigned(p)
        assert TP.chip_idx_from_annotation(p) == RP.chip_idx_from_annotation(p)
    want = [RP.name(p) for p in RP.candidate_pods(pods, "node-a")]
    assert [TP.name(p) for p in TP.candidate_pods(pods, "node-a")] == want
    assert TP.used_units_by_chip(pods) == RP.used_units_by_chip(pods)
    assert TP.used_chips(pods) == RP.used_chips(pods)
