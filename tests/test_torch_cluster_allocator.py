"""ClusterAllocator and ClusterCoreAllocator: the port against the reference.

Each case is one of the reference's tests (``tests/test_cluster_allocator.py``,
``tests/test_core_allocator.py``) run twice, once on each package, each on a
``FakeApiServer`` of its own seeded with the same pods and nodes. The
reference's assertions hold the port; ``torch_cluster_mirror`` then holds the
two runs' wire records equal: every PATCH body, the pods' and nodes'
annotations and labels, the events posted, and every Allocate's envs or
refusal. Timestamps, trace ids and uids are compared by form.
"""

import pytest

from torch_cluster_mirror import cases, mirror_case

CLUSTER = [
    "test_binpack_branch_allocates_and_persists",
    "test_usage_accounting_from_running_pods",
    "test_extender_assumed_branch_wins",
    "test_assumed_with_garbage_idx_fails_admission",
    "test_no_matching_pod_fails_admission",
    "test_oldest_pod_matched_first",
    "test_patch_conflict_retried_once",
    "test_patch_conflict_twice_fails",
    "test_unhealthy_chips_excluded",
    "test_kubelet_pod_source_path",
    "test_isolation_disabled_label",
    "test_patch_chip_count_skips_noop",
    "test_informer_allocate_end_to_end",
    "test_informer_refresh_on_miss_finds_just_bound_pod",
    "test_informer_does_not_rematch_just_assigned_pod",
    "test_deleted_pod_404_evicts_and_rematches",
    "test_deleted_pod_404_with_no_live_candidate_fails",
    "test_workload_class_persisted_and_injected",
    "test_workload_class_garbled_normalizes_to_critical",
]

CORE = [
    "test_core_held_chip_forces_mem_pod_elsewhere",
    "test_core_held_noncontiguous_chips_excluded",
    "test_all_chips_core_held_fails_mem_admission",
    "test_extender_assumed_onto_core_held_chip_rejected",
    "test_mem_usage_blocks_core_grant",
    "test_core_grant_on_free_chip_persists_hold",
    "test_core_vs_core_conflict_fails",
    "test_core_multi_chip_multi_container",
    "test_core_no_matching_pod_fails",
    "test_core_unhealthy_chip_rejected",
    "test_restart_rederives_core_holds_from_apiserver",
    "test_preferred_core_chips_avoids_busy_chips",
    "test_allocation_failure_emits_pod_event",
    "test_core_conflict_emits_pod_event",
    "test_no_matching_pod_failure_has_no_event",
]


@pytest.mark.parametrize("name, params", cases("test_cluster_allocator", CLUSTER))
def test_cluster_allocator_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_cluster_allocator", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_core_allocator", CORE))
def test_core_allocator_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_core_allocator", name, params, tmp_path_factory)
