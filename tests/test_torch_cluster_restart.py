"""Restart safety: the WAL's replay and fence, the drift reconciler, and the
manager's crash recovery, the port against the reference.

The reference's cases run on each package through ``torch_cluster_mirror``
(``tests/test_checkpoint.py`` without the compaction case, which is the WAL
format the port carried since the KV handoff; ``tests/test_reconciler.py``;
``tests/test_restart_recovery.py``, its three extender cases on each
package's own ``ExtenderCore`` and bind WAL), and their wire records (PATCH bodies, annotations, the fence generation on the
node, events, envs and refusals) must be equal.
"""

import pytest

from torch_cluster_mirror import cases, mirror_case

CHECKPOINT = [
    "test_begin_commit_abort_roundtrip",
    "test_unresolved_entries_survive_reopen",
    "test_generation_bumps_every_open",
    "test_torn_tail_line_tolerated",
    "test_replay_installs_reservations",
    "test_crash_fault_fires_after_durable_write",
    "test_fencing_newer_instance_fences_older",
    "test_fencing_equal_generation_foreign_token_fences",
    "test_resolve_seq_guard_protects_newer_begin",
    "test_fencing_reacquire_unfences",
    "test_fenced_allocator_refuses_admission",
]

RECONCILER = [
    "test_orphan_reservation_released",
    "test_redundant_reservation_released",
    "test_claimed_reservation_is_not_touched",
    "test_release_if_unclaimed_is_atomic_guard",
    "test_checkpoint_entry_committed_when_patch_landed",
    "test_checkpoint_entry_aborted_when_nothing_persisted",
    "test_ttl_expiry_unstrands_capacity",
    "test_ttl_lazy_expiry_without_reconciler",
    "test_kubelet_grants_diff",
    "test_annotation_audit_flags_garbled_and_overcommit",
    "test_fenced_instance_skips_repairs",
    "test_background_loop_runs_and_stops",
    "test_expired_partial_gang_releases_every_member_in_one_pass",
    "test_orphaned_gang_reservation_released_whole",
    "test_gang_annotation_audit_counts_per_chip",
    "test_gang_unknown_chip_not_double_counted_as_overcommit",
    "test_gang_request_admitted_single_chip_audits_normally",
]

RECOVERY = [
    "test_kill_at_every_journal_step_mem",
    "test_kill_and_restart_core_resource",
    "test_replayed_reservation_blocks_double_booking_before_reconcile",
    "test_manager_replays_and_reconciler_resolves",
    "test_plugin_socket_vanish_triggers_reregistration",
    "test_graceful_drain_finishes_inflight_allocate",
    "test_extender_warmup_ages_out_stale_entries",
    "test_extender_warmup_serves_from_checkpoint",
    "test_expired_bind_abort_journals_outside_the_decision_lock",
]


@pytest.mark.parametrize("name, params", cases("test_checkpoint", CHECKPOINT))
def test_checkpoint_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_checkpoint", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_reconciler", RECONCILER))
def test_reconciler_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_reconciler", name, params, tmp_path_factory)


@pytest.mark.parametrize("name, params", cases("test_restart_recovery", RECOVERY))
def test_restart_recovery_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_restart_recovery", name, params, tmp_path_factory)
