"""The ``tpushare_*`` metric families the port publishes.

Counterpart of ``gpushare_device_plugin_tpu/utils/metric_catalog.py``,
cut to the families of the port's modules:

- a serving pod: the engine's step profile, pages, prefix cache,
  preemptions, speculative decoding and adapters, the best-effort
  governor, SLO budgets and the build identity;
- the protocol layer: the KV handoff, the WAL, the circuit breaker and
  the assume cache's expiry; the serving fleet's router, replica table
  and scale-down;
- the node agent: Allocate's latency and outcomes, the allocators' lock
  waits, the health watcher, the pod informer, the apiserver PATCH
  pipeline, node events, the drift reconciler, live defragmentation and
  the interference detector;
- the scheduler extender: its verbs' latency and outcomes, its view
  source and the sharded router's gang two-phase commit.

Names, types and label sets are the reference's letter for letter, so
the reference control plane's scrapers (``cluster/interference.py``, the
inspect CLI) read a port pod as they read a reference pod. A site may
emit a subset of a family's labels (the ``pod`` label only when the
engine is pod-scoped).
"""

from __future__ import annotations

import dataclasses

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One family: its exposition type and every label key it may carry."""

    name: str
    type: str
    labels: tuple[str, ...]


def _m(name: str, mtype: str, *labels: str) -> tuple[str, MetricSpec]:
    return name, MetricSpec(name, mtype, tuple(sorted(labels)))


ALLOCATE_SECONDS = "tpushare_allocate_seconds"
ALLOCATE_TOTAL = "tpushare_allocate_total"
ALLOCATOR_LOCK_WAIT_SECONDS = "tpushare_allocator_lock_wait_seconds"
ASSUME_EXPIRED_TOTAL = "tpushare_assume_expired_total"
BUILD_INFO = "tpushare_build_info"
CHECKPOINT_APPENDS_TOTAL = "tpushare_checkpoint_appends_total"
CHECKPOINT_ERRORS_TOTAL = "tpushare_checkpoint_errors_total"
CHECKPOINT_FENCED = "tpushare_checkpoint_fenced"
CHECKPOINT_FSYNC_SECONDS = "tpushare_checkpoint_fsync_seconds"
CHECKPOINT_REPLAYED_TOTAL = "tpushare_checkpoint_replayed_total"
CHECKPOINT_WAL_BATCH_RECORDS = "tpushare_checkpoint_wal_batch_records"
CIRCUIT_FASTFAIL_TOTAL = "tpushare_circuit_fastfail_total"
CIRCUIT_STATE = "tpushare_circuit_state"
CIRCUIT_TRANSITIONS_TOTAL = "tpushare_circuit_transitions_total"
DEFRAG_MOVE_SECONDS = "tpushare_defrag_move_seconds"
DEFRAG_MOVES_TOTAL = "tpushare_defrag_moves_total"
DEFRAG_STRANDED_PCT = "tpushare_defrag_stranded_pct"
DEFRAG_STRANDED_UNITS = "tpushare_defrag_stranded_units"
ENGINE_ADAPTER_CACHE_PAGES = "tpushare_engine_adapter_cache_pages"
ENGINE_ADAPTER_ENABLED = "tpushare_engine_adapter_enabled"
ENGINE_ADAPTER_EVICTIONS_TOTAL = "tpushare_engine_adapter_evictions_total"
ENGINE_ADAPTER_HITS_TOTAL = "tpushare_engine_adapter_hits_total"
ENGINE_ADAPTER_MISS_STALL_SECONDS = "tpushare_engine_adapter_miss_stall_seconds"
ENGINE_ADAPTER_MISSES_TOTAL = "tpushare_engine_adapter_misses_total"
ENGINE_ADAPTER_RESIDENT = "tpushare_engine_adapter_resident"
ENGINE_KV_PAGES_FREE = "tpushare_engine_kv_pages_free"
ENGINE_KV_PAGES_TOTAL = "tpushare_engine_kv_pages_total"
ENGINE_KV_PAGES_USED = "tpushare_engine_kv_pages_used"
ENGINE_PREEMPTIONS = "tpushare_engine_preemptions"
ENGINE_PREEMPTIONS_TOTAL = "tpushare_engine_preemptions_total"
ENGINE_PREFIX_CACHED_PAGES = "tpushare_engine_prefix_cached_pages"
ENGINE_PREFIX_HIT_RATIO = "tpushare_engine_prefix_hit_ratio"
ENGINE_PREFIX_HIT_TOKENS = "tpushare_engine_prefix_hit_tokens"
ENGINE_SPEC_ACCEPTANCE_LEN = "tpushare_engine_spec_acceptance_len"
ENGINE_SPEC_ACCEPTED_TOKENS_PER_STEP = "tpushare_engine_spec_accepted_tokens_per_step"
ENGINE_SPEC_DRAFT_STEPS_TOTAL = "tpushare_engine_spec_draft_steps_total"
ENGINE_SPEC_ENABLED = "tpushare_engine_spec_enabled"
ENGINE_SPEC_K = "tpushare_engine_spec_k"
ENGINE_SPEC_ROLLBACK_PAGES_TOTAL = "tpushare_engine_spec_rollback_pages_total"
ENGINE_STEP_P50_SECONDS = "tpushare_engine_step_p50_seconds"
ENGINE_STEP_P99_SECONDS = "tpushare_engine_step_p99_seconds"
ENGINE_STEP_SECONDS = "tpushare_engine_step_seconds"
EXTENDER_VERB_SECONDS = "tpushare_extender_verb_seconds"
EXTENDER_VERB_TOTAL = "tpushare_extender_verb_total"
EXTENDER_VIEW_TOTAL = "tpushare_extender_view_total"
FLEET_DRAIN_MIGRATED_REQUESTS_TOTAL = "tpushare_fleet_drain_migrated_requests_total"
FLEET_REPLICAS = "tpushare_fleet_replicas"
FLEET_SCALE_OPS_TOTAL = "tpushare_fleet_scale_ops_total"
GANG2PC_TOTAL = "tpushare_gang2pc_total"
GOVERNOR_ENGAGED = "tpushare_governor_engaged"
GOVERNOR_ENGAGEMENTS_TOTAL = "tpushare_governor_engagements_total"
GOVERNOR_THROTTLE_SECONDS_TOTAL = "tpushare_governor_throttle_seconds_total"
GOVERNOR_THROTTLED_STEPS_TOTAL = "tpushare_governor_throttled_steps_total"
HANDOFF_BYTES = "tpushare_handoff_bytes"
HANDOFF_FALLBACK_REPREFILL_TOTAL = "tpushare_handoff_fallback_reprefill_total"
HANDOFF_PAGES_IN_FLIGHT = "tpushare_handoff_pages_in_flight"
HANDOFF_TRANSFER_SECONDS = "tpushare_handoff_transfer_seconds"
HANDOFF_TRANSFERS_TOTAL = "tpushare_handoff_transfers_total"
HEALTH_EVENTS_TOTAL = "tpushare_health_events_total"
HEALTH_WATCHER_RESTARTS_TOTAL = "tpushare_health_watcher_restarts_total"
INFORMER_APPLY_BATCH_EVENTS = "tpushare_informer_apply_batch_events"
INFORMER_INDEX_REBUILDS_TOTAL = "tpushare_informer_index_rebuilds_total"
INFORMER_STALENESS_SECONDS = "tpushare_informer_staleness_seconds"
INTERFERENCE_RATIO = "tpushare_interference_ratio"
NODE_EVENTS_DROPPED_TOTAL = "tpushare_node_events_dropped_total"
PATCH_BATCH_RECORDS = "tpushare_patch_batch_records"
PATCH_COALESCED_TOTAL = "tpushare_patch_coalesced_total"
PATCH_REQUESTS_TOTAL = "tpushare_patch_requests_total"
RECONCILE_DRIFT_TOTAL = "tpushare_reconcile_drift_total"
RECONCILE_REPAIRS_TOTAL = "tpushare_reconcile_repairs_total"
RECONCILE_RUNS_TOTAL = "tpushare_reconcile_runs_total"
RECONCILE_SECONDS = "tpushare_reconcile_seconds"
ROUTER_PREFIX_AFFINITY_HITS_TOTAL = "tpushare_router_prefix_affinity_hits_total"
ROUTER_ROUTED_TOTAL = "tpushare_router_routed_total"
ROUTER_SHED_TOTAL = "tpushare_router_shed_total"
SLO_BURN_RATE = "tpushare_slo_burn_rate"
SLO_ERROR_BUDGET_REMAINING = "tpushare_slo_error_budget_remaining"
SLO_SEVERITY = "tpushare_slo_severity"
UNHEALTHY_CHIPS = "tpushare_unhealthy_chips"

# Family prefixes the inspect CLI's parsers slice on
# (`cli/inspect.py::parse_engine_metrics`, `parse_observability_metrics`).
PREFIX_ENGINE = "tpushare_engine_"
PREFIX_SLO = "tpushare_slo_"
PREFIX_GOVERNOR = "tpushare_governor_"
PREFIX_HANDOFF = "tpushare_handoff_"
PREFIX_FLEET = "tpushare_fleet_"
PREFIX_ROUTER = "tpushare_router_"

CATALOG: dict[str, MetricSpec] = dict((
    _m(ALLOCATE_SECONDS, HISTOGRAM, "resource"),
    _m(ALLOCATE_TOTAL, COUNTER, "resource", "outcome"),
    _m(ALLOCATOR_LOCK_WAIT_SECONDS, HISTOGRAM, "lock"),
    _m(ASSUME_EXPIRED_TOTAL, COUNTER, "kind"),
    _m(BUILD_INFO, GAUGE, "component", "version", "git_rev", "python", "jax"),
    _m(CHECKPOINT_APPENDS_TOTAL, COUNTER, "op"),
    _m(CHECKPOINT_ERRORS_TOTAL, COUNTER, "op"),
    _m(CHECKPOINT_FENCED, GAUGE),
    _m(CHECKPOINT_FSYNC_SECONDS, HISTOGRAM, "mode"),
    _m(CHECKPOINT_REPLAYED_TOTAL, COUNTER),
    _m(CHECKPOINT_WAL_BATCH_RECORDS, HISTOGRAM, "mode"),
    _m(CIRCUIT_FASTFAIL_TOTAL, COUNTER, "breaker"),
    _m(CIRCUIT_STATE, GAUGE, "breaker"),
    _m(CIRCUIT_TRANSITIONS_TOTAL, COUNTER, "breaker", "to"),
    _m(DEFRAG_MOVE_SECONDS, HISTOGRAM),
    _m(DEFRAG_MOVES_TOTAL, COUNTER, "outcome"),
    _m(DEFRAG_STRANDED_PCT, GAUGE),
    _m(DEFRAG_STRANDED_UNITS, GAUGE),
    _m(ENGINE_ADAPTER_CACHE_PAGES, GAUGE, "pod"),
    _m(ENGINE_ADAPTER_ENABLED, GAUGE, "pod"),
    _m(ENGINE_ADAPTER_EVICTIONS_TOTAL, COUNTER, "pod"),
    _m(ENGINE_ADAPTER_HITS_TOTAL, COUNTER, "pod"),
    _m(ENGINE_ADAPTER_MISS_STALL_SECONDS, HISTOGRAM, "pod"),
    _m(ENGINE_ADAPTER_MISSES_TOTAL, COUNTER, "pod"),
    _m(ENGINE_ADAPTER_RESIDENT, GAUGE, "pod"),
    _m(ENGINE_KV_PAGES_FREE, GAUGE, "pod"),
    _m(ENGINE_KV_PAGES_TOTAL, GAUGE, "pod"),
    _m(ENGINE_KV_PAGES_USED, GAUGE, "pod"),
    _m(ENGINE_PREEMPTIONS, GAUGE, "pod"),
    _m(ENGINE_PREEMPTIONS_TOTAL, COUNTER, "pod"),
    _m(ENGINE_PREFIX_CACHED_PAGES, GAUGE, "pod"),
    _m(ENGINE_PREFIX_HIT_RATIO, GAUGE, "pod"),
    _m(ENGINE_PREFIX_HIT_TOKENS, HISTOGRAM, "pod"),
    _m(ENGINE_SPEC_ACCEPTANCE_LEN, HISTOGRAM, "pod"),
    _m(ENGINE_SPEC_ACCEPTED_TOKENS_PER_STEP, HISTOGRAM, "pod"),
    _m(ENGINE_SPEC_DRAFT_STEPS_TOTAL, COUNTER, "pod"),
    _m(ENGINE_SPEC_ENABLED, GAUGE, "pod"),
    _m(ENGINE_SPEC_K, GAUGE, "pod"),
    _m(ENGINE_SPEC_ROLLBACK_PAGES_TOTAL, COUNTER, "pod"),
    _m(ENGINE_STEP_P50_SECONDS, GAUGE, "pod"),
    _m(ENGINE_STEP_P99_SECONDS, GAUGE, "pod"),
    _m(ENGINE_STEP_SECONDS, HISTOGRAM, "pod"),
    _m(EXTENDER_VERB_SECONDS, HISTOGRAM, "verb"),
    _m(EXTENDER_VERB_TOTAL, COUNTER, "verb", "outcome"),
    _m(EXTENDER_VIEW_TOTAL, COUNTER, "outcome"),
    _m(FLEET_DRAIN_MIGRATED_REQUESTS_TOTAL, COUNTER, "pod"),
    _m(FLEET_REPLICAS, GAUGE, "state", "pod"),
    _m(FLEET_SCALE_OPS_TOTAL, COUNTER, "outcome", "pod"),
    _m(GANG2PC_TOTAL, COUNTER, "phase", "outcome"),
    _m(GOVERNOR_ENGAGED, GAUGE, "pod"),
    _m(GOVERNOR_ENGAGEMENTS_TOTAL, COUNTER, "pod"),
    _m(GOVERNOR_THROTTLE_SECONDS_TOTAL, COUNTER, "pod"),
    _m(GOVERNOR_THROTTLED_STEPS_TOTAL, COUNTER, "pod"),
    _m(HANDOFF_BYTES, HISTOGRAM, "pod"),
    _m(HANDOFF_FALLBACK_REPREFILL_TOTAL, COUNTER, "reason", "pod"),
    _m(HANDOFF_PAGES_IN_FLIGHT, GAUGE, "pod"),
    _m(HANDOFF_TRANSFER_SECONDS, HISTOGRAM, "pod"),
    _m(HANDOFF_TRANSFERS_TOTAL, COUNTER, "outcome", "pod"),
    _m(HEALTH_EVENTS_TOTAL, COUNTER, "health", "severity"),
    _m(HEALTH_WATCHER_RESTARTS_TOTAL, COUNTER),
    _m(INFORMER_APPLY_BATCH_EVENTS, HISTOGRAM, "scope"),
    _m(INFORMER_INDEX_REBUILDS_TOTAL, COUNTER, "reason", "scope"),
    _m(INFORMER_STALENESS_SECONDS, GAUGE, "scope"),
    _m(INTERFERENCE_RATIO, GAUGE, "chip", "victim", "aggressor"),
    _m(NODE_EVENTS_DROPPED_TOTAL, COUNTER, "reason"),
    _m(PATCH_BATCH_RECORDS, HISTOGRAM, "kind"),
    _m(PATCH_COALESCED_TOTAL, COUNTER, "kind"),
    _m(PATCH_REQUESTS_TOTAL, COUNTER, "transport"),
    _m(RECONCILE_DRIFT_TOTAL, COUNTER, "kind"),
    _m(RECONCILE_REPAIRS_TOTAL, COUNTER, "kind"),
    _m(RECONCILE_RUNS_TOTAL, COUNTER, "outcome"),
    _m(RECONCILE_SECONDS, HISTOGRAM),
    _m(ROUTER_PREFIX_AFFINITY_HITS_TOTAL, COUNTER, "pod"),
    _m(ROUTER_ROUTED_TOTAL, COUNTER, "engine", "outcome", "pod"),
    _m(ROUTER_SHED_TOTAL, COUNTER, "tier", "pod"),
    _m(SLO_BURN_RATE, GAUGE, "tier", "window", "pod"),
    _m(SLO_ERROR_BUDGET_REMAINING, GAUGE, "tier", "pod"),
    _m(SLO_SEVERITY, GAUGE, "tier", "pod"),
    _m(UNHEALTHY_CHIPS, GAUGE),
))



def spec_of(name: str) -> MetricSpec:
    try:
        return CATALOG[name]
    except KeyError:
        raise ValueError(
            f"unknown metric family {name!r}; declare it in "
            "gpushare_device_plugin_tpu_torch/utils/metric_catalog.py"
        ) from None
