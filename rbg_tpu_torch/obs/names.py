"""The ``rbg_*`` metric and span names the serving path emits, with the
values of ``rbg_tpu/obs/names.py`` so the port's series carry the same
names on the wire. Only the names the port's modules use are here (the
serving path's and, under "control plane", the store's, the controllers'
and the scheduler's)."""

from __future__ import annotations

# ---- counters ----

SERVING_SHED_TOTAL = "rbg_serving_shed_total"
SERVING_DEADLINE_EXCEEDED_TOTAL = "rbg_serving_deadline_exceeded_total"
SERVING_DRAINS_TOTAL = "rbg_serving_drains_total"
SERVING_DRAIN_REFUSALS_TOTAL = "rbg_serving_drain_refusals_total"
SERVING_EARLY_REJECTS_TOTAL = "rbg_serving_early_rejects_total"
SERVING_REQUESTS_FINISHED_TOTAL = "rbg_serving_requests_finished_total"
SERVING_TOKENS_TOTAL = "rbg_serving_tokens_total"
TRACE_TRACES_TOTAL = "rbg_trace_traces_total"
TRACE_SPANS_DROPPED_TOTAL = "rbg_trace_spans_dropped_total"
SLO_JUDGED_TOTAL = "rbg_slo_judged_total"
SLO_TTFT_MET_TOTAL = "rbg_slo_ttft_met_total"
SLO_TPOT_MET_TOTAL = "rbg_slo_tpot_met_total"
SLO_GOODPUT_TOTAL = "rbg_slo_goodput_total"
LOCKTRACE_INVERSIONS_TOTAL = "rbg_locktrace_inversions_total"
KVC_TIER_HITS_TOTAL = "rbg_kvcache_tier_hits_total"
KVC_TIER_MISSES_TOTAL = "rbg_kvcache_tier_misses_total"
KVC_TIER_SPILLED_PAGES_TOTAL = "rbg_kvcache_tier_spilled_pages_total"
KVC_TIER_PROMOTED_PAGES_TOTAL = "rbg_kvcache_tier_promoted_pages_total"
KVC_TIER_EVICTED_PAGES_TOTAL = "rbg_kvcache_tier_evicted_pages_total"
KVT_DIR_REPLICATIONS_TOTAL = "rbg_kvtransfer_dir_replications_total"
KVT_INTEGRITY_FAILURES_TOTAL = "rbg_kvtransfer_integrity_failures_total"
ROUTER_INGRESS_TOKENS_TOTAL = "rbg_router_ingress_tokens_total"
ROUTER_RING_ROUTES_TOTAL = "rbg_router_ring_routes_total"
ROUTER_RING_RESHARDS_TOTAL = "rbg_router_ring_reshards_total"
ROUTER_PEER_EVENTS_TOTAL = "rbg_router_peer_events_total"
KVT_CHUNKS_TOTAL = "rbg_kvtransfer_chunks_total"
KVT_BYTES_TOTAL = "rbg_kvtransfer_bytes_total"
KVT_STREAMS_TOTAL = "rbg_kvtransfer_streams_total"
KVT_LAYER_ADMIT_TOTAL = "rbg_kvtransfer_layer_admit_total"
KVT_DIR_LOOKUPS_TOTAL = "rbg_kvtransfer_dir_lookups_total"
KVT_DIR_INVALIDATIONS_TOTAL = "rbg_kvtransfer_dir_invalidations_total"
KVT_DIR_BREAKER_OPEN_TOTAL = "rbg_kvtransfer_dir_breaker_open_total"
KVT_CHUNKS_DUPLICATE_TOTAL = "rbg_kvtransfer_chunks_duplicate_total"
KVT_CHUNKS_REORDERED_TOTAL = "rbg_kvtransfer_chunks_reordered_total"
CHAOS_FAULTS_INJECTED_TOTAL = "rbg_chaos_faults_injected_total"
# control plane
RECONCILE_TOTAL = "rbg_reconcile_total"
RECONCILE_REQUEUES_TOTAL = "rbg_reconcile_requeues_total"
RECONCILE_DEDUPED_TOTAL = "rbg_reconcile_deduped_total"
WORKQUEUE_ADDS_TOTAL = "rbg_workqueue_adds_total"
RESYNC_BACKSTOP_ENQUEUED_TOTAL = "rbg_resync_backstop_enqueued_total"
RESYNC_BACKSTOP_SKIPPED_TOTAL = "rbg_resync_backstop_skipped_total"
SCHED_SHARD_SCANS_TOTAL = "rbg_sched_shard_scans_total"
SCHED_SHARD_SKIPS_TOTAL = "rbg_sched_shard_skips_total"
SCHED_BINDS_TOTAL = "rbg_sched_binds_total"
WATCH_REPLAYS_TOTAL = "rbg_watch_replays_total"
WATCH_EVENTS_TOTAL = "rbg_watch_events_total"
WATCH_DELIVERIES_TOTAL = "rbg_watch_deliveries_total"
EVENTS_RECORDED_TOTAL = "rbg_events_recorded_total"
EVENTS_DEDUPED_TOTAL = "rbg_events_deduped_total"
EVENTS_EVICTED_TOTAL = "rbg_events_evicted_total"
PLANE_FENCED_WRITES_TOTAL = "rbg_plane_fenced_writes_total"
DISRUPTION_SPARES_CONSUMED_TOTAL = "rbg_disruption_spares_consumed_total"

# ---- gauges ----

SERVING_DRAINING = "rbg_serving_draining"
SLO_TTFT_ATTAINMENT = "rbg_slo_ttft_attainment"
SLO_TPOT_ATTAINMENT = "rbg_slo_tpot_attainment"
SLO_GOODPUT_RPS = "rbg_slo_goodput_rps"
ROUTER_BACKEND_OUTSTANDING = "rbg_router_backend_outstanding"
ROUTER_BACKEND_DRAINING = "rbg_router_backend_draining"
KVT_LINK_RATE = "rbg_kvtransfer_link_bytes_per_s"
KVC_TIER_PAGES = "rbg_kvcache_tier_pages"
KVC_TIER_BYTES = "rbg_kvcache_tier_bytes"
ROUTER_RING_MEMBERS = "rbg_router_ring_members"
SERVING_RETRY_BUDGET_TOKENS = "rbg_serving_retry_budget_tokens"
DEGRADED_MODE = "rbg_degraded_mode"
KVT_DIR_ENTRIES = "rbg_kvtransfer_dir_entries"
# control plane
WORKQUEUE_DEPTH = "rbg_workqueue_depth"
WORKQUEUE_RETRIES_PENDING = "rbg_workqueue_retries_pending"
EVENTS_OBJECTS = "rbg_events_objects"
DISRUPTION_SPARE_POOL_DEPTH = "rbg_disruption_spare_pool_depth"

# ---- histograms ----

SERVING_QUEUE_DEPTH = "rbg_serving_queue_depth"
SERVING_REQUEST_DURATION_SECONDS = "rbg_serving_request_duration_seconds"
SERVING_BATCH_OCCUPANCY = "rbg_serving_batch_occupancy"
SERVING_JOIN_LATENCY_SECONDS = "rbg_serving_join_latency_seconds"
SERVING_PREDICTED_TTFT_SECONDS = "rbg_serving_predicted_ttft_seconds"
SLO_TTFT_SECONDS = "rbg_slo_ttft_seconds"
SLO_TPOT_SECONDS = "rbg_slo_tpot_seconds"
KVC_TIER_SPILL_SECONDS = "rbg_kvcache_tier_spill_seconds"
KVC_TIER_PROMOTE_SECONDS = "rbg_kvcache_tier_promote_seconds"
PD_LOCK_HOLD_SECONDS = "rbg_pd_lock_hold_seconds"
KVT_ADMIT_LEAD_SECONDS = "rbg_kvtransfer_admit_lead_seconds"
KVT_LAYER_ADMIT_LEAD_SECONDS = "rbg_kvtransfer_layer_admit_lead_seconds"
KVT_LAYER_ADMIT_COVERAGE_LAYERS = (
    "rbg_kvtransfer_layer_admit_coverage_layers")
# control plane
RECONCILE_DURATION_SECONDS = "rbg_reconcile_duration_seconds"
WORKQUEUE_QUEUE_AGE_SECONDS = "rbg_workqueue_queue_age_seconds"
WATCH_DISPATCH_SECONDS = "rbg_watch_dispatch_seconds"
SCHED_FEASIBILITY_SCAN_SECONDS = "rbg_sched_feasibility_scan_seconds"

COUNTERS = frozenset({
    SERVING_SHED_TOTAL, SERVING_DEADLINE_EXCEEDED_TOTAL, SERVING_DRAINS_TOTAL,
    SERVING_DRAIN_REFUSALS_TOTAL, SERVING_EARLY_REJECTS_TOTAL,
    SERVING_REQUESTS_FINISHED_TOTAL, SERVING_TOKENS_TOTAL, TRACE_TRACES_TOTAL,
    TRACE_SPANS_DROPPED_TOTAL, SLO_JUDGED_TOTAL, SLO_TTFT_MET_TOTAL,
    SLO_TPOT_MET_TOTAL, SLO_GOODPUT_TOTAL, LOCKTRACE_INVERSIONS_TOTAL,
    KVC_TIER_HITS_TOTAL, KVC_TIER_MISSES_TOTAL, KVC_TIER_SPILLED_PAGES_TOTAL,
    KVC_TIER_PROMOTED_PAGES_TOTAL, KVC_TIER_EVICTED_PAGES_TOTAL,
    KVT_DIR_REPLICATIONS_TOTAL, KVT_INTEGRITY_FAILURES_TOTAL,
    ROUTER_INGRESS_TOKENS_TOTAL, ROUTER_RING_ROUTES_TOTAL,
    ROUTER_RING_RESHARDS_TOTAL, ROUTER_PEER_EVENTS_TOTAL, KVT_CHUNKS_TOTAL,
    KVT_BYTES_TOTAL, KVT_STREAMS_TOTAL, KVT_LAYER_ADMIT_TOTAL,
    KVT_DIR_LOOKUPS_TOTAL, KVT_DIR_INVALIDATIONS_TOTAL,
    KVT_DIR_BREAKER_OPEN_TOTAL, KVT_CHUNKS_DUPLICATE_TOTAL,
    KVT_CHUNKS_REORDERED_TOTAL, CHAOS_FAULTS_INJECTED_TOTAL,
    RECONCILE_TOTAL, RECONCILE_REQUEUES_TOTAL, RECONCILE_DEDUPED_TOTAL,
    WORKQUEUE_ADDS_TOTAL, RESYNC_BACKSTOP_ENQUEUED_TOTAL,
    RESYNC_BACKSTOP_SKIPPED_TOTAL, SCHED_SHARD_SCANS_TOTAL,
    SCHED_SHARD_SKIPS_TOTAL, SCHED_BINDS_TOTAL, WATCH_REPLAYS_TOTAL,
    WATCH_EVENTS_TOTAL, WATCH_DELIVERIES_TOTAL, EVENTS_RECORDED_TOTAL,
    EVENTS_DEDUPED_TOTAL, EVENTS_EVICTED_TOTAL, PLANE_FENCED_WRITES_TOTAL,
    DISRUPTION_SPARES_CONSUMED_TOTAL,
})
GAUGES = frozenset({
    SERVING_DRAINING, SLO_TTFT_ATTAINMENT, SLO_TPOT_ATTAINMENT, SLO_GOODPUT_RPS,
    ROUTER_BACKEND_OUTSTANDING, ROUTER_BACKEND_DRAINING, KVT_LINK_RATE,
    KVC_TIER_PAGES, KVC_TIER_BYTES, ROUTER_RING_MEMBERS,
    SERVING_RETRY_BUDGET_TOKENS, DEGRADED_MODE, KVT_DIR_ENTRIES,
    WORKQUEUE_DEPTH, WORKQUEUE_RETRIES_PENDING, EVENTS_OBJECTS,
    DISRUPTION_SPARE_POOL_DEPTH,
})
HISTOGRAMS = frozenset({
    SERVING_QUEUE_DEPTH, SERVING_REQUEST_DURATION_SECONDS,
    SERVING_BATCH_OCCUPANCY, SERVING_JOIN_LATENCY_SECONDS,
    SERVING_PREDICTED_TTFT_SECONDS, SLO_TTFT_SECONDS, SLO_TPOT_SECONDS,
    KVC_TIER_SPILL_SECONDS, KVC_TIER_PROMOTE_SECONDS, PD_LOCK_HOLD_SECONDS,
    KVT_ADMIT_LEAD_SECONDS, KVT_LAYER_ADMIT_LEAD_SECONDS,
    KVT_LAYER_ADMIT_COVERAGE_LAYERS, RECONCILE_DURATION_SECONDS,
    WORKQUEUE_QUEUE_AGE_SECONDS, WATCH_DISPATCH_SECONDS,
    SCHED_FEASIBILITY_SCAN_SECONDS,
})
ALL_NAMES = COUNTERS | GAUGES | HISTOGRAMS

# ---- span names ----

SPAN_HTTP_REQUEST = "http.request"
SPAN_ENGINE_OP = "engine.op"
SPAN_SERVICE_QUEUE_WAIT = "service.queue_wait"
SPAN_SERVICE_SCAN = "service.scan"
SPAN_ROUTER_REQUEST = "router.request"
SPAN_ROUTER_ATTEMPT = "router.attempt"
SPAN_ROUTER_RESHARD = "router.reshard"
SPAN_PD_PREFILL = "pd.prefill"
SPAN_PD_KV_HANDOFF = "pd.kv_handoff"
SPAN_KVT_PUSH = "kvtransfer.push"
SPAN_KVT_COMMIT = "kvtransfer.commit"
SPAN_PD_LAYER_SLICED_STEP = "pd.layer_sliced_step"
SPAN_STRESS_REQUEST = "stress.request"
SPAN_CTRL_EVENT = "controller.event"
SPAN_CTRL_RECONCILE = "controller.reconcile"

SPANS = frozenset({SPAN_HTTP_REQUEST, SPAN_ENGINE_OP, SPAN_SERVICE_QUEUE_WAIT,
                   SPAN_SERVICE_SCAN, SPAN_ROUTER_REQUEST, SPAN_ROUTER_ATTEMPT,
                   SPAN_ROUTER_RESHARD, SPAN_PD_PREFILL, SPAN_PD_KV_HANDOFF,
                   SPAN_KVT_PUSH, SPAN_KVT_COMMIT, SPAN_PD_LAYER_SLICED_STEP,
                   SPAN_STRESS_REQUEST, SPAN_CTRL_EVENT, SPAN_CTRL_RECONCILE})
