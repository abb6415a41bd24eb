"""The ``rbg_*`` metric and span names the serving path emits, with the
values of ``rbg_tpu/obs/names.py`` so the port's series carry the same
names on the wire. Only the names the port's modules use are here."""

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
})
GAUGES = frozenset({
    SERVING_DRAINING, SLO_TTFT_ATTAINMENT, SLO_TPOT_ATTAINMENT, SLO_GOODPUT_RPS,
    ROUTER_BACKEND_OUTSTANDING, ROUTER_BACKEND_DRAINING, KVT_LINK_RATE,
    KVC_TIER_PAGES, KVC_TIER_BYTES, ROUTER_RING_MEMBERS,
    SERVING_RETRY_BUDGET_TOKENS, DEGRADED_MODE, KVT_DIR_ENTRIES,
})
HISTOGRAMS = frozenset({
    SERVING_QUEUE_DEPTH, SERVING_REQUEST_DURATION_SECONDS,
    SERVING_BATCH_OCCUPANCY, SERVING_JOIN_LATENCY_SECONDS,
    SERVING_PREDICTED_TTFT_SECONDS, SLO_TTFT_SECONDS, SLO_TPOT_SECONDS,
    KVC_TIER_SPILL_SECONDS, KVC_TIER_PROMOTE_SECONDS, PD_LOCK_HOLD_SECONDS,
    KVT_ADMIT_LEAD_SECONDS, KVT_LAYER_ADMIT_LEAD_SECONDS,
    KVT_LAYER_ADMIT_COVERAGE_LAYERS,
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

SPANS = frozenset({SPAN_HTTP_REQUEST, SPAN_ENGINE_OP, SPAN_SERVICE_QUEUE_WAIT,
                   SPAN_SERVICE_SCAN, SPAN_ROUTER_REQUEST, SPAN_ROUTER_ATTEMPT,
                   SPAN_ROUTER_RESHARD, SPAN_PD_PREFILL, SPAN_PD_KV_HANDOFF,
                   SPAN_KVT_PUSH, SPAN_KVT_COMMIT, SPAN_PD_LAYER_SLICED_STEP,
                   SPAN_STRESS_REQUEST})
