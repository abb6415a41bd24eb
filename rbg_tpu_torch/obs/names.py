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

# ---- gauges ----

SERVING_DRAINING = "rbg_serving_draining"
SLO_TTFT_ATTAINMENT = "rbg_slo_ttft_attainment"
SLO_TPOT_ATTAINMENT = "rbg_slo_tpot_attainment"
SLO_GOODPUT_RPS = "rbg_slo_goodput_rps"

# ---- histograms ----

SERVING_QUEUE_DEPTH = "rbg_serving_queue_depth"
SERVING_REQUEST_DURATION_SECONDS = "rbg_serving_request_duration_seconds"
SERVING_BATCH_OCCUPANCY = "rbg_serving_batch_occupancy"
SERVING_JOIN_LATENCY_SECONDS = "rbg_serving_join_latency_seconds"
SERVING_PREDICTED_TTFT_SECONDS = "rbg_serving_predicted_ttft_seconds"
SLO_TTFT_SECONDS = "rbg_slo_ttft_seconds"
SLO_TPOT_SECONDS = "rbg_slo_tpot_seconds"

COUNTERS = frozenset({
    SERVING_SHED_TOTAL, SERVING_DEADLINE_EXCEEDED_TOTAL, SERVING_DRAINS_TOTAL,
    SERVING_DRAIN_REFUSALS_TOTAL, SERVING_EARLY_REJECTS_TOTAL,
    SERVING_REQUESTS_FINISHED_TOTAL, SERVING_TOKENS_TOTAL, TRACE_TRACES_TOTAL,
    TRACE_SPANS_DROPPED_TOTAL, SLO_JUDGED_TOTAL, SLO_TTFT_MET_TOTAL,
    SLO_TPOT_MET_TOTAL, SLO_GOODPUT_TOTAL,
})
GAUGES = frozenset({
    SERVING_DRAINING, SLO_TTFT_ATTAINMENT, SLO_TPOT_ATTAINMENT, SLO_GOODPUT_RPS,
})
HISTOGRAMS = frozenset({
    SERVING_QUEUE_DEPTH, SERVING_REQUEST_DURATION_SECONDS,
    SERVING_BATCH_OCCUPANCY, SERVING_JOIN_LATENCY_SECONDS,
    SERVING_PREDICTED_TTFT_SECONDS, SLO_TTFT_SECONDS, SLO_TPOT_SECONDS,
})
ALL_NAMES = COUNTERS | GAUGES | HISTOGRAMS

# ---- span names ----

SPAN_HTTP_REQUEST = "http.request"
SPAN_ENGINE_OP = "engine.op"
SPAN_SERVICE_QUEUE_WAIT = "service.queue_wait"
SPAN_SERVICE_SCAN = "service.scan"

SPANS = frozenset({SPAN_HTTP_REQUEST, SPAN_ENGINE_OP, SPAN_SERVICE_QUEUE_WAIT,
                   SPAN_SERVICE_SCAN})
