"""Observability of the serving path: metric registry, windowed signals,
SLO judgment and request tracing (copies of ``rbg_tpu/obs``, trimmed to
what the engine service and server use)."""
