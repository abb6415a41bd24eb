"""Metrics registry: counters, gauges and histograms keyed by name and
labels (``rbg_tpu/obs/metrics.py``'s ``Registry``, without the text
exposition, which the engine server does not serve).

Histograms keep the reference's buckets, sum, count, observed max and,
per bucket, the slowest observation's trace id (an exemplar), which the
``traces`` op returns so a bad quantile links to a trace.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Optional, Tuple

_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
            1.0, 2.5, 5.0, 10.0)


def _key(name: str, labels: dict) -> Tuple[str, tuple]:
    return name, tuple(sorted(labels.items()))


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = defaultdict(float)
        self._hist: Dict[Tuple[str, tuple], list] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}

    def inc(self, name: str, value: float = 1.0, **labels):
        key = _key(name, labels)
        with self._lock:
            self._counters[key] += value

    def set_gauge(self, name: str, value: float, **labels):
        """Last-write-wins gauge (drain state, attainment, ...)."""
        key = _key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, exemplar: Optional[str] = None,
                **labels):
        """Record one value; ``exemplar`` is a trace id remembered for the
        bucket the value lands in (the slowest value per bucket wins)."""
        key = _key(name, labels)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                # buckets, sum, count, observed max, per-bucket exemplar
                h = [[0] * (len(_BUCKETS) + 1), 0.0, 0, 0.0,
                     [None] * (len(_BUCKETS) + 1)]
                self._hist[key] = h
            for i, b in enumerate(_BUCKETS):
                if value <= b:
                    break
            else:
                i = len(_BUCKETS)
            h[0][i] += 1
            h[1] += value
            h[2] += 1
            h[3] = max(h[3], value)
            if exemplar is not None:
                ex = h[4][i]
                if ex is None or value >= ex[0]:
                    h[4][i] = (value, exemplar)

    def exemplars_snapshot(self) -> list:
        """Every bucket exemplar of every histogram series, flat."""
        with self._lock:
            out = []
            for (name, labels), h in sorted(self._hist.items()):
                for i, ex in enumerate(h[4]):
                    if ex is None:
                        continue
                    out.append({
                        "metric": name, "labels": dict(labels),
                        "le": (str(_BUCKETS[i]) if i < len(_BUCKETS)
                               else "+Inf"),
                        "value": round(ex[0], 6), "trace_id": ex[1]})
            return out

    def snapshot_values(self):
        """Point-in-time copies for the windowed sampler: ``(counters,
        hists)`` keyed by ``(name, sorted labels)``, histograms reduced to
        ``(sum, count)``."""
        with self._lock:
            counters = dict(self._counters)
            hists = {k: (h[1], h[2]) for k, h in self._hist.items()}
        return counters, hists


REGISTRY = Registry()
