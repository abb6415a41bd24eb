"""Windowed signals over the metrics registry (``rbg_tpu/obs/timeseries.py``):
one process-wide daemon sampler snapshots ``REGISTRY`` every ``INTERVAL_S``
into a ring that holds ``RETENTION_S``, and ``rate`` / ``mean_observed``
turn a series into a number over a sliding window. The ``slo`` op reads
them over ``WINDOWS_S``.

* ``rbg_*`` names must be in ``obs/names.py`` (a typo raises instead of
  reading 0);
* a query sums every series of the name whose labels include the ones
  it passes (``rate`` only; none: every series);
* a counter that went down was reset: it counts as grown from 0.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs.metrics import REGISTRY

WINDOWS_S = (10.0, 60.0, 300.0)
INTERVAL_S = 2.0
# The largest window plus one interval, so the boundary sample stays in
# the ring.
RETENTION_S = 330.0


def _check_name(name: str) -> None:
    if name.startswith("rbg_") and name not in names.ALL_NAMES:
        raise ValueError(f"metric {name!r} is not cataloged in "
                         f"rbg_tpu_torch/obs/names.py")


class _Sampler:
    """Periodic registry snapshots and windowed queries. ``start()`` spawns
    the sampling thread once."""

    def __init__(self):
        # Ring of (t, counters, hists) snapshots.
        self._samples = collections.deque(
            maxlen=int(RETENTION_S / INTERVAL_S) + 1)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "_Sampler":
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="timeseries-sampler")
                self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            self.sample_now()
            time.sleep(INTERVAL_S)

    def sample_now(self) -> None:
        """Take one snapshot. Snapshot, timestamp and append share one
        critical section, so the ring stays in time order."""
        with self._lock:
            counters, hists = REGISTRY.snapshot_values()
            self._samples.append((time.monotonic(), counters, hists))

    def stats(self) -> dict:
        with self._lock:
            n = len(self._samples)
            span = (self._samples[-1][0] - self._samples[0][0]) if n else 0.0
            running = self._thread is not None
        return {"samples": n, "interval_s": INTERVAL_S,
                "retention_s": RETENTION_S, "span_s": round(span, 3),
                "running": running}

    def _window(self, window_s: float) -> List[tuple]:
        """The samples inside the window plus the newest one at or before
        its start (the baseline a delta is measured from)."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        cutoff = samples[-1][0] - window_s
        inside = [s for s in samples if s[0] > cutoff]
        before = [s for s in samples if s[0] <= cutoff]
        if before:
            inside.insert(0, before[-1])
        return inside

    @staticmethod
    def _increase(win: List[tuple], name: str, labels: dict, field: int,
                  hist_part: Optional[int] = None):
        """Summed increase of the name's series over ``win`` and the span
        it covers (None, None under two samples). ``field`` picks the
        snapshot store; ``hist_part`` sum (0) or count (1) of a histogram."""
        if len(win) < 2:
            return None, None
        want = set(labels.items())
        total = 0.0
        prev: Dict[tuple, float] = {}
        first = True
        for sample in win:
            seen = set()
            for key, v in sample[field].items():
                if key[0] != name or not want.issubset(key[1]):
                    continue
                if hist_part is not None:
                    v = v[hist_part]
                seen.add(key)
                if key in prev:
                    d = v - prev[key]
                    total += v if d < 0 else d     # a reset grew from 0
                elif not first:
                    total += v                     # born inside the window
                prev[key] = v
            for key in [k for k in prev if k not in seen]:
                del prev[key]                      # vanished: restart later
            first = False
        return total, win[-1][0] - win[0][0]

    def rate(self, name: str, window_s: float, **labels) -> Optional[float]:
        """Per-second counter rate over the window."""
        _check_name(name)
        total, elapsed = self._increase(self._window(window_s), name, labels,
                                        field=1)
        if total is None or not elapsed:
            return None
        return total / elapsed

    def mean_observed(self, name: str, window_s: float) -> Optional[float]:
        """Mean value observed into a histogram over the window (Δsum /
        Δcount, both from one window)."""
        _check_name(name)
        win = self._window(window_s)
        dsum, _ = self._increase(win, name, {}, field=2, hist_part=0)
        dcount, _ = self._increase(win, name, {}, field=2, hist_part=1)
        if dsum is None or not dcount:
            return None
        return dsum / dcount


SAMPLER = _Sampler()


def ensure_started() -> _Sampler:
    """Start (once) and return the process-wide sampler."""
    return SAMPLER.start()
