"""Per-request SLO judgment: TTFT / TPOT targets, windowed attainment and
goodput (``rbg_tpu/obs/slo.py``).

Every finished request is judged once against ``SLOTargets`` (seconds to
first token; seconds per output token after the first; a 0 target
disables that dimension). Verdicts land in the ``rbg_slo_*`` series, and
a bounded event window answers attainment and goodput (requests/s meeting
both targets) over 10/60/300 s. The engine service judges at finish; the
``slo`` op returns every live tracker's snapshot.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from rbg_tpu_torch.obs import names, timeseries
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.obs.timeseries import WINDOWS_S

DEFAULT_TTFT_S = 2.0
DEFAULT_TPOT_S = 0.5
# Per-tracker event bound: 300 s of judgments at ~13 req/s.
_MAX_EVENTS = 4096
# Gauges are published for this window on every snapshot().
_GAUGE_WINDOW_S = 60.0


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """``ttft_s``: seconds to first token; ``tpot_s``: seconds per output
    token after the first. 0 disables a dimension (always met)."""

    ttft_s: float = DEFAULT_TTFT_S
    tpot_s: float = DEFAULT_TPOT_S

    def as_dict(self) -> dict:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s}

    def verdict(self, ttft_s, tpot_s) -> Tuple[bool, bool]:
        """(ttft_ok, tpot_ok): a disabled dimension is always met; a missing
        measurement (None) fails an enabled one."""
        ttft_ok = self.ttft_s <= 0 or (ttft_s is not None
                                       and ttft_s <= self.ttft_s)
        tpot_ok = self.tpot_s <= 0 or (tpot_s is not None
                                       and tpot_s <= self.tpot_s)
        return ttft_ok, tpot_ok


class _Event:
    __slots__ = ("t", "labels", "ttft_ok", "tpot_ok")

    def __init__(self, t, labels, ttft_ok, tpot_ok):
        self.t = t
        self.labels = labels
        self.ttft_ok = ttft_ok
        self.tpot_ok = tpot_ok


class SLOTracker:
    """One judgment stream. ``judge()`` records a verdict and its registry
    series; ``attainment()`` / ``snapshot()`` answer windowed fractions and
    goodput, optionally grouped by a label."""

    def __init__(self, targets: Optional[SLOTargets] = None,
                 component: str = "service"):
        self.targets = targets or SLOTargets()
        self.component = component
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=_MAX_EVENTS)
        self._judged = 0
        self._met = [0, 0, 0]     # ttft, tpot, both
        register_tracker(self)

    def judge(self, ttft_s: float, tpot_s: float, **labels) -> dict:
        """Judge one finished request; publishes the rbg_slo_* series with
        ``labels`` and this tracker's component."""
        ttft_ok, tpot_ok = self.targets.verdict(ttft_s, tpot_s)
        both = ttft_ok and tpot_ok
        ev = _Event(time.monotonic(), tuple(sorted(labels.items())),
                    ttft_ok, tpot_ok)
        with self._lock:
            self._events.append(ev)
            self._judged += 1
            self._met[0] += ttft_ok
            self._met[1] += tpot_ok
            self._met[2] += both
        lbl = dict(labels, component=self.component)
        REGISTRY.inc(names.SLO_JUDGED_TOTAL, **lbl)
        if ttft_ok:
            REGISTRY.inc(names.SLO_TTFT_MET_TOTAL, **lbl)
        if tpot_ok:
            REGISTRY.inc(names.SLO_TPOT_MET_TOTAL, **lbl)
        if both:
            REGISTRY.inc(names.SLO_GOODPUT_TOTAL, **lbl)
        REGISTRY.observe(names.SLO_TTFT_SECONDS, ttft_s, **lbl)
        REGISTRY.observe(names.SLO_TPOT_SECONDS, tpot_s, **lbl)
        return {"ttft_ok": ttft_ok, "tpot_ok": tpot_ok, "goodput": both}

    def judged_total(self) -> int:
        with self._lock:
            return self._judged

    def totals(self) -> dict:
        with self._lock:
            judged, (ttft, tpot, both) = self._judged, tuple(self._met)
        return {"judged": judged, "ttft_met": ttft, "tpot_met": tpot,
                "goodput": both}

    @staticmethod
    def _frac(num: int, den: int) -> Optional[float]:
        return round(num / den, 4) if den else None

    def attainment(self, window_s: float,
                   group_by: Optional[Iterable[str]] = None) -> Dict[str, dict]:
        """Attainment over the window, grouped by the given label names (or
        one ``"all"`` group)."""
        cutoff = time.monotonic() - window_s
        keys = tuple(group_by or ())
        with self._lock:
            events = [e for e in self._events if e.t >= cutoff]
        groups: Dict[str, List[_Event]] = {}
        for e in events:
            if keys:
                lbl = dict(e.labels)
                gk = ",".join(f"{k}={lbl.get(k, '')}" for k in keys)
            else:
                gk = "all"
            groups.setdefault(gk, []).append(e)
        out = {}
        for gk, evs in sorted(groups.items()):
            n = len(evs)
            good = sum(1 for e in evs if e.ttft_ok and e.tpot_ok)
            out[gk] = {
                "judged": n,
                "ttft_attainment": self._frac(
                    sum(1 for e in evs if e.ttft_ok), n),
                "tpot_attainment": self._frac(
                    sum(1 for e in evs if e.tpot_ok), n),
                "goodput_attainment": self._frac(good, n),
                "goodput_rps": round(good / window_s, 4),
            }
        return out

    def snapshot(self, group_by: Optional[Iterable[str]] = None) -> dict:
        """Targets, totals and per-window attainment; publishes the 60 s
        attainment and goodput gauges."""
        out = {
            "component": self.component,
            "targets": self.targets.as_dict(),
            "totals": self.totals(),
            "windows": {f"{int(w)}s": self.attainment(w, group_by=group_by)
                        for w in WINDOWS_S},
        }
        overall = self.attainment(_GAUGE_WINDOW_S).get("all")
        if overall:
            if overall["ttft_attainment"] is not None:
                REGISTRY.set_gauge(names.SLO_TTFT_ATTAINMENT,
                                   overall["ttft_attainment"],
                                   component=self.component)
            if overall["tpot_attainment"] is not None:
                REGISTRY.set_gauge(names.SLO_TPOT_ATTAINMENT,
                                   overall["tpot_attainment"],
                                   component=self.component)
            REGISTRY.set_gauge(names.SLO_GOODPUT_RPS, overall["goodput_rps"],
                               component=self.component)
        return out


# The process's live trackers, newest _MAX_TRACKERS only.
_MAX_TRACKERS = 16
_TRACKERS: List[SLOTracker] = []
_REG_LOCK = threading.Lock()


def register_tracker(tracker: SLOTracker) -> None:
    with _REG_LOCK:
        _TRACKERS.append(tracker)
        del _TRACKERS[:-_MAX_TRACKERS]


def trackers() -> List[SLOTracker]:
    with _REG_LOCK:
        return list(_TRACKERS)


def slo_response(window=None) -> dict:
    """The ``slo`` op's reply: every tracker's snapshot plus the windowed
    signals of the process's sampler. ``window`` (seconds) picks the
    headline window; malformed input reads as 60, clamped to [1, 3600].
    ``cache`` stays empty: the port has no KV tier hierarchy."""
    try:
        w = float(window)
    except (TypeError, ValueError):
        w = 60.0
    w = max(1.0, min(w, 3600.0))
    sampler = timeseries.SAMPLER

    def signals(window_s: float) -> dict:
        def r(v, nd=4):
            return round(v, nd) if v is not None else None
        return {
            "requests_per_s": r(sampler.rate(
                names.SERVING_REQUESTS_FINISHED_TOTAL, window_s)),
            "tokens_per_s": r(sampler.rate(
                names.SERVING_TOKENS_TOTAL, window_s), 2),
            "shed_per_s": r(sampler.rate(names.SERVING_SHED_TOTAL, window_s)),
            "deadline_exceeded_per_s": r(sampler.rate(
                names.SERVING_DEADLINE_EXCEEDED_TOTAL, window_s)),
            "goodput_per_s": r(sampler.rate(names.SLO_GOODPUT_TOTAL, window_s)),
            "queue_depth_mean": r(sampler.mean_observed(
                names.SERVING_QUEUE_DEPTH, window_s), 2),
            "occupancy_mean": r(sampler.mean_observed(
                names.SERVING_BATCH_OCCUPANCY, window_s)),
            "ttft_mean_s": r(sampler.mean_observed(
                names.SLO_TTFT_SECONDS, window_s)),
            "tpot_mean_s": r(sampler.mean_observed(
                names.SLO_TPOT_SECONDS, window_s)),
        }

    return {
        "window_s": w,
        "sampler": sampler.stats(),
        "signals": signals(w),
        "signals_by_window": {f"{int(ws)}s": signals(ws) for ws in WINDOWS_S},
        "cache": {},
        "trackers": [t.snapshot(group_by=("role",)) for t in trackers()],
    }
