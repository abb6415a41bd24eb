"""Fault schedules (``rbg_tpu/chaos/schedule.py``): a list of
``FaultWindow``s read against an injectable clock, so the same schedule,
seed and clock script replay the same faults in the same order and a
chaos drill is a regression test.

Fault kinds, one per degradation ladder:

* ``PARTITION``: asymmetric link death. ``params["dead"]`` lists the
  ``"src->dst"`` directions that blackhole (A to B dead while B to A
  delivers).
* ``CORRUPT``: payload bytes of KV chunks flipped in flight, the
  producer's checksum left as it was, so the receiver's verify-at-commit
  must catch it.
* ``SKEW``: per-process clock offset (``params["offsets"]``: name to
  seconds).
* ``BROWNOUT``: ``params["delay_s"]`` added to every frame sent while the
  window is open.

Every applied fault counts under ``rbg_chaos_faults_injected_total`` by
kind; the partition drill's ``all_faults_counted`` invariant reads it.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence

from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY

PARTITION = "partition"
CORRUPT = "corrupt"
SKEW = "skew"
BROWNOUT = "brownout"

KINDS = (PARTITION, CORRUPT, SKEW, BROWNOUT)


@dataclasses.dataclass
class FaultWindow:
    """One scheduled fault: ``kind`` active over ``[t_start, t_end)`` on
    the schedule's clock, shaped by ``params``."""

    kind: str
    t_start: float
    t_end: float
    params: Dict = dataclasses.field(default_factory=dict)

    def active_at(self, t: float) -> bool:
        return self.t_start <= t < self.t_end


class ChaosClock:
    """Scripted clock with a settable skew; callable, thread-safe."""

    def __init__(self, t0: float = 0.0):
        self._lock = threading.Lock()
        self._t = float(t0)
        self._skew = 0.0

    def __call__(self) -> float:
        with self._lock:
            return self._t + self._skew

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += float(dt)
            return self._t + self._skew

    def set(self, t: float) -> None:
        with self._lock:
            self._t = float(t)

    def skew(self, offset: float) -> None:
        """A constant offset on top of the scripted time."""
        with self._lock:
            self._skew = float(offset)


class FaultSchedule:
    """Seeded, clock-driven fault activation. ``clock`` is any zero-arg
    callable; determinism is the caller scripting it."""

    def __init__(self, windows: Sequence[FaultWindow],
                 clock: Callable[[], float], seed: int = 0):
        self.windows: List[FaultWindow] = list(windows)
        self.clock = clock
        self.rng = random.Random(seed)

    def now(self) -> float:
        return float(self.clock())

    def active(self, kind: str,
               now: Optional[float] = None) -> Optional[FaultWindow]:
        """The first ``kind`` window open at ``now`` (schedule order)."""
        t = self.now() if now is None else now
        for w in self.windows:
            if w.kind == kind and w.active_at(t):
                return w
        return None

    def note(self, kind: str, n: float = 1.0) -> None:
        """Count ``n`` applied faults of ``kind``."""
        REGISTRY.inc(obs_names.CHAOS_FAULTS_INJECTED_TOTAL, float(n), kind=kind)

    @staticmethod
    def cut(window: FaultWindow, src: str, dst: str) -> bool:
        """True when ``window`` (a PARTITION) kills the src->dst direction."""
        return f"{src}->{dst}" in (window.params.get("dead") or ())


class SkewedClock:
    """A base clock as one named process reads it under a schedule's SKEW
    windows: the base plus this process's offset while a window is open.
    The skew counts once per window entry, not per read."""

    def __init__(self, base: Callable[[], float], schedule: FaultSchedule,
                 who: str):
        self.base = base
        self.schedule = schedule
        self.who = who
        self._noted = False

    def __call__(self) -> float:
        t = float(self.base())
        w = self.schedule.active(SKEW, now=t)
        if w is None:
            return t
        off = float((w.params.get("offsets") or {}).get(self.who, 0.0))
        if off and not self._noted:
            self._noted = True
            self.schedule.note(SKEW)
        elif not off:
            self._noted = False
        return t + off
