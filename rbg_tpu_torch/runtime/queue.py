"""Rate-limited work queue — k8s workqueue semantics.

Dedup (dirty/processing sets), delayed adds, per-item exponential backoff.
Reference analog: controller-runtime's workqueue + the custom rate limiters in
``pkg/utils`` (SURVEY.md §2 #25). This is the control plane's hot loop; a C++
implementation can be slotted behind the same interface (see native/).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Hashable, Optional

from rbg_tpu_torch.utils.locktrace import named_condition, named_lock
# The port has no racetrace: the reference's @_race_guard is left out.


class ExponentialBackoff:
    """Per-item failure backoff: min(base * 2^(n-1), max).

    With ``jitter=True`` the delay is DECORRELATED jitter instead
    (``min(max, uniform(base, prev*3))``): a slice-wide failure marks
    every member of the gang failed within the same millisecond, and
    pure exponential backoff then re-fires every retry in lockstep — a
    synchronized reconcile storm against the store/apiserver on each
    wave. Jittered delays spread the wave while keeping the same growth
    rate and cap."""

    def __init__(self, base: float = 0.005, max_delay: float = 30.0,
                 jitter: bool = False):
        self.base = base
        self.max_delay = max_delay
        self.jitter = jitter
        self._failures: dict = {}  # guarded_by[runtime.backoff]
        # item -> previous jittered delay  # guarded_by[runtime.backoff]
        self._prev: dict = {}
        self._lock = named_lock("runtime.backoff")

    def next_delay(self, item: Hashable) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            if not self.jitter:
                return min(self.base * (2 ** n), self.max_delay)
            import random
            # First delay seeds prev with base (standard AWS decorrelated
            # jitter): uniform(base, 3*base) — a deterministic first wait
            # of exactly `base` would leave the FIRST retry wave of a
            # slice-wide failure fully synchronized.
            prev = self._prev.get(item) or self.base
            d = min(self.max_delay, random.uniform(self.base, prev * 3))
            self._prev[item] = d
            return d

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)
            self._prev.pop(item, None)

    def seed(self, item: Hashable, failures: int) -> None:
        """Pre-charge an item's failure count (never lowering it): a
        restarted plane seeds crash-loop damping from observed pod
        restart counts instead of starting every key from zero."""
        if failures <= 0:
            return
        with self._lock:
            if failures > self._failures.get(item, 0):
                self._failures[item] = failures
                if self.jitter:
                    # Equivalent decorrelated state: the delay a run of
                    # `failures` consecutive fails would have reached.
                    self._prev[item] = min(
                        self.max_delay, self.base * (2 ** (failures - 1)))

    def retries(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def pending_count(self) -> int:
        """Items currently carrying failure backoff (not yet forgotten) —
        the per-controller retries-pending gauge."""
        with self._lock:
            return len(self._failures)

    def pending(self, top: int = 0) -> dict:
        """Snapshot of item -> consecutive-failure count, most-failed
        first; ``top`` truncates (0 = all). The admin ``controlplane`` op
        and the fleet drill's no-stuck-keys invariant read this."""
        with self._lock:
            items = sorted(self._failures.items(), key=lambda kv: -kv[1])
        if top > 0:
            items = items[:top]
        return dict(items)


class WorkQueue:
    """FIFO queue with dedup + delayed add. An item present in ``processing``
    that is re-added lands in ``dirty`` and is re-queued on ``done()`` —
    guaranteeing a reconcile never runs concurrently for the same key while
    never losing an event."""

    def __init__(self):
        self._lock = named_condition("runtime.workqueue")
        self._queue: list = []  # guarded_by[runtime.workqueue]
        self._dirty: set = set()  # guarded_by[runtime.workqueue]
        self._processing: set = set()  # guarded_by[runtime.workqueue]
        # heap of (fire_time, seq, item)  # guarded_by[runtime.workqueue]
        self._delayed: list = []
        self._seq = 0  # guarded_by[runtime.workqueue]
        self._shutdown = False  # guarded_by[runtime.workqueue]

    def add(self, item: Hashable) -> None:
        with self._lock:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                self._lock.notify()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            return self.add(item)
        with self._lock:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, item))
            self._lock.notify()

    def _pump_delayed_locked(self) -> Optional[float]:
        """Move due delayed items into the queue; return wait time to next."""
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item not in self._dirty:
                self._dirty.add(item)
                if item not in self._processing:
                    self._queue.append(item)
        return (self._delayed[0][0] - now) if self._delayed else None

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            while True:
                if self._shutdown:
                    # Drop queued work on shutdown: the controller is
                    # terminal, and post-stop reconciles churn against
                    # backends that are themselves stopping (leaked ambient
                    # load was the PR-2 flake class).
                    return None
                next_delay = self._pump_delayed_locked()
                if self._queue:
                    item = self._queue.pop(0)
                    self._processing.add(item)
                    self._dirty.discard(item)
                    return item
                wait = next_delay
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining) if wait is not None else remaining
                self._lock.wait(wait if wait is not None else 1.0)

    def done(self, item: Hashable) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._lock.notify()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)
