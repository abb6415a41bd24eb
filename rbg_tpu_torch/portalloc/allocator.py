"""Cluster-wide host-port allocator.

Reference analog: ``pkg/port-allocator`` (inventory #18, Appendix E):
flag-gated singleton, random strategy in [start, start+range), config via a
JSON annotation on the pod template, results persisted as workload
annotations and injected as env vars. The port keeps the reference's
pure-Python allocator only (its fallback, identical semantics); the C++
backend of ``native/portalloc.cc`` is not ported.
"""

from __future__ import annotations

import random
from typing import Optional

from rbg_tpu_torch.utils.locktrace import named_lock
# The port has no racetrace: the reference's @_race_guard is left out.

DEFAULT_START = 30000
DEFAULT_RANGE = 5000


class PortAllocator:
    def __init__(self, start: int = DEFAULT_START, range_: int = DEFAULT_RANGE,
                 seed: int = 0):
        self.start = start
        self.range = range_
        self._used = set()  # guarded_by[portalloc.allocator]
        self._rng = random.Random(seed or None)  # guarded_by[portalloc.allocator]
        self._lock = named_lock("portalloc.allocator")

    @property
    def native(self) -> bool:
        return False

    def allocate(self) -> Optional[int]:
        with self._lock:
            if len(self._used) >= self.range:
                return None
            for _ in range(64):
                p = self.start + self._rng.randrange(self.range)
                if p not in self._used:
                    self._used.add(p)
                    return p
            for p in range(self.start, self.start + self.range):
                if p not in self._used:
                    self._used.add(p)
                    return p
            return None

    def reserve(self, port: int) -> bool:
        with self._lock:
            if port < self.start or port >= self.start + self.range or port in self._used:
                return False
            self._used.add(port)
            return True

    def release(self, port: int) -> None:
        with self._lock:
            self._used.discard(port)

    def in_use(self) -> int:
        with self._lock:
            return len(self._used)
