"""IntOrString — rolling-update knobs that accept an int or a percent.

Reference analog: ``intstr.IntOrString`` consumed via
``GetScaledValueFromIntOrPercent`` in the workload reconcilers
(``sts_reconciler.go:198-449`` percent handling). Kubernetes rounding
conventions are preserved: **maxSurge rounds UP**, **maxUnavailable rounds
DOWN** (so "25%" of 3 replicas surges 1 but only takes 0 unavailable —
the engines then floor the combined budget to 1 to keep progress).
"""

from __future__ import annotations

import math
import re
from typing import Union

IntOrStr = Union[int, str]

_PCT = re.compile(r"^(\d+)%$")


def validate(value: IntOrStr, name: str = "value") -> None:
    """Admission check: ints must be >= 0 is the caller's rule; strings
    must be a whole-number percent like ``"25%"``."""
    if isinstance(value, str):
        if not _PCT.match(value.strip()):
            raise ValueError(
                f"{name}: {value!r} is not an integer or a percent "
                f"(expected e.g. 1 or \"25%\")")


def resolve(value: IntOrStr, total: int, *, round_up: bool,
            name: str = "value") -> int:
    """Scale ``value`` against ``total`` replicas. Ints pass through."""
    if isinstance(value, str):
        m = _PCT.match(value.strip())
        if not m:
            raise ValueError(
                f"{name}: {value!r} is not an integer or a percent")
        pct = int(m.group(1))
        scaled = pct * total / 100.0
        return math.ceil(scaled) if round_up else math.floor(scaled)
    return int(value)
