"""Deterministic chaos plane (``rbg_tpu/chaos``): schedule-driven fault
injection at the serving plane's seams (the kvtransfer transports, the
directory wire, clocks). The same schedule, seed and clock script give
the same faults at the same frames as the reference's."""

from rbg_tpu_torch.chaos.inject import ChaosTransport, directory_fault
from rbg_tpu_torch.chaos.schedule import (BROWNOUT, CORRUPT, KINDS, PARTITION,
                                          SKEW, ChaosClock, FaultSchedule,
                                          FaultWindow, SkewedClock)

__all__ = [
    "BROWNOUT", "CORRUPT", "KINDS", "PARTITION", "SKEW",
    "ChaosClock", "ChaosTransport", "FaultSchedule", "FaultWindow",
    "SkewedClock", "directory_fault",
]
