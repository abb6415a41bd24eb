"""Fault injectors on the serving plane's seams
(``rbg_tpu/chaos/inject.py``): the kvtransfer ``Transport`` (chunk
streams) and the ``DirectoryClient`` wire (its ``chaos=`` hook). Each
wraps a boundary the production code already routes through, so taking
the wrapper away leaves the system as it was."""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

from rbg_tpu_torch.chaos.schedule import (BROWNOUT, CORRUPT, PARTITION,
                                          FaultSchedule)
from rbg_tpu_torch.kvtransfer.chunks import Frame, KVChunk
from rbg_tpu_torch.kvtransfer.transport import Transport


class ChaosTransport(Transport):
    """Schedule-gated fault wrapper for any chunk transport (where
    ``SlowLossyTransport`` draws its faults freely):

    * BROWNOUT: ``delay_s`` added to every frame sent in the window.
    * PARTITION: frames into a dead ``src->dst`` direction vanish, with no
      error and no FIN; the receiver's bounded wait is what saves it.
    * CORRUPT: one payload byte of an in-window data chunk flipped, the
      producer's checksum kept, within ``params["max_faults"]`` per window
      and at ``params["rate"]`` (default every chunk).
    """

    name = "chaos"

    def __init__(self, inner: Transport, schedule: FaultSchedule,
                 src: str = "prefill", dst: str = "decode"):
        super().__init__()
        self.inner = inner
        self.schedule = schedule
        self.src = src
        self.dst = dst
        # Faults spent per window (for max_faults), by window identity.
        self._spent: dict = {}

    def _corrupted(self, ch: KVChunk) -> KVChunk:
        kb = bytearray(ch.k_bytes)
        if not kb:
            return ch
        i = self.schedule.rng.randrange(len(kb))
        kb[i] ^= 0xFF
        # The checksum is deliberately not recomputed.
        return dataclasses.replace(ch, k_bytes=bytes(kb))

    def send_one(self, peer: str, frame: Frame) -> None:
        s = self.schedule
        w = s.active(BROWNOUT)
        if w is not None:
            s.note(BROWNOUT)
            time.sleep(float(w.params.get("delay_s", 0.02)))
        w = s.active(PARTITION)
        if w is not None and s.cut(w, self.src, self.dst):
            s.note(PARTITION)
            return
        w = s.active(CORRUPT)
        if w is not None and isinstance(frame, KVChunk):
            budget = w.params.get("max_faults")
            in_budget = (budget is None
                         or self._spent.get(id(w), 0) < int(budget))
            rate = float(w.params.get("rate", 1.0))
            if in_budget and (rate >= 1.0 or s.rng.random() < rate):
                self._spent[id(w)] = self._spent.get(id(w), 0) + 1
                s.note(CORRUPT)
                frame = self._corrupted(frame)
        self.inner.send_one(peer, frame)

    def recv_chunks(self, stream_id: str,
                    timeout: float = 30.0) -> Iterator[Frame]:
        return self.inner.recv_chunks(stream_id, timeout=timeout)


def directory_fault(schedule: FaultSchedule, src: str = "router",
                    dst: str = "directory"):
    """Hook for ``DirectoryClient(chaos=...)``: raises ``OSError`` while a
    PARTITION window kills src->dst, so the client's own breaker and
    degraded gauge engage."""

    def hook() -> None:
        w = schedule.active(PARTITION)
        if w is not None and schedule.cut(w, src, dst):
            schedule.note(PARTITION)
            raise OSError("chaos: directory partitioned")

    return hook
