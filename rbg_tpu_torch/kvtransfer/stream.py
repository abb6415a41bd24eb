"""Stream receiver + registry: the decode-side half of the transfer plane.

``KVStreamReceiver`` wraps a ``ChunkAssembler`` with the thread contract
the decode service needs:

* frames are FED on transport/connection threads (host-memory staging
  only — never the engine);
* ``wait_ready`` blocks a server handler until admission coverage (all
  (layer, page) cells + first token) or a structured ``StreamError``;
* the ENGINE LOOP thread drains committed-chunk deltas and performs the
  device page-table writes (single-writer engine contract) — copy outside
  the critical section, commit under it.

``StreamRegistry`` resolves arrival races: the KV stream connection and
the ``decode_stream`` request for the same ``stream_id`` may land in
either order.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.kvtransfer.chunks import (ChunkAssembler, Frame, KVChunk,
                                       StreamError, StreamFin, StreamMeta)
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_condition


class KVStreamReceiver:
    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self._cond = named_condition("kvtransfer.receiver")
        self.assembler: Optional[ChunkAssembler] = None  # guarded_by[kvtransfer.receiver]
        self._pre_meta: List[Frame] = []   # guarded_by[kvtransfer.receiver]
        self._error: Optional[str] = None  # guarded_by[kvtransfer.receiver]
        self.t_open = time.monotonic()
        self.t_ready: Optional[float] = None   # coverage+first_token time
        self.t_fin: Optional[float] = None     # stream-close time
        self.t_first_step: Optional[float] = None  # stamped by the decoder
        # Layer-sliced admission bookkeeping: the decode worker stamps
        # these when it admits at layer-k coverage (before full ready).
        self.t_layer_ready: Optional[float] = None  # min_layers reached
        self.layers_at_admit: Optional[int] = None  # coverage at admit
        self.total_layers: Optional[int] = None
        self._min_layers: int = 0          # guarded_by[kvtransfer.receiver]

    # -- producer side (transport / connection threads) --

    def feed(self, frame: Frame) -> None:
        with self._cond:
            try:
                if isinstance(frame, StreamMeta):
                    if self.assembler is None:
                        self.assembler = ChunkAssembler(frame)
                        for f in self._pre_meta:
                            self.assembler.feed(f)
                        self._pre_meta.clear()
                elif self.assembler is None:
                    # Reordered link delivered data before META — hold it.
                    self._pre_meta.append(frame)
                else:
                    self.assembler.feed(frame)
                    if isinstance(frame, KVChunk):
                        REGISTRY.inc(obs_names.KVT_CHUNKS_TOTAL,
                                     direction="recv")
            except StreamError as e:
                self._error = str(e)
            a = self.assembler
            if a is not None:
                if (self.t_layer_ready is None and self._min_layers > 0
                        and a.ready_layers(self._min_layers)):
                    self.t_layer_ready = time.monotonic()
                if self.t_ready is None and a.ready():
                    self.t_ready = time.monotonic()
                    if self.t_layer_ready is not None:
                        # The overlap the layer-sliced admission created:
                        # how long before FULL coverage the decode side
                        # could already start.
                        REGISTRY.observe(
                            obs_names.KVT_LAYER_ADMIT_LEAD_SECONDS,
                            max(0.0, self.t_ready - self.t_layer_ready))
                if a.fin is not None and self.t_fin is None:
                    self.t_fin = time.monotonic()
                    # An abort AFTER coverage is complete is harmless —
                    # the data all arrived; only an incomplete stream's
                    # abort/truncation is a failure.
                    if self._error is None and not a.ready():
                        if a.fin.aborted:
                            self._error = a.fin.error or "stream aborted"
                        else:
                            try:
                                a.check_closed()
                            except StreamError as e:
                                self._error = str(e)
                    if self.t_ready is not None and self._error is None:
                        REGISTRY.observe(
                            obs_names.KVT_ADMIT_LEAD_SECONDS,
                            max(0.0, self.t_fin - self.t_ready))
            self._cond.notify_all()

    def fail(self, msg: str) -> None:
        """Transport-level failure (connection died before FIN)."""
        with self._cond:
            if self._error is None:
                self._error = msg
            self._cond.notify_all()

    def pump(self, transport, timeout: float = 30.0) -> None:
        """Drive a transport's frame iterator into this receiver until FIN
        — the in-proc receiver-thread body."""
        try:
            for frame in transport.recv_chunks(self.stream_id,
                                               timeout=timeout):
                self.feed(frame)
        except StreamError as e:
            self.fail(str(e))

    # -- consumer side --

    def error(self) -> Optional[str]:
        with self._cond:
            return self._error

    def ready(self) -> bool:
        with self._cond:
            return (self._error is None and self.assembler is not None
                    and self.assembler.ready())

    def ready_layers(self, min_layers: int) -> bool:
        """Layer-sliced readiness: first ``min_layers`` layers fully
        covered + first token (also registers the watermark so feed()
        stamps ``t_layer_ready`` the moment it is crossed)."""
        with self._cond:
            if min_layers > self._min_layers:
                self._min_layers = min_layers
            a = self.assembler
            ok = (self._error is None and a is not None
                  and a.ready_layers(min_layers))
            if ok and self.t_layer_ready is None:
                self.t_layer_ready = time.monotonic()
            return ok

    def layer_coverage(self) -> int:
        with self._cond:
            a = self.assembler
            return 0 if a is None else a.layer_coverage()

    def wait_ready(self, timeout: float,
                   min_layers: int = 0) -> "ChunkAssembler":
        """Block until admission coverage or failure. With ``min_layers``
        > 0, returns as soon as the FIRST ``min_layers`` layers are fully
        covered (+ first token) — the layer-sliced admission entry; the
        caller must then verify per-layer watermarks before each dispatch
        and fall back to a full-coverage wait on a miss. Returns the
        assembler; raises StreamError on abort/truncation/timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            if min_layers > self._min_layers:
                self._min_layers = min_layers
            while True:
                if self._error is not None:
                    raise StreamError(self._error)
                a = self.assembler
                if a is not None:
                    if min_layers > 0 and a.ready_layers(min_layers):
                        if self.t_layer_ready is None:
                            self.t_layer_ready = time.monotonic()
                        return a
                    if a.ready():
                        return a
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StreamError(
                        f"stream {self.stream_id} not ready within "
                        f"{timeout}s (coverage "
                        f"{'n/a' if a is None else a.chunks_seen})")
                self._cond.wait(remaining)

    def drain_uncommitted(self) -> List[Tuple[int, int, int, int]]:
        """New (layer_lo, layer_hi, page_lo, page_hi) cells staged since
        the last drain — the engine-loop committer's work list."""
        with self._cond:
            if self.assembler is None:
                return []
            return self.assembler.drain_uncommitted()

    def admit_lead_s(self) -> Optional[float]:
        """Seconds between admission-readiness and stream close — the
        overlap the plane creates (None until both happened)."""
        if self.t_ready is None or self.t_fin is None:
            return None
        return self.t_fin - self.t_ready


class StreamRegistry:
    """stream_id → receiver, created by WHOEVER arrives first (the KV
    stream connection or the decode_stream request). Entries expire after
    ``ttl_s`` without consumption so an abandoned push cannot leak host
    staging buffers forever."""

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s
        self._cond = named_condition("kvtransfer.registry")
        self._streams: Dict[str, KVStreamReceiver] = {}  # guarded_by[kvtransfer.registry]

    def get_or_create(self, stream_id: str) -> KVStreamReceiver:
        with self._cond:
            self._gc_locked()
            r = self._streams.get(stream_id)
            if r is None:
                r = self._streams[stream_id] = KVStreamReceiver(stream_id)
                self._cond.notify_all()
            return r

    def pop(self, stream_id: str) -> None:
        with self._cond:
            self._streams.pop(stream_id, None)

    def active(self) -> List[str]:
        with self._cond:
            return list(self._streams)

    def _gc_locked(self) -> None:
        now = time.monotonic()
        for sid in [s for s, r in self._streams.items()
                    if now - r.t_open > self.ttl_s]:
            del self._streams[sid]
