"""Transports for KV chunk streams.

One explicit seam: senders publish frames through a
``Transport``; receivers iterate them. Implementations:

* ``InProcTransport``  — queue-backed, same process (the PDPair path).
* ``TCPTransport``     — frames over the project's length-prefixed wire
  (``protocol.send_msg`` binary lanes); the DCN analog. The server side is
  whoever accepts the socket (the decode server's ``kv_stream`` op) — this
  class is the CLIENT half plus the frame codec both halves share.
* ``FakeICITransport`` — in-proc with modeled link pacing (bytes/sec +
  per-frame latency): the intra-slice interconnect stand-in the bench and
  stress drills measure overlap against.
* ``SlowLossyTransport`` — wrapper injecting delay, reordering, duplicate
  delivery, and truncation into any inner transport (stress
  ``--kv-slow-link``).

Every implementation reports OBSERVED transfer rates through ``LinkStats``
(`rbg_kvtransfer_link_bytes_per_s` et al) — the router's transfer-cost
scoring reads measured rates, never configured hopes.
"""

from __future__ import annotations

import queue
import random
import socket
import threading
import time
from typing import Dict, Iterator, List, Optional

from rbg_tpu_torch.kvtransfer.chunks import (Frame, KVChunk, StreamError,
                                       StreamFin, StreamFirstToken,
                                       StreamMeta)
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

_FIN_SENTINEL = object()


class LinkStats:
    """Measured per-link throughput (EWMA over real transfers). Keyed by
    an arbitrary peer/transport label; thread-safe leaf state."""

    ALPHA = 0.3
    MIN_SAMPLE_BYTES = 1 << 12   # ignore tiny frames; latency dominates

    def __init__(self, transport: str):
        self.transport = transport
        self._lock = named_lock("kvtransfer.linkstats")
        self._rate: Dict[str, float] = {}  # guarded_by[kvtransfer.linkstats]

    def observe(self, peer: str, nbytes: int, seconds: float) -> None:
        if seconds <= 0 or nbytes < self.MIN_SAMPLE_BYTES:
            return
        rate = nbytes / seconds
        with self._lock:
            prev = self._rate.get(peer)
            cur = rate if prev is None else \
                (1 - self.ALPHA) * prev + self.ALPHA * rate
            self._rate[peer] = cur
        REGISTRY.set_gauge(obs_names.KVT_LINK_RATE, cur,
                           transport=self.transport, peer=peer)

    def rate(self, peer: str, default: Optional[float] = None) -> Optional[float]:
        with self._lock:
            return self._rate.get(peer, default)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._rate)


class Transport:
    """Contract: ``send_chunks`` publishes an ORDERED frame sequence for a
    stream (meta first, fin last — the sender's obligation); the receiver
    side tolerates reorder/duplication anyway. ``recv_chunks`` yields
    frames until FIN (inclusive) or raises ``StreamError`` on a broken
    stream; a ``timeout`` bounds each wait so a dead sender can never
    wedge a decode thread."""

    name = "base"

    def __init__(self):
        self.stats = LinkStats(self.name)

    # -- sender half --
    def send_chunks(self, peer: str, frames) -> int:
        """Send all frames (iterable, possibly lazily produced); returns
        payload bytes moved. Blocking — run inside a sender thread when
        the producer must not stall on the link."""
        t0 = time.monotonic()
        nbytes = 0
        for frame in frames:
            self.send_one(peer, frame)
            if isinstance(frame, KVChunk):
                nbytes += frame.nbytes
                REGISTRY.inc(obs_names.KVT_CHUNKS_TOTAL, direction="sent")
        if nbytes:
            REGISTRY.inc(obs_names.KVT_BYTES_TOTAL, float(nbytes),
                         direction="sent", transport=self.name)
            self.stats.observe(peer, nbytes, time.monotonic() - t0)
        return nbytes

    def send_one(self, peer: str, frame: Frame) -> None:
        raise NotImplementedError

    # -- receiver half --
    def recv_chunks(self, stream_id: str,
                    timeout: float = 30.0) -> Iterator[Frame]:
        raise NotImplementedError


class InProcTransport(Transport):
    """Queue-per-stream transport for same-process PD pairs. ``peer`` is
    ignored (there is only one receiver side)."""

    name = "inproc"

    def __init__(self):
        super().__init__()
        self._lock = named_lock("kvtransfer.inproc")
        self._streams: Dict[str, queue.Queue] = {}  # guarded_by[kvtransfer.inproc]

    def _q(self, stream_id: str) -> queue.Queue:
        with self._lock:
            q = self._streams.get(stream_id)
            if q is None:
                q = self._streams[stream_id] = queue.Queue()
            return q

    def send_one(self, peer: str, frame: Frame) -> None:
        sid = getattr(frame, "stream_id", None)
        if sid is None:
            raise ValueError(f"frame without stream_id: {frame!r}")
        self._q(sid).put(frame)

    def recv_chunks(self, stream_id: str,
                    timeout: float = 30.0) -> Iterator[Frame]:
        q = self._q(stream_id)
        while True:
            try:
                frame = q.get(timeout=timeout)
            except queue.Empty:
                raise StreamError(
                    f"stream {stream_id}: no frame within {timeout}s "
                    f"(sender dead or link stalled)") from None
            yield frame
            if isinstance(frame, StreamFin):
                with self._lock:
                    self._streams.pop(stream_id, None)
                return


class FakeICITransport(InProcTransport):
    """In-proc transport with modeled link pacing: each frame is delayed
    by per-frame latency + payload/bandwidth, on the SENDER side (the
    producer hands frames to a pacer thread via ``send_chunks`` — use a
    sender thread when the producer must overlap). Models an ICI/DCN hop
    well enough for overlap A/Bs without real remote memory."""

    name = "fake_ici"

    def __init__(self, bytes_per_s: float = 512e6,
                 latency_s: float = 0.0005):
        super().__init__()
        self.bytes_per_s = float(bytes_per_s)
        self.latency_s = float(latency_s)

    def send_one(self, peer: str, frame: Frame) -> None:
        pay = frame.nbytes if isinstance(frame, KVChunk) else 0
        delay = self.latency_s + (pay / self.bytes_per_s
                                  if self.bytes_per_s > 0 else 0.0)
        if delay > 0:
            time.sleep(delay)
        super().send_one(peer, frame)


class SlowLossyTransport(Transport):
    """Fault-injecting wrapper for stress: per-frame delay, bounded
    reordering (a frame may overtake up to ``reorder_window`` queued
    predecessors), duplicate delivery, and optional truncation (drop all
    frames of a chosen stream past a byte budget, then deliver a
    FIN(aborted) so the receiver surfaces a structured error).

    META is never reordered ahead of nothing / behind data of its own
    stream beyond the window — the assembler tolerates any order anyway
    (it is constructed from META by the registry, which waits for it)."""

    name = "slow_lossy"

    def __init__(self, inner: Transport, delay_s: float = 0.02,
                 reorder_window: int = 3, dup_rate: float = 0.0,
                 truncate_stream: Optional[str] = None,
                 truncate_after_bytes: int = 0,
                 truncate_nth_stream: Optional[int] = None, seed: int = 0):
        super().__init__()
        self.inner = inner
        self.delay_s = delay_s
        self.reorder_window = reorder_window
        self.dup_rate = dup_rate
        self.truncate_stream = truncate_stream
        self.truncate_after_bytes = truncate_after_bytes
        # Convenience for drills: cut the Nth DISTINCT stream this link
        # carries (stream ids are minted per attempt, so a retry of the
        # victim rides a fresh id and passes).
        self.truncate_nth_stream = truncate_nth_stream
        self._streams_seen = 0
        self._rng = random.Random(seed)
        self._lock = named_lock("kvtransfer.slowlossy")
        self._sent_bytes: Dict[str, int] = {}  # guarded_by[kvtransfer.slowlossy]
        self._cut: set = set()                 # guarded_by[kvtransfer.slowlossy]
        self._pending: List[Frame] = []        # guarded_by[kvtransfer.slowlossy]

    def _truncated(self, frame: Frame) -> Optional[Frame]:
        sid = getattr(frame, "stream_id", "")
        if sid != self.truncate_stream:
            return frame
        with self._lock:
            if sid in self._cut:
                return None   # everything past the cut is dropped
            seen = self._sent_bytes.get(sid, 0)
            if isinstance(frame, KVChunk):
                seen += frame.nbytes
                self._sent_bytes[sid] = seen
            if seen > self.truncate_after_bytes:
                # Past the budget: this and later frames are dropped; the
                # stream's close becomes one aborted FIN so the receiver
                # gets a structured error, not a silent wedge.
                self._cut.add(sid)
                return StreamFin(sid, n_chunks=0, aborted=True,
                                 error="link truncated the stream")
        return frame

    def send_one(self, peer: str, frame: Frame) -> None:
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if isinstance(frame, StreamMeta) \
                and self.truncate_nth_stream is not None:
            with self._lock:
                if self._streams_seen == self.truncate_nth_stream \
                        and self.truncate_stream is None:
                    self.truncate_stream = frame.stream_id
                self._streams_seen += 1
        frame = self._truncated(frame)
        if frame is None:
            return
        emit: List[Frame] = []
        with self._lock:
            fin = isinstance(frame, StreamFin)
            flush = fin or isinstance(frame, StreamFirstToken)
            if not flush:
                self._pending.append(frame)
            # Flush in shuffled order once the window fills. Control
            # frames flush everything and go LAST in their flush: the
            # receive loop stops at FIN (an overtaking FIN would read as
            # false truncation), and a sender wants the first token
            # visible the moment it exists — reordering applies to
            # data/meta frames only.
            if len(self._pending) > self.reorder_window or flush:
                self._rng.shuffle(self._pending)
                emit, self._pending = self._pending, []
            if flush:
                emit.append(frame)
        for f in emit:
            self.inner.send_one(peer, f)
            if isinstance(f, KVChunk) and self._rng.random() < self.dup_rate:
                self.inner.send_one(peer, f)

    def recv_chunks(self, stream_id: str,
                    timeout: float = 30.0) -> Iterator[Frame]:
        return self.inner.recv_chunks(stream_id, timeout=timeout)


# ---- TCP frame codec (shared by client half and server ops) -------------


def frame_to_wire(frame: Frame):
    """(header, k_bytes, v_bytes) for ``protocol.send_msg``."""
    if isinstance(frame, StreamMeta):
        return ({"op": "kv_meta", "stream_id": frame.stream_id,
                 "prompt": list(frame.prompt), "n_pages": frame.n_pages,
                 "k_page_shape": list(frame.k_page_shape),
                 "v_page_shape": list(frame.v_page_shape),
                 "dtype": frame.dtype, "layers": frame.layers,
                 "page_size": frame.page_size}, None, None)
    if isinstance(frame, KVChunk):
        hdr = {"op": "kv_chunk", "stream_id": frame.stream_id,
               "seq": frame.seq, "layer_lo": frame.layer_lo,
               "layer_hi": frame.layer_hi, "page_lo": frame.page_lo,
               "page_hi": frame.page_hi}
        if frame.checksum is not None:
            # Omitted (not null) when absent so pre-checksum receivers
            # never see an unknown key with a surprising value.
            hdr["checksum"] = frame.checksum
        return (hdr, frame.k_bytes, frame.v_bytes)
    if isinstance(frame, StreamFirstToken):
        return ({"op": "kv_first", "stream_id": frame.stream_id,
                 "first_token": frame.first_token}, None, None)
    if isinstance(frame, StreamFin):
        return ({"op": "kv_fin", "stream_id": frame.stream_id,
                 "n_chunks": frame.n_chunks, "aborted": frame.aborted,
                 "error": frame.error}, None, None)
    raise ValueError(f"unknown frame {frame!r}")


def frame_from_wire(obj: dict, k: Optional[bytes],
                    v: Optional[bytes]) -> Frame:
    op = obj.get("op")
    if op == "kv_meta":
        return StreamMeta(stream_id=obj["stream_id"],
                          prompt=list(obj["prompt"]),
                          n_pages=int(obj["n_pages"]),
                          k_page_shape=tuple(obj["k_page_shape"]),
                          v_page_shape=tuple(obj["v_page_shape"]),
                          dtype=obj["dtype"], layers=int(obj["layers"]),
                          page_size=int(obj["page_size"]))
    if op == "kv_chunk":
        cs = obj.get("checksum")
        return KVChunk(stream_id=obj["stream_id"], seq=int(obj["seq"]),
                       layer_lo=int(obj["layer_lo"]),
                       layer_hi=int(obj["layer_hi"]),
                       page_lo=int(obj["page_lo"]),
                       page_hi=int(obj["page_hi"]),
                       k_bytes=k or b"", v_bytes=v or b"",
                       checksum=int(cs) if cs is not None else None)
    if op == "kv_first":
        return StreamFirstToken(obj["stream_id"], int(obj["first_token"]))
    if op == "kv_fin":
        return StreamFin(obj["stream_id"], n_chunks=int(obj["n_chunks"]),
                         aborted=bool(obj.get("aborted")),
                         error=obj.get("error") or "")
    raise StreamError(f"unknown kv frame op {op!r}")


class TCPTransport(Transport):
    """Client half of the TCP chunk stream: one connection per stream to
    the accepting server (the decode server's ``kv_stream`` op, or the
    standalone contract-test listener). ``peer`` is ``host:port``. The
    connection opens lazily on the first frame and closes after FIN."""

    name = "tcp"

    def __init__(self, token: Optional[str] = None,
                 connect_timeout: float = 5.0, io_timeout: float = 60.0):
        super().__init__()
        self.token = token
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self._lock = named_lock("kvtransfer.tcp")
        self._conns: Dict[str, socket.socket] = {}  # guarded_by[kvtransfer.tcp]

    def send_one(self, peer: str, frame: Frame) -> None:
        from rbg_tpu_torch.engine.protocol import send_msg

        sid = getattr(frame, "stream_id", "")
        with self._lock:
            s = self._conns.get(sid)
        if s is None:
            host, port = peer.rsplit(":", 1)
            s = socket.create_connection((host, int(port)),
                                         timeout=self.connect_timeout)
            s.settimeout(self.io_timeout)
            hello = {"op": "kv_stream", "stream_id": sid}
            if self.token:
                hello["token"] = self.token
            send_msg(s, hello)
            with self._lock:
                self._conns[sid] = s
        hdr, kb, vb = frame_to_wire(frame)
        try:
            send_msg(s, hdr, kb, vb)
        except OSError as e:
            self._close(sid)
            raise StreamError(f"kv stream {sid} to {peer} broke: {e}") from e
        if isinstance(frame, StreamFin):
            self._drain_ack(sid, s)

    def _drain_ack(self, sid: str, s: socket.socket) -> None:
        from rbg_tpu_torch.engine.protocol import recv_msg
        try:
            recv_msg(s)  # {"ok": true} / {"error": ...} — best effort
        except (OSError, ValueError):
            pass
        finally:
            self._close(sid)

    def _close(self, sid: str) -> None:
        with self._lock:
            s = self._conns.pop(sid, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def recv_chunks(self, stream_id: str,
                    timeout: float = 30.0) -> Iterator[Frame]:
        raise NotImplementedError(
            "TCP receive is socket-driven: the accepting server feeds a "
            "StreamRegistry from its kv_stream handler")
