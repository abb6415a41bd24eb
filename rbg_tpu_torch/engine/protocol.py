"""Wire protocol of the engine server: newline-delimited JSON over TCP
(a copy of the framing in ``rbg_tpu/engine/protocol.py`` and the error
codes of ``rbg_tpu/api/errors.py``), so the reference's clients and router
talk to this port's server unchanged, and the port's router to either.
The reference's binary lanes (a KV bundle's bytes after the header) come
with PD serving.

Ops served here:
  {"op": "health"}                          → {"ok": true, "mode": ...}
  {"op": "warmup", "input_len": n}          → {"ok": true, "elapsed_s": x}
  {"op": "metrics"}                         → {"metrics": {...}, "mode": ...}
  {"op": "generate", "prompt": [...], ...}  → {"tokens": [...], "ttft_s": x}
      with "stream": true → {"tokens": [...], "done": false}* then
      {"tokens": [], "done": true, "ttft_s": x}
  {"op": "generate_text", "text": "..."}    → {"text": ..., "tokens": [...], "ttft_s": x}
  {"op": "embed", "prompts": [[...], ...]}  → {"embeddings": [...], "dim": d, ...}
  {"op": "slo", "window": s}                → SLO attainment and windowed signals
  {"op": "traces", "n": k}                  → recent and slowest request traces

With an auth token set, every op but ``health``, ``metrics`` and ``slo``
carries ``"token"``; a draining server refuses new data ops with
``CODE_DRAINING``.
"""

from __future__ import annotations

import hmac
import json
import socket
import weakref
from typing import Optional, Tuple

#: Admission control shed the request (queue full). Retryable.
CODE_OVERLOADED = "overloaded"
#: The client's end-to-end budget is spent. Not retryable.
CODE_DEADLINE = "deadline_exceeded"
#: Base code of ``Rejected``.
CODE_REJECTED = "rejected"
#: The server is draining (SIGTERM): new data ops are refused. Retryable.
CODE_DRAINING = "draining"
#: A streamed KV handoff broke (PD serving); the router re-routes in
#: bundle mode.
CODE_KV_STREAM = "kv_stream_failed"

#: Codes the router may retry on a sibling backend (a shed or draining
#: backend is HEALTHY — never evicted).
RETRYABLE_REJECT_CODES = (CODE_OVERLOADED, CODE_DRAINING)

# The HTTP edge's mapping (``rbg_tpu/api/errors.py``) for the codes this
# server emits: 429 tells clients to back off (Retry-After carries the
# hint), 503 marks a draining server to rotate out, 504 a spent deadline.
CODE_HTTP_STATUS = {
    CODE_OVERLOADED: 429,
    CODE_DRAINING: 503,
    CODE_DEADLINE: 504,
}

#: code → OpenAI-style error ``type`` of the JSON error body.
CODE_HTTP_ETYPE = {
    CODE_OVERLOADED: "overloaded",
    CODE_DRAINING: "unavailable",
    CODE_DEADLINE: "timeout",
}


class Rejected(RuntimeError):
    """Structured service rejection; ``code`` rides the wire."""

    code = CODE_REJECTED

    def __init__(self, msg: str, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s

    def to_wire(self) -> dict:
        frame = {"error": str(self), "code": self.code}
        if self.retry_after_s is not None:
            frame["retry_after_s"] = round(self.retry_after_s, 3)
        return frame


class Overloaded(Rejected):
    code = CODE_OVERLOADED


class DeadlineExceeded(Rejected):
    code = CODE_DEADLINE


def token_ok(presented, expected) -> bool:
    """Constant-time bearer-token compare, on utf-8 bytes (``hmac``'s
    compare refuses non-ASCII str)."""
    return hmac.compare_digest(str(presented or "").encode("utf-8"),
                               str(expected or "").encode("utf-8"))


def send_msg(sock: socket.socket, obj: dict) -> None:
    sock.sendall(json.dumps(obj).encode() + b"\n")


# Per-socket receive buffers: bytes of the NEXT message read in one recv
# must not be lost. Keyed weakly so a buffer dies with its socket.
_rbufs: "weakref.WeakKeyDictionary[socket.socket, bytearray]" = weakref.WeakKeyDictionary()

_RECV_CHUNK = 1 << 16


def _read_line(sock: socket.socket, buf: bytearray) -> bytes:
    while True:
        nl = buf.find(b"\n")
        if nl >= 0:
            line = bytes(buf[:nl + 1])
            del buf[:nl + 1]
            return line
        chunk = sock.recv(_RECV_CHUNK)
        if not chunk:
            if buf:
                raise ConnectionError("peer closed mid-header")
            return b""
        buf.extend(chunk)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """The next message, or None when the peer closed cleanly."""
    buf = _rbufs.setdefault(sock, bytearray())
    line = _read_line(sock, buf)
    return json.loads(line) if line else None


def request_once(addr: str, obj: dict, timeout: float = 120.0) -> Optional[dict]:
    """One request/response round trip to ``host:port``."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        send_msg(s, obj)
        return recv_msg(s)


def request_stream(addr: str, obj: dict, timeout: float = 120.0) -> Tuple[list, dict]:
    """Send a streaming generate; returns (all frames, the final frame)."""
    host, port = addr.rsplit(":", 1)
    frames = []
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        send_msg(s, obj)
        while True:
            msg = recv_msg(s)
            if msg is None:
                raise ConnectionError("server closed the stream early")
            frames.append(msg)
            if msg.get("done") or "error" in msg:
                return frames, msg
