"""Wire protocol of the engine server: newline-delimited JSON over TCP
with optional raw binary KV lanes (a copy of the framing in
``rbg_tpu/engine/protocol.py`` and the error codes of
``rbg_tpu/api/errors.py``), so the reference's clients and router talk to
this port's server unchanged, and the port's router to either. A header
that carries ``bin_k`` / ``bin_v`` is followed by that many bytes of K and
then V payload (a KV bundle, a chunk of a KV stream, a pool page run): no
base64 tax on multi-MB transfers.

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
  {"op": "prefill", "prompt": [...], ...}   → bundle header + K/V bytes, or
      with "push_to" → {"pushed": ..., "stream_id": ..., "first_token": ...}
  {"op": "decode_bundle", ...hdr} + K/V     → {"tokens": [...]}
  {"op": "kv_stream", "stream_id": s}       → chunk frames in, {"ok": true} after FIN
  {"op": "decode_stream", "stream_id": s}   → {"tokens": [...]}

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

import numpy as np

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
#: A KV payload failed its end-to-end checksum (corrupted between the
#: producer and the consumer's commit). Same recovery as CODE_KV_STREAM.
CODE_KV_INTEGRITY = "kv_integrity_failed"

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


def send_msg(sock: socket.socket, obj: dict,
             k_bytes: Optional[bytes] = None,
             v_bytes: Optional[bytes] = None) -> None:
    """One header line, then the K and V lanes when ``k_bytes`` is given
    (their lengths ride the header as ``bin_k`` / ``bin_v``)."""
    obj = dict(obj)
    if k_bytes is not None:
        obj["bin_k"] = len(k_bytes)
        obj["bin_v"] = len(v_bytes or b"")
    sock.sendall(json.dumps(obj).encode() + b"\n")
    if k_bytes is not None:
        sock.sendall(k_bytes)
        if v_bytes:
            sock.sendall(v_bytes)


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


def _read_exact(sock: socket.socket, buf: bytearray, n: int) -> bytes:
    while len(buf) < n:
        chunk = sock.recv(_RECV_CHUNK)
        if not chunk:
            raise ConnectionError("peer closed mid-payload")
        buf.extend(chunk)
    out = bytes(buf[:n])
    del buf[:n]
    return out


def recv_msg(sock: socket.socket) -> Tuple[Optional[dict], Optional[bytes],
                                           Optional[bytes]]:
    """The next message as (header, k_bytes, v_bytes): the lanes are None
    when the header carries none, and all three are None when the peer
    closed cleanly."""
    buf = _rbufs.setdefault(sock, bytearray())
    line = _read_line(sock, buf)
    if not line:
        return None, None, None
    obj = json.loads(line)
    k = v = None
    if "bin_k" in obj:
        k = _read_exact(sock, buf, obj["bin_k"])
        v = _read_exact(sock, buf, obj.get("bin_v", 0))
    return obj, k, v


def recv_obj(sock: socket.socket) -> Optional[dict]:
    """``recv_msg``'s header alone (lanes read and dropped), or None when
    the peer closed cleanly: the JSON-only callers' helper."""
    return recv_msg(sock)[0]


def request_once(addr: str, obj: dict, k_bytes=None, v_bytes=None,
                 timeout: float = 120.0, ssl_context=None):
    """One request/response round trip to ``host:port`` (optionally TLS);
    returns ``recv_msg``'s (header, k_bytes, v_bytes)."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as raw:
        if ssl_context is not None:
            with ssl_context.wrap_socket(raw, server_hostname=host) as s:
                send_msg(s, obj, k_bytes, v_bytes)
                return recv_msg(s)
        send_msg(raw, obj, k_bytes, v_bytes)
        return recv_msg(raw)


def request_obj(addr: str, obj: dict, timeout: float = 120.0) -> Optional[dict]:
    """``request_once``'s reply header alone (no lanes either way)."""
    return request_once(addr, obj, timeout=timeout)[0]


def request_stream(addr: str, obj: dict, timeout: float = 120.0) -> Tuple[list, dict]:
    """Send a streaming generate; returns (all frames, the final frame)."""
    host, port = addr.rsplit(":", 1)
    frames = []
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        send_msg(s, obj)
        while True:
            msg = recv_obj(s)
            if msg is None:
                raise ConnectionError("server closed the stream early")
            frames.append(msg)
            if msg.get("done") or "error" in msg:
                return frames, msg


def bundle_to_wire(bundle) -> Tuple[dict, bytes, bytes]:
    """A ``pd.KVBundle`` as (header, k_bytes, v_bytes). The header is the
    reference's (``shape`` from k, the wire dtype name); where v's shape
    differs from k's (an MLA pool: the latent against the RoPE key) it
    also carries ``v_shape``, which the reference's header cannot say."""
    header = {
        "prompt": bundle.prompt,
        "first_token": bundle.first_token,
        "shape": list(bundle.k_data.shape),
        "dtype": bundle.dtype,
    }
    if tuple(bundle.v_data.shape) != tuple(bundle.k_data.shape):
        header["v_shape"] = list(bundle.v_data.shape)
    return header, bundle.k_data.tobytes(), bundle.v_data.tobytes()


def bundle_from_wire(header: dict, k_bytes: bytes, v_bytes: bytes):
    from rbg_tpu_torch.engine.pd import KVBundle
    from rbg_tpu_torch.kvtransfer.chunks import host_dtype

    shape = tuple(header["shape"])
    vshape = tuple(header.get("v_shape") or shape)
    dtype = host_dtype(header["dtype"])
    return KVBundle(
        prompt=list(header["prompt"]),
        first_token=int(header["first_token"]),
        k_data=np.frombuffer(k_bytes, dtype).reshape(shape),
        v_data=np.frombuffer(v_bytes, dtype).reshape(vshape),
        dtype=header["dtype"],
    )
