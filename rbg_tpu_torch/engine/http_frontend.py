"""OpenAI-compatible HTTP front end with SSE streaming
(``rbg_tpu/engine/http_frontend.py``). This process is the public edge of
a serving group:

    client ──HTTP/SSE──> http_frontend ──TCP──> engine server (or router)

    python -m rbg_tpu_torch.engine.http_frontend --backend 127.0.0.1:9000 --port 8000

Endpoints:

* ``POST /v1/completions``       — OpenAI Completions (+``stream``)
* ``POST /v1/chat/completions``  — OpenAI Chat (+``stream``)
* ``POST /v1/embeddings``        — OpenAI Embeddings
* ``GET  /v1/models``            — the served model
* ``GET  /healthz``              — liveness + backend reachability

``response_format`` (``json_object``, ``json_schema``), ``guided_json``,
``guided_regex`` and ``regex`` map onto the wire's grammar fields.
Tokenization lives HERE (encode prompts, incrementally detokenize streamed
ids — ``tokenizer.IncrementalDetokenizer``); the TCP wire stays token-id
based."""

from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from rbg_tpu_torch.engine.config import SamplingParams
from rbg_tpu_torch.engine.protocol import CODE_HTTP_ETYPE as _CODE_ETYPE
from rbg_tpu_torch.engine.protocol import CODE_HTTP_STATUS as _CODE_STATUS
from rbg_tpu_torch.engine.protocol import recv_obj, request_obj, send_msg
from rbg_tpu_torch.engine.tokenizer import IncrementalDetokenizer, load_tokenizer
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs import trace

# Structured backend rejections → HTTP statuses and OpenAI-style error
# types: the mapping lives with the code catalog (protocol.py) so the
# edge and the catalog cannot drift apart.
MAX_TIMEOUT_S = 600.0


def _chat_to_prompt(messages: List[dict]) -> str:
    """Minimal chat template: role-tagged lines + assistant cue. Real
    deployments pass --tokenizer-path whose chat template could be applied;
    byte-level serving uses this plain form."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


class _State:
    def __init__(self, args):
        self.backend = args.backend
        self.model = args.model
        self.tokenizer = load_tokenizer(args.tokenizer_path or None)
        self.default_max_tokens = args.default_max_tokens
        # SSE liveness: comment frames every this-many idle seconds so
        # clients behind the router tier detect a dead hop in seconds
        # instead of waiting out TCP timeouts. 0 disables.
        self.sse_keepalive_s = float(
            getattr(args, "sse_keepalive_s", 15.0) or 0.0)
        # Data-plane bearer token attached to every backend call when the
        # serving wire is token-gated (RBG_DATA_TOKEN).
        self.data_token = os.environ.get("RBG_DATA_TOKEN") or None

    def backend_req(self, req: dict) -> dict:
        if self.data_token:
            req["token"] = self.data_token
        # Trace context rides the wire next to the token: the router (or a
        # unified engine server) continues this edge's http.request span.
        # No-op when the request is unsampled or tracing is off.
        return trace.inject(req)


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rbg-tpu"

    def log_message(self, *a):
        pass

    # ---- plumbing ----

    def _json(self, code: int, body: dict, extra_headers=None):
        data = json.dumps(body).encode()
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header("X-Request-Id", rid)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str, etype: str = "invalid_request_error",
               retry_after_s=None):
        headers = None
        if retry_after_s is not None:
            # HTTP Retry-After is integer seconds; round UP so a 0.3 s
            # hint never becomes "retry immediately".
            headers = {"Retry-After":
                       str(max(1, int(-(-float(retry_after_s) // 1))))}
        self._json(code, {"error": {"message": message, "type": etype}},
                   extra_headers=headers)

    def _backend_error(self, resp: dict):
        """Map a backend error reply: structured rejection codes get their
        HTTP status + Retry-After; anything else stays a 502."""
        resp = resp or {}
        status = _CODE_STATUS.get(resp.get("code"))
        if status is not None:
            return self._error(status, resp.get("error", "rejected"),
                               _CODE_ETYPE[resp["code"]],
                               retry_after_s=resp.get("retry_after_s"))
        return self._error(502, resp.get("error", "no response"),
                           "server_error")

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw)

    # ---- routes ----

    def do_GET(self):
        # Re-stamp per request: the handler instance persists across a
        # keep-alive connection, so a stale id from an earlier POST must
        # not be echoed on this response.
        self._request_id = self.headers.get("X-Request-Id")
        st: _State = self.server.state
        if self.path == "/healthz":
            ok, draining = True, False
            try:
                h = request_obj(st.backend, {"op": "health"}, timeout=5)
                ok = bool(h and (h.get("ok") or "pd" in h))
                draining = bool(h and h.get("draining"))
            except OSError:
                ok = False
            # A draining backend is alive but should be rotated out: 503
            # flips readiness while in-flight streams keep finishing.
            return self._json(200 if ok and not draining else 503,
                              {"ok": ok, "draining": draining,
                               "backend": st.backend})
        if self.path == "/v1/models":
            return self._json(200, {"object": "list", "data": [
                {"id": st.model, "object": "model", "owned_by": "rbg-tpu"}]})
        return self._error(404, f"no route {self.path}")

    def do_POST(self):
        # Request identity + trace ingress:
        # accept the caller's X-Request-Id (stamp one otherwise — it is
        # echoed on every response), accept a W3C ``traceparent`` header,
        # and make the http.request span ambient so the whole handler —
        # backend_req injection included — rides under it.
        self._request_id = (self.headers.get("X-Request-Id")
                            or f"req-{uuid.uuid4().hex[:16]}")
        self._status = 0
        span = trace.ingress_span(obs_names.SPAN_HTTP_REQUEST,
                                  traceparent=self.headers.get("traceparent"),
                                  path=self.path,
                                  request_id=self._request_id)
        try:
            with trace.use_span(span):
                self._handle_post()
        finally:
            span.end(status=self._status)

    def _handle_post(self):
        st: _State = self.server.state
        try:
            body = self._body()
        except json.JSONDecodeError as e:
            return self._error(400, f"bad JSON: {e}")
        if self.path == "/v1/completions":
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = "".join(prompt)
            return self._complete(st, body, prompt, chat=False)
        if self.path == "/v1/chat/completions":
            messages = body.get("messages") or []
            text = None
            if hasattr(st.tokenizer, "apply_chat_template"):
                try:
                    # The model's OWN template when the tokenizer ships one.
                    text = st.tokenizer.apply_chat_template(messages)
                except Exception as e:  # jinja TemplateError/TypeError etc.
                    return self._error(
                        400, f"messages rejected by the model's chat "
                             f"template: {e}")
            if text is None:
                text = _chat_to_prompt(messages)
            return self._complete(st, body, text, chat=True)
        if self.path == "/v1/embeddings":
            return self._embeddings(st, body)
        return self._error(404, f"no route {self.path}")

    def _embeddings(self, st: _State, body: dict):
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if (not isinstance(inputs, list) or not inputs
                or not all(isinstance(s, str) and s for s in inputs)):
            return self._error(400, "input must be a non-empty string or "
                                    "non-empty list of non-empty strings")
        if len(inputs) > 256:
            return self._error(400, "input list too large (max 256 per "
                                    "request)")
        # Tokenize EDGE-side (same contract as completions — the wire stays
        # token-ids; the backend's fallback tokenizer must never see text),
        # and ship the whole batch as ONE op → one batched forward.
        prompts = [st.tokenizer.encode(s, add_bos=False) for s in inputs]
        try:
            resp = request_obj(st.backend,
                                st.backend_req({"op": "embed",
                                                "prompts": prompts}),
                                timeout=300)
        except OSError as e:
            return self._error(502, f"backend: {e}", "server_error")
        if resp is None or "error" in (resp or {}):
            return self._backend_error(resp)
        total = sum(len(p) for p in prompts)
        data = [{"object": "embedding", "index": i, "embedding": v}
                for i, v in enumerate(resp["embeddings"])]
        return self._json(200, {
            "object": "list", "model": st.model, "data": data,
            "usage": {"prompt_tokens": total, "total_tokens": total}})

    # ---- completion core ----

    @staticmethod
    def _parse_stops(body: dict) -> List[str]:
        stop = body.get("stop")
        if stop is None:
            return []
        if not isinstance(stop, (str, list)):
            raise ValueError("stop must be a string or array of strings")
        stops = [stop] if isinstance(stop, str) else stop
        return [s for s in stops if isinstance(s, str) and s][:4]

    @staticmethod
    def _earliest_stop(text: str, stops: List[str]) -> int:
        """Index of the earliest stop-string match, or -1."""
        return min((i for i in (text.find(s) for s in stops) if i >= 0),
                   default=-1)

    @staticmethod
    def _tokens_until(tok, tokens: List[int], cut: int) -> int:
        """How many leading tokens produce the first ``cut`` chars of the
        decoded text (the token crossing the boundary is included)."""
        if cut <= 0:
            return 0
        detok = IncrementalDetokenizer(tok)
        total = 0
        for i, t in enumerate(tokens):
            total += len(detok.feed([t]))
            if total >= cut:
                return i + 1
        return len(tokens)

    @staticmethod
    def _sampling_fields(body: dict) -> dict:
        """OpenAI body → wire sampling fields (top_k / min_p /
        repetition_penalty are the usual engine extensions)."""
        out = {
            "temperature": float(body.get("temperature", 0.0)),
            "top_k": int(body.get("top_k", 0)),
            "top_p": float(body.get("top_p", 1.0)),
            "min_p": float(body.get("min_p", 0.0)),
            "repetition_penalty": float(body.get("repetition_penalty", 1.0)),
            "presence_penalty": float(body.get("presence_penalty", 0.0)),
            "frequency_penalty": float(body.get("frequency_penalty", 0.0)),
        }
        if body.get("seed") is not None:
            out["seed"] = int(body["seed"])
        if body.get("logprobs"):
            out["logprobs"] = True
        if body.get("lora"):
            out["lora"] = str(body["lora"])
        # Regex-constrained output (sglang `regex` / vLLM `guided_regex`).
        # `is not None`: "" is a legal pattern (empty output only).
        regex = body.get("regex")
        if regex is None:
            regex = body.get("guided_regex")
        if regex is not None:
            out["regex"] = str(regex)
        # Schema-constrained output (vLLM `guided_json`).
        gj = body.get("guided_json")
        if gj is not None:
            if not isinstance(gj, dict):
                raise ValueError("guided_json must be a JSON Schema object")
            out["json_schema"] = gj
        rf = body.get("response_format")
        if rf is not None:
            rft = rf.get("type") if isinstance(rf, dict) else None
            if rft == "json_object":
                out["json_mode"] = True
            elif rft == "json_schema":
                # OpenAI structured outputs: response_format.json_schema
                # .schema carries the schema itself.
                js = rf.get("json_schema")
                schema = js.get("schema") if isinstance(js, dict) else None
                if not isinstance(schema, dict):
                    raise ValueError(
                        "response_format.json_schema.schema must be a "
                        "JSON Schema object")
                out["json_schema"] = schema
            elif rft != "text":
                # Silently ignoring an unsupported constraint would return
                # unconstrained output a client will feed to json.loads.
                raise ValueError(
                    f"unsupported response_format {rft!r} (supported: "
                    "text, json_object, json_schema)")
        return out

    @staticmethod
    def _logprobs_obj(chat: bool, text_tokens: List[str],
                      lps: List[float]) -> Optional[dict]:
        if not lps:
            return None
        if chat:
            return {"content": [{"token": t, "logprob": l}
                                for t, l in zip(text_tokens, lps)]}
        return {"tokens": text_tokens, "token_logprobs": lps,
                "top_logprobs": None, "text_offset": None}

    def _complete(self, st: _State, body: dict, prompt_text: str, chat: bool):
        tok = st.tokenizer
        # No BOS: byte-fallback ids must stay inside small demo vocabs; HF
        # tokenizers add specials via their own template when configured.
        ids = tok.encode(prompt_text, add_bos=False)
        try:
            # Validate edge-side: a caller mistake must be a 400, not the
            # backend's wire error surfacing as a 502 (which retry
            # middleware would pointlessly retry). The field conversions
            # themselves can raise too ("temperature": "hot") — they
            # belong inside this guard as much as from_wire does.
            req = {
                "op": "generate",
                "prompt": ids,
                "max_new_tokens": int(body.get("max_tokens")
                                      or st.default_max_tokens),
                **self._sampling_fields(body),
            }
            if tok.eos_id is not None:
                req["stop_token"] = tok.eos_id
            # End-to-end deadline (extension field): rides the wire as
            # timeout_s; the router stamps the absolute deadline from it
            # and every hop downstream spends from that one budget.
            t = body.get("timeout_s", body.get("timeout"))
            if t is not None:
                t = float(t)
                if not 0 < t <= MAX_TIMEOUT_S:
                    raise ValueError(
                        f"timeout_s must be in (0, {MAX_TIMEOUT_S:g}]")
                req["timeout_s"] = t
            SamplingParams.from_wire(req)
            stops = self._parse_stops(body)
        except (ValueError, TypeError) as e:
            return self._error(400, f"invalid sampling parameters: {e}")
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        if body.get("stream"):
            return self._stream(st, req, rid, created, chat, stops)
        try:
            # Transport timeout shadows the end-to-end budget (+5 s grace
            # for the backend's own structured deadline reply to arrive).
            resp = request_obj(st.backend, st.backend_req(req),
                                timeout=(req["timeout_s"] + 5
                                         if "timeout_s" in req else 300))
        except OSError as e:
            return self._error(502, f"backend: {e}", "server_error")
        if resp is None or "error" in (resp or {}):
            return self._backend_error(resp)
        tokens = resp.get("tokens", [])
        lps = resp.get("logprobs", [])
        text = tok.decode(tokens)
        finish = ("stop" if (tok.eos_id is not None and tokens
                             and tokens[-1] == tok.eos_id) else "length")
        if stops:
            cut = self._earliest_stop(text, stops)
            if cut >= 0:
                # Truncate tokens/logprobs/usage with the text — the client
                # only ever sees the kept prefix (the backend generated
                # more; stop matching is this edge's concern).
                keep = self._tokens_until(tok, tokens, cut)
                tokens, lps = tokens[:keep], lps[:keep]
                text, finish = text[:cut], "stop"
        usage = {"prompt_tokens": len(ids), "completion_tokens": len(tokens),
                 "total_tokens": len(ids) + len(tokens)}
        lp_obj = (self._logprobs_obj(chat, [tok.decode([t]) for t in tokens],
                                     lps) if lps else None)
        if chat:
            choice = {"index": 0, "finish_reason": finish,
                      "message": {"role": "assistant", "content": text}}
            if lp_obj is not None:
                choice["logprobs"] = lp_obj
            return self._json(200, {
                "id": rid, "object": "chat.completion", "created": created,
                "model": st.model, "usage": usage, "choices": [choice]})
        return self._json(200, {
            "id": rid, "object": "text_completion", "created": created,
            "model": st.model, "usage": usage,
            "choices": [{"index": 0, "text": text, "logprobs": lp_obj,
                         "finish_reason": finish}]})

    def _sse(self, obj) -> None:
        data = b"data: " + json.dumps(obj).encode() + b"\n\n" \
            if obj != "[DONE]" else b"data: [DONE]\n\n"
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _sse_comment(self, text: str = "keep-alive") -> None:
        """SSE comment frame (``: ...``): ignored by every SSE parser,
        but its WRITE fails fast when the client is gone and its ARRIVAL
        tells a waiting client the path is alive — pure liveness, never
        part of the completion payload."""
        data = f": {text}\n\n".encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _chunk(self, st, rid, created, chat, text: Optional[str],
               finish: Optional[str], lp_obj: Optional[dict] = None) -> dict:
        if chat:
            delta = {} if text is None else {"content": text}
            choice = {"index": 0, "delta": delta, "finish_reason": finish}
            if lp_obj is not None:
                choice["logprobs"] = lp_obj
            return {"id": rid, "object": "chat.completion.chunk",
                    "created": created, "model": st.model,
                    "choices": [choice]}
        return {"id": rid, "object": "text_completion", "created": created,
                "model": st.model,
                "choices": [{"index": 0, "text": text or "",
                             "logprobs": lp_obj, "finish_reason": finish}]}

    def _stream(self, st: _State, req: dict, rid: str, created: int,
                chat: bool, stops: List[str] = ()):
        req["stream"] = True
        detok = IncrementalDetokenizer(st.tokenizer)
        # Stop-string hold-back: never emit the last len(longest stop)-1
        # chars until more text rules out a partial stop match.
        holdback = max((len(s) for s in stops), default=1) - 1
        buf = ""
        host, port = st.backend.rsplit(":", 1)
        try:
            conn = socket.create_connection((host, int(port)), timeout=300)
        except OSError as e:
            return self._error(502, f"backend: {e}", "server_error")
        # First frame BEFORE committing to SSE: an admission-time rejection
        # (overloaded / draining / spent deadline) must surface as a real
        # HTTP status + Retry-After — retry middleware and load balancers
        # can't see codes buried inside a 200 event stream.
        try:
            send_msg(conn, st.backend_req(req))
            first_frame = recv_obj(conn)
        except OSError as e:
            conn.close()
            return self._error(502, f"backend: {e}", "server_error")
        if first_frame is None:
            conn.close()
            return self._error(502, "backend closed before streaming",
                               "server_error")
        if "error" in first_frame:
            conn.close()
            return self._backend_error(first_frame)
        self._status = 200
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        rid_hdr = getattr(self, "_request_id", None)
        if rid_hdr:
            self.send_header("X-Request-Id", rid_hdr)
        self.end_headers()
        if chat:
            first = self._chunk(st, rid, created, chat, None, None)
            first["choices"][0]["delta"] = {"role": "assistant"}
            self._sse(first)
        finish, stopped = "length", False
        chars_out = 0                       # text chars emitted to the client
        want_lp = bool(req.get("logprobs"))
        # With stop strings, per-frame logprob chunks could cover tokens the
        # stop later cuts (text lags tokens through the hold-back buffer) —
        # defer to ONE exact chunk truncated against the emitted text.
        defer_lp = want_lp and bool(stops)
        all_toks: List[int] = []
        all_lps: List[Optional[float]] = []

        def send_text(text: str) -> None:
            nonlocal chars_out
            chars_out += len(text)
            self._sse(self._chunk(st, rid, created, chat, text, None))

        def emit_text(delta: str) -> bool:
            """Emit delta through the stop-string buffer; True = stop hit
            (buffer already flushed up to the match)."""
            nonlocal buf, finish
            if not stops:
                if delta:
                    send_text(delta)
                return False
            buf += delta
            cut = self._earliest_stop(buf, stops)
            if cut >= 0:
                if buf[:cut]:
                    send_text(buf[:cut])
                buf, finish = "", "stop"
                return True
            safe = buf[:-holdback] if holdback else buf
            if safe:
                send_text(safe)
                buf = buf[len(safe):]
            return False

        # Idle-liveness plumbing: the per-recv timeout becomes the
        # keep-alive period; each expiry emits ONE comment frame and
        # re-arms, bounded by the original 300 s true-idle cap (a hung
        # backend must still die, keepalives notwithstanding). Deadline
        # budgets are untouched — the stamp rode the FIRST request and
        # comment frames never re-arm anything downstream.
        ka_s = st.sse_keepalive_s
        idle_cap = 300.0
        last_progress = time.monotonic()
        if ka_s > 0:
            conn.settimeout(ka_s)
        try:
            with conn:
                while True:
                    if first_frame is not None:
                        frame, first_frame = first_frame, None
                    else:
                        try:
                            frame = recv_obj(conn)
                        except socket.timeout:
                            if time.monotonic() - last_progress > idle_cap:
                                break
                            self._sse_comment()
                            continue
                    if frame is None:
                        break
                    last_progress = time.monotonic()
                    if frame.get("keepalive"):
                        # Router-forwarded liveness (a backend hop is
                        # slow, not dead): surface as a comment frame —
                        # never a token chunk.
                        self._sse_comment()
                        continue
                    if "error" in frame:
                        self._sse(self._chunk(st, rid, created, chat,
                                              f"\n[error: {frame['error']}]",
                                              "stop"))
                        break
                    toks = frame.get("tokens", [])
                    if toks:
                        if (st.tokenizer.eos_id is not None
                                and toks[-1] == st.tokenizer.eos_id):
                            finish = "stop"
                        if defer_lp:
                            all_toks.extend(toks)
                            all_lps.extend(frame.get("logprobs")
                                           or [None] * len(toks))
                        hit = emit_text(detok.feed(toks))
                        if (not hit and want_lp and not defer_lp
                                and frame.get("logprobs")):
                            # Token-level logprobs ride their own chunk —
                            # text deltas lag tokens (detok buffering), so
                            # aligning them to text chunks would
                            # misattribute positions.
                            lp_obj = self._logprobs_obj(
                                chat,
                                [st.tokenizer.decode([t]) for t in toks],
                                frame["logprobs"])
                            if lp_obj is not None:
                                self._sse(self._chunk(st, rid, created, chat,
                                                      None, None, lp_obj))
                        if hit:
                            stopped = True
                            break  # client-side cut; backend stream abandoned
                    if frame.get("done"):
                        break
            if not stopped:
                tail = detok.flush()
                if stops:
                    buf += tail
                    cut = self._earliest_stop(buf, stops)
                    if cut >= 0:
                        buf, finish = buf[:cut], "stop"
                    if buf:
                        send_text(buf)
                elif tail:
                    send_text(tail)
            if defer_lp and all_toks:
                # Exactly the tokens whose text was emitted — mirrors the
                # non-stream truncation contract.
                keep = self._tokens_until(st.tokenizer, all_toks, chars_out)
                lp_obj = self._logprobs_obj(
                    chat, [st.tokenizer.decode([t]) for t in all_toks[:keep]],
                    all_lps[:keep])
                if lp_obj is not None:
                    self._sse(self._chunk(st, rid, created, chat, None, None,
                                          lp_obj))
            self._sse(self._chunk(st, rid, created, chat, None, finish))
            self._sse("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass


class FrontendServer(ThreadingHTTPServer):
    daemon_threads = True


def serve(args) -> FrontendServer:
    server = FrontendServer((args.host, args.port), Handler)
    server.state = _State(args)
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("rbg-tpu-torch OpenAI-compatible front end")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("RBG_HTTP_PORT", "8000")))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--backend",
                    default=os.environ.get("RBG_ROUTER_ADDR",
                                           "127.0.0.1:9100"),
                    help="engine server (or router) host:port")
    ap.add_argument("--model", default=os.environ.get("RBG_MODEL", "tiny"))
    ap.add_argument("--tokenizer-path",
                    default=os.environ.get("RBG_TOKENIZER_PATH", ""))
    ap.add_argument("--default-max-tokens", type=int, default=64)
    ap.add_argument("--sse-keepalive-s", type=float, default=15.0,
                    help="emit an SSE comment frame after this many idle "
                         "seconds on a live stream so clients detect dead "
                         "hops fast (0 disables)")
    args = ap.parse_args(argv)
    server = serve(args)
    print(f"http frontend on {args.host}:{args.port} -> {args.backend}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
