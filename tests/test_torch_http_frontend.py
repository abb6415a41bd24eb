"""The port's OpenAI front end (``rbg_tpu_torch.engine.http_frontend``)
against the reference's (``rbg_tpu.engine.http_frontend``): both run in
this process in front of one scripted wire backend, and every case sends
the same request to both. Statuses, bodies (``id`` and ``created``
removed), SSE event streams and the fields forwarded to the backend must
be equal: stop strings, streaming hold-back, logprobs shapes, forwarded
sampling and grammar fields, ``response_format``, 400s and backend
rejections, the request id. Then the port's front end in front of the
port's tiny server on the CPU, with grammar-constrained requests."""

import http.client
import json
import re
import socketserver
import threading
import time

import pytest

from rbg_tpu.engine import http_frontend as j_hf
from rbg_tpu_torch.engine import http_frontend as t_hf
from rbg_tpu_torch.engine.protocol import recv_obj, send_msg
from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

TOK = ByteTokenizer()
SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"},
    "state": {"enum": ["on", "off"]},
}}


class _Backend:
    """A wire backend replying with a canned token stream (``set``), or
    with a canned error frame; records every data request it saw."""

    def __init__(self):
        self.seen = []
        self.set("ok")
        mock = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        obj = recv_obj(self.request)
                    except (ConnectionError, json.JSONDecodeError):
                        return
                    if obj is None:
                        return
                    if obj.get("op") == "health":
                        send_msg(self.request, {"ok": True, "mode": "unified"})
                        continue
                    mock.seen.append(obj)
                    try:
                        mock.reply(self.request, obj)
                    except OSError:
                        return      # the front end cut the stream (a stop string)

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), H)
        self.server.daemon_threads = True
        self.addr = "127.0.0.1:%d" % self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def set(self, text, logprobs=False, frame_size=3, error=None):
        self.tokens = TOK.encode(text, add_bos=False)
        self.logprobs = [-0.5] * len(self.tokens) if logprobs else None
        self.frame_size = frame_size
        self.error = error

    def reply(self, sock, obj):
        if self.error is not None:
            send_msg(sock, dict(self.error))
            return
        if obj.get("op") == "embed":
            vecs = [[float(len(p)), 0.5, -1.0] for p in obj["prompts"]]
            send_msg(sock, {"embeddings": vecs, "dim": 3, "embedding": vecs[0]})
            return
        toks, lps = self.tokens, self.logprobs
        if not obj.get("stream"):
            resp = {"tokens": toks, "ttft_s": 0.01}
            if lps and obj.get("logprobs"):
                resp["logprobs"] = lps
            send_msg(sock, resp)
            return
        for i in range(0, len(toks), self.frame_size):
            frame = {"tokens": toks[i:i + self.frame_size], "done": False}
            if lps and obj.get("logprobs"):
                frame["logprobs"] = lps[i:i + self.frame_size]
            send_msg(sock, frame)
        send_msg(sock, {"tokens": [], "done": True, "ttft_s": 0.01})

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _frontend(module, backend_addr):
    ns = type("A", (), {})()
    ns.host, ns.port = "127.0.0.1", 0
    ns.backend = backend_addr
    ns.model, ns.tokenizer_path, ns.default_max_tokens = "tiny", "", 16
    server = module.serve(ns)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


@pytest.fixture(scope="module")
def pair():
    be = _Backend()
    ref, ref_port = _frontend(j_hf, be.addr)
    port, port_port = _frontend(t_hf, be.addr)
    yield be, ref_port, port_port
    for s in (ref, port):
        s.shutdown()
        s.server_close()
    be.close()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _http(port, method, path, body=None, headers=None, raw=None):
    """(status, headers, JSON body or list of SSE payloads)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        payload = r.read()
        if r.getheader("Content-Type") == "text/event-stream":
            events = [p[len(b"data: "):] for p in payload.split(b"\n\n")
                      if p.startswith(b"data: ")]
            out = [e.decode() if e == b"[DONE]" else json.loads(e) for e in events]
        else:
            out = json.loads(payload)
        return r.status, dict(r.getheaders()), out
    finally:
        conn.close()


def _same(pair, method, path, body=None, **kw):
    """Send to both front ends; their statuses and stripped bodies must be
    equal, and so must the backend requests they made. Returns the port's
    (status, headers, body)."""
    be, ref_port, port_port = pair
    n0 = len(be.seen)
    want = _http(ref_port, method, path, body, **kw)
    seen_ref = [dict(o) for o in be.seen[n0:]]
    n1 = len(be.seen)
    got = _http(port_port, method, path, body, **kw)
    seen_port = [dict(o) for o in be.seen[n1:]]
    assert got[0] == want[0]
    assert _strip(got[2]) == _strip(want[2])
    assert seen_port == seen_ref
    return got


CASES = [
    # (canned text, logprobs, frame size, path, body)
    ("hello STOP world", False, 3, "/v1/completions",
     {"prompt": "x", "stop": ["STOP"], "max_tokens": 32}),
    ("ab STOP tail", False, 2, "/v1/completions",
     {"prompt": "x", "stop": "STOP", "max_tokens": 32, "stream": True}),
    ("plain text out", False, 4, "/v1/completions",
     {"prompt": "x", "max_tokens": 32, "stream": True}),
    ("abc", True, 3, "/v1/completions",
     {"prompt": "x", "logprobs": 1, "max_tokens": 8}),
    ("abc", True, 3, "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "x"}], "logprobs": True,
      "max_tokens": 8}),
    ("hello STOP world", True, 3, "/v1/completions",
     {"prompt": "x", "stop": ["STOP"], "logprobs": 1, "max_tokens": 32}),
    ("abcdef", True, 2, "/v1/completions",
     {"prompt": "x", "logprobs": 1, "max_tokens": 32, "stream": True}),
    ("abcdef", True, 2, "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "x"}], "logprobs": True,
      "max_tokens": 32, "stream": True}),
    ("STOP right away", True, 3, "/v1/completions",
     {"prompt": "x", "stop": ["STOP"], "logprobs": 1, "max_tokens": 32}),
    ("hello STOP world", True, 2, "/v1/completions",
     {"prompt": "x", "stop": ["STOP"], "logprobs": 1, "max_tokens": 32,
      "stream": True}),
    ("héllo wörld 你好", False, 1, "/v1/chat/completions",
     {"messages": [{"role": "system", "content": "s"},
                   {"role": "user", "content": "x"}], "stream": True}),
    ("ok", False, 3, "/v1/completions",
     {"prompt": ["a", "b"], "temperature": 0.7, "top_p": 0.9, "min_p": 0.05,
      "top_k": 40, "seed": 123, "presence_penalty": 0.1,
      "frequency_penalty": 0.2, "repetition_penalty": 1.1, "max_tokens": 4,
      "timeout_s": 30}),
]


@pytest.mark.parametrize("text,lp,frame,path,body", CASES)
def test_completions_match_reference(pair, text, lp, frame, path, body):
    pair[0].set(text, logprobs=lp, frame_size=frame)
    status, _, out = _same(pair, "POST", path, body)
    assert status == 200 and out


@pytest.mark.parametrize("fields,wire", [
    ({"response_format": {"type": "json_object"}}, {"json_mode": True}),
    ({"response_format": {"type": "json_schema",
                          "json_schema": {"name": "s", "schema": SCHEMA}}},
     {"json_schema": SCHEMA}),
    ({"response_format": {"type": "text"}}, {}),
    ({"guided_json": SCHEMA}, {"json_schema": SCHEMA}),
    ({"guided_regex": r"\d{3}-\d{4}"}, {"regex": r"\d{3}-\d{4}"}),
    ({"regex": ""}, {"regex": ""}),
], ids=["json_object", "json_schema", "text", "guided_json", "guided_regex",
        "empty_regex"])
def test_grammar_fields_map_like_reference(pair, fields, wire):
    pair[0].set("{}")
    for path, body in (("/v1/completions", {"prompt": "x"}),
                       ("/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "x"}]})):
        status, _, _ = _same(pair, "POST", path, {**body, **fields, "max_tokens": 4})
        assert status == 200
        seen = pair[0].seen[-1]
        for k in ("json_mode", "regex", "json_schema"):
            assert seen.get(k) == wire.get(k), k


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "x", "temperature": -1}),
    ("/v1/completions", {"prompt": "x", "temperature": "hot"}),
    ("/v1/completions", {"prompt": "x", "max_tokens": "abc"}),
    ("/v1/completions", {"prompt": "x", "top_p": None}),
    ("/v1/completions", {"prompt": "x", "timeout_s": 0}),
    ("/v1/completions", {"prompt": "x", "stop": 5}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "response_format": {"type": "json_schema"}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "response_format": {"type": "xml"}}),
    ("/v1/completions", {"prompt": "x", "guided_json": "not a schema"}),
    ("/v1/completions", {"prompt": "x", "json_mode": True,
                         "response_format": {"type": "json_object"},
                         "regex": "a"}),
    ("/v1/embeddings", {"input": []}),
    ("/v1/embeddings", {"input": [""]}),
    ("/v1/nothing", {}),
])
def test_bad_requests_match_reference(pair, path, body):
    status, _, out = _same(pair, "POST", path, body)
    assert status in (400, 404) and out["error"]["type"] == "invalid_request_error"


def test_bad_json_body_and_get_routes_match_reference(pair):
    status, _, _ = _same(pair, "POST", "/v1/completions", raw=b"{nope")
    assert status == 400
    for path in ("/healthz", "/v1/models", "/v1/nothing"):
        _same(pair, "GET", path)


@pytest.mark.parametrize("frame,status", [
    ({"error": "queue full", "code": "overloaded", "retry_after_s": 0.3}, 429),
    ({"error": "server is draining", "code": "draining", "retry_after_s": 2.0}, 503),
    ({"error": "spent", "code": "deadline_exceeded"}, 504),
    ({"error": "boom"}, 502),
])
def test_backend_rejections_match_reference(pair, frame, status):
    pair[0].set("ok", error=frame)
    try:
        for stream in (False, True):
            got = _same(pair, "POST", "/v1/completions",
                        {"prompt": "x", "max_tokens": 4, "stream": stream})
            assert got[0] == status
            if "retry_after_s" in frame:
                assert got[1]["Retry-After"] == str(int(-(-frame["retry_after_s"] // 1)))
    finally:
        pair[0].set("ok")


def test_embeddings_match_reference(pair):
    status, _, out = _same(pair, "POST", "/v1/embeddings",
                           {"input": ["ab", "cde"], "model": "tiny"})
    assert status == 200 and [d["embedding"][0] for d in out["data"]] == [2.0, 3.0]


def test_request_id_stamped_and_echoed(pair):
    _, _, port = pair
    pair[0].set("hi")
    _, h, _ = _http(port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 4},
                    headers={"X-Request-Id": "req-mine-42"})
    assert h["X-Request-Id"] == "req-mine-42"
    _, h, _ = _http(port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 4})
    assert h["X-Request-Id"].startswith("req-")
    _, h, _ = _http(port, "POST", "/v1/completions",
                    {"prompt": "x", "max_tokens": 4, "stream": True},
                    headers={"X-Request-Id": "req-s"})
    assert h["X-Request-Id"] == "req-s"
    _, h, _ = _http(port, "GET", "/v1/models")
    assert "X-Request-Id" not in h


def test_traceparent_continues_the_trace(pair):
    """With tracing on, a sampled W3C traceparent parents the edge's
    http.request span, and the backend request carries its wire context;
    with tracing off nothing rides the wire."""
    from rbg_tpu_torch.obs import trace

    be, _, port = pair
    be.set("hi")
    old = (trace._CFG.enabled, trace._CFG.sample)
    trace.configure(enabled=True, sample=1.0)
    trace.SINK.reset()
    try:
        tid, parent = "ab" * 16, "cd" * 8
        _http(port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 4},
              headers={"traceparent": f"00-{tid}-{parent}-01"})
        wire = be.seen[-1]["trace"]
        assert wire["trace_id"] == tid and wire["sampled"]
        recs, deadline = [], time.monotonic() + 10
        while not recs and time.monotonic() < deadline:
            recs = [r for r in trace.SINK.recent(10) if r["trace_id"] == tid]
            time.sleep(0.01)
        span = recs[0]["spans"][0]
        assert span["name"] == "http.request" and span["parent_id"] == parent
        assert span["attrs"]["status"] == 200 and wire["parent_id"] == span["span_id"]
        _http(port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 4},
              headers={"traceparent": f"00-{tid}-{parent}-00"})
        assert "trace" not in be.seen[-1]
        trace.configure(enabled=False)
        _http(port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 4})
        assert "trace" not in be.seen[-1]
    finally:
        trace.configure(enabled=old[0], sample=old[1])
        trace.SINK.reset()


# ---- the port's front end in front of the port's server ----


def test_frontend_serves_grammar_from_the_port_server():
    """tiny (vocab 512) on the CPU behind the port's server, the grammar
    wired from the byte tokenizer: a guided_regex completion fullmatches,
    a json_schema chat reply validates, a streamed greedy completion
    equals the non-streamed one, embeddings come back, and an
    unsupported response_format is a 400."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService

    svc = EngineService(EngineConfig(model="tiny", vocab_size=512, page_size=8,
                                     num_pages=64, max_seq_len=256,
                                     prefill_chunk=16, multi_step=2, device="cpu"))
    svc.engine.enable_json_grammar(TOK)
    srv = start_server(svc, tokenizer=TOK)
    fe, port = _frontend(t_hf, srv.addr)
    try:
        assert _http(port, "GET", "/healthz")[2]["ok"]
        assert _http(port, "GET", "/v1/models")[2]["data"][0]["id"] == "tiny"
        st, _, out = _http(port, "POST", "/v1/completions",
                           {"prompt": "call ", "guided_regex": r"\d{3}-\d{4}",
                            "max_tokens": 12})
        c = out["choices"][0]
        assert st == 200 and c["finish_reason"] == "stop"
        assert re.fullmatch(r"\d{3}-\d{4}", c["text"])
        st, _, out = _http(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "state?"}], "max_tokens": 60,
            "response_format": {"type": "json_schema",
                                "json_schema": {"name": "s", "schema": SCHEMA}}})
        c = out["choices"][0]
        assert st == 200
        if c["finish_reason"] == "stop":
            doc = json.loads(c["message"]["content"])
            assert set(doc) == {"id", "state"} and doc["state"] in ("on", "off")
        body = {"prompt": "hello", "max_tokens": 10}
        plain = _http(port, "POST", "/v1/completions", body)[2]["choices"][0]["text"]
        events = _http(port, "POST", "/v1/completions", {**body, "stream": True})[2]
        assert events[-1] == "[DONE]"
        assert "".join(e["choices"][0]["text"] for e in events[:-1]) == plain
        st, _, out = _http(port, "POST", "/v1/embeddings", {"input": ["ab", "abc"]})
        assert st == 200 and len(out["data"]) == 2
        assert len(out["data"][0]["embedding"]) == svc.engine.mcfg.hidden_size
        st, _, out = _http(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}],
            "response_format": {"type": "yaml"}})
        assert st == 400 and out["error"]["type"] == "invalid_request_error"
    finally:
        fe.shutdown()
        fe.server_close()
        srv.shutdown()
        srv.server_close()
        svc.stop()
