"""The port's engine server as a subprocess (``python -m
rbg_tpu_torch.engine.server --device cpu --model tiny``), driven with the
reference's wire client (``rbg_tpu.engine.protocol``): health, metrics,
non-streaming and streaming generate, and an error reply."""

import os
import socket
import subprocess
import sys
import time

import pytest

from rbg_tpu.engine.protocol import recv_msg, request_once, send_msg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rbg_tpu_torch.engine.server", "--device", "cpu",
         "--model", "tiny", "--port", str(port), "--num-pages", "64",
         "--max-seq-len", "128", "--prefill-chunk", "16", "--multi-step", "2"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    addr = f"127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    try:
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                h, _, _ = request_once(addr, {"op": "health"}, timeout=2)
                if h and h.get("ok"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never healthy"
            time.sleep(0.2)
        yield addr
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_health_and_generate(server):
    h, _, _ = request_once(server, {"op": "health"}, timeout=10)
    assert h["ok"] and h["device"] == "cpu"
    r, _, _ = request_once(server, {"op": "generate", "prompt": [5, 9, 13, 2],
                                    "max_new_tokens": 6}, timeout=60)
    assert len(r["tokens"]) == 6 and r["ttft_s"] > 0
    assert all(0 <= t < 256 for t in r["tokens"])
    # Greedy is deterministic across requests.
    r2, _, _ = request_once(server, {"op": "generate", "prompt": [5, 9, 13, 2],
                                     "max_new_tokens": 6}, timeout=60)
    assert r2["tokens"] == r["tokens"]
    m, _, _ = request_once(server, {"op": "metrics"}, timeout=10)
    assert m["metrics"]["decode_tokens"] >= 10


def test_streaming_generate(server):
    host, port = server.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=60) as s:
        send_msg(s, {"op": "generate", "prompt": list(range(1, 30)),
                     "max_new_tokens": 9, "stream": True, "logprobs": True})
        toks, lps, final = [], [], None
        while final is None:
            msg, _, _ = recv_msg(s)
            assert msg is not None and "error" not in msg, msg
            toks += msg["tokens"]
            lps += msg.get("logprobs", [])
            if msg["done"]:
                final = msg
    assert len(toks) == 9 and len(lps) == 9 and final["ttft_s"] > 0
    r, _, _ = request_once(server, {"op": "generate", "prompt": list(range(1, 30)),
                                    "max_new_tokens": 9}, timeout=60)
    assert r["tokens"] == toks


def test_bad_requests_get_error_replies(server):
    r, _, _ = request_once(server, {"op": "generate", "prompt": [1, 999],
                                    "max_new_tokens": 2}, timeout=30)
    assert "outside model vocab" in r["error"]
    r, _, _ = request_once(server, {"op": "generate", "prompt": [1, 2],
                                    "json_mode": True}, timeout=30)
    assert "not ported" in r["error"]
    r, _, _ = request_once(server, {"op": "generate", "prompt": [1, 2],
                                    "top_p": 0.0}, timeout=30)
    assert "bad sampling params" in r["error"]
