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
import torch

from rbg_tpu.engine.protocol import recv_msg, request_once, send_msg
from rbg_tpu_torch.engine.config import SamplingParams
from rbg_tpu_torch.engine.server import build_config, parse_args
from rbg_tpu_torch.engine.service import EngineService

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
    # json_mode is served: the server wired the grammar from its
    # tokenizer, so every token stays legal under the JSON grammar.
    from rbg_tpu_torch.engine.grammar import JsonGrammar, TokenGrammar, token_bytes_for
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    r, _, _ = request_once(server, {"op": "generate", "prompt": [1, 2],
                                    "json_mode": True, "max_new_tokens": 6},
                           timeout=30)
    assert "error" not in r and len(r["tokens"]) == 6
    tok = ByteTokenizer()
    g = TokenGrammar(JsonGrammar(), token_bytes_for(tok), tok.eos_id)
    s = g.initial()
    for t in r["tokens"]:
        s = g.advance_token(s, t)
        assert s is not None, r["tokens"]
    r, _, _ = request_once(server, {"op": "generate", "prompt": [1, 2],
                                    "top_p": 0.0}, timeout=30)
    assert "bad sampling params" in r["error"]


def test_kv_dtype_and_model_flags():
    """--kv-dtype int8 builds an int8 pool that serves, for a GQA model and
    for an MLA model (int8 latent pools)."""
    base = ["--device", "cpu", "--num-pages", "32", "--max-seq-len", "64",
            "--prefill-chunk", "8"]
    for model in ("tiny", "tiny-mla"):
        cfg = build_config(parse_args(base + ["--model", model, "--kv-dtype", "int8"]))
        assert cfg.kv_dtype == "int8"
        svc = EngineService(cfg)
        try:
            assert svc.engine.cache.quantized
            assert svc.engine.cache.k_pages.dtype == torch.int8
            assert svc.engine.mcfg.mla == (model == "tiny-mla")
            p = svc.submit_wait([5, 9, 13, 2], SamplingParams(max_new_tokens=4))
            assert len(p.tokens) == 4
        finally:
            svc.stop()
    assert build_config(parse_args(base + ["--model", "deepseek-v2-lite"])
                        ).model_config.mla


# ---- the serving surface: generate_text, embed, slo, traces, auth, drain ----


@pytest.fixture(scope="module")
def text_server():
    """The port's server in this process on tiny with a 512-token vocab
    (the byte tokenizer's ids fit), on JAX's converted weights, with an
    auth token; and the reference's service on the same weights."""
    import jax
    import numpy as np

    from rbg_tpu.engine.config import EngineConfig as JConfig
    from rbg_tpu.engine.service import EngineService as JService
    from rbg_tpu.models import get_config as j_get_config, init_params as j_init
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.convert import params_from_numpy

    kw = dict(model="tiny", vocab_size=512, page_size=8, num_pages=64,
              max_seq_len=128, prefill_chunk=16)
    jp = j_init(j_get_config("tiny", vocab_size=512), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           get_config("tiny", vocab_size=512), "cpu")
    svc = EngineService(EngineConfig(**kw), params=tp, device="cpu")
    ref = JService(JConfig(use_pallas="never", **kw), params=jp)
    srv = start_server(svc, auth_token="s3cret")
    try:
        yield srv, ref
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()
        ref.stop()


def _ask(srv, obj, token="s3cret"):
    from rbg_tpu_torch.engine.protocol import request_obj
    if token:
        obj = {**obj, "token": token}
    return request_obj(srv.addr, obj, timeout=120)


def test_generate_text_matches_reference(text_server):
    from rbg_tpu.engine.config import SamplingParams as JSampling
    from rbg_tpu.engine.tokenizer import ByteTokenizer as JByte

    srv, ref = text_server
    tok = JByte()
    for text, n in (("hello world", 12), ("naïve 東京", 7)):
        r = _ask(srv, {"op": "generate_text", "text": text, "max_new_tokens": n})
        ids, _ = ref.submit(tok.encode(text), JSampling.from_wire(
            {"max_new_tokens": n}, default_max_tokens=64, stop_token=tok.eos_id))
        assert r["tokens"] == ids and r["text"] == tok.decode(ids), r
        assert r["ttft_s"] > 0
    r = _ask(srv, {"op": "generate_text", "text": "x" * 120, "max_new_tokens": 20})
    assert "exceeds max_seq_len" in r["error"]


def test_embed_op_matches_reference(text_server):
    import numpy as np

    from rbg_tpu.engine.service import embed_prompts as j_embed

    srv, ref = text_server
    prompts = [[1, 2, 3], list(range(5, 45))]
    r = _ask(srv, {"op": "embed", "prompts": prompts})
    assert r["dim"] == 128 and len(r["embeddings"]) == 2
    assert r["prompt_tokens"] == 43 and r["embedding"] == r["embeddings"][0]
    want = np.asarray(j_embed(ref.engine, prompts))
    assert np.max(np.abs(np.asarray(r["embeddings"]) - want)) < 1e-4
    r = _ask(srv, {"op": "embed", "text": "hi"})
    assert r["dim"] == 128
    assert "outside model vocab" in _ask(srv, {"op": "embed", "prompt": [999]})["error"]


def test_slo_and_traces_replies_have_reference_keys(text_server):
    from rbg_tpu.obs.slo import slo_response
    from rbg_tpu.obs.trace import traces_response

    srv, _ = text_server
    _ask(srv, {"op": "generate", "prompt": [3, 4, 5], "max_new_tokens": 3})
    got, want = _ask(srv, {"op": "slo", "window": 30}, token=None), slo_response(30)
    assert set(got) == set(want)
    assert set(got["signals"]) == set(want["signals"])
    assert set(got["signals_by_window"]) == set(want["signals_by_window"])
    assert set(got["sampler"]) == set(want["sampler"])
    mine = [t for t in got["trackers"] if t["component"] == "engineservice"]
    assert max(t["totals"]["judged"] for t in mine) >= 1
    assert all(set(t) == {"component", "targets", "totals", "windows"}
               for t in mine)
    got, want = _ask(srv, {"op": "traces", "n": 5}), traces_response(5)
    assert set(got) == set(want)


def test_auth_refuses_wrong_token_and_leaves_probes_open(text_server):
    srv, _ = text_server
    for token in (None, "wrong"):
        for op in ({"op": "generate", "prompt": [1, 2], "max_new_tokens": 2},
                   {"op": "traces"}, {"op": "warmup"}, {"op": "embed",
                                                         "prompt": [1]}):
            assert _ask(srv, op, token=token) == {"error": "unauthorized"}
    h = _ask(srv, {"op": "health"}, token=None)
    assert h["ok"] and h["draining"] is False
    m = _ask(srv, {"op": "metrics"}, token=None)["metrics"]
    for key in ("draining", "estimated_wait_s", "slo_judged_total", "shed_total",
                "join_wait_steps_max"):
        assert key in m, key
    assert "window_s" in _ask(srv, {"op": "slo"}, token=None)
    assert len(_ask(srv, {"op": "generate", "prompt": [1, 2],
                          "max_new_tokens": 2})["tokens"]) == 2
    # A unified server answers the disaggregated ops as the reference's
    # does: unsupported in its mode.
    for op in ("prefill", "decode_bundle", "kv_stream", "decode_stream"):
        assert _ask(srv, {"op": op, "prompt": [1]})["error"] == \
            f"unsupported op {op!r} in mode unified"


def test_start_drain_refuses_new_data_ops():
    """In process: with a stream in flight, ``start_drain`` refuses a new
    generate with ``draining``; the stream finishes, then the listener
    shuts down."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.protocol import CODE_DRAINING
    from rbg_tpu_torch.engine.protocol import recv_obj
    from rbg_tpu_torch.engine.protocol import send_msg as port_send
    from rbg_tpu_torch.engine.server import start_drain, start_server

    svc = EngineService(EngineConfig(model="tiny", num_pages=32,
                                     max_seq_len=64, prefill_chunk=8),
                        device="cpu")
    step = svc.engine.step

    def slow_step():
        time.sleep(0.02)        # 40 tokens stay in flight for >= 0.8 s
        return step()

    svc.engine.step = slow_step
    srv = start_server(svc)
    try:
        host, port = srv.addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=60) as s:
            port_send(s, {"op": "generate", "prompt": [4, 5, 6], "stream": True,
                          "max_new_tokens": 40})
            assert "error" not in recv_obj(s)
            start_drain(srv, 30.0)
            r = _ask(srv, {"op": "generate", "prompt": [1, 2]}, token=None)
            assert r["code"] == CODE_DRAINING and r["done"]
            assert 0.5 <= r["retry_after_s"] <= 5.0
            assert _ask(srv, {"op": "health"}, token=None)["draining"] is True
            while not recv_obj(s)["done"]:
                pass
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()


def test_sigterm_drains_stream_then_exits_cleanly():
    """SIGTERM mid-stream: the stream completes, health reports draining,
    a new generate is refused with ``draining``, and the process exits 0.
    The drain deadline is far above the stream's time on a loaded host:
    past it the server exits and cuts the stream."""
    import signal

    from rbg_tpu.engine.protocol import CODE_DRAINING as J_DRAINING
    from rbg_tpu_torch.engine.protocol import CODE_DRAINING

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # One compute thread: the tiny model needs no more, and a loaded host
    # (parallel test workers) would otherwise slow every step many times.
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rbg_tpu_torch.engine.server", "--device", "cpu",
         "--model", "tiny", "--port", str(port), "--num-pages", "64",
         "--max-seq-len", "256", "--prefill-chunk", "16",
         "--drain-deadline-s", "600"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    addr = f"127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
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
        with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
            send_msg(s, {"op": "generate", "prompt": [7, 3, 5, 11], "stream": True,
                         "max_new_tokens": 200})
            first, _, _ = recv_msg(s)
            assert first is not None and "error" not in first, first
            proc.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + 10
            while not request_once(addr, {"op": "health"}, timeout=5)[0].get(
                    "draining"):
                assert time.monotonic() < deadline, "never reported draining"
                time.sleep(0.02)
            r, _, _ = request_once(addr, {"op": "generate", "prompt": [1, 2],
                                          "max_new_tokens": 4}, timeout=10)
            assert r["code"] == CODE_DRAINING == J_DRAINING, r
            tokens = list(first.get("tokens") or [])
            while True:
                frame, _, _ = recv_msg(s)
                assert frame is not None and "error" not in frame, frame
                tokens += frame.get("tokens") or []
                if frame.get("done"):
                    break
        assert len(tokens) == 200
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
