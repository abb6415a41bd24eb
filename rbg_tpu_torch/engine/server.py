"""Engine server: the newline-JSON wire of ``rbg_tpu/engine/server.py``
(unified mode) in front of an ``EngineService``.

Ops: ``health``, ``warmup``, ``metrics``, ``generate`` (streaming or not),
``generate_text`` (through the tokenizer), ``embed``, ``slo`` and
``traces``. ``generate`` and ``generate_text`` take the grammar fields
(``json_mode``, ``regex``, ``json_schema``): the server wires the engine's
grammar from its tokenizer. The disaggregated ops (``prefill``, ``kv_stream``,
``decode_stream``, ``decode_bundle``) are not ported and get the reply of
an unknown op.

    python -m rbg_tpu_torch.engine.server --model llama3-8b --port 9000
    python -m rbg_tpu_torch.engine.server --model llama3-8b --kv-dtype int8
    python -m rbg_tpu_torch.engine.server --model deepseek-v2-lite --port 9000
    python -m rbg_tpu_torch.engine.server --device cpu --model tiny --port 0
    python -m rbg_tpu_torch.engine.server --model llama3-8b --grammar-table off
    python -m rbg_tpu_torch.engine.server --model llama3-8b --host-tier-bytes $((8<<30))

The server binds first (readiness probes connect), then builds the engine
in the background; ``health`` reports ``ok`` once it is ready. It runs on
the card unless ``--device`` says otherwise. With ``--auth-token`` (or
``RBG_DATA_TOKEN``) every op but ``health``, ``metrics`` and ``slo``
needs the token. SIGTERM drains: in-flight requests finish, new data ops
are refused with code ``draining``, and the process exits 0 when nothing
is in flight or the drain deadline passes. With ``--host-tier-bytes``
the engine spills evicted prefix pages to host memory and promotes them
back on a hit; ``metrics`` then carries ``host_tier`` (the tier's stats)
and ``device_tier_pages``. ``start_server`` serves an existing
EngineService from a thread of the calling process.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socketserver
import sys
import threading
import time
import traceback

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, CODE_DRAINING,
                                           Rejected, recv_msg, send_msg,
                                           token_ok)
from rbg_tpu_torch.engine.service import DEFAULT_TIMEOUT_S, embed_prompts
from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
from rbg_tpu_torch.obs import names, trace
from rbg_tpu_torch.obs.metrics import REGISTRY

DEFAULT_DRAIN_DEADLINE_S = 30.0


def _deadline_of(obj: dict):
    """Absolute monotonic deadline from a wire ``timeout_s`` (None = none)."""
    t = obj.get("timeout_s")
    if t is None:
        return None
    t = float(t)
    if t <= 0:
        raise ValueError(f"timeout_s must be > 0, got {t}")
    return time.monotonic() + t


class Handler(socketserver.BaseRequestHandler):
    # Ops that carry prompts: counted in flight, refused while draining,
    # traced as an ``engine.op`` span.
    _DATA_OPS = frozenset({"generate", "generate_text", "embed"})

    def handle(self):
        while True:
            try:
                obj = recv_msg(self.request)
            except (ConnectionError, json.JSONDecodeError):
                return
            if obj is None:
                return
            try:
                self._dispatch(self.server, obj)
            except ConnectionError:
                return      # client went away; its generation was cancelled
            except Exception as e:  # noqa: BLE001 — reply, keep the connection
                try:
                    send_msg(self.request, {"error": str(e)})
                except OSError:
                    return

    def _stream(self, service, pending, with_logprobs: bool, deadline):
        """Relay a pending generation as ``{"tokens": [...], "done": false}``
        frames, then a final ``done`` frame with ttft."""
        if deadline is None:
            deadline = time.monotonic() + DEFAULT_TIMEOUT_S
        sent = 0
        try:
            while True:
                done = pending.done.is_set()
                if done and pending.error:
                    frame = {"error": pending.error, "done": True}
                    if pending.code:
                        frame["code"] = pending.code
                    send_msg(self.request, frame)
                    return
                tokens = list(pending.tokens)
                n = len(tokens)
                if with_logprobs and not done:
                    n = min(n, len(pending.logprobs))
                if n > sent:
                    frame = {"tokens": tokens[sent:n], "done": False}
                    if with_logprobs:
                        frame["logprobs"] = list(pending.logprobs[sent:n])
                    send_msg(self.request, frame)
                    sent = n
                if done and sent == len(pending.tokens):
                    break
                if time.monotonic() > deadline:
                    service.cancel(pending)
                    send_msg(self.request, {"error": "generation timed out",
                                            "code": CODE_DEADLINE, "done": True})
                    return
                time.sleep(0.005)
            send_msg(self.request, {"tokens": [], "done": True,
                                    "ttft_s": service.ttft(pending)})
        except OSError:
            service.cancel(pending)   # free the slot and pages
            raise ConnectionError("client closed stream")

    def _dispatch(self, srv, obj):
        op = obj.get("op")
        if op == "health":
            resp = {"ok": srv.service is not None, "mode": "unified",
                    "device": srv.device_name, "draining": srv.draining}
            if srv.draining:
                resp["draining_for_s"] = round(
                    time.monotonic() - srv.drain_started, 3)
            send_msg(self.request, resp)
            return
        if op not in self._DATA_OPS:
            self._dispatch_data(srv, obj)
            return
        if srv.draining:
            # In-flight work finishes; new work is refused with a
            # retryable code and the drain budget left (within [0.5, 5] s).
            REGISTRY.inc(names.SERVING_DRAIN_REFUSALS_TOTAL)
            remaining = max(0.0, srv.drain_deadline_s
                            - (time.monotonic() - srv.drain_started))
            send_msg(self.request, {
                "error": "server is draining (SIGTERM received)",
                "code": CODE_DRAINING, "done": True,
                "retry_after_s": round(min(5.0, max(0.5, remaining)), 3)})
            return
        srv.note_inflight(+1)
        try:
            self._dispatch_data(srv, obj)
        finally:
            srv.note_inflight(-1)

    def _dispatch_data(self, srv, obj):
        """The auth gate, the operator ops, and the ``engine.op`` span that
        continues the request's wire trace context around a data op."""
        op = obj.get("op")
        if srv.auth_token and op not in ("metrics", "slo"):
            if not token_ok(obj.get("token"), srv.auth_token):
                send_msg(self.request, {"error": "unauthorized"})
                return
        if op == "slo":
            from rbg_tpu_torch.obs.slo import slo_response
            send_msg(self.request, slo_response(obj.get("window")))
            return
        if op == "traces":
            send_msg(self.request, trace.traces_response(obj.get("n", 10)))
            return
        if op not in self._DATA_OPS:
            self._serve(srv, obj)
            return
        span = trace.from_wire(obj.get("trace"), names.SPAN_ENGINE_OP, op=op,
                               mode="unified")
        try:
            with trace.use_span(span):
                self._serve(srv, obj)
        finally:
            span.end()

    def _serve(self, srv, obj):
        op = obj.get("op")
        service = srv.service
        if service is None:
            send_msg(self.request, {"error": "engine not ready"})
            return
        if op == "warmup":
            t0 = time.perf_counter()
            service.warmup(int(obj.get("input_len", 32)))
            send_msg(self.request, {
                "ok": True, "elapsed_s": round(time.perf_counter() - t0, 2)})
            return
        if op == "metrics":
            stats = service.stats()
            eng = service.engine
            if eng.host_tier is not None:
                stats["host_tier"] = eng.host_tier.stats()
                stats["device_tier_pages"] = (
                    eng.radix.cached_pages if eng.radix is not None else 0)
            stats["draining"] = srv.draining
            send_msg(self.request, {"metrics": stats, "mode": "unified"})
            return
        if op == "generate_text":
            self._generate_text(srv, service, obj)
            return
        if op == "generate":
            self._generate(service, obj)
            return
        if op == "embed":
            tok = srv.tokenizer
            if "prompts" in obj:
                prompts = [list(p) for p in obj["prompts"]]
            elif "text" in obj:
                prompts = [tok.encode(obj["text"], add_bos=False)]
            else:
                prompts = [list(obj.get("prompt") or [])]
            try:
                vecs = embed_prompts(service.engine, prompts)
            except ValueError as e:
                send_msg(self.request, {"error": str(e)})
                return
            send_msg(self.request, {
                "embeddings": vecs, "dim": len(vecs[0]),
                "prompt_tokens": sum(len(p) for p in prompts),
                "embedding": vecs[0]})
            return
        send_msg(self.request, {"error": f"unknown op {op!r}"})

    def _generate_text(self, srv, service, obj):
        tok = srv.tokenizer
        vocab = service.engine.mcfg.vocab_size
        if tok.vocab_size > vocab:
            send_msg(self.request, {"error": (
                f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
                f"{vocab}; pass --tokenizer-path matching the model")})
            return
        try:
            sampling = SamplingParams.from_wire(obj, default_max_tokens=64,
                                                stop_token=tok.eos_id)
            deadline = _deadline_of(obj)
        except (ValueError, TypeError) as e:
            send_msg(self.request, {"error": f"bad sampling params: {e}"})
            return
        prompt = tok.encode(obj["text"])
        limit = service.engine.cfg.max_seq_len
        if len(prompt) + sampling.max_new_tokens > limit:
            send_msg(self.request, {"error": (
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds max_seq_len {limit}")})
            return
        try:
            ids, ttft = service.submit(prompt, sampling, deadline=deadline)
        except Rejected as e:
            send_msg(self.request, e.to_wire())
            return
        send_msg(self.request, {"text": tok.decode(ids), "tokens": ids,
                                "ttft_s": ttft})

    def _generate(self, service, obj):
        try:
            sampling = SamplingParams.from_wire(obj)
            deadline = _deadline_of(obj)
        except (ValueError, TypeError) as e:
            send_msg(self.request, {"error": f"bad sampling params: {e}"})
            return
        prompt = obj["prompt"]
        if obj.get("stream"):
            try:
                pending = service.submit_async(prompt, sampling,
                                               deadline=deadline)
            except Rejected as e:
                send_msg(self.request, {**e.to_wire(), "done": True})
                return
            self._stream(service, pending, sampling.logprobs, deadline)
            return
        try:
            p = service.submit_wait(prompt, sampling, deadline=deadline)
        except Rejected as e:
            send_msg(self.request, e.to_wire())
            return
        except (TimeoutError, ValueError) as e:
            send_msg(self.request, {"error": str(e)})
            return
        resp = {"tokens": p.tokens, "ttft_s": service.ttft(p)}
        if sampling.logprobs:
            resp["logprobs"] = p.logprobs
        send_msg(self.request, resp)


class EngineServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service=None, tokenizer=None, auth_token=None,
                 drain_deadline_s: float = DEFAULT_DRAIN_DEADLINE_S):
        super().__init__(addr, Handler)
        self.service = service
        self.device_name = (None if service is None
                            else str(service.engine.device))
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        self.auth_token = auth_token or None
        self.drain_deadline_s = drain_deadline_s
        self.draining = False
        self.drain_started = 0.0
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    @property
    def addr(self) -> str:
        host, port = self.server_address[:2]
        return f"{host}:{port}"

    def note_inflight(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight += delta

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight


def start_drain(server: EngineServer, drain_deadline_s: float) -> None:
    """Flip the server into draining and schedule its shutdown: health
    reports it, new data ops are refused with ``draining``, in-flight work
    runs on; once nothing is in flight (or the deadline passes) the
    listener shuts down. A second call changes nothing."""
    if server.draining:
        return
    server.draining = True
    server.drain_started = time.monotonic()
    server.drain_deadline_s = drain_deadline_s
    REGISTRY.inc(names.SERVING_DRAINS_TOTAL)
    REGISTRY.set_gauge(names.SERVING_DRAINING, 1.0)
    print(f"draining: finishing in-flight work (deadline "
          f"{drain_deadline_s:.1f}s)", flush=True)

    def drainer():
        deadline = server.drain_started + drain_deadline_s
        while time.monotonic() < deadline:
            s = server.service
            busy = server.inflight() > 0 or (
                s is not None and (s.engine.has_work() or s._queue))
            if not busy:
                break
            time.sleep(0.05)
        aborted = server.inflight()
        print(f"drain {'complete' if not aborted else 'deadline'} after "
              f"{time.monotonic() - server.drain_started:.2f}s "
              f"({aborted} in-flight aborted)", flush=True)
        server.shutdown()

    threading.Thread(target=drainer, daemon=True, name="drainer").start()


def start_server(service, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, auth_token=None) -> EngineServer:
    """Serve ``service`` from a daemon thread; port 0 picks a free port
    (read it from ``.addr``). Stop with ``shutdown()`` + ``server_close()``."""
    server = EngineServer((host, port), service, tokenizer=tokenizer,
                          auth_token=auth_token)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="engine-server").start()
    return server


def build_config(args) -> EngineConfig:
    return EngineConfig(
        model=args.model, page_size=args.page_size, num_pages=args.num_pages,
        max_batch=args.max_batch, max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk, multi_step=args.multi_step,
        ragged=args.ragged, speculative=args.speculative, spec_k=args.spec_k,
        spec_ngram=args.spec_ngram, kv_dtype=args.kv_dtype, slo_ttft_s=args.slo_ttft_s,
        slo_tpot_s=args.slo_tpot_s, early_reject=args.early_reject,
        early_reject_factor=args.early_reject_factor,
        grammar_table=args.grammar_table,
        grammar_state_budget=args.grammar_state_budget,
        host_tier_bytes=args.host_tier_bytes,
        vocab_size=args.vocab_size, seed=args.seed, device=args.device)


def load_adapter_npz(path: str):
    """A LoRA adapter file: ``<target>.A`` [L, d, r] and ``<target>.B``
    [L, r, o] arrays and an optional scalar ``alpha`` (default 16).
    Returns (adapter, alpha)."""
    import numpy as np

    with np.load(path) as z:
        targets = sorted({k.rsplit(".", 1)[0] for k in z.files if k.endswith(".A")})
        adapter = {t: (z[f"{t}.A"], z[f"{t}.B"]) for t in targets}
        alpha = float(z["alpha"]) if "alpha" in z.files else 16.0
    return adapter, alpha


def lora_specs(specs) -> list:
    """``--lora NAME=PATH`` values → (name, adapter, alpha) triples."""
    out = []
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise ValueError(f"--lora expects NAME=PATH, got {spec!r}")
        out.append((name, *load_adapter_npz(path)))
    return out


def serve(args) -> None:
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.engine.tokenizer import load_tokenizer
    from rbg_tpu_torch.obs import timeseries

    cfg = build_config(args)
    cfg.validate()  # fail fast on bad flags, before the port binds
    # The windowed sampler the `slo` op reads starts with the process.
    timeseries.ensure_started()
    drain_deadline_s = float(
        args.drain_deadline_s if args.drain_deadline_s is not None
        else os.environ.get("RBG_DRAIN_DEADLINE_S", DEFAULT_DRAIN_DEADLINE_S))
    server = EngineServer(
        ("127.0.0.1", args.port),
        auth_token=args.auth_token or os.environ.get("RBG_DATA_TOKEN"),
        drain_deadline_s=drain_deadline_s)
    # serve() runs on the main thread, where signal() is allowed.
    signal.signal(signal.SIGTERM,
                  lambda *_: start_drain(server, drain_deadline_s))

    def init_engine():
        try:
            if args.tokenizer_path:
                server.tokenizer = load_tokenizer(args.tokenizer_path)
            # Adapters and the grammar are wired before the service is
            # published: health reports ready once it is, and a json_mode
            # request racing the wiring would be refused.
            service = EngineService(cfg, max_queue=args.max_queue or None,
                                    lora=lora_specs(args.lora))
            service.engine.enable_json_grammar(server.tokenizer)
        except Exception:  # noqa: BLE001 — a server without an engine must die
            traceback.print_exc()
            os._exit(1)
        server.device_name = str(service.engine.device)
        server.service = service
        print(f"engine ready model={cfg.model} device={service.engine.device} "
              f"addr={server.addr}", flush=True)

    threading.Thread(target=init_engine, daemon=True).start()
    print(f"engine listening on {server.addr}", flush=True)
    server.serve_forever()
    # serve_forever returns only through the drainer's shutdown().
    server.server_close()
    print("engine exited cleanly after drain", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="rbg-tpu-torch-engine")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    ap.add_argument("--port", type=int, default=9000, help="0 = any free port")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--multi-step", type=int, default=1,
                    help="decode steps per window before tokens reach the host")
    ap.add_argument("--ragged", choices=("auto", "off"), default="auto",
                    help="'off' serves through the split prefill and decode "
                         "paths instead of the ragged unified step")
    ap.add_argument("--speculative", choices=("off", "ngram"), default="off",
                    help="prompt-lookup speculative decoding (the same "
                         "tokens; needs --multi-step 1)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="most drafted tokens per speculative verify step")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="trailing n-gram length of the prompt lookup")
    ap.add_argument("--grammar-table", choices=("auto", "off"),
                    default="auto",
                    help="device grammar tables: regex / json_schema rows "
                         "decode inside the fused window; 'off' keeps the "
                         "host-masked per-token verify")
    ap.add_argument("--grammar-state-budget", type=int, default=512,
                    help="most token-level states of one grammar table (S x "
                         "V x 5 bytes on the card); a grammar over it takes "
                         "the host-masked verify")
    ap.add_argument("--lora", action="append", default=[],
                    metavar="NAME=PATH.npz",
                    help="load a LoRA adapter (repeatable): '<target>.A' "
                         "[L, d, r] and '<target>.B' [L, r, o] arrays and an "
                         "optional scalar 'alpha'")
    ap.add_argument("--kv-dtype", default="model", choices=("model", "int8"),
                    help="KV pool element type: the model's, or int8 with "
                         "per-(slot, head) scales")
    ap.add_argument("--vocab-size", type=int, default=0,
                    help="override the preset's vocab size (0 = keep; 259 "
                         "or more serves the byte tokenizer's ids)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--tokenizer-path",
                    default=os.environ.get("RBG_TOKENIZER_PATH", ""),
                    help="local HF tokenizer directory (needs transformers; "
                         "default: the byte tokenizer)")
    ap.add_argument("--auth-token", default="",
                    help="require this token on every op but health, "
                         "metrics and slo (default: $RBG_DATA_TOKEN; empty "
                         "= open)")
    ap.add_argument("--slo-ttft-s", type=float, default=2.0,
                    help="TTFT target every finished request is judged "
                         "against (0 disables the dimension)")
    ap.add_argument("--slo-tpot-s", type=float, default=0.5,
                    help="per-output-token target after the first token "
                         "(0 disables the dimension)")
    ap.add_argument("--host-tier-bytes", type=int, default=0,
                    help="host-DRAM KV spill tier budget in bytes: device "
                         "page-pool evictions spill prefix pages here and "
                         "admission promotes them back on a hit (0 = off; "
                         "needs the radix cache; not with --kv-dtype int8)")
    ap.add_argument("--early-reject", choices=("off", "auto"), default="off",
                    help="shed at admission when the predicted TTFT (queue "
                         "wait + prefill net of the prefix hit) exceeds "
                         "--early-reject-factor x --slo-ttft-s")
    ap.add_argument("--early-reject-factor", type=float, default=1.5,
                    help="early-reject gate as a multiple of --slo-ttft-s")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="service queue bound; submissions past it are shed "
                         "with code 'overloaded' (0 = unbounded)")
    ap.add_argument("--drain-deadline-s", type=float, default=None,
                    help="after SIGTERM, in-flight requests may finish for "
                         "this long before the process exits (default: "
                         "$RBG_DRAIN_DEADLINE_S or 30)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    serve(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
