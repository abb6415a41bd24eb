"""Engine server: the newline-JSON wire of ``rbg_tpu/engine/server.py``
(ops ``health``, ``warmup``, ``metrics`` and ``generate``, streaming or not)
in front of an ``EngineService``.

    python -m rbg_tpu_torch.engine.server --model llama3-8b --port 9000
    python -m rbg_tpu_torch.engine.server --device cpu --model tiny --port 0

The server binds first (readiness probes connect), then builds the engine
in the background; ``health`` reports ``ok`` once it is ready. It runs on
the card unless ``--device`` says otherwise. ``start_server`` serves an
existing EngineService from a thread of the calling process.
"""

from __future__ import annotations

import argparse
import json
import os
import socketserver
import sys
import threading
import time
import traceback

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, Rejected, recv_msg,
                                           send_msg)
from rbg_tpu_torch.engine.service import DEFAULT_TIMEOUT_S


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
        service = srv.service
        if op == "health":
            send_msg(self.request, {"ok": service is not None, "mode": "unified",
                                    "device": srv.device_name})
            return
        if service is None:
            send_msg(self.request, {"error": "engine not ready"})
            return
        if op == "warmup":
            t0 = time.perf_counter()
            service.warmup(int(obj.get("input_len", 32)))
            send_msg(self.request, {"ok": True, "elapsed_s": round(
                time.perf_counter() - t0, 2)})
            return
        if op == "metrics":
            send_msg(self.request, {"metrics": service.stats(), "mode": "unified"})
            return
        if op == "generate":
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
            return
        send_msg(self.request, {"error": f"unknown op {op!r}"})


class EngineServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service=None):
        super().__init__(addr, Handler)
        self.service = service
        self.device_name = (None if service is None
                            else str(service.engine.device))

    @property
    def addr(self) -> str:
        host, port = self.server_address[:2]
        return f"{host}:{port}"


def start_server(service, host: str = "127.0.0.1", port: int = 0) -> EngineServer:
    """Serve ``service`` from a daemon thread; port 0 picks a free port
    (read it from ``.addr``). Stop with ``shutdown()`` + ``server_close()``."""
    server = EngineServer((host, port), service)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="engine-server").start()
    return server


def build_config(args) -> EngineConfig:
    return EngineConfig(
        model=args.model, page_size=args.page_size, num_pages=args.num_pages,
        max_batch=args.max_batch, max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk, multi_step=args.multi_step, vocab_size=args.vocab_size,
        seed=args.seed, device=args.device)


def serve(args) -> None:
    from rbg_tpu_torch.engine.service import EngineService

    cfg = build_config(args)
    cfg.validate()  # fail fast on bad flags, before the port binds
    server = EngineServer(("127.0.0.1", args.port))

    def init_engine():
        try:
            service = EngineService(cfg, max_queue=args.max_queue or None)
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


def main(argv=None) -> int:
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
    ap.add_argument("--vocab-size", type=int, default=0,
                    help="override the preset's vocab size (0 = keep)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="service queue bound; submissions past it are shed "
                         "with code 'overloaded' (0 = unbounded)")
    serve(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
