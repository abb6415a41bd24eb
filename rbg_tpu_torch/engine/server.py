"""Engine server: the newline-JSON wire of ``rbg_tpu/engine/server.py``
in front of an ``EngineService`` (``--mode unified``), a ``PrefillWorker``
(``--mode prefill``) or a ``DecodeService`` (``--mode decode``).

Ops: ``health``, ``warmup``, ``metrics``, ``generate`` (streaming or not),
``generate_text`` (through the tokenizer), ``embed``, ``slo`` and
``traces``. ``generate`` and ``generate_text`` take the grammar fields
(``json_mode``, ``regex``, ``json_schema``): the server wires the engine's
grammar from its tokenizer. The disaggregated ops: a prefill server
answers ``prefill`` with a KV bundle (header + binary lanes), or, given
``push_to``, pushes the KV as a chunk stream straight to that decode
server and replies once compute is done; a decode server answers
``decode_bundle`` (a bundle in its lanes), ``kv_stream`` (one inbound
chunk stream per connection, committed into the page table as it lands)
and ``decode_stream`` (decode a pushed stream once its coverage is in).

    python -m rbg_tpu_torch.engine.server --model llama3-8b --port 9000
    python -m rbg_tpu_torch.engine.server --model llama3-8b --kv-dtype int8
    python -m rbg_tpu_torch.engine.server --model deepseek-v2-lite --port 9000
    python -m rbg_tpu_torch.engine.server --device cpu --model tiny --port 0
    python -m rbg_tpu_torch.engine.server --model llama3-8b --grammar-table off
    python -m rbg_tpu_torch.engine.server --model llama3-8b --host-tier-bytes $((8<<30))
    python -m rbg_tpu_torch.engine.server --mode prefill --port 9001 --kv-pool 127.0.0.1:9200
    python -m rbg_tpu_torch.engine.server --mode decode --port 9002

The server binds first (readiness probes connect), then builds the engine
in the background; ``health`` reports ``ok`` once it is ready. It runs on
the card unless ``--device`` says otherwise. With ``--auth-token`` (or
``RBG_DATA_TOKEN``) every op but ``health``, ``metrics`` and ``slo``
needs the token. SIGTERM drains: in-flight requests finish, new data ops
are refused with code ``draining``, and the process exits 0 when nothing
is in flight or the drain deadline passes. With ``--host-tier-bytes``
the engine spills evicted prefix pages to host memory and promotes them
back on a hit; ``metrics`` then carries ``host_tier`` (the tier's stats)
and ``device_tier_pages``. A prefill server with ``--kv-pool`` consults
the shared KV pool before computing, publishes page-aligned prefixes to
it after, and registers them in the cluster prefix directory the pool
hosts under ``--advertise-addr``; ``--kv-stream off`` keeps the
whole-bundle wire. ``start_server`` serves an existing EngineService (or
a PrefillWorker / DecodeService) from a thread of the calling process.
Under the control plane's multi-process contract (``RBG_DISTRIBUTED=1``,
``RBG_JAX_NUM_PROCESSES`` > 1, ``RBG_JAX_COORDINATOR_ADDRESS``,
``RBG_JAX_PROCESS_ID``) the process first joins that world (nccl on the
card, gloo with ``--device cpu``), then serves its role unsharded; the
ready line names its rank.
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
                                           CODE_KV_STREAM, DeadlineExceeded,
                                           Rejected, bundle_from_wire,
                                           bundle_to_wire, recv_msg, send_msg,
                                           token_ok)
from rbg_tpu_torch.engine.service import DEFAULT_TIMEOUT_S, embed_prompts
from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
from rbg_tpu_torch.obs import names, trace
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

DEFAULT_DRAIN_DEADLINE_S = 30.0
# Blocking decode_stream wait bound when the client sent no deadline.
DEFAULT_WAIT_S = 600.0


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
    # Ops that carry prompts or KV: counted in flight, refused while
    # draining, traced as an ``engine.op`` span.
    _DATA_OPS = frozenset({"generate", "generate_text", "embed",
                           "prefill", "decode_bundle", "kv_stream",
                           "decode_stream"})

    def handle(self):
        while True:
            try:
                obj, k, v = recv_msg(self.request)
            except (ConnectionError, json.JSONDecodeError):
                return
            if obj is None:
                return
            try:
                self._dispatch(self.server, obj, k, v)
            except ConnectionError:
                return      # client went away; its generation was cancelled
            except Exception as e:  # noqa: BLE001 — reply, keep the connection
                try:
                    send_msg(self.request, {"error": str(e)})
                except OSError:
                    return

    def _stream(self, service, pending, with_logprobs: bool, deadline,
                first_tokens=()):
        """Relay a pending generation as ``{"tokens": [...], "done": false}``
        frames, then a final ``done`` frame with ttft. ``first_tokens``
        (a PD decode leg: the prefill-sampled token) go out first, with a
        null logprob each."""
        if deadline is None:
            deadline = time.monotonic() + DEFAULT_TIMEOUT_S
        sent = 0
        try:
            if first_tokens:
                frame = {"tokens": list(first_tokens), "done": False}
                if with_logprobs:
                    frame["logprobs"] = [None] * len(first_tokens)
                send_msg(self.request, frame)
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

    def _dispatch(self, srv, obj, k=None, v=None):
        op = obj.get("op")
        if op == "health":
            resp = {"ok": srv.ready, "mode": srv.mode,
                    "device": srv.device_name, "draining": srv.draining}
            if srv.draining:
                resp["draining_for_s"] = round(
                    time.monotonic() - srv.drain_started, 3)
            send_msg(self.request, resp)
            return
        if op not in self._DATA_OPS:
            self._dispatch_data(srv, obj, k, v)
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
            self._dispatch_data(srv, obj, k, v)
        finally:
            srv.note_inflight(-1)

    def _dispatch_data(self, srv, obj, k=None, v=None):
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
            self._serve(srv, obj, k, v)
            return
        span = trace.from_wire(obj.get("trace"), names.SPAN_ENGINE_OP, op=op,
                               mode=srv.mode)
        try:
            with trace.use_span(span):
                self._serve(srv, obj, k, v)
        finally:
            span.end()

    def _serve(self, srv, obj, k=None, v=None):
        op = obj.get("op")
        service = srv.service
        if not srv.ready:
            send_msg(self.request, {"error": "engine not ready"})
            return
        if op == "warmup":
            t0 = time.perf_counter()
            n = int(obj.get("input_len", 32))
            if srv.prefill is not None:
                with srv.pd_lock:
                    srv.prefill.warmup(n)
            else:
                (service or srv.decode).warmup(n)
            send_msg(self.request, {
                "ok": True, "elapsed_s": round(time.perf_counter() - t0, 2)})
            return
        if op == "metrics":
            if srv.prefill is not None:
                eng = srv.prefill.engine
                stats = {**eng.metrics, **srv.prefill.metrics}
            else:
                stats = (service or srv.decode).stats()
                eng = (service or srv.decode).engine
            if eng.host_tier is not None:
                stats["host_tier"] = eng.host_tier.stats()
                stats["device_tier_pages"] = (
                    eng.radix.cached_pages if eng.radix is not None else 0)
            stats["draining"] = srv.draining
            # Each hand-written kernel's launches in this process, so a
            # caller across processes (the control plane's card check) can
            # see the served path went through them.
            from rbg_tpu_torch.ops.kernels import LAUNCHES
            send_msg(self.request, {"metrics": stats, "mode": srv.mode,
                                    "kernel_launches": dict(LAUNCHES)})
            return
        if op == "generate_text" and service is not None:
            self._generate_text(srv, service, obj)
            return
        if op == "generate" and service is not None:
            self._generate(service, obj)
            return
        if op == "prefill" and srv.prefill is not None:
            self._prefill(srv, obj)
            return
        if op == "kv_stream" and srv.decode is not None:
            self._serve_kv_stream(srv, obj)
            return
        if op == "decode_stream" and srv.decode is not None:
            self._serve_decode_stream(srv, obj)
            return
        if op == "decode_bundle" and srv.decode is not None:
            self._decode_bundle(srv, obj, k, v)
            return
        if op == "embed":
            # Every mode serves embeddings: prefill and decode roles hold
            # the same weights, so a PD group's edge works too.
            tok = srv.tokenizer
            if "prompts" in obj:
                prompts = [list(p) for p in obj["prompts"]]
            elif "text" in obj:
                prompts = [tok.encode(obj["text"], add_bos=False)]
            else:
                prompts = [list(obj.get("prompt") or [])]
            try:
                vecs = embed_prompts(srv.engine, prompts)
            except ValueError as e:
                send_msg(self.request, {"error": str(e)})
                return
            send_msg(self.request, {
                "embeddings": vecs, "dim": len(vecs[0]),
                "prompt_tokens": sum(len(p) for p in prompts),
                "embedding": vecs[0]})
            return
        send_msg(self.request, {"error": f"unsupported op {op!r} in mode "
                                         f"{srv.mode}"})

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


    def _prefill(self, srv, obj):
        """Run one prompt to its first token on the prefill engine, which
        serializes behind ``pd_lock``: a deadline bounds the wait for the
        lock, and a budget spent while queued is refused before any
        compute. With ``push_to`` (and the stream transport on) the KV
        streams to that decode server as prefill chunks complete, from a
        sender thread outside the lock, and the reply goes out when
        compute is done; otherwise the reply is the bundle."""
        try:
            sampling = SamplingParams.from_wire(obj)
            deadline = _deadline_of(obj)
        except (ValueError, TypeError) as e:
            send_msg(self.request, {"error": f"bad sampling params: {e}"})
            return
        qspan = trace.child(names.SPAN_SERVICE_QUEUE_WAIT)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not srv.pd_lock.acquire(timeout=remaining):
                REGISTRY.inc(names.SERVING_DEADLINE_EXCEEDED_TOTAL,
                             stage="prefill_queue")
                qspan.end(outcome="deadline")
                send_msg(self.request, DeadlineExceeded(
                    "deadline spent waiting for the prefill engine"
                ).to_wire())
                return
        else:
            srv.pd_lock.acquire()
        qspan.end(outcome="admitted")
        t_lock = time.perf_counter()
        pspan = trace.child(names.SPAN_PD_PREFILL,
                            prompt_tokens=len(obj.get("prompt") or ()))
        push_to = obj.get("push_to")
        push = None
        try:
            if push_to and srv.kv_push is not None:
                push = srv.prefill.prefill_stream(
                    obj["prompt"], sampling, transport=srv.kv_push,
                    peer=push_to, stream_id=obj.get("stream_id"),
                    deadline=deadline)
            else:
                bundle = srv.prefill.prefill(obj["prompt"], sampling,
                                             deadline=deadline)
        except DeadlineExceeded as e:
            pspan.end(outcome="deadline_abort")
            send_msg(self.request, e.to_wire())
            return
        except Exception:
            pspan.end(outcome="error")
            raise
        finally:
            srv.pd_lock.release()
            REGISTRY.observe(names.PD_LOCK_HOLD_SECONDS,
                             time.perf_counter() - t_lock, lock="server_pd")
        if push is not None:
            pspan.end(outcome="pushed", bytes=push.meta.nbytes())
            # Reply the moment COMPUTE is done — the chunk tail drains to
            # the decode peer while the router sets up the decode leg. An
            # already-failed push (connect refused surfaces during
            # compute) is reported so the router falls back to the bundle
            # path instead of a doomed decode_stream.
            send_msg(self.request, {
                "pushed": push.error() is None,
                "stream_id": push.stream_id,
                "first_token": push.first_token,
                "prompt": list(obj["prompt"]),
                "kv_bytes": push.meta.nbytes(),
                "push_error": push.error(),
                # Measured prefill→decode link rates from COMPLETED
                # pushes — the router's transfer-cost scoring input.
                "link_rates": srv.kv_push.stats.snapshot()})
            return
        pspan.end(outcome="ok", bytes=bundle.nbytes)
        header, kb, vb = bundle_to_wire(bundle)
        send_msg(self.request, header, kb, vb)

    def _decode_bundle(self, srv, obj, k, v):
        bundle = bundle_from_wire(obj, k, v)
        try:
            sampling = SamplingParams.from_wire(obj)
            deadline = _deadline_of(obj)
        except (ValueError, TypeError) as e:
            send_msg(self.request, {"error": f"bad sampling params: {e}"})
            return
        # Continuous batching: bundles from concurrent connections decode
        # together on the device.
        if obj.get("stream"):
            # A bundle finished at inject (max_new_tokens == 1 / stop
            # token) resolves with done set and no tokens — the stream
            # then carries only the first_token frame.
            try:
                pending = srv.decode.submit_async(bundle, sampling,
                                                  deadline=deadline)
            except Rejected as e:
                send_msg(self.request, {**e.to_wire(), "done": True})
                return
            self._stream(srv.decode, pending, sampling.logprobs, deadline,
                         first_tokens=[bundle.first_token])
            return
        try:
            p = srv.decode.submit_wait(bundle, sampling, deadline=deadline)
        except Rejected as e:
            send_msg(self.request, e.to_wire())
            return
        except (TimeoutError, ValueError) as e:
            send_msg(self.request, {"error": str(e)})
            return
        resp = {"tokens": [bundle.first_token] + p.tokens}
        if sampling.logprobs:
            # First token sampled prefill-side — null placeholder.
            resp["logprobs"] = [None] + p.logprobs
        send_msg(self.request, resp)

    def _serve_kv_stream(self, srv, obj):
        """Ingest one inbound KV chunk stream on THIS connection (the
        prefill peer opened it): frames land in the decode service's
        stream registry (host staging on this thread); the loop thread
        commits them into the page table as they arrive. Replies an ack
        after FIN (the sender's drain barrier). A broken connection fails
        the stream with a structured error — never a wedge."""
        from rbg_tpu_torch.kvtransfer.chunks import StreamFin
        from rbg_tpu_torch.kvtransfer.transport import frame_from_wire

        sid = obj.get("stream_id") or ""
        rx = srv.decode.kv_streams.get_or_create(sid)
        srv.decode.watch_stream(rx)
        nbytes = 0
        while True:
            try:
                fobj, fk, fv = recv_msg(self.request)
            except (ConnectionError, json.JSONDecodeError) as e:
                rx.fail(f"kv stream connection broke: {e}")
                return
            if fobj is None:
                rx.fail("kv stream EOF before FIN")
                return
            try:
                frame = frame_from_wire(fobj, fk, fv)
            except Exception as e:  # noqa: BLE001 — fail the stream, not the handler
                rx.fail(f"bad kv frame: {e}")
                send_msg(self.request, {"error": str(e)})
                return
            nbytes += len(fk or b"") + len(fv or b"")
            rx.feed(frame)
            if isinstance(frame, StreamFin):
                REGISTRY.inc(names.KVT_BYTES_TOTAL, float(nbytes),
                             direction="recv", transport="tcp")
                send_msg(self.request, {"ok": True, "bytes": nbytes})
                return

    def _serve_decode_stream(self, srv, obj):
        """Decode a previously (or concurrently) pushed KV stream: wait
        for admission coverage, then decode exactly like decode_bundle.
        The row is admitted the moment layer coverage for the prompt is
        complete — the stream's FIN may still be in flight."""
        from rbg_tpu_torch.kvtransfer.chunks import StreamError

        try:
            sampling = SamplingParams.from_wire(obj)
            deadline = _deadline_of(obj)
        except (ValueError, TypeError) as e:
            send_msg(self.request, {"error": f"bad sampling params: {e}"})
            return
        sid = obj.get("stream_id") or ""
        rx = srv.decode.kv_streams.get_or_create(sid)
        srv.decode.watch_stream(rx)
        wait_s = 30.0
        if deadline is not None:
            wait_s = max(0.0, min(wait_s, deadline - time.monotonic()))
        try:
            rx.wait_ready(wait_s)
        except StreamError as e:
            # Mark the receiver failed so the loop thread's pump releases
            # any pages it pre-allocated — an abandoned stream must not
            # hold KV capacity.
            rx.fail(f"abandoned: {e}")
            srv.decode.kv_streams.pop(sid)
            send_msg(self.request, {"error": f"kv stream: {e}",
                                    "code": CODE_KV_STREAM, "done": True})
            return
        first_token = rx.assembler.first_token
        if obj.get("stream"):
            try:
                pending = srv.decode.submit_stream(rx, sampling,
                                                   deadline=deadline)
            except Rejected as e:
                send_msg(self.request, {**e.to_wire(), "done": True})
                return
            self._stream(srv.decode, pending, sampling.logprobs, deadline,
                         first_tokens=[first_token])
            return
        p = None
        try:
            p = srv.decode.submit_stream(rx, sampling, deadline=deadline)
            srv.decode.wait(p, DEFAULT_WAIT_S if deadline is None
                            else max(0.0, deadline - time.monotonic()) + 1.0)
        except Rejected as e:
            send_msg(self.request, e.to_wire())
            return
        except (TimeoutError, ValueError) as e:
            frame = {"error": str(e)}
            # Admit-time stream failures (dead kv_stream connection, no
            # pages for the pushed KV) keep their wire code so the router
            # re-routes in bundle mode instead of surfacing them.
            if p is not None and p.code:
                frame["code"] = p.code
            send_msg(self.request, frame)
            return
        resp = {"tokens": [first_token] + p.tokens}
        if sampling.logprobs:
            resp["logprobs"] = [None] + p.logprobs
        send_msg(self.request, resp)


class EngineServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service=None, tokenizer=None, auth_token=None,
                 drain_deadline_s: float = DEFAULT_DRAIN_DEADLINE_S,
                 mode: str = "unified", prefill=None, decode=None,
                 kv_push=None):
        """``mode`` names the role; ``service`` (unified), ``prefill`` (a
        PrefillWorker) or ``decode`` (a DecodeService) serves it once set.
        ``kv_push``: the prefill role's stream transport (None keeps the
        whole-bundle wire)."""
        super().__init__(addr, Handler)
        self.mode = mode
        self.service = service
        self.prefill = prefill
        self.decode = decode
        self.kv_push = kv_push
        # The prefill engine serves one request at a time behind it.
        self.pd_lock = named_lock("engine.server_pd")
        eng = self.engine
        self.device_name = None if eng is None else str(eng.device)
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        self.auth_token = auth_token or None
        self.drain_deadline_s = drain_deadline_s
        self.draining = False
        self.drain_started = 0.0
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    @property
    def engine(self):
        for s in (self.service, self.prefill, self.decode):
            if s is not None:
                return s.engine
        return None

    @property
    def ready(self) -> bool:
        return self.engine is not None

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
    # A draining prefill replica's prefix-directory entries go stale the
    # moment it exits — invalidate them NOW so no router routes a prefix
    # hit at a pod that is about to refuse it.
    pf = server.prefill
    if pf is not None and pf.directory is not None and pf.advertise_addr:
        try:
            pf.directory.invalidate_backend(pf.advertise_addr, reason="drain")
        except Exception:  # noqa: BLE001 — drain must never fail on this
            pass
    print(f"draining: finishing in-flight work (deadline "
          f"{drain_deadline_s:.1f}s)", flush=True)

    def drainer():
        deadline = server.drain_started + drain_deadline_s
        while time.monotonic() < deadline:
            busy = server.inflight() > 0 or any(
                s is not None and (s.engine.has_work() or s._queue)
                for s in (server.service, server.decode))
            if not busy:
                break
            time.sleep(0.05)
        aborted = server.inflight()
        print(f"drain {'complete' if not aborted else 'deadline'} after "
              f"{time.monotonic() - server.drain_started:.2f}s "
              f"({aborted} in-flight aborted)", flush=True)
        server.shutdown()

    threading.Thread(target=drainer, daemon=True, name="drainer").start()


def start_server(service=None, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, auth_token=None, prefill=None, decode=None,
                 kv_stream: str = "auto") -> EngineServer:
    """Serve ``service`` (unified), ``prefill`` (a PrefillWorker) or
    ``decode`` (a DecodeService) from a daemon thread; port 0 picks a free
    port (read it from ``.addr``). Stop with ``shutdown()`` +
    ``server_close()``."""
    mode = ("prefill" if prefill is not None
            else "decode" if decode is not None else "unified")
    kv_push = None
    if prefill is not None and kv_stream != "off":
        from rbg_tpu_torch.kvtransfer.transport import TCPTransport
        kv_push = TCPTransport(token=auth_token or None)
    server = EngineServer((host, port), service, tokenizer=tokenizer,
                          auth_token=auth_token, mode=mode, prefill=prefill,
                          decode=decode, kv_push=kv_push)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="engine-server").start()
    return server


def build_config(args) -> EngineConfig:
    return EngineConfig(
        model=args.model, mode=args.mode, page_size=args.page_size, num_pages=args.num_pages,
        max_batch=args.max_batch, max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk, multi_step=args.multi_step,
        ragged=args.ragged, speculative=args.speculative, spec_k=args.spec_k,
        spec_ngram=args.spec_ngram, kv_dtype=args.kv_dtype, slo_ttft_s=args.slo_ttft_s,
        slo_tpot_s=args.slo_tpot_s, early_reject=args.early_reject,
        early_reject_factor=args.early_reject_factor,
        grammar_table=args.grammar_table,
        grammar_state_budget=args.grammar_state_budget,
        host_tier_bytes=args.host_tier_bytes,
        vocab_size=args.vocab_size, checkpoint_path=args.checkpoint_path,
        seed=args.seed, device=args.device)


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


def build_prefill(cfg: EngineConfig, args, addr: str, auth_token=None):
    """The prefill role's worker: with ``--kv-pool`` it consults and
    publishes to the shared KV pool, and registers computed prefixes (and
    its host tier's spills) in the cluster prefix directory the pool
    hosts, under ``--advertise-addr``."""
    from rbg_tpu_torch.engine.pd import PrefillWorker

    pool = directory = None
    advertise = (args.advertise_addr or os.environ.get("RBG_ADVERTISE_ADDR")
                 or addr)
    pool_addr = args.kv_pool or os.environ.get("RBG_KV_POOL_ADDR", "")
    if pool_addr:
        from rbg_tpu_torch.engine.kvpool import KVPoolClient
        from rbg_tpu_torch.kvtransfer.directory import DirectoryClient
        pool = KVPoolClient(pool_addr, token=auth_token,
                            ca_path=(args.kv_pool_ca
                                     or os.environ.get("RBG_KV_POOL_CA")
                                     or None))
        directory = DirectoryClient(pool_addr, token=auth_token,
                                    page_size=cfg.page_size)
    prefill = PrefillWorker(cfg, pool=pool, directory=directory,
                            advertise_addr=advertise)
    if prefill.engine.host_tier is not None and directory:
        # Host-tier spills register in the cluster directory under this
        # replica's serving address (tier="host").
        prefill.engine.host_tier.wire_directory(directory, advertise)
    return prefill


def serve_port(args) -> int:
    """The port to bind: the control plane's (``RBG_SERVE_PORT``, else
    ``RBG_PORT_SERVE``) before ``--port``, as the reference's serve() reads
    it, so an executor's pod answers on the port it was given."""
    return int(os.environ.get("RBG_SERVE_PORT")
               or os.environ.get("RBG_PORT_SERVE") or args.port)


def serve(args) -> None:
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.engine.tokenizer import load_tokenizer
    from rbg_tpu_torch.obs import timeseries

    cfg = build_config(args)
    cfg.validate()  # fail fast on bad flags, before the port binds
    # The control plane's multi-process contract (RBG_DISTRIBUTED=1 and
    # RBG_JAX_NUM_PROCESSES > 1), read as the reference's serve() reads it:
    # the world forms before the role is built. Each process then serves its
    # own role unsharded, as the reference's does (its mesh_spec is inert).
    world = ""
    if (os.environ.get("RBG_DISTRIBUTED", "0") == "1"
            and int(os.environ.get("RBG_JAX_NUM_PROCESSES", "1")) > 1):
        from rbg_tpu_torch.parallel.mesh import contract_world, init_world
        coordinator, num, rank = contract_world()
        init_world(coordinator, num, rank, args.device)
        world = f" world={rank}/{num}"
    # The windowed sampler the `slo` op reads starts with the process.
    timeseries.ensure_started()
    drain_deadline_s = float(
        args.drain_deadline_s if args.drain_deadline_s is not None
        else os.environ.get("RBG_DRAIN_DEADLINE_S", DEFAULT_DRAIN_DEADLINE_S))
    auth_token = args.auth_token or os.environ.get("RBG_DATA_TOKEN") or None
    server = EngineServer(
        ("127.0.0.1", serve_port(args)), auth_token=auth_token,
        drain_deadline_s=drain_deadline_s, mode=cfg.mode)
    # serve() runs on the main thread, where signal() is allowed.
    signal.signal(signal.SIGTERM,
                  lambda *_: start_drain(server, drain_deadline_s))

    def init_engine():
        try:
            if args.tokenizer_path:
                server.tokenizer = load_tokenizer(args.tokenizer_path)
            # Adapters and the grammar are wired before the engine is
            # published: health reports ready once it is, and a json_mode
            # request racing the wiring would be refused.
            if cfg.mode == "prefill":
                role = build_prefill(cfg, args, server.addr, auth_token)
                if args.kv_stream != "off":
                    from rbg_tpu_torch.kvtransfer.transport import TCPTransport
                    server.kv_push = TCPTransport(token=auth_token)
                for name, adapter, alpha in lora_specs(args.lora):
                    role.engine.load_lora(name, adapter, alpha=alpha)
            elif cfg.mode == "decode":
                from rbg_tpu_torch.engine.service import DecodeService
                role = DecodeService(cfg, max_queue=args.max_queue or None,
                                     lora=lora_specs(args.lora))
            else:
                role = EngineService(cfg, max_queue=args.max_queue or None,
                                     lora=lora_specs(args.lora))
            role.engine.enable_json_grammar(server.tokenizer)
        except Exception:  # noqa: BLE001 — a server without an engine must die
            traceback.print_exc()
            os._exit(1)
        server.device_name = str(role.engine.device)
        setattr(server, {"prefill": "prefill", "decode": "decode"}.get(
            cfg.mode, "service"), role)
        print(f"engine ready mode={cfg.mode} model={cfg.model} "
              f"device={role.engine.device} addr={server.addr}{world}", flush=True)

    threading.Thread(target=init_engine, daemon=True).start()
    print(f"engine listening on {server.addr}", flush=True)
    server.serve_forever()
    # serve_forever returns only through the drainer's shutdown().
    server.server_close()
    print("engine exited cleanly after drain", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="rbg-tpu-torch-engine")
    ap.add_argument("--model", default=os.environ.get("RBG_MODEL", "tiny"))
    ap.add_argument("--mode", default="unified",
                    choices=["unified", "prefill", "decode"],
                    help="PD role: unified serves generate; prefill answers "
                         "prefill with KV (bundle or pushed stream); decode "
                         "imports KV and decodes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    ap.add_argument("--port", type=int, default=9000,
                    help="0 = any free port ($RBG_SERVE_PORT or $RBG_PORT_SERVE, "
                         "when set, win)")
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
    ap.add_argument("--checkpoint-path",
                    default=os.environ.get("RBG_CHECKPOINT_PATH", ""),
                    help="native checkpoint dir or local HF dir (else random "
                         "weights from --seed)")
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
    ap.add_argument("--kv-pool",
                    default=os.environ.get("RBG_KV_POOL_ADDR", ""),
                    help="host:port of the shared KV pool (prefill mode; "
                         "python -m rbg_tpu_torch.engine.kvpool)")
    ap.add_argument("--kv-pool-ca", default="",
                    help="CA cert path for a TLS kv-pool (default: "
                         "$RBG_KV_POOL_CA; empty = plaintext)")
    ap.add_argument("--kv-stream", choices=("auto", "off"), default="auto",
                    help="chunked layer-overlapped prefill→decode KV "
                         "streaming (the router passes push_to and this "
                         "prefill pushes chunks as they compute); 'off' "
                         "keeps the whole-bundle wire path")
    ap.add_argument("--advertise-addr", default="",
                    help="address this replica registers in the cluster "
                         "prefix directory (default: $RBG_ADVERTISE_ADDR "
                         "or this server's address)")
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
