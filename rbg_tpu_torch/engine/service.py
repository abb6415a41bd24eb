"""Engine services: a background continuous-batching loop over one Engine,
and the blocking APIs around it (``rbg_tpu/engine/service.py``).

Server threads only enqueue and wait; ONE loop thread owns the engine
(single writer, no engine locking on the hot path), so requests arriving
on different connections batch together on the device. ``_BatchService``
holds the loop and the admission gates; ``EngineService`` serves unified
generate and embeddings (the disaggregated ``DecodeService`` is not
ported yet).

Admission: a full queue, a deadline the measured backlog cannot meet, or
(with ``early_reject="auto"``) a predicted TTFT over the gate sheds the
submission with ``Overloaded`` and a ``retry_after_s`` hint. A deadline
drops a queued request or aborts an admitted one on the loop thread; a
cancel (client gone, wait timed out) recycles the batch slot and the KV
pages. Every finished request is judged once against the SLO targets.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams, warm_prompt
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, DeadlineExceeded,
                                           Overloaded, Rejected)
from rbg_tpu_torch.obs import names, trace
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.obs.slo import SLOTargets, SLOTracker

DEFAULT_TIMEOUT_S = 600.0
# Completion timestamps kept for the estimated-wait gate.
_RATE_WINDOW = 64
# Past this without a prefill window the prefill-rate EMA is no longer a
# measurement: a shed request does no prefill, so a stale slow rate (kernel
# builds on an unwarmed service) would otherwise shed everything forever.
_PF_RATE_TTL_S = 30.0
# Backpressure hint when no throughput estimate exists yet.
_RETRY_AFTER_FLOOR_S = 0.5
# Rows per embeddings forward; longer lists run in chunks.
EMBED_MAX_BATCH = 32
# Bytes of one float32 attention-score tensor [B, H, T, T] (bucketed B and
# T) an embeddings forward may hold per layer; the softmax keeps two more
# of its size. Rows per forward shrink as T grows (llama3-8b: 32 rows at
# T 512, 2 at T 2048). One row always runs, so max_seq_len bounds that.
EMBED_SCORE_BYTES = 1 << 30


class Pending:
    """One submitted request: tokens stream in from the loop thread."""

    __slots__ = ("tokens", "logprobs", "done", "t_submit", "t_first", "error",
                 "code", "deadline", "span_parent", "span_queue", "span_scan")

    def __init__(self, deadline: Optional[float] = None):
        self.tokens: List[int] = []
        self.logprobs: List[float] = []   # 1:1 with tokens when requested
        self.done = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.error: Optional[str] = None
        self.code: Optional[str] = None   # structured rejection code
        self.deadline = deadline          # absolute time.monotonic()
        # The request's parent span and its queue-wait / scan children
        # (NULL_SPAN when unsampled, so every site ends them unconditionally).
        self.span_parent = trace.NULL_SPAN
        self.span_queue = trace.NULL_SPAN
        self.span_scan = trace.NULL_SPAN


def _chunk_bucket(n: int, chunk: int = 1) -> int:
    """``n`` rounded up to ``chunk`` × a power of two (chunk 1: a power of
    two); padding is masked downstream."""
    m = 1
    while m * chunk < n:
        m *= 2
    return m * chunk


def embed_prompts(engine: Engine, prompts: List[List[int]]) -> List[List[float]]:
    """Mean-pooled final-norm hidden states, one batched forward per span of
    ``_embed_spans`` on the engine's device. Reads only the engine's
    weights, so server threads may call it beside the loop."""
    for p in prompts:
        engine._check_prompt(p)
        if len(p) > engine.cfg.max_seq_len:
            raise ValueError(f"prompt ({len(p)} tokens) exceeds "
                             f"max_seq_len {engine.cfg.max_seq_len}")
    out: List[List[float]] = []
    for lo, hi in _embed_spans([len(p) for p in prompts],
                               engine.mcfg.num_heads, engine.cfg.prefill_chunk):
        out.extend(_embed_batch(engine, prompts[lo:hi]))
    return out


def _embed_spans(lengths: List[int], heads: int,
                 chunk: int) -> List[Tuple[int, int]]:
    """Consecutive ``[lo, hi)`` runs of prompts, each at most
    ``EMBED_MAX_BATCH`` rows whose bucketed scores fit
    ``EMBED_SCORE_BYTES`` (a single prompt always makes a run)."""
    spans: List[Tuple[int, int]] = []
    lo, longest = 0, 0
    for i, n in enumerate(lengths):
        rows, t = i + 1 - lo, max(longest, n)
        score = (_chunk_bucket(rows) * heads
                 * _chunk_bucket(t, chunk) ** 2 * 4)
        if rows > 1 and (rows > EMBED_MAX_BATCH or score > EMBED_SCORE_BYTES):
            spans.append((lo, i))
            lo, t = i, n
        longest = t
    if lengths:
        spans.append((lo, len(lengths)))
    return spans


def _embed_batch(engine: Engine, prompts: List[List[int]]) -> List[List[float]]:
    """Both axes bucketed as the reference buckets them: T to
    prefill_chunk × a power of two, B to a power of two."""
    from rbg_tpu_torch.models.llama import encode_hidden

    T = _chunk_bucket(max(len(p) for p in prompts), engine.cfg.prefill_chunk)
    B = _chunk_bucket(len(prompts))
    toks = np.zeros((B, T), np.int64)
    mask = np.zeros((B, T), bool)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        mask[i, :len(p)] = True
    dev = engine.device
    tmask = torch.from_numpy(mask).to(dev)
    h = encode_hidden(engine.params, engine.mcfg, torch.from_numpy(toks).to(dev),
                      tmask).float()
    # Pool in float32: a bf16 sum and token count would be exact only to 256.
    m = tmask[:, :, None].float()
    vecs = ((h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)).cpu().numpy()
    return [vecs[i].tolist() for i in range(len(prompts))]


class _BatchService:
    """The loop and its admission gates. Subclasses set ``engine`` before
    calling ``__init__`` and implement ``_admit(item, sampling) -> rid``
    (raising fails just that request)."""

    engine: Engine
    # Role label the SLO judgments carry.
    slo_role = "unified"

    def __init__(self, max_queue: Optional[int] = None):
        self.max_queue = max_queue
        cfg = self.engine.cfg
        self.slo = SLOTracker(
            SLOTargets(ttft_s=cfg.slo_ttft_s, tpot_s=cfg.slo_tpot_s),
            component=type(self).__name__.lower())
        self.counters = {"shed_total": 0, "deadline_queue_drops": 0,
                         "deadline_running_aborts": 0, "early_rejects": 0,
                         "loop_errors": 0}
        self._early_reject = cfg.early_reject == "auto" and cfg.slo_ttft_s > 0
        self._er_gate_s = cfg.slo_ttft_s * cfg.early_reject_factor
        # Prefill throughput (tokens/s EMA): written by the loop thread
        # between steps, read racily by submitters (a float read; staleness
        # skews one prediction). Expires after _PF_RATE_TTL_S.
        self._prefill_rate: Optional[float] = None
        self._pf_rate_t = 0.0
        self._pf_tokens = self.engine.metrics.get("prefill_tokens", 0)
        self._pf_t = time.monotonic()
        self._pending: Dict[int, Pending] = {}    # loop-thread confined
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = False
        self._queue: List[Tuple[object, SamplingParams, Pending]] = []
        self._cancels: List[Pending] = []
        self._done_times = collections.deque(maxlen=_RATE_WINDOW)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=type(self).__name__.lower())
        self._thread.start()

    # -- subclass hooks --

    def _admit(self, item, sampling: SamplingParams) -> Optional[int]:
        raise NotImplementedError

    def _ingress_prompt(self, item) -> Optional[List[int]]:
        """The prompt tokens of a submission, for the TTFT predictor (None:
        no prefill work here)."""
        return None

    # -- admission control --

    def _completion_rate(self) -> Optional[float]:
        """Recent completions per second (None: no estimate yet), over the
        span between the completions themselves, so an idle period does
        not decay it."""
        d = self._done_times
        if len(d) < 2:
            return None
        span = d[-1] - d[0]
        if span <= 0:
            return None
        return (len(d) - 1) / span

    def estimated_wait_s(self, depth: Optional[int] = None) -> Optional[float]:
        """Expected queueing delay of a new submission from the completion
        rate; None until there is history."""
        if depth is None:
            with self._lock:
                depth = len(self._queue)
        rate = self._completion_rate()
        if rate is None or rate <= 0:
            return None
        eng = self.engine
        backlog = depth + len(eng.running) + len(eng.waiting)
        return backlog / rate

    def _retry_after_hint(self, depth: int) -> float:
        est = self.estimated_wait_s(depth)
        return max(_RETRY_AFTER_FLOOR_S, est if est is not None else 1.0)

    def _note_prefill_progress(self) -> None:
        """Sample prefill throughput between steps; only windows that
        prefilled update the EMA."""
        now = time.monotonic()
        dt = now - self._pf_t
        if dt < 0.2:
            return
        tp = self.engine.metrics.get("prefill_tokens", 0)
        if tp > self._pf_tokens:
            rate = (tp - self._pf_tokens) / dt
            stale = now - self._pf_rate_t > _PF_RATE_TTL_S
            self._prefill_rate = (
                rate if self._prefill_rate is None or stale
                else 0.7 * self._prefill_rate + 0.3 * rate)
            self._pf_rate_t = now
        self._pf_tokens, self._pf_t = tp, now

    def predicted_ttft_s(self, item,
                         depth: Optional[int] = None) -> Optional[float]:
        """Predicted TTFT of a new submission: queue wait plus its prefill
        time net of the prefix hit it would get. Without (or with expired)
        prefill-rate history it predicts the queue wait only."""
        est = self.estimated_wait_s(depth)
        prompt = self._ingress_prompt(item)
        rate = self._prefill_rate
        if (prompt is None or rate is None or rate <= 0
                or time.monotonic() - self._pf_rate_t > _PF_RATE_TTL_S):
            return est
        hit = self.engine.prefix_peek(list(prompt))
        prefill_s = max(0, len(prompt) - hit) / rate
        return prefill_s if est is None else est + prefill_s

    def _shed(self, msg: str, depth: int) -> None:
        self.counters["shed_total"] += 1
        REGISTRY.inc(names.SERVING_SHED_TOTAL,
                     service=type(self).__name__.lower())
        raise Overloaded(msg, retry_after_s=self._retry_after_hint(depth))

    # -- public --

    def submit_async(self, item, sampling: SamplingParams,
                     deadline: Optional[float] = None, span=None) -> Pending:
        """Enqueue one request. ``deadline`` is absolute ``time.monotonic()``
        seconds; raises ``Overloaded`` / ``DeadlineExceeded`` instead of
        queueing work that cannot be served. ``span`` (or the current span)
        parents the request's queue-wait and scan spans."""
        parent = span if span is not None else trace.current()
        qspan = parent.child(names.SPAN_SERVICE_QUEUE_WAIT)
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            with self._lock:
                self.counters["deadline_queue_drops"] += 1
            REGISTRY.inc(names.SERVING_DEADLINE_EXCEEDED_TOTAL, stage="queue")
            qspan.end(outcome="deadline")
            raise DeadlineExceeded("deadline already expired at submission")
        p = Pending(deadline=deadline)
        p.span_parent = parent
        p.span_queue = qspan
        try:
            with self._lock:
                # estimated_wait_s with an explicit depth does not take the
                # lock again, so every gate may raise from inside it.
                depth = len(self._queue)
                if self.max_queue is not None and depth >= self.max_queue:
                    self._shed(f"service queue full ({self.max_queue})", depth)
                if deadline is not None:
                    est = self.estimated_wait_s(depth)
                    if est is not None and now + est >= deadline:
                        self._shed(
                            f"estimated wait {est:.2f}s exceeds remaining "
                            f"deadline budget {deadline - now:.2f}s", depth)
                if self._early_reject:
                    pred = self.predicted_ttft_s(item, depth)
                    if pred is not None:
                        svc = type(self).__name__.lower()
                        REGISTRY.observe(names.SERVING_PREDICTED_TTFT_SECONDS,
                                         pred, service=svc)
                        if pred > self._er_gate_s:
                            self.counters["early_rejects"] += 1
                            REGISTRY.inc(names.SERVING_EARLY_REJECTS_TOTAL,
                                         service=svc)
                            self._shed(
                                f"predicted TTFT {pred:.2f}s exceeds the "
                                f"early-reject gate {self._er_gate_s:.2f}s",
                                depth)
                self._queue.append((item, sampling, p))
                REGISTRY.observe(names.SERVING_QUEUE_DEPTH, depth + 1)
        except Rejected as e:
            qspan.end(outcome=e.code)
            raise
        self._wake.set()
        return p

    def submit_wave(self, items) -> List[Pending]:
        """Atomically enqueue ``[(item, sampling), ...]`` so one loop
        iteration admits them together (up to max_batch)."""
        ps = []
        with self._lock:
            for item, sampling in items:
                p = Pending()
                self._queue.append((item, sampling, p))
                ps.append(p)
        self._wake.set()
        return ps

    def warmup(self, input_len: int = 32, out_len: int = 2) -> float:
        """Build the CUDA kernels (first use compiles them) and run one wave
        per decode bucket size through the normal submit path, largest
        first. The prefill-rate EMA then restarts, so the early-reject
        predictor learns from warm steps only. Returns elapsed seconds."""
        t0 = time.monotonic()
        if self.engine.device.type == "cuda":
            from rbg_tpu_torch.ops.kernels.build import build
            build()
        eng = self.engine
        sizes = sorted({eng._bucket(b) for b in range(1, eng.cfg.max_batch + 1)},
                       reverse=True)
        for B in sizes:
            items = [(self._warm_item(input_len, B, i),
                      SamplingParams(max_new_tokens=out_len)) for i in range(B)]
            for p in self.submit_wave(items):
                self.wait(p, DEFAULT_TIMEOUT_S)
        self._prefill_rate = None
        self._pf_tokens = self.engine.metrics.get("prefill_tokens", 0)
        self._pf_t = time.monotonic()
        return time.monotonic() - t0

    def _warm_item(self, input_len: int, wave: int, row: int):
        raise NotImplementedError

    def wait(self, p: Pending, timeout: float) -> List[int]:
        if not p.done.wait(timeout):
            self.cancel(p)  # recycle batch slot + KV pages
            raise TimeoutError("generation timed out")
        if p.error:
            if p.code == CODE_DEADLINE:
                raise DeadlineExceeded(p.error)
            raise ValueError(p.error)
        return p.tokens

    def submit_wait(self, item, sampling: SamplingParams,
                    timeout: float = DEFAULT_TIMEOUT_S,
                    deadline: Optional[float] = None, span=None) -> Pending:
        """Blocking submit; returns the completed Pending. ``deadline``
        bounds the admission gates, the queue and the engine-side abort."""
        p = self.submit_async(item, sampling, deadline=deadline, span=span)
        if deadline is not None:
            timeout = min(timeout, max(0.0, deadline - time.monotonic()) + 1.0)
        self.wait(p, timeout)
        return p

    @staticmethod
    def ttft(p: Pending) -> float:
        return (p.t_first - p.t_submit) if p.t_first else 0.0

    def service_stats(self) -> dict:
        """Admission and lifecycle counters (merged into the metrics op)."""
        with self._lock:
            depth = len(self._queue)
            out = dict(self.counters)
        est = self.estimated_wait_s(depth)
        out["queue_depth"] = depth
        out["max_queue"] = self.max_queue
        out["estimated_wait_s"] = round(est, 4) if est is not None else None
        out["slo_judged_total"] = self.slo.judged_total()
        pf = self._prefill_rate
        out["prefill_tokens_per_s"] = round(pf, 2) if pf is not None else None
        out["early_reject_armed"] = self._early_reject
        return out

    def cancel(self, pending: Pending) -> None:
        """Abort a request (routed through the loop thread)."""
        with self._lock:
            self._cancels.append(pending)
        self._wake.set()

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=30.0)

    # -- loop --

    def _expire_queue_locked(self, now: float) -> List[Pending]:
        """Drop queued entries whose deadline passed (caller holds the
        lock; they are failed outside it)."""
        if not any(p.deadline is not None for _, _, p in self._queue):
            return []
        live, dead = [], []
        for entry in self._queue:
            p = entry[2]
            if p.deadline is not None and now >= p.deadline:
                dead.append(p)
            else:
                live.append(entry)
        self._queue = live
        return dead

    def _abort_expired_running(self, now: float) -> None:
        """Abort admitted rows past their deadline: the slot and pages
        recycle now instead of decoding to max_new_tokens."""
        expired = [(rid, p) for rid, p in self._pending.items()
                   if p.deadline is not None and now >= p.deadline]
        if expired:
            with self._lock:
                self.counters["deadline_running_aborts"] += len(expired)
        for rid, p in expired:
            self.engine.cancel_request(rid)
            del self._pending[rid]
            REGISTRY.inc(names.SERVING_DEADLINE_EXCEEDED_TOTAL, stage="running")
            p.error = "deadline exceeded mid-generation (aborted)"
            p.code = CODE_DEADLINE
            p.span_scan.end(outcome="deadline_abort", tokens=len(p.tokens))
            p.done.set()

    def _judge_finished(self, pending: Pending, t_done: float) -> None:
        """SLO-judge one finished request: TTFT from submission to the
        first token, TPOT the mean per-token time after it (0 for one
        token). Aborts, cancels and admission errors are not judged."""
        n = len(pending.tokens)
        if pending.t_first is not None:
            ttft = pending.t_first - pending.t_submit
            tpot = ((t_done - pending.t_first) / (n - 1)) if n > 1 else 0.0
        else:
            ttft = t_done - pending.t_submit
            tpot = 0.0
        self.slo.judge(ttft, tpot, role=self.slo_role)
        svc = type(self).__name__.lower()
        REGISTRY.inc(names.SERVING_REQUESTS_FINISHED_TOTAL, service=svc)
        if n:
            REGISTRY.inc(names.SERVING_TOKENS_TOTAL, float(n), service=svc)

    def _fail_step(self, e: Exception) -> None:
        """A device fault fails every admitted request, not the loop."""
        traceback.print_exc()
        with self._lock:
            self.counters["loop_errors"] += 1
        for rid, p in list(self._pending.items()):
            self.engine.cancel_request(rid)
            p.error = f"engine step failed: {e}"
            p.span_scan.end(outcome="error")
            p.done.set()
        self._pending.clear()
        self.engine._dec = None   # the decode window's rows are gone

    def _loop(self):
        eng = self.engine
        svc = type(self).__name__.lower()
        while not self._stopped:
            now = time.monotonic()
            with self._lock:
                cancels, self._cancels = self._cancels, []
                expired = self._expire_queue_locked(now)
                budget = max(0, eng.cfg.max_batch - len(eng.running)
                             - len(eng.waiting))
                newly, self._queue = self._queue[:budget], self._queue[budget:]
                # Submissions still queued shorten the decode window so the
                # next free slot takes them at step granularity.
                eng.join_hint = bool(self._queue)
                self.counters["deadline_queue_drops"] += len(expired)
            for p in expired:
                REGISTRY.inc(names.SERVING_DEADLINE_EXCEEDED_TOTAL, stage="queue")
                p.error = "deadline expired before admission"
                p.code = CODE_DEADLINE
                p.span_queue.end(outcome="deadline_dropped")
                p.done.set()
            for item, sampling, p in newly:
                p.span_queue.end(outcome="admitted")
                scan = p.span_scan = p.span_parent.child(names.SPAN_SERVICE_SCAN)
                try:
                    with trace.use_span(p.span_parent):
                        rid = self._admit(item, sampling)
                except Exception as e:  # noqa: BLE001 — a bad request fails itself
                    scan.end(outcome="admit_error")
                    p.error = str(e)
                    p.done.set()
                    continue
                self._pending[rid] = p
            self._abort_expired_running(now)
            for p in cancels:
                rid = next((r for r, q in self._pending.items() if q is p), None)
                if rid is not None:
                    eng.cancel_request(rid)
                    del self._pending[rid]
                    p.span_scan.end(outcome="cancelled")
                else:
                    with self._lock:
                        self._queue = [q for q in self._queue if q[2] is not p]
                    p.span_queue.end(outcome="cancelled")
                p.done.set()
            if not eng.has_work():
                with self._lock:
                    idle = not self._queue and not self._cancels
                if idle:
                    # Idle time must not enter the prefill-rate window.
                    self._pf_t = time.monotonic()
                    self._pf_tokens = eng.metrics.get("prefill_tokens", 0)
                    self._wake.wait(0.01)
                    self._wake.clear()
                continue
            try:
                events = eng.step()
            except Exception as e:  # noqa: BLE001 — the loop must keep serving
                self._fail_step(e)
                continue
            self._note_prefill_progress()
            REGISTRY.observe(names.SERVING_BATCH_OCCUPANCY,
                             len(eng.running) / max(1, eng.cfg.max_batch),
                             service=svc)
            for w in eng.last_join_waits:
                REGISTRY.observe(names.SERVING_JOIN_LATENCY_SECONDS, w,
                                 service=svc)
            eng.last_join_waits.clear()
            for ev in events:
                p = self._pending.get(ev.request_id)
                if p is None:
                    continue
                if p.t_first is None:
                    p.t_first = time.perf_counter()
                p.tokens.append(ev.token)
                if ev.logprob is not None:
                    p.logprobs.append(ev.logprob)
                if ev.finished:
                    p.span_scan.end(outcome="ok", tokens=len(p.tokens))
                    t_done = time.perf_counter()
                    REGISTRY.observe(names.SERVING_REQUEST_DURATION_SECONDS,
                                     t_done - p.t_submit,
                                     exemplar=p.span_scan.trace_id or None,
                                     service=svc)
                    self._judge_finished(p, t_done)
                    p.done.set()
                    del self._pending[ev.request_id]
                    # Completion history feeds the estimated-wait gate.
                    self._done_times.append(time.monotonic())


class EngineService(_BatchService):
    def __init__(self, cfg: EngineConfig, params=None, device=None,
                 max_queue: Optional[int] = None, lora=()):
        """``lora``: (name, adapter, alpha) triples loaded into the engine
        (``Engine.load_lora``) before its loop starts."""
        self.engine = Engine(cfg, params=params, device=device)
        for name, adapter, alpha in lora:
            self.engine.load_lora(name, adapter, alpha=alpha)
        super().__init__(max_queue=max_queue)

    def _admit(self, prompt, sampling: SamplingParams) -> int:
        return self.engine.add_request(prompt, sampling)

    def _ingress_prompt(self, item) -> Optional[List[int]]:
        return item if isinstance(item, (list, tuple)) else None

    def _warm_item(self, input_len: int, wave: int, row: int):
        return warm_prompt(input_len, wave, row)

    def submit(self, prompt: List[int], sampling: SamplingParams,
               timeout: float = DEFAULT_TIMEOUT_S,
               deadline: Optional[float] = None) -> Tuple[List[int], float]:
        """Blocking generate. Returns (tokens, ttft_seconds)."""
        p = self.submit_wait(prompt, sampling, timeout, deadline=deadline)
        return p.tokens, self.ttft(p)

    def embed(self, prompt: List[int]) -> List[float]:
        """Mean-pooled final-norm hidden state of one prompt."""
        return embed_prompts(self.engine, [prompt])[0]

    def stats(self) -> dict:
        eng = self.engine
        out = dict(eng.metrics)
        out["running"] = len(eng.running)
        out["waiting"] = len(eng.waiting)
        out["free_pages"] = eng.allocator.free_pages
        out["radix_nodes"] = eng.radix.num_nodes if eng.radix is not None else 0
        out.update(self.service_stats())
        return out
