"""EngineService: a background continuous-batching loop over one Engine
(``rbg_tpu/engine/service.py`` ``EngineService``).

Server threads only enqueue and wait; ONE loop thread owns the engine
(single writer, no engine locking on the hot path), so requests arriving
on different connections batch together on the device. Admission is
capped at the engine's max_batch; a bounded queue sheds with
``Overloaded``; a deadline drops a queued request or aborts an admitted
one; a cancel (client gone, wait timed out) recycles the batch slot and
the KV pages.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams, warm_prompt
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.protocol import CODE_DEADLINE, DeadlineExceeded, Overloaded

DEFAULT_TIMEOUT_S = 600.0


class Pending:
    """One submitted request: tokens stream in from the loop thread."""

    __slots__ = ("tokens", "logprobs", "done", "t_submit", "t_first", "error",
                 "code", "deadline")

    def __init__(self, deadline: Optional[float] = None):
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.done = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.error: Optional[str] = None
        self.code: Optional[str] = None
        self.deadline = deadline          # absolute time.monotonic()


class EngineService:
    def __init__(self, cfg: EngineConfig, params=None, device=None,
                 max_queue: Optional[int] = None):
        self.engine = Engine(cfg, params=params, device=device)
        self.max_queue = max_queue
        self.counters = {"shed_total": 0, "deadline_queue_drops": 0,
                         "deadline_running_aborts": 0, "loop_errors": 0}
        self._pending: Dict[int, Pending] = {}    # loop-thread confined
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = False
        self._queue: List[Tuple[List[int], SamplingParams, Pending]] = []
        self._cancels: List[Pending] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engineservice")
        self._thread.start()

    # -- public --

    def submit_async(self, prompt: List[int], sampling: SamplingParams,
                     deadline: Optional[float] = None) -> Pending:
        """Enqueue one request. Raises ``Overloaded`` when the queue is full
        and ``DeadlineExceeded`` when the deadline has already passed."""
        if deadline is not None and time.monotonic() >= deadline:
            with self._lock:
                self.counters["deadline_queue_drops"] += 1
            raise DeadlineExceeded("deadline already expired at submission")
        p = Pending(deadline=deadline)
        with self._lock:
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                self.counters["shed_total"] += 1
                raise Overloaded(f"service queue full ({self.max_queue})",
                                 retry_after_s=0.5)
            self._queue.append((prompt, sampling, p))
        self._wake.set()
        return p

    def submit_wave(self, items) -> List[Pending]:
        """Atomically enqueue ``[(prompt, sampling), ...]`` so one loop
        iteration admits them together (up to max_batch)."""
        ps = []
        with self._lock:
            for prompt, sampling in items:
                p = Pending()
                self._queue.append((prompt, sampling, p))
                ps.append(p)
        self._wake.set()
        return ps

    def wait(self, p: Pending, timeout: float) -> List[int]:
        if not p.done.wait(timeout):
            self.cancel(p)  # recycle batch slot + KV pages
            raise TimeoutError("generation timed out")
        if p.error:
            if p.code == CODE_DEADLINE:
                raise DeadlineExceeded(p.error)
            raise ValueError(p.error)
        return p.tokens

    def submit_wait(self, prompt: List[int], sampling: SamplingParams,
                    timeout: float = DEFAULT_TIMEOUT_S,
                    deadline: Optional[float] = None) -> Pending:
        """Blocking submit; returns the completed Pending."""
        p = self.submit_async(prompt, sampling, deadline=deadline)
        if deadline is not None:
            timeout = min(timeout, max(0.0, deadline - time.monotonic()) + 1.0)
        self.wait(p, timeout)
        return p

    def submit(self, prompt: List[int], sampling: SamplingParams,
               timeout: float = DEFAULT_TIMEOUT_S,
               deadline: Optional[float] = None) -> Tuple[List[int], float]:
        """Blocking generate. Returns (tokens, ttft_seconds)."""
        p = self.submit_wait(prompt, sampling, timeout, deadline=deadline)
        return p.tokens, self.ttft(p)

    @staticmethod
    def ttft(p: Pending) -> float:
        return (p.t_first - p.t_submit) if p.t_first else 0.0

    def warmup(self, input_len: int = 32, out_len: int = 2) -> float:
        """Build the CUDA kernels (first use compiles them) and run one
        wave per decode bucket size through the normal submit path, largest
        first. Returns elapsed seconds."""
        t0 = time.monotonic()
        if self.engine.device.type == "cuda":
            from rbg_tpu_torch.ops.kernels.build import build
            build()
        eng = self.engine
        sizes = sorted({eng._bucket(b) for b in range(1, eng.cfg.max_batch + 1)},
                       reverse=True)
        for B in sizes:
            items = [(warm_prompt(input_len, B, i),
                      SamplingParams(max_new_tokens=out_len)) for i in range(B)]
            for p in self.submit_wave(items):
                self.wait(p, DEFAULT_TIMEOUT_S)
        return time.monotonic() - t0

    def stats(self) -> dict:
        eng = self.engine
        out = dict(eng.metrics)
        out["running"] = len(eng.running)
        out["waiting"] = len(eng.waiting)
        out["free_pages"] = eng.allocator.free_pages
        out["radix_nodes"] = eng.radix.num_nodes if eng.radix is not None else 0
        with self._lock:
            out.update(self.counters)
            out["queue_depth"] = len(self._queue)
        out["max_queue"] = self.max_queue
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

    def _fail(self, p: Pending, msg: str, code: Optional[str] = None) -> None:
        p.error, p.code = msg, code
        p.done.set()

    def _loop(self):
        eng = self.engine
        while not self._stopped:
            now = time.monotonic()
            with self._lock:
                cancels, self._cancels = self._cancels, []
                live, expired = [], []
                for entry in self._queue:
                    d = entry[2].deadline
                    (expired if d is not None and now >= d else live).append(entry)
                budget = max(0, eng.cfg.max_batch - len(eng.running)
                             - len(eng.waiting))
                newly, self._queue = live[:budget], live[budget:]
                # Submissions still queued shorten the decode window so the
                # next free slot takes them at step granularity.
                eng.join_hint = bool(self._queue)
                self.counters["deadline_queue_drops"] += len(expired)
            for _, _, p in expired:
                self._fail(p, "deadline expired before admission", CODE_DEADLINE)
            for prompt, sampling, p in newly:
                try:
                    rid = eng.add_request(prompt, sampling)
                except Exception as e:  # noqa: BLE001 — a bad request fails itself
                    self._fail(p, str(e))
                    continue
                self._pending[rid] = p
            for rid, p in list(self._pending.items()):
                if p.deadline is not None and now >= p.deadline:
                    eng.cancel_request(rid)
                    del self._pending[rid]
                    with self._lock:
                        self.counters["deadline_running_aborts"] += 1
                    self._fail(p, "deadline exceeded mid-generation (aborted)",
                               CODE_DEADLINE)
            for p in cancels:
                rid = next((r for r, q in self._pending.items() if q is p), None)
                if rid is not None:
                    eng.cancel_request(rid)
                    del self._pending[rid]
                else:
                    with self._lock:
                        self._queue = [q for q in self._queue if q[2] is not p]
                p.done.set()
            if not eng.has_work():
                with self._lock:
                    idle = not self._queue and not self._cancels
                if idle:
                    self._wake.wait(0.01)
                    self._wake.clear()
                continue
            try:
                events = eng.step()
            except Exception as e:  # noqa: BLE001 — the loop must keep serving
                # A device fault fails every admitted request, not the loop.
                traceback.print_exc()
                with self._lock:
                    self.counters["loop_errors"] += 1
                for rid, p in list(self._pending.items()):
                    eng.cancel_request(rid)
                    self._fail(p, f"engine step failed: {e}")
                self._pending.clear()
                eng._dec = None   # the decode window's rows are gone
                continue
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
                    p.done.set()
                    del self._pending[ev.request_id]
