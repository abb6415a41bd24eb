"""Prefill/decode disaggregation: KV-cache handoff between engines
(``rbg_tpu/engine/pd.py``).

* ``PrefillWorker`` — runs prompts to first-token on a prefill engine and
  exports the sequence's KV pages: as one ``KVBundle`` (the whole-blob
  form) or as a CHUNKED STREAM over a ``rbg_tpu_torch.kvtransfer``
  transport — page-aligned, layer-ordered chunks published AS prefill
  chunks complete, so the transfer overlaps the remaining prefill compute.
* ``DecodeWorker`` — imports KV into its own page pool and continues
  decoding with continuous batching. The streaming form writes chunks
  into the page table as they arrive (host staging on transport threads;
  device commits on the engine loop thread, the single-writer contract)
  and admits the row the moment layer coverage is complete for the
  prompt — decode starts before the stream closes. With layer-sliced
  admission the row's first decode step runs as a chain of layer windows,
  each dispatched the moment its layers' pages are on the device.
* ``PDPair`` / ``PDStreamPair`` — in-process pairs sharing one weights
  dict. Cross-process transfer rides ``rbg_tpu_torch.engine.server`` ops
  (``prefill`` / ``kv_stream`` / ``decode_stream`` / ``decode_bundle``).

Device half, in torch's idiom: an export is one gather on dim 1 of the
``[L, NP, page, KV, hd]`` pools by a device index and one synchronous copy
into pinned host memory (the copy has finished before the prefill engine
releases the pages); an import is one host-to-device copy and an in-place
``index_copy_`` into the decode engine's pools on its stream. Where the
reference rebuilds the pool functionally under its commit lock, the port
writes in place: every write runs on the engine loop thread, stream-ordered
after any decode window still in flight. Host payloads are numpy arrays in
the wire dtype's host form (bfloat16 as int16 bits, ``kvtransfer.chunks``);
their bytes equal the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine, Request
from rbg_tpu_torch.engine.kvcache import pages_for_tokens
from rbg_tpu_torch.engine.kvtier import _to_device, _to_host
from rbg_tpu_torch.kvtransfer.chunks import (KVChunk, StreamError, StreamFin,
                                             StreamFirstToken, StreamMeta,
                                             slab_to_chunks)
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs import trace
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

_stream_ids = itertools.count()


def new_stream_id(prefix: str = "kvs") -> str:
    return f"{prefix}-{os.getpid()}-{next(_stream_ids)}"


def wire_dtype(dtype: torch.dtype) -> str:
    """The reference's wire name of a torch dtype (``"bfloat16"``, ...)."""
    return str(dtype).rsplit(".", 1)[-1]


def _stage(a: np.ndarray, wire: str, like: torch.Tensor) -> torch.Tensor:
    """Host pages of wire dtype ``wire`` as a tensor of ``like``'s dtype on
    its device: the bits as they are when the dtypes agree, else a value
    conversion (an f32 bundle into a bf16 pool, as the reference's
    ``jnp.asarray(.., pool dtype)`` converts)."""
    if wire == wire_dtype(like.dtype):
        return _to_device(a, like)
    t = torch.from_numpy(np.array(a))
    src = getattr(torch, wire)
    if t.dtype != src:
        t = t.view(src)
    return t.to(like.device, like.dtype)


@dataclasses.dataclass
class KVBundle:
    """A sequence's transferable KV state (the whole-blob form): host pages
    ``[L, n_pages, page, KV, hd]`` (MLA: the latent and the RoPE key, of
    different widths) in the wire dtype's host form."""

    prompt: List[int]
    first_token: int
    k_data: np.ndarray
    v_data: np.ndarray
    dtype: str = ""      # wire dtype name; "" = the arrays' own

    def __post_init__(self):
        if not self.dtype:
            self.dtype = str(self.k_data.dtype)

    @property
    def nbytes(self) -> int:
        return self.k_data.nbytes + self.v_data.nbytes


class PushResult:
    """Handle on an in-flight chunked KV push. ``prefill_stream`` returns
    the moment prefill COMPUTE ends (first token exists); the sender
    thread keeps draining queued chunks over the link. ``wait`` joins the
    push; ``error`` is the structured failure, if any."""

    def __init__(self, stream_id: str, meta: StreamMeta):
        self.stream_id = stream_id
        self.meta = meta
        self.first_token: Optional[int] = None
        self.nbytes = 0
        self.push_s = 0.0
        self.chunks = 0
        self._err: Optional[str] = None
        self._done = threading.Event()

    def wait(self, timeout: float = 60.0) -> bool:
        return self._done.wait(timeout)

    def error(self) -> Optional[str]:
        return self._err


class PrefillWorker:
    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 device=None, pool=None, directory=None,
                 advertise_addr: str = "", slice_id: Optional[str] = None,
                 mesh=None):
        """``pool``: optional ``engine.kvpool.KVPoolClient`` — the SHARED
        cross-request/cross-replica prefix store (Mooncake-store analog).
        Consulted before computing, published to after. Pool failures
        degrade to cold prefill, never to request failure.

        ``directory``: optional cluster prefix directory handle
        (``kvtransfer.PrefixDirectory`` or ``DirectoryClient``). Computed
        page-aligned prefixes are registered under ``advertise_addr`` (this
        replica's serving address) so the router can send prefix-sharing
        requests to ANY holder. ``slice_id`` tags entries for slice-level
        invalidation on preemption (default: $RBG_SLICE_ID).

        ``mesh``: the engine's (``Engine(mesh=...)``). Every rank exports
        pages with all of their KV heads (an all-gather over tp), so a
        bundle and a stream carry the unsharded engine's bytes."""
        cfg = dataclasses.replace(cfg, mode="prefill")
        self.engine = Engine(cfg, params=params, device=device, mesh=mesh)
        self.pool = pool
        self.directory = directory
        self.advertise_addr = advertise_addr
        self.slice_id = (slice_id if slice_id is not None
                         else os.environ.get("RBG_SLICE_ID", ""))
        if pool is not None and getattr(pool, "page_size", None) is None:
            pool.page_size = cfg.page_size  # handshake: server verifies
        self.metrics = {"bundles": 0, "bytes_out": 0, "transfer_s": 0.0,
                        "pool_hits": 0, "pool_hit_tokens": 0,
                        "pool_exports": 0, "pool_errors": 0,
                        "streams": 0, "stream_chunks": 0,
                        "dir_registers": 0}

    @property
    def wire_dtype(self) -> str:
        return wire_dtype(self.engine.cache.k_pages.dtype)

    def warmup(self, input_len: int = 32) -> float:
        """Build the kernels (on the card) and run one prompt through the
        prefill + export path before traffic. The shared pool and the
        directory are bypassed: warmup KV must not pollute them."""
        from rbg_tpu_torch.engine.config import warm_prompt

        t0 = time.perf_counter()
        if self.engine.device.type == "cuda":
            from rbg_tpu_torch.ops.kernels.build import build
            build()
        pool, self.pool = self.pool, None
        directory, self.directory = self.directory, None
        try:
            self.prefill(warm_prompt(input_len))
        finally:
            self.pool = pool
            self.directory = directory
        return time.perf_counter() - t0

    # ---- shared prefill core ----

    def _start_request(self, prompt: List[int], one: SamplingParams):
        """Pool-consulted admission. Returns (rid, matched_tokens)."""
        rid = None
        matched = 0
        # Adapter requests skip the shared pool: pooled KV is base-model KV.
        if self.pool is not None and one.lora is None:
            # Keep at least the prompt's last token for prefill (logits) —
            # same contract as the in-process radix cache.
            try:
                matched, kd, vd = self.pool.match(prompt[:-1])
            except (OSError, RuntimeError):
                self.metrics["pool_errors"] += 1
                matched = 0
            if matched:
                try:
                    rid = self.engine.add_request_with_prefix(
                        prompt, one, matched, kd, vd)
                except ValueError:
                    # Malformed pool data (e.g. misaligned prefix) must
                    # degrade to a cold prefill, never fail the request.
                    self.metrics["pool_errors"] += 1
                    rid = None
                if rid is None:
                    matched = 0  # no free pages / bad data: cold prefill
                else:
                    self.metrics["pool_hits"] += 1
                    self.metrics["pool_hit_tokens"] += matched
        if rid is None:
            rid = self.engine.add_request(prompt, one)
        return rid, matched

    def _run_to_first(self, rid: int, deadline: Optional[float],
                      on_step: Optional[Callable[[Request], None]] = None
                      ) -> int:
        """Step the engine until ``rid`` emits its first token. ``on_step``
        fires after every step with the request — the chunk-publish hook."""
        first = None
        req = self.engine.requests[rid]
        while first is None:
            if deadline is not None and time.monotonic() >= deadline:
                from rbg_tpu_torch.engine.protocol import DeadlineExceeded
                self.engine.cancel_request(rid)
                self.metrics["deadline_aborts"] = (
                    self.metrics.get("deadline_aborts", 0) + 1)
                raise DeadlineExceeded(
                    "deadline spent mid-prefill (aborted, pages recycled)")
            for ev in self.engine.step():
                if ev.request_id == rid:
                    first = ev.token
            if on_step is not None:
                on_step(req)
        return first

    def _export_pages(self, req: Request, lo: int, hi: int):
        """Host copy of device pages [lo, hi) of this request — the
        transfer payload: one gather per pool on the page axis, then one
        synchronous copy into pinned host memory (finished when this
        returns, so the pages may be released right after). Callers keep
        it off any critical section. Under tp the gathered pages join every
        rank's KV heads first (``Engine.whole_heads``)."""
        eng = self.engine
        cache = eng.cache
        ids = torch.tensor(req.pages[lo:hi], dtype=torch.long,
                           device=cache.k_pages.device)
        t0 = time.perf_counter()
        k = _to_host(eng.whole_heads(cache.k_pages.index_select(1, ids)))
        v = _to_host(eng.whole_heads(cache.v_pages.index_select(1, ids)))
        self.metrics["transfer_s"] += time.perf_counter() - t0
        return k, v

    def _publish_pool(self, prompt: List[int], matched: int,
                      k: np.ndarray, v: np.ndarray,
                      lora) -> None:
        """Publish the page-aligned prompt prefix to the shared store and
        register it in the cluster directory. Adapter KV never enters
        either — it is not base-model KV."""
        ps = self.engine.cfg.page_size
        full = len(prompt) // ps
        if self.pool is not None and lora is None and full > matched // ps:
            try:
                self.pool.put(prompt, k[:, :full], v[:, :full],
                              dtype=self.wire_dtype)
                self.metrics["pool_exports"] += 1
            except (OSError, RuntimeError):
                self.metrics["pool_errors"] += 1
        if self.directory is not None and lora is None and full > 0 \
                and self.advertise_addr:
            try:
                self.directory.register(prompt[:full * ps],
                                        self.advertise_addr,
                                        slice_id=self.slice_id)
                self.metrics["dir_registers"] += 1
            except (OSError, RuntimeError, ValueError):
                pass  # the directory is an optimization, never a dependency

    def prefill(self, prompt: List[int],
                sampling: Optional[SamplingParams] = None,
                deadline: Optional[float] = None) -> KVBundle:
        """Run one prompt to its first token; export KV pages as one
        bundle (the whole-blob handoff).

        ``deadline`` (absolute ``time.monotonic()``) aborts a long chunked
        prefill between chunks once the client's budget is spent — the
        pages recycle immediately instead of finishing a bundle nobody is
        waiting for. Raises ``DeadlineExceeded`` so the server maps it to
        the structured wire code."""
        sampling = sampling or SamplingParams()
        one = dataclasses.replace(sampling, max_new_tokens=1)
        rid, matched = self._start_request(prompt, one)
        first = self._run_to_first(rid, deadline)
        req = self.engine.requests[rid]
        n_pages = pages_for_tokens(len(prompt), self.engine.cfg.page_size)
        k, v = self._export_pages(req, 0, n_pages)
        self.engine.release_request(rid)
        self._publish_pool(prompt, matched, k, v, sampling.lora)
        bundle = KVBundle(prompt=list(prompt), first_token=first,
                          k_data=k, v_data=v, dtype=self.wire_dtype)
        self.metrics["bundles"] += 1
        self.metrics["bytes_out"] += bundle.nbytes
        return bundle

    def stream_meta(self, prompt: List[int],
                    stream_id: str) -> StreamMeta:
        cache = self.engine.cache
        return StreamMeta(
            stream_id=stream_id, prompt=list(prompt),
            n_pages=pages_for_tokens(len(prompt),
                                     self.engine.cfg.page_size),
            k_page_shape=cache.whole_page_shape(cache.k_pages),
            v_page_shape=cache.whole_page_shape(cache.v_pages),
            dtype=self.wire_dtype,
            layers=int(cache.k_pages.shape[0]),
            page_size=self.engine.cfg.page_size)

    # hot_path
    def prefill_stream(self, prompt: List[int],
                       sampling: Optional[SamplingParams] = None,
                       *, transport, peer: str,
                       stream_id: Optional[str] = None,
                       deadline: Optional[float] = None,
                       layer_split: int = 0) -> PushResult:
        """Chunked, layer-overlapped prefill→decode push.

        META is sent before compute (the receiver can allocate pages
        early); each prefill chunk's newly-final full pages are exported
        and published AS the next chunk computes; the remaining pages, the
        first token, and FIN follow prefill completion. All SENDS happen
        on a dedicated sender thread — the prefill engine (and the
        server's pd_lock critical section around it) never blocks on the
        link. Returns when COMPUTE is done; the push drains behind
        (``PushResult.wait``). Push failures surface on the result, not as
        request failures — the caller decides bundle-fallback vs retry."""
        sampling = sampling or SamplingParams()
        one = dataclasses.replace(sampling, max_new_tokens=1)
        sid = stream_id or new_stream_id()
        meta = self.stream_meta(prompt, sid)
        res = PushResult(sid, meta)
        ps = self.engine.cfg.page_size
        split = layer_split or meta.layers
        q: "queue.Queue" = queue.Queue()
        pspan = trace.child(obs_names.SPAN_KVT_PUSH, stream_id=sid,
                            peer=peer, pages=meta.n_pages)

        def sender():
            send_s = 0.0   # pure link time, excluding waits on compute
            try:
                while True:
                    frame = q.get()
                    if frame is None:      # producer abort (deadline)
                        transport.send_one(peer, StreamFin(
                            sid, n_chunks=res.chunks, aborted=True,
                            error="prefill aborted"))
                        res._err = "prefill aborted before completion"
                        return
                    t0 = time.monotonic()
                    transport.send_one(peer, frame)
                    send_s += time.monotonic() - t0
                    if isinstance(frame, KVChunk):
                        res.nbytes += frame.nbytes
                        res.chunks += 1
                        REGISTRY.inc(obs_names.KVT_CHUNKS_TOTAL,
                                     direction="sent")
                    if isinstance(frame, StreamFin):
                        return
            except (StreamError, OSError) as e:
                res._err = str(e)
            finally:
                res.push_s = send_s
                if res.nbytes and res._err is None:
                    REGISTRY.inc(obs_names.KVT_STREAMS_TOTAL, outcome="ok")
                    REGISTRY.inc(obs_names.KVT_BYTES_TOTAL,
                                 float(res.nbytes), direction="sent",
                                 transport=transport.name)
                    # Measured link rate from THIS real transfer — what
                    # the router's transfer-cost scoring consumes.
                    transport.stats.observe(peer, res.nbytes, send_s)
                elif res._err is not None:
                    REGISTRY.inc(obs_names.KVT_STREAMS_TOTAL,
                                 outcome="error")
                pspan.end(outcome=res._err or "ok", bytes=res.nbytes)
                res._done.set()

        t = threading.Thread(target=sender, daemon=True,
                             name=f"kvpush-{sid}")
        t.start()
        q.put(meta)
        rid, matched = self._start_request(prompt, one)
        req = self.engine.requests[rid]
        exported = [0]    # pages fully exported so far
        seq = [0]
        # Retain the exported slabs when a pool/directory publish will
        # need the full prefix — exporting device→host a second time
        # would double the transfer AND stretch the server's pd_lock
        # critical section.
        publishing = ((self.pool is not None or self.directory is not None)
                      and sampling.lora is None and len(prompt) // ps > 0)
        slabs: List = []

        def publish_final_pages(r: Request) -> None:
            # Hold the LAST page group for the post-token tail: the final
            # page finalizes with the final prefill chunk (same instant
            # the first token's logits exist), and exporting it here
            # would queue its bytes AHEAD of StreamFirstToken — on an
            # in-order link that serializes every admission (which needs
            # the token) behind the full transfer, closing the
            # layer-sliced window for page-aligned prompts.
            done = min(r.prefill_pos // ps, meta.n_pages - 1)
            if done <= exported[0]:
                return
            k, v = self._export_pages(r, exported[0], done)
            if publishing:
                slabs.append((k, v))
            for ch in slab_to_chunks(meta, k, v, exported[0], seq[0],
                                     split):
                q.put(ch)
                seq[0] += 1
            self.metrics["stream_chunks"] += 1
            exported[0] = done

        try:
            first = self._run_to_first(rid, deadline,
                                       on_step=publish_final_pages)
        except Exception:
            q.put(None)    # structured abort to the receiver
            raise
        res.first_token = first
        # First token the moment compute ends — BEFORE the tail pages'
        # payload (the StreamFirstToken contract in kvtransfer.chunks).
        q.put(StreamFirstToken(sid, first))
        # Remaining pages (the last prefill chunk's, incl. a partial
        # final page), then FIN.
        if exported[0] < meta.n_pages:
            k, v = self._export_pages(req, exported[0], meta.n_pages)
            if publishing:
                slabs.append((k, v))
            for ch in slab_to_chunks(meta, k, v, exported[0], seq[0],
                                     split):
                q.put(ch)
                seq[0] += 1
            exported[0] = meta.n_pages
        q.put(StreamFin(sid, n_chunks=seq[0]))
        # Pool/directory publish wants the page-aligned prefix —
        # assembled from the slabs already exported for the stream.
        if publishing and slabs:
            full = len(prompt) // ps
            k = np.concatenate([s[0] for s in slabs], axis=1)[:, :full]
            v = np.concatenate([s[1] for s in slabs], axis=1)[:, :full]
            self._publish_pool(prompt, matched, k, v, sampling.lora)
        self.engine.release_request(rid)
        self.metrics["streams"] += 1
        self.metrics["bytes_out"] += meta.nbytes()
        return res


class _StreamCommit:
    """Loop-thread bookkeeping for one in-flight inbound stream: the
    allocated pages and which staged cells already hit the device."""

    __slots__ = ("receiver", "pages", "committed", "t_first_commit",
                 "committed_map", "dispatched_layers", "admitted")

    def __init__(self, receiver):
        self.receiver = receiver
        self.pages: Optional[List[int]] = None
        self.committed = 0
        self.t_first_commit: Optional[float] = None
        # Layer-sliced admission state: which (layer, page) cells hit the
        # DEVICE (the dispatch watermark source), how many leading layers
        # the window chain already attended (commits below this are
        # clipped — a retransmitted slab must not overwrite, in place, the
        # decode-token KV the window pass wrote), and whether the row was
        # admitted (page ownership moved to the request).
        self.committed_map = None          # np.bool_ [L, n_pages]
        self.dispatched_layers = 0
        self.admitted = False


class DecodeWorker:
    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 device=None, mesh=None, sliced: bool = False):
        """``mesh``: the engine's (``Engine(mesh=...)``); every rank imports
        the same payloads, each writing its own KV heads. ``sliced``:
        ``params`` already hold this rank's slices (``Engine``)."""
        cfg = dataclasses.replace(cfg, mode="decode", enable_radix_cache=False)
        self.engine = Engine(cfg, params=params, device=device, mesh=mesh,
                             sliced=sliced)
        self.metrics = {"bundles": 0, "bytes_in": 0, "streams_in": 0,
                        "stream_commits": 0, "stream_errors": 0,
                        "commit_s": 0.0}
        # Serializes the in-place pool writes against any OTHER committer
        # (the engine loop thread is the only sanctioned one — the lock
        # makes a violation visible) and feeds the pd_lock hold-time
        # histogram: staging happens OUTSIDE this lock, the write alone
        # inside it.
        self._commit_lock = named_lock("engine.pd_commit")
        # Loop-thread-confined: stream_id → _StreamCommit. TTL backstop:
        # a stream nobody finalizes (abandoned push, dead consumer) must
        # release its pages instead of holding KV capacity forever.
        self._stream_commits: Dict[str, _StreamCommit] = {}
        self.stream_ttl_s = 120.0

    # ---- shared commit primitive ----

    def _commit_pages(self, pages: List[int], k_host: np.ndarray,
                      v_host: np.ndarray, wire: str,
                      layer_lo: Optional[int] = None,
                      layer_hi: Optional[int] = None) -> None:
        """Write host K/V pages into the device pool in place: staging
        (one host-to-device copy per pool, of this rank's KV heads under
        tp) outside the commit lock, the ``index_copy_`` on the page axis
        inside it, all on the engine's stream."""
        eng = self.engine
        cache = eng.cache
        t0 = time.perf_counter()
        ids = torch.tensor(pages, dtype=torch.long, device=cache.k_pages.device)
        k_dev = _stage(eng.local_heads(k_host), wire, cache.k_pages)
        v_dev = _stage(eng.local_heads(v_host), wire, cache.v_pages)
        t1 = time.perf_counter()
        with self._commit_lock:
            kp, vp = cache.k_pages, cache.v_pages
            if layer_lo is not None:
                kp, vp = kp[layer_lo:layer_hi], vp[layer_lo:layer_hi]
            kp.index_copy_(1, ids, k_dev)
            vp.index_copy_(1, ids, v_dev)
        t2 = time.perf_counter()
        self.metrics["commit_s"] += t2 - t0
        REGISTRY.observe(obs_names.PD_LOCK_HOLD_SECONDS, t2 - t1,
                         lock="pd_commit")

    # ---- whole-bundle import ----

    # hot_path
    def inject(self, bundle: KVBundle,
               sampling: Optional[SamplingParams] = None) -> int:
        """Import a KV bundle and start decoding it. Returns the request id.
        The first token is accounted as output[0] (already produced).

        The page-pool import (the on-device half of the prefill→decode KV
        handoff) gets its own ``pd.kv_handoff`` span under the ambient
        request span."""
        sampling = sampling or SamplingParams()
        eng = self.engine
        prompt = bundle.prompt
        eng._check_prompt(prompt)
        # Before alloc — a raise must not leak pages.
        eng._grammar_check(sampling)
        n_pages = bundle.k_data.shape[1]
        need = pages_for_tokens(len(prompt) + 1, eng.cfg.page_size)
        pages = eng._alloc(need)
        if pages is None:
            raise RuntimeError("decode engine out of KV pages")
        # Context-manager form: a raise in the page import must still end
        # the span or the trace finalizes incomplete.
        try:
            with trace.child(obs_names.SPAN_PD_KV_HANDOFF,
                             bytes=bundle.nbytes, pages=int(n_pages)):
                self._commit_pages(pages[:n_pages], bundle.k_data,
                                   bundle.v_data, bundle.dtype)
            rid = self._admit_row(prompt, bundle.first_token, pages,
                                  sampling)
        except Exception:
            eng.allocator.release(pages)
            raise
        self.metrics["bundles"] += 1
        self.metrics["bytes_in"] += bundle.nbytes
        return rid

    def _admit_row(self, prompt: List[int], first_token: int,
                   pages: List[int],
                   sampling: SamplingParams) -> int:
        """Post-KV-import admission shared by bundle and stream paths:
        grammar fold-in, request construction, finished-at-inject
        handling. The caller releases pages on a raise. The row joins the
        engine's NEXT decode window: a window in flight keeps its own rows
        (the fused step drains it when its batch changes)."""
        eng = self.engine
        lora_idx = eng._resolve_lora(sampling)
        req = Request(prompt, sampling)
        req.lora_idx = lora_idx
        g = eng._grammar_for(sampling)
        if g is not None:
            # The first token was sampled prefill-side under the grammar
            # mask — fold it in so decode continues from the right state.
            nxt = g.advance_token(g.initial(), first_token)
            if nxt is None:
                # A grammar-wired prefill can't produce this; it means the
                # prefill peer ignored the constraint (mixed-version
                # deploy). Reject rather than emit corrupt "constrained"
                # output.
                raise ValueError(
                    f"first token {first_token} violates the "
                    "request's grammar constraint — prefill peer ignored "
                    "json_mode/regex/json_schema?")
            req.grammar = g
            req.gstate = nxt
        req.state = "running"
        req.pages = pages
        req.seq_len = len(prompt)
        req.prefill_pos = len(prompt)
        req.output = [first_token]
        req.last_token = first_token
        req.t_first = time.perf_counter()
        eng.requests[req.id] = req
        eng.running.append(req)
        # Already complete (max_new_tokens == 1 or stop token hit): finish
        # now so its pages recycle.
        if (len(req.output) >= sampling.max_new_tokens
                or (sampling.stop_token is not None
                    and first_token == sampling.stop_token)):
            eng._finish(req)
        return req.id

    # ---- streaming import (engine loop thread only) ----

    def begin_stream(self, receiver) -> None:
        """Start committing a stream's chunks as they arrive. Loop-thread
        only (the engine single-writer contract)."""
        sid = receiver.stream_id
        if sid not in self._stream_commits:
            self._stream_commits[sid] = _StreamCommit(receiver)

    # hot_path
    def pump_streams(self) -> int:
        """Write newly-arrived chunks of every watched stream into the
        device page table. Loop-thread only. Returns cells committed."""
        eng = self.engine
        done = 0
        now = time.monotonic()
        for sid in list(self._stream_commits):
            sc = self._stream_commits[sid]
            rx = sc.receiver
            if now - rx.t_open > self.stream_ttl_s:
                rx.fail("stream expired unconsumed (TTL)")
            if rx.error() is not None:
                # Structured failure: recycle any pages; the waiter (the
                # decode_stream handler) surfaces the error. An ADMITTED
                # row's pages belong to the request (the layer-sliced
                # window chain cancels it and releases them there) —
                # releasing here too would double-free the page ids.
                if sc.pages is not None and not sc.admitted:
                    eng.allocator.release(sc.pages)
                del self._stream_commits[sid]
                self.metrics["stream_errors"] += 1
                REGISTRY.inc(obs_names.KVT_STREAMS_TOTAL,
                             outcome="recv_error")
                continue
            a = rx.assembler
            if a is None:
                continue
            if sc.pages is None:
                need = pages_for_tokens(len(a.meta.prompt) + 1,
                                        eng.cfg.page_size)
                pages = eng._alloc(need)
                if pages is None:
                    continue   # retry when pages free up
                sc.pages = pages
            cells = rx.drain_uncommitted()
            if not cells:
                continue
            done += self._commit_cells(sc, cells)
        return done

    def _commit_cells(self, sc: _StreamCommit, cells) -> int:
        """Device writes for staged (layer, page) cells, one per cell
        range; the host slice and the staging happen outside the commit
        lock."""
        rx = sc.receiver
        a = rx.assembler
        if sc.t_first_commit is None:
            sc.t_first_commit = time.perf_counter()
        if sc.committed_map is None:
            sc.committed_map = np.zeros((a.meta.layers, a.meta.n_pages),
                                        bool)
        with trace.child(obs_names.SPAN_KVT_COMMIT,
                         stream_id=rx.stream_id, cells=len(cells)):
            for (llo, lhi, plo, phi) in cells:
                # Clip below the dispatch watermark: layers the window
                # chain already attended carry the decode token's KV at
                # slot len(prompt) — a lossy link's retransmitted slab
                # (re-staged by the assembler on partial overlap) must not
                # overwrite it in place. Everything below the watermark is
                # on the device already (dispatch REQUIRES the watermark),
                # so skipping is lossless.
                llo = max(llo, sc.dispatched_layers)
                if llo >= lhi:
                    continue
                self._commit_pages(sc.pages[plo:phi],
                                   a.k[llo:lhi, plo:phi],
                                   a.v[llo:lhi, plo:phi], a.meta.dtype,
                                   llo, lhi)
                sc.committed_map[llo:lhi, plo:phi] = True
                self.metrics["stream_commits"] += 1
        return len(cells)

    def finalize_stream(self, receiver,
                        sampling: Optional[SamplingParams] = None) -> int:
        """Admit a coverage-complete stream as a running decode row. Loop
        thread only; the receiver must be ready() (the caller waited).
        Flushes any cells not yet committed, then admits — the row starts
        decoding even while the stream's FIN is still in flight."""
        sampling = sampling or SamplingParams()
        eng = self.engine
        rx = receiver
        if rx.error() is not None:
            raise StreamError(rx.error())
        a = rx.assembler
        if a is None or not a.ready():
            raise StreamError(
                f"stream {rx.stream_id} not ready at finalize")
        prompt = list(a.meta.prompt)
        try:
            eng._check_prompt(prompt)
            eng._grammar_check(sampling)
        except Exception:
            # Wire-supplied meta can be garbage — recycle any pages the
            # pump already allocated for it before failing the request.
            self.abandon_stream(rx)
            raise
        if rx.t_first_step is None:
            # Decode stopped waiting on the transfer plane here: the
            # admission decision is made and everything after (page
            # flush, the first step) is engine cost, not plane wait.
            rx.t_first_step = time.monotonic()
        self.begin_stream(rx)
        sc = self._stream_commits[rx.stream_id]
        if sc.pages is None:
            need = pages_for_tokens(len(prompt) + 1, eng.cfg.page_size)
            sc.pages = eng._alloc(need)
            if sc.pages is None:
                del self._stream_commits[rx.stream_id]
                # StreamError (not RuntimeError): the wire code lets the
                # router retry this row on a sibling in bundle mode — the
                # pushed KV cannot be admitted here.
                raise StreamError("decode engine out of KV pages")
        cells = rx.drain_uncommitted()
        if cells:
            self._commit_cells(sc, cells)
        pages = sc.pages
        del self._stream_commits[rx.stream_id]
        try:
            rid = self._admit_row(prompt, int(a.first_token), pages,
                                  sampling)
        except Exception:
            eng.allocator.release(pages)
            raise
        self.metrics["streams_in"] += 1
        self.metrics["bytes_in"] += a.bytes_seen
        REGISTRY.inc(obs_names.KVT_BYTES_TOTAL, float(a.bytes_seen),
                     direction="recv", transport="stream")
        return rid

    # ---- layer-sliced admission (engine loop thread only) ----

    def _device_layer_coverage(self, sc: _StreamCommit) -> int:
        """Leading layers whose every page cell hit the DEVICE — the
        dispatch watermark (host assembly coverage is necessary but not
        sufficient: the window must attend committed pages)."""
        m = sc.committed_map
        if m is None:
            return 0
        return int(np.cumprod(m.all(axis=1)).sum())

    def _window(self, lo: int, hi: int, x, pos, mask, kvl, table):
        """One layer window over the live pools, in place (eager torch
        compiles nothing, so nothing is cached per (lo, hi, bucket))."""
        from rbg_tpu_torch.models.llama import forward_paged_window
        eng = self.engine
        cache = eng.cache
        with self._commit_lock:
            return forward_paged_window(
                eng.params, eng.mcfg, lo, hi, x, pos, mask, kvl, table,
                cache.k_pages, cache.v_pages, k_scales=cache.k_scales,
                v_scales=cache.v_scales, par=eng.par)

    def _embed(self, tok):
        from rbg_tpu_torch.models.llama import _embed
        return _embed(self.engine.params, self.engine.mcfg, tok, self.engine.par)

    def _head(self, x):
        from rbg_tpu_torch.models.llama import _head
        return _head(self.engine.params, self.engine.mcfg, x, self.engine.par)

    def _wait_layer_watermark(self, sc: _StreamCommit, hi: int,
                              deadline: Optional[float]) -> None:
        """Block (pumping commits) until the first ``hi`` layers are fully
        on device. A layer missing its watermark degrades to waiting — the
        same wait the full-coverage path would pay — bounded by
        ``deadline`` and the receiver's error state, never a wedge."""
        rx = sc.receiver
        while self._device_layer_coverage(sc) < hi:
            if rx.error() is not None:
                raise StreamError(rx.error())
            self.pump_streams()
            if self._device_layer_coverage(sc) >= hi:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise StreamError(
                    f"stream {rx.stream_id}: layer watermark {hi} not "
                    f"reached before deadline (device coverage "
                    f"{self._device_layer_coverage(sc)})")
            time.sleep(0.0002)

    def finalize_stream_layer_sliced(self, receiver,
                                     sampling: Optional[SamplingParams]
                                     = None,
                                     min_layers: int = 1,
                                     deadline: Optional[float] = None
                                     ) -> int:
        """Admit a stream at layer-``min_layers`` coverage — BEFORE the
        tail layers land — and run the first decode step as a chain of
        layer-windowed forward passes, each dispatched the moment its
        layers' pages are on device. The decode step overlaps the
        transfer tail instead of waiting it out. Loop thread only.

        The chain reproduces the fused decode window's first iteration
        exactly: same padded bucket, same write mask, same key schedule
        (row key at position seq_len + 1), same grammar-mask / penalty /
        sampler composition — its token is the token the fused path would
        have produced, and the KV it writes at slot ``len(prompt)`` is the
        KV the fused path would have written. Later tokens ride the fused
        path."""
        sampling = sampling or SamplingParams()
        eng = self.engine
        rx = receiver
        if rx.error() is not None:
            raise StreamError(rx.error())
        if sampling.lora is not None:
            # The layer-window forward has no adapter path — callers route
            # lora rows to the full-coverage wait.
            raise StreamError(
                "layer-sliced admission does not support lora requests")
        a = rx.assembler
        if a is None or not a.ready_layers(min_layers):
            raise StreamError(
                f"stream {rx.stream_id} not layer-ready at layer-sliced "
                f"finalize (need {min_layers} layers)")
        prompt = list(a.meta.prompt)
        try:
            eng._check_prompt(prompt)
            eng._grammar_check(sampling)
        except Exception:
            self.abandon_stream(rx)
            raise
        self.begin_stream(rx)
        sid = rx.stream_id
        sc = self._stream_commits[sid]
        if sc.pages is None:
            need = pages_for_tokens(len(prompt) + 1, eng.cfg.page_size)
            sc.pages = eng._alloc(need)
            if sc.pages is None:
                del self._stream_commits[sid]
                raise StreamError("decode engine out of KV pages")
        cells = rx.drain_uncommitted()
        if cells:
            self._commit_cells(sc, cells)
        pages = sc.pages
        try:
            rid = self._admit_row(prompt, int(a.first_token), pages,
                                  sampling)
        except Exception:
            eng.allocator.release(pages)
            del self._stream_commits[sid]
            raise
        # Page ownership moved to the request — a later stream error must
        # not release them a second time (pump_streams checks this flag).
        sc.admitted = True
        layers_at_admit = a.layer_coverage()
        rx.layers_at_admit = layers_at_admit
        rx.total_layers = int(a.meta.layers)
        self.metrics["streams_in"] += 1
        self.metrics["bytes_in"] += a.bytes_seen
        REGISTRY.inc(obs_names.KVT_BYTES_TOTAL, float(a.bytes_seen),
                     direction="recv", transport="stream")
        REGISTRY.inc(obs_names.KVT_LAYER_ADMIT_TOTAL)
        REGISTRY.observe(obs_names.KVT_LAYER_ADMIT_COVERAGE_LAYERS,
                         float(layers_at_admit))
        req = eng.requests.get(rid)
        if req is None or req.state != "running":
            # Finished at inject (max_new_tokens == 1 / stop token): its
            # pages already recycled — stop committing into them NOW.
            del self._stream_commits[sid]
            return rid
        try:
            # The chain IS the row's first decode step — stamp it here
            # (before FIN can land) so overlap accounting credits the
            # decode work started under the transfer tail.
            receiver.t_first_step = time.monotonic()
            with trace.child(obs_names.SPAN_PD_LAYER_SLICED_STEP,
                             stream_id=sid,
                             layers_at_admit=layers_at_admit):
                self._layer_sliced_first_step(sc, req, min_layers,
                                              deadline)
        except BaseException:
            self._stream_commits.pop(sid, None)
            eng.cancel_request(rid)
            raise
        # Every layer is dispatched (and therefore committed) — the only
        # frames still in flight are duplicates/FIN; drop the watch.
        del self._stream_commits[sid]
        return rid

    def _first_step_inputs(self, req: Optional[Request]):
        """The fused window's first-iteration inputs at bucket B for one
        row (``req``; None: a warm row whose writes are all masked off)."""
        eng = self.engine
        B = eng._bucket(1)
        P = eng.cfg.max_pages_per_seq
        tok = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        kvl = np.ones(B, np.int32)
        mask = np.zeros((B, 1), bool)
        limit = np.zeros(B, np.int32)
        table = np.zeros((B, P), np.int32)
        if req is not None:
            tok[0] = req.last_token
            pos[0] = req.seq_len
            kvl[0] = req.seq_len + 1
            mask[0, 0] = True
            limit[0] = req.max_len()
            table[0, :len(req.pages)] = req.pages
        dev = eng.device
        return (B, pos,
                torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev),
                torch.from_numpy(mask & (pos < limit)[:, None]).to(dev),
                torch.from_numpy(kvl).to(dev),
                torch.from_numpy(table).to(dev))

    def _layer_sliced_first_step(self, sc: _StreamCommit, req,
                                 min_layers: int,
                                 deadline: Optional[float]) -> None:
        """The layer-windowed decode step for a just-admitted row: embed →
        [wait watermark → window forward] per layer window → head →
        sample → emit (deferred). Mirrors the fused window's first
        iteration; see ``finalize_stream_layer_sliced``."""
        eng = self.engine
        L = int(eng.cache.k_pages.shape[0])
        win = max(1, int(min_layers))
        B, pos, tok_d, pos_d, write_ok, kvl_d, table_d = \
            self._first_step_inputs(req)
        x = self._embed(tok_d[:, None])
        for lo in range(0, L, win):
            hi = min(lo + win, L)
            self._wait_layer_watermark(sc, hi, deadline)
            x = self._window(lo, hi, x, pos_d[:, None], write_ok, kvl_d,
                             table_d)
            sc.dispatched_layers = hi
        lg = self._head(x)[:, 0, :]                            # [B, V]
        rows = eng._sampling_rows([req], B)
        out_counts = eng._penalty_counts([req], B) if rows["pen"] else None
        # Grammar mask before sampling (penalties apply inside the
        # sampler), as the fused window orders them.
        lg = eng._grammar_masked(lg, [req])
        # Key by the OUTPUT position (seq_len + 1) — the fused window's
        # key schedule for the first decode token.
        toks, lps = eng._sample(lg, rows,
                                torch.from_numpy(pos + 1).to(eng.device),
                                out_counts)
        tok_out = int(toks[0])
        lp_val = (float(lps[0]) if lps is not None and req.sampling.logprobs
                  else None)
        req.seq_len += 1
        eng.metrics["decode_tokens"] += 1
        # Deferred emission: the event comes out of the engine's next
        # step(), exactly like a fused-window decode token.
        eng._deferred_events.append(eng._emit(req, tok_out, lp_val))

    def warm_layer_sliced(self, min_layers: int) -> float:
        """Run the layer-window chain once (every window, the head, the
        default sampler) before traffic, all writes masked off so the live
        pool is unchanged: on the card this builds and loads the kernels
        the chain launches."""
        eng = self.engine
        t0 = time.perf_counter()
        L = int(eng.cache.k_pages.shape[0])
        win = max(1, int(min_layers))
        B, pos, tok_d, pos_d, write_ok, kvl_d, table_d = \
            self._first_step_inputs(None)
        x = self._embed(tok_d[:, None])
        for lo in range(0, L, win):
            x = self._window(lo, min(lo + win, L), x, pos_d[:, None],
                             write_ok, kvl_d, table_d)
        lg = self._head(x)[:, 0, :]
        eng._sample(lg, eng._sampling_rows([], B),
                    torch.from_numpy(pos + 1).to(eng.device))
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return time.perf_counter() - t0

    def abandon_stream(self, receiver) -> None:
        """Drop a watched stream (deadline/cancel before admission) —
        pages recycle. Loop thread only."""
        sc = self._stream_commits.pop(receiver.stream_id, None)
        if sc is not None and sc.pages is not None:
            self.engine.allocator.release(sc.pages)


class PDPair:
    """In-process prefill+decode pair: the decode worker shares the
    prefill worker's weights dict (one copy on the card)."""

    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 device=None, mesh=None):
        self.prefill = PrefillWorker(cfg, params=params, device=device, mesh=mesh)
        # Decode shares weights with prefill (same card in process; under a
        # mesh, this rank's slices).
        self.decode = DecodeWorker(cfg, params=self.prefill.engine.params,
                                   device=self.prefill.engine.device, mesh=mesh,
                                   sliced=True)

    def generate(self, prompts: List[List[int]],
                 sampling: Optional[SamplingParams] = None,
                 collect_ttft: bool = False):
        sampling = sampling or SamplingParams()
        outputs: Dict[int, List[int]] = {}
        ttft: List[float] = []
        order = []
        for p in prompts:
            t0 = time.perf_counter()
            bundle = self.prefill.prefill(p, sampling)
            rid = self.decode.inject(bundle, sampling)
            ttft.append(time.perf_counter() - t0)
            outputs[rid] = [bundle.first_token]
            order.append(rid)
        while self.decode.engine.has_work():
            for ev in self.decode.engine.step():
                if ev.request_id in outputs:
                    outputs[ev.request_id].append(ev.token)
        result = [outputs[r] for r in order]
        return (result, ttft) if collect_ttft else result


class PDStreamPair:
    """In-process PD pair over an explicit ``kvtransfer`` transport — the
    chunked/overlapped twin of ``PDPair``. ``stream=False`` sends the SAME
    frames whole (every chunk after prefill completes, admission only at
    FIN): the whole-bundle baseline measured over the identical link."""

    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 device=None, transport=None, layer_split: int = 0,
                 admit_layers: int = 0, mesh=None):
        from rbg_tpu_torch.kvtransfer.transport import InProcTransport

        self.prefill = PrefillWorker(cfg, params=params, device=device, mesh=mesh)
        self.decode = DecodeWorker(cfg, params=self.prefill.engine.params,
                                   device=self.prefill.engine.device, mesh=mesh,
                                   sliced=True)
        if admit_layers and self.prefill.engine.tp > 1:
            # Whether a row is admitted at layer coverage or at full coverage
            # depends on when each rank's chunks land, so the ranks would run
            # different forwards and their collectives would not pair up.
            raise ValueError("admit_layers with tp > 1: layer-sliced admission "
                             "is timed per rank (ROADMAP.md queue 1 item 8: a "
                             "multi-rank EngineService, whose rank 0 decides)")
        self.transport = transport or InProcTransport()
        self.layer_split = layer_split
        # > 0: admit at layer-k coverage and run the first decode step as
        # a layer-windowed chain overlapping the transfer tail. Only
        # effective with a layer_split fine enough to stream layers
        # separately (layer_split == 0 sends all layers per chunk — there
        # is no tail to overlap).
        self.admit_layers = int(admit_layers)

    def generate_one(self, prompt: List[int],
                     sampling: Optional[SamplingParams] = None,
                     stream: bool = True, recv_timeout: float = 30.0,
                     max_retries: int = 1) -> dict:
        """One request through the transfer plane. Returns a timing dict:
        tokens, t_first_decode (request start → first DECODE token — the
        stall the plane shrinks), admit_lead_s, retries."""
        from rbg_tpu_torch.kvtransfer.chunks import bundle_to_frames
        from rbg_tpu_torch.kvtransfer.stream import KVStreamReceiver

        sampling = sampling or SamplingParams()
        t0 = time.perf_counter()
        last_err = None
        for attempt in range(max_retries + 1):
            sid = new_stream_id()
            rx = KVStreamReceiver(sid)
            rx_thread = threading.Thread(
                target=rx.pump, args=(self.transport,),
                kwargs={"timeout": recv_timeout}, daemon=True,
                name=f"kvrecv-{sid}")
            rx_thread.start()
            if stream:
                res = self.prefill.prefill_stream(
                    prompt, sampling, transport=self.transport, peer="",
                    stream_id=sid, layer_split=self.layer_split)
                first_token = res.first_token
            else:
                bundle = self.prefill.prefill(prompt, sampling)
                first_token = bundle.first_token
                meta = self.prefill.stream_meta(prompt, sid)
                frames = bundle_to_frames(meta, bundle.k_data,
                                          bundle.v_data,
                                          bundle.first_token,
                                          self.layer_split)
                threading.Thread(target=self.transport.send_chunks,
                                 args=("", frames), daemon=True,
                                 name=f"kvsend-{sid}").start()
            # Drive commits while the stream lands; admit at coverage
            # (stream arm) / at FIN (whole-bundle semantics).
            self.decode.begin_stream(rx)
            deadline = time.monotonic() + recv_timeout
            rid = None
            while rid is None:
                if rx.error() is not None:
                    last_err = rx.error()
                    self.decode.abandon_stream(rx)
                    break
                self.decode.pump_streams()
                if (self.admit_layers > 0 and stream
                        and sampling.lora is None and not rx.ready()
                        and rx.ready_layers(self.admit_layers)):
                    # Layer-sliced early admission: layer-k coverage is in
                    # but full coverage is not — start decoding under the
                    # transfer tail. A mid-chain stream failure cancels
                    # the row before any token is emitted, so falling into
                    # the retry loop stays token-exact.
                    try:
                        rid = self.decode.finalize_stream_layer_sliced(
                            rx, sampling, min_layers=self.admit_layers,
                            deadline=deadline)
                    except StreamError as e:
                        last_err = str(e)
                    break
                if rx.ready() and (stream or rx.t_fin is not None):
                    rid = self.decode.finalize_stream(rx, sampling)
                    break
                if time.monotonic() >= deadline:
                    self.decode.abandon_stream(rx)
                    raise StreamError(
                        f"stream {sid} never became ready")
                time.sleep(0.0002)
            if rid is None:
                continue   # retry (token-exact: decode never started)
            tokens = [first_token]
            t_first_decode = None
            while self.decode.engine.has_work():
                for ev in self.decode.engine.step():
                    if ev.request_id == rid:
                        if t_first_decode is None:
                            t_first_decode = time.perf_counter() - t0
                            if rx.t_first_step is None:
                                rx.t_first_step = time.monotonic()
                        tokens.append(ev.token)
            rx_thread.join(timeout=recv_timeout)
            return {"tokens": tokens, "t_first_decode": t_first_decode,
                    "admit_lead_s": rx.admit_lead_s(),
                    # Overlap: the first decode step landed BEFORE the
                    # stream's close frame — decode started while the
                    # transfer plane was still moving this row's stream.
                    "overlap": (rx.t_first_step is not None
                                and rx.t_fin is not None
                                and rx.t_first_step < rx.t_fin),
                    "retries": attempt, "stream_id": sid,
                    "layers_at_admit": rx.layers_at_admit,
                    "total_layers": rx.total_layers,
                    "bytes": rx.assembler.bytes_seen if rx.assembler
                    else 0}
        raise StreamError(
            f"stream failed after {max_retries + 1} attempts: {last_err}")

    def generate(self, prompts: List[List[int]],
                 sampling: Optional[SamplingParams] = None,
                 stream: bool = True, **kw) -> List[List[int]]:
        return [self.generate_one(p, sampling, stream=stream, **kw)["tokens"]
                for p in prompts]
