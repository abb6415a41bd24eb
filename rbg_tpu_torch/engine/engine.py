"""Serving engine: continuous batching over a paged KV pool
(``rbg_tpu/engine/engine.py``, unified mode).

One scheduler step admits waiting requests onto the pool (with radix
prefix matching), then either

* runs ONE ragged forward for the whole batch while any row is still
  prefilling (``_unified_step``: prefill chunks and decode tokens packed
  on one token axis → the ragged CUDA kernel), or
* runs the fused decode window on a pure-decode batch
  (``_fused_decode_step``: K decode steps with the sampled token fed back
  on the device → the paged decode CUDA kernel; the window's tokens reach
  the host in one fetch, one window late, so host bookkeeping overlaps the
  device).

Page exhaustion preempts the youngest request back to the queue.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rbg_tpu_torch.engine.config import (EngineConfig, SamplingParams,
                                         resolve_device)
from rbg_tpu_torch.engine.kvcache import (PageAllocator, PagedKVCache,
                                          pages_for_tokens)
from rbg_tpu_torch.engine.radix_cache import RadixCache
from rbg_tpu_torch.engine.sampler import row_keys, sample
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged, init_params


@dataclasses.dataclass
class StepEvent:
    request_id: int
    token: int
    finished: bool
    logprob: Optional[float] = None


class Request:
    _ids = itertools.count()

    def __init__(self, prompt: List[int], sampling: SamplingParams):
        self.id = next(Request._ids)
        self.prompt = list(prompt)
        # _preempt folds generated output into prompt for re-prefill;
        # everything past this index is OUTPUT for penalty accounting.
        self.orig_prompt_len = len(prompt)
        self.sampling = sampling
        self.output: List[int] = []
        self.state = "waiting"          # waiting | prefill | running | finished
        self.pages: List[int] = []
        self.prefill_pos = 0            # next prompt index to prefill
        self.seq_len = 0                # tokens materialized in KV
        self.last_token: Optional[int] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None

    def max_len(self) -> int:
        return len(self.prompt) + self.sampling.max_new_tokens


class Engine:
    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 device=None):
        cfg.validate()
        self.cfg = cfg
        self.mcfg = cfg.model_config
        self.device = resolve_device(device if device is not None else cfg.device)
        if params is None:
            params = init_params(self.mcfg, cfg.seed, self.device)
        elif params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        # Row keys of requests without a seed hash this with the request id.
        self._sample_base = cfg.seed + 1
        self.cache = PagedKVCache.create(self.mcfg, cfg.num_pages,
                                         cfg.page_size, device=self.device)
        self.allocator = PageAllocator(cfg.num_pages)
        self.radix = (RadixCache(self.allocator, cfg.page_size)
                      if cfg.enable_radix_cache else None)
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.requests: Dict[int, Request] = {}
        # Fused decode state (device tensors) plus the pending window whose
        # tokens are fetched one step late.
        self._dec: Optional[dict] = None
        # Set by the serving loop when submissions wait beyond this step's
        # admissions: the decode window shortens so the join lands next step.
        self.join_hint = False
        self.metrics = {"steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                        "radix_hit_tokens": 0, "preemptions": 0,
                        "unified_steps": 0, "decode_windows": 0, "joins": 0}

    # ---- public API ----

    def _check_prompt(self, prompt: List[int]) -> None:
        V = self.mcfg.vocab_size
        if not prompt:
            raise ValueError("empty prompt")
        lo, hi = min(prompt), max(prompt)
        if lo < 0 or hi >= V:
            bad = lo if lo < 0 else hi
            raise ValueError(f"prompt token {bad} outside model vocab [0, {V})")

    def add_request(self, prompt: List[int],
                    sampling: Optional[SamplingParams] = None) -> int:
        sampling = sampling or SamplingParams()
        sampling.check_supported()
        self._check_prompt(prompt)
        if len(prompt) + sampling.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens {len(prompt)}+{sampling.max_new_tokens} "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        req = Request(prompt, sampling)
        self.requests[req.id] = req
        self.waiting.append(req)
        return req.id

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self) -> List[StepEvent]:
        """One scheduler iteration: admit, then the ragged unified step while
        any row prefills, else the fused decode window."""
        self.metrics["steps"] += 1
        self._admit()
        if any(r.state == "prefill" for r in self.running):
            self.metrics["unified_steps"] += 1
            events = self._unified_step()
        else:
            events = self._fused_decode_step()
        self.join_hint = False
        return events

    def generate(self, prompts: List[List[int]],
                 sampling: Optional[SamplingParams] = None) -> List[List[int]]:
        ids = [self.add_request(p, sampling) for p in prompts]
        outputs = {i: [] for i in ids}
        while self.has_work():
            for ev in self.step():
                if ev.request_id in outputs:
                    outputs[ev.request_id].append(ev.token)
        return [outputs[i] for i in ids]

    # ---- admission ----

    def _admit(self):
        while self.waiting:
            if len(self.running) >= self.cfg.max_batch:
                break
            req = self.waiting[0]
            matched, shared_pages = 0, []
            if self.radix is not None and req.state == "waiting":
                # Keep at least the prompt's last token for prefill (logits).
                matched, shared_pages = self.radix.match(req.prompt[:-1])
            # Pages for the prompt + first token only: decode grows page by
            # page, and preemption reclaims on exhaustion.
            need = (pages_for_tokens(len(req.prompt) + 1, self.cfg.page_size)
                    - len(shared_pages))
            pages = self._alloc(need)
            if pages is None:
                if shared_pages:
                    self.allocator.release(shared_pages)
                break  # no capacity — stay queued
            self.waiting.pop(0)
            self.metrics["joins"] += 1
            self.metrics["radix_hit_tokens"] += matched
            req.pages = shared_pages + pages
            req.prefill_pos = matched
            req.seq_len = matched
            req.state = "prefill"
            self.running.append(req)

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n <= 0:
            return []
        pages = self.allocator.alloc(n)
        if pages is None and self.radix is not None:
            self.radix.evict(n - self.allocator.free_pages)
            pages = self.allocator.alloc(n)
        return pages

    # ---- ragged unified prefill/decode step ----

    @staticmethod
    def _token_bucket(n: int) -> int:
        """Packed-token bucket: next power of two (>= 8)."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _grow_decode_pages(self, rows: List[Request]) -> None:
        """Every decode row gets a page for its next token; preempt the
        youngest on exhaustion."""
        for req in sorted(rows, key=lambda r: r.t_submit):
            if req.state != "running":
                continue  # preempted earlier in this very loop
            need = (pages_for_tokens(req.seq_len + 1, self.cfg.page_size)
                    - len(req.pages))
            if need <= 0:
                continue
            extra = self._alloc(need)
            while extra is None:
                if self._preempt_youngest(exclude=req) is None:
                    break
                extra = self._alloc(need)
            if extra is None:
                self._preempt(req)
                continue
            req.pages.extend(extra)

    def _unified_step(self) -> List[StepEvent]:
        """ONE ragged forward for the whole batch: each prefilling row adds
        its next chunk, each decoding row one token. The pending decode
        window is drained first — its tokens already count in seq_len."""
        events: List[StepEvent] = list(self._drain_decode())
        self._grow_decode_pages([r for r in self.running if r.state == "running"])

        entries = []                 # (req, start, end); end == start: decode
        for r in self.running:
            if r.state == "prefill":
                start = r.prefill_pos
                entries.append((r, start, min(start + self.cfg.prefill_chunk,
                                              len(r.prompt))))
            elif r.state == "running":
                entries.append((r, r.seq_len, r.seq_len))
        if not entries:
            return events

        P = self.cfg.max_pages_per_seq
        Rb = self._bucket(len(entries))
        Tb = self._token_bucket(sum((e - s) if e > s else 1 for _, s, e in entries))
        tok = np.zeros((1, Tb), np.int32)
        pos = np.full((1, Tb), -1, np.int32)   # -1 = pad (the pack's contract)
        tmask = np.zeros((1, Tb), bool)
        row_ids = np.zeros(Tb, np.int32)
        kvl = np.zeros(Rb, np.int32)
        table = np.zeros((Rb, P), np.int32)
        off = 0
        sample_rows = []             # (req, packed_idx, key_pos, is_decode)
        for i, (req, start, end) in enumerate(entries):
            if end > start:          # prefill chunk
                n = end - start
                tok[0, off:off + n] = req.prompt[start:end]
                pos[0, off:off + n] = np.arange(start, end, dtype=np.int32)
                kvl[i] = end
                if end == len(req.prompt):
                    # The first output token samples at the position right
                    # after the prompt (a token at position p is keyed by p).
                    sample_rows.append((req, off + n - 1, end, False))
            else:                    # decode step: write last_token, sample
                n = 1
                tok[0, off] = req.last_token
                pos[0, off] = req.seq_len
                kvl[i] = req.seq_len + 1
                sample_rows.append((req, off, req.seq_len + 1, True))
            tmask[0, off:off + n] = True
            row_ids[off:off + n] = i
            table[i, :len(req.pages)] = req.pages
            off += n

        dev = self.device
        logits = forward_ragged(
            self.params, self.mcfg, torch.from_numpy(tok).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(tmask).to(dev),
            torch.from_numpy(row_ids).to(dev), torch.from_numpy(kvl).to(dev),
            torch.from_numpy(table).to(dev), self.cache.k_pages,
            self.cache.v_pages, max_q_len=self.cfg.prefill_chunk)

        for req, start, end in entries:
            if end > start:
                req.prefill_pos = end
                req.seq_len = end
                self.metrics["prefill_tokens"] += end - start
        if not sample_rows:
            return events

        reqs = [r for r, _, _, _ in sample_rows]
        Bs = self._bucket(len(sample_rows))
        pad = Bs - len(sample_rows)
        idx = torch.tensor([i for _, i, _, _ in sample_rows] + [0] * pad,
                           device=dev)
        key_pos = np.zeros(Bs, np.int32)
        key_pos[:len(sample_rows)] = [kp for _, _, kp, _ in sample_rows]
        rows = self._sampling_rows(reqs, Bs)
        out_counts = None
        if rows["pen"]:
            out_counts = self._penalty_counts(reqs, Bs)
        toks, lps = self._sample(logits[0, idx], rows,
                                 torch.from_numpy(key_pos).to(dev), out_counts)
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy() if lps is not None else None
        for n, (req, _, _, is_decode) in enumerate(sample_rows):
            lpv = (float(lps[n]) if lps is not None and req.sampling.logprobs
                   else None)
            if is_decode:
                req.seq_len += 1
                self.metrics["decode_tokens"] += 1
            else:
                req.state = "running"
                req.t_first = time.perf_counter()
            events.append(self._emit(req, int(toks[n]), lpv))
        return events

    # ---- sampling rows ----

    def _sampling_rows(self, reqs: List[Request], B: int) -> dict:
        """Per-row sampling tensors (on the device) and the host-known flags
        that pick the sampler's variant."""
        temps = np.zeros(B, np.float32)
        ks = np.zeros(B, np.int64)
        tps = np.ones(B, np.float32)
        mps = np.zeros(B, np.float32)
        seeds: List[Optional[int]] = [None] * B
        rids = [0] * B
        for i, r in enumerate(reqs):
            sp = r.sampling
            temps[i], ks[i], tps[i], mps[i] = (sp.temperature, sp.top_k,
                                               sp.top_p, sp.min_p)
            seeds[i], rids[i] = sp.seed, r.id
        dev = self.device
        out = {
            "temps": torch.from_numpy(temps).to(dev),
            "ks": torch.from_numpy(ks).to(dev),
            "tps": torch.from_numpy(tps).to(dev),
            "mps": torch.from_numpy(mps).to(dev),
            "keys": row_keys(seeds, self._sample_base, rids, dev),
            "pen": any(r.sampling.needs_penalties() for r in reqs),
            "lp": any(r.sampling.logprobs for r in reqs),
            "tpmp": any(r.sampling.top_p < 1.0 or r.sampling.min_p > 0.0
                        for r in reqs),
            "hot": any(r.sampling.temperature > 0 for r in reqs),
        }
        if out["pen"]:
            out.update(self._penalty_rows(reqs, B))
        return out

    def _penalty_rows(self, reqs: List[Request], B: int) -> dict:
        """Prompt-seen mask and per-row factors. A preempted-and-resumed
        request carries its earlier output inside ``prompt``; those tokens
        count as OUTPUT (see ``_penalty_counts``), not prompt."""
        V = self.mcfg.vocab_size
        pmask = np.zeros((B, V), bool)
        rep = np.ones(B, np.float32)
        pres = np.zeros(B, np.float32)
        freq = np.zeros(B, np.float32)
        for n, req in enumerate(reqs):
            sp = req.sampling
            pmask[n, np.asarray(req.prompt[:req.orig_prompt_len], np.int64)] = True
            rep[n], pres[n], freq[n] = (sp.repetition_penalty,
                                        sp.presence_penalty, sp.frequency_penalty)
        dev = self.device
        return {"pmask": torch.from_numpy(pmask).to(dev),
                "rep": torch.from_numpy(rep).to(dev),
                "pres": torch.from_numpy(pres).to(dev),
                "freq": torch.from_numpy(freq).to(dev)}

    def _penalty_counts(self, reqs: List[Request], B: int) -> torch.Tensor:
        """[B, V] output-token counts: the tokens generated before a
        preemption (folded into the prompt) plus the current output."""
        oc = np.zeros((B, self.mcfg.vocab_size), np.int64)
        for n, req in enumerate(reqs):
            np.add.at(oc[n], np.asarray(req.prompt[req.orig_prompt_len:], np.int64), 1)
            np.add.at(oc[n], np.asarray(req.output, np.int64), 1)
        return torch.from_numpy(oc).to(self.device)

    def _sample(self, logits, rows: dict, positions, out_counts=None):
        pkw = {}
        if rows["pen"]:
            pkw = dict(prompt_mask=rows["pmask"], out_counts=out_counts,
                       rep=rows["rep"], pres=rows["pres"], freq=rows["freq"])
        return sample(logits, rows["keys"], positions, rows["temps"], rows["ks"],
                      rows["tps"], rows["mps"], any_sampled=rows["hot"],
                      want_logprobs=rows["lp"], use_top_p_min_p=rows["tpmp"],
                      **pkw)

    # ---- fused decode ----

    def _pending_counts(self) -> Dict[int, int]:
        """id(req) → number of un-emitted tokens awaiting fetch."""
        if self._dec is None or self._dec["pending"] is None:
            return {}
        rows, _, _, valid = self._dec["pending"]
        return {id(r): v for r, v in zip(rows, valid)}

    def _decode_batch(self) -> List[Request]:
        """Running requests worth dispatching: rows whose length budget is
        already spent by pending tokens can only finish."""
        pend = self._pending_counts()
        return [r for r in self.running
                if r.state == "running"
                and len(r.output) + pend.get(id(r), 0) < r.sampling.max_new_tokens]

    def _emit_pending(self, pending) -> List[StepEvent]:
        rows, toks_host, lps_host, valid = pending
        vals = toks_host.numpy()         # [K, B]; waits for that window only
        lpv = lps_host.numpy() if lps_host is not None else None
        events = []
        for i, req in enumerate(rows):
            for k in range(valid[i]):
                if req.state != "running":
                    break                    # stop token cut the window short
                self.metrics["decode_tokens"] += 1
                lp = (float(lpv[k, i])
                      if lpv is not None and req.sampling.logprobs else None)
                events.append(self._emit(req, int(vals[k, i]), lp))
        return events

    def _drain_decode(self) -> List[StepEvent]:
        """Emit the pending window's tokens and drop the device state
        (forcing a rebuild)."""
        st, self._dec = self._dec, None
        if st is None or st["pending"] is None:
            return []
        return self._emit_pending(st["pending"])

    def _decode_window(self) -> int:
        """Window length for THIS step: 1 when a join is possible (a free
        slot) and work is waiting, so the join lands next step."""
        K = self.cfg.multi_step
        if K > 1 and (len(self.running) < self.cfg.max_batch
                      and (self.join_hint or self.waiting)):
            return 1
        return K

    def _build_decode_state(self, batch: List[Request]) -> dict:
        B = self._bucket(len(batch))
        P = self.cfg.max_pages_per_seq
        tok = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        kvl = np.zeros(B, np.int32)
        mask = np.zeros((B, 1), bool)
        limit = np.zeros(B, np.int32)
        table = np.zeros((B, P), np.int32)
        for i, r in enumerate(batch):
            tok[i] = r.last_token
            pos[i] = r.seq_len
            kvl[i] = r.seq_len + 1
            mask[i, 0] = True
            limit[i] = r.max_len()
            table[i, :len(r.pages)] = r.pages
        dev = self.device
        st = {"rows": list(batch), "B": B, "table_np": table,
              "table": torch.from_numpy(table).to(dev),
              "tok": torch.from_numpy(tok).to(dev),
              "pos": torch.from_numpy(pos).to(dev),
              "kvl": torch.from_numpy(kvl).to(dev),
              "mask": torch.from_numpy(mask).to(dev),
              "limit": torch.from_numpy(limit).to(dev),
              "sampling": self._sampling_rows(batch, B), "pending": None}
        if st["sampling"]["pen"]:
            st["ocounts"] = self._penalty_counts(batch, B)
        return st

    def _run_window(self, st: dict, K: int):
        """K decode steps on the device, each = forward + sampling +
        position/length advance, the sampled token fed straight back. Rows
        at their length limit stop writing KV and stop advancing; their
        samples are discarded host-side. Keys are (row key, OUTPUT position
        pos + 1). Returns (tokens [K, B], logprobs [K, B] or None)."""
        rows = st["sampling"]
        tok, pos, kvl = st["tok"], st["pos"], st["kvl"]
        toks_seq, lps_seq = [], []
        for _ in range(K):
            write_ok = st["mask"] & (pos < st["limit"])[:, None]     # [B, 1]
            logits = forward_paged(
                self.params, self.mcfg, tok[:, None], pos[:, None], write_ok,
                kvl, st["table"], self.cache.k_pages, self.cache.v_pages)
            toks, lps = self._sample(logits[:, 0], rows, pos + 1,
                                     st.get("ocounts"))
            active = write_ok[:, 0]
            if rows["pen"]:
                st["ocounts"][torch.arange(st["B"], device=self.device),
                              toks] += active.long()
            pos = torch.where(active, pos + 1, pos)
            kvl = torch.where(active, kvl + 1, kvl)
            tok = torch.where(active, toks, tok)
            toks_seq.append(toks)
            if lps is not None:
                lps_seq.append(lps)
        st["tok"], st["pos"], st["kvl"] = tok, pos, kvl
        return (torch.stack(toks_seq),
                torch.stack(lps_seq) if lps_seq else None)

    def _fused_decode_step(self) -> List[StepEvent]:
        events: List[StepEvent] = []
        batch = self._decode_batch()
        st = self._dec
        if st is not None and st["rows"] != batch:
            events.extend(self._drain_decode())
            st = None
            batch = self._decode_batch()
        if not batch:
            events.extend(self._drain_decode())
            return events

        # Pages for the whole window; preempt the youngest on exhaustion,
        # oldest first so old requests finish and release memory.
        K = self._decode_window()
        pages_changed = False
        for req in sorted(batch, key=lambda r: r.t_submit):
            if req.state != "running":
                continue  # preempted earlier in this very loop
            horizon = min(req.seq_len + K, req.max_len())
            need = pages_for_tokens(horizon, self.cfg.page_size) - len(req.pages)
            if need <= 0:
                continue
            extra = self._alloc(need)
            while extra is None:
                # Emit in-flight tokens before any pages are released: a
                # preempted request must not receive a stale token.
                events.extend(self._drain_decode())
                st = None
                if req.state != "running":
                    break  # the drain just finished THIS request
                extra = self._alloc(need)
                if extra is not None:
                    break
                if self._preempt_youngest(exclude=req) is None:
                    break
                extra = self._alloc(need)
            if req.state != "running":
                if extra:
                    self.allocator.release(extra)
                continue
            if extra is None:
                events.extend(self._drain_decode())
                st = None
                if req.state == "running":
                    self._preempt(req)
                continue
            req.pages.extend(extra)
            pages_changed = True
        batch2 = self._decode_batch()
        if batch2 != batch:
            if st is not None:
                events.extend(self._drain_decode())
                st = None
            batch = batch2
        if not batch:
            return events

        if st is None:
            st = self._dec = self._build_decode_state(batch)
        elif pages_changed:
            for i, r in enumerate(batch):
                row = st["table_np"][i]
                row[:len(r.pages)] = r.pages
                row[len(r.pages):] = 0
            st["table"] = torch.from_numpy(st["table_np"]).to(self.device)

        toks_seq, lps_seq = self._run_window(st, K)
        self.metrics["decode_windows"] += 1
        # Start the copy to the host now; it is read (and waited for) only
        # when the next step emits this window.
        toks_host = _HostCopy(toks_seq)
        lps_host = _HostCopy(lps_seq) if lps_seq is not None else None
        valid = []
        for req in batch:
            valid.append(min(K, req.max_len() - req.seq_len))
            req.seq_len = min(req.seq_len + K, req.max_len())
        prev, st["pending"] = st["pending"], (list(batch), toks_host, lps_host,
                                              valid)
        if prev is not None:
            events.extend(self._emit_pending(prev))
        return events

    def _emit(self, req: Request, tok: int,
              logprob: Optional[float] = None) -> StepEvent:
        req.output.append(tok)
        req.last_token = tok
        finished = (len(req.output) >= req.sampling.max_new_tokens
                    or (req.sampling.stop_token is not None
                        and tok == req.sampling.stop_token))
        if finished:
            self._finish(req)
        return StepEvent(req.id, tok, finished, logprob=logprob)

    # ---- lifecycle ----

    def _finish(self, req: Request):
        req.state = "finished"
        self.running = [r for r in self.running if r is not req]
        if self.radix is not None:
            # Cache the full sequence (prompt + output) for future prefixes.
            self.radix.insert(req.prompt + req.output[:-1], req.pages)
        self.allocator.release(req.pages)
        req.pages = []
        self.requests.pop(req.id, None)

    def cancel_request(self, req_id: int) -> bool:
        """Abort a request: drop it from the queues and recycle its pages
        (from the thread that drives step())."""
        req = self.requests.get(req_id)
        if req is None or req.state == "finished":
            return False
        req.state = "finished"
        self.waiting = [r for r in self.waiting if r is not req]
        self.running = [r for r in self.running if r is not req]
        if req.pages:
            self.allocator.release(req.pages)
            req.pages = []
        self.requests.pop(req_id, None)
        return True

    def _preempt(self, req: Request):
        self.metrics["preemptions"] += 1
        self.allocator.release(req.pages)
        req.pages = []
        req.state = "waiting"
        req.prefill_pos = 0
        req.seq_len = 0
        # Generated tokens become prompt so decoding resumes where it left off.
        if req.output:
            req.prompt = req.prompt + req.output
            req.sampling = dataclasses.replace(
                req.sampling,
                max_new_tokens=req.sampling.max_new_tokens - len(req.output))
            req.output = []
        self.running = [r for r in self.running if r is not req]
        self.waiting.insert(0, req)

    def _preempt_youngest(self, exclude: Request) -> Optional[Request]:
        candidates = [r for r in self.running
                      if r.state == "running" and r is not exclude]
        if not candidates:
            return None
        victim = max(candidates, key=lambda r: r.t_submit)
        self._preempt(victim)
        return victim

    def _bucket(self, n: int) -> int:
        for b in self.cfg.decode_buckets:
            if b >= n:
                return min(b, max(self.cfg.decode_buckets))
        return max(self.cfg.decode_buckets)


class _HostCopy:
    """A device→host copy started now and waited for when read: reading
    waits for the work that produced the tensor, not for work queued
    after it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._t.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._t = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._t.numpy()
