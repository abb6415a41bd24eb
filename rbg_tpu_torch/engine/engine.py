"""Serving engine: continuous batching over a paged KV pool
(``rbg_tpu/engine/engine.py``, unified mode).

One scheduler step admits waiting requests onto the pool (with radix
prefix matching), then either

* runs ONE ragged forward for the whole batch while any row is still
  prefilling (``_unified_step``: prefill chunks and decode tokens packed
  on one token axis → a ragged CUDA kernel: B, D on an int8 pool, F, H
  for an MLA model), or
* takes the split paths (``ragged="off"``, speculative mode, or a batch
  holding an adapter row): one batched (B, chunk) ``forward_paged`` for
  every prefilling row (``_prefill_step``; on CUDA the ragged kernels see
  the block as a pack), then the decode step;
* the decode step is the fused decode window (``_fused_decode_step``: K
  decode steps with the sampled token fed back on the device → a paged
  decode CUDA kernel: A, C on an int8 pool, E, G for an MLA model; the
  window's tokens reach the host in one fetch, one window late, so host
  bookkeeping overlaps the device), or in speculative mode the verify
  (``_spec_decode_step``: n-gram drafts checked by one (B, spec_k + 1)
  forward).

Requests may name a LoRA adapter (``load_lora``): all adapters ride one
stack, gathered per row inside each forward. Page exhaustion preempts the
youngest request back to the queue.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rbg_tpu_torch.engine.config import (EngineConfig, SamplingParams,
                                         resolve_device)
from rbg_tpu_torch.engine.kvcache import (PageAllocator, PagedKVCache,
                                          pages_for_tokens)
from rbg_tpu_torch.engine.radix_cache import RadixCache
from rbg_tpu_torch.engine.sampler import row_keys, sample
from rbg_tpu_torch.engine.spec import NGramIndex
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
        self.ngram: Optional[NGramIndex] = None   # speculative mode
        self.lora_idx = 0                         # adapter slot (0 = base model)
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        # Join accounting: the engine step at which the request entered
        # `waiting`, and the admission attempts it sat out for want of a
        # batch slot or pages. wait − blocked is its EXCESS wait, which
        # continuous batching bounds at one step. t_enqueue is the wall
        # clock twin (reset on preemption, so running time is not queue
        # wait).
        self.enqueue_step = 0
        self.blocked_steps = 0
        self.t_enqueue = self.t_submit

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
        # A request without a seed samples with fold_in(key(this), its id),
        # as the reference does.
        self._sample_base = cfg.seed + 1
        self.cache = PagedKVCache.create(self.mcfg, cfg.num_pages,
                                         cfg.page_size, device=self.device,
                                         quantize=(cfg.kv_dtype == "int8"))
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
        # Seconds each admitted request waited between entering `waiting`
        # and joining the batch; the service loop drains it into
        # rbg_serving_join_latency_seconds.
        self.last_join_waits: List[float] = []
        # Loaded LoRA adapters: name → stack slot, the raw adapters in slot
        # order, and the stack every forward gathers rows from.
        self._lora_slots: Dict[str, int] = {}
        self._lora_raw: List[Tuple[dict, float]] = []
        self.lora_stack: Optional[dict] = None
        self.metrics = {"steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                        "radix_hit_tokens": 0, "preemptions": 0,
                        "unified_steps": 0, "decode_windows": 0, "joins": 0,
                        "join_wait_steps_max": 0, "join_excess_steps_max": 0,
                        "spec_drafted": 0, "spec_accepted": 0, "spec_steps": 0}

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
        req.lora_idx = self._resolve_lora(sampling)
        req.enqueue_step = self.metrics["steps"]
        self.requests[req.id] = req
        self.waiting.append(req)
        return req.id

    def prefix_peek(self, prompt: List[int]) -> int:
        """Prefix-hit depth this prompt would get at admission. Read from
        submitter threads by the TTFT predictor while the loop thread owns
        the trie: a stale or zero answer only skews one prediction."""
        if self.radix is None or len(prompt) < 2:
            return 0
        try:
            return self.radix.peek(prompt[:-1])
        except Exception:  # noqa: BLE001 — racy read, degrade to a miss
            return 0

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self) -> List[StepEvent]:
        """One scheduler iteration: admit, then the ragged unified step while
        any row prefills (``_unified_eligible``), else the split paths:
        the batched prefill step, then the decode step."""
        self.metrics["steps"] += 1
        self._admit()
        if self._unified_eligible():
            self.metrics["unified_steps"] += 1
            events = self._unified_step()
        else:
            events = self._prefill_step() + self._decode_step()
        self.join_hint = False
        return events

    # ---- LoRA adapters ----

    _LORA_ATTN_TARGETS = ("wq", "wk", "wv", "wo")
    _LORA_MLA_TARGETS = ("wq", "w_dkv", "wo")
    _LORA_MLP_TARGETS = ("w_gate", "w_up", "w_down")

    def load_lora(self, name: str, adapter: dict, alpha: float = 16.0) -> None:
        """Register a LoRA adapter for per-request serving. ``adapter``:
        {target: (A [L, d_in, r], B [L, r, d_out])} (numpy or tensors) for
        wq/wk/wv/wo (GQA) or wq/w_dkv/wo (MLA; the absorbed w_uk/w_uv are no
        targets), and w_gate/w_up/w_down on models with a dense MLP. Every
        loaded adapter rides one stack (``_rebuild_lora_stack``), so a
        batch may mix adapters row by row."""
        if not adapter:
            raise ValueError("empty adapter")
        if name in self._lora_slots:
            raise ValueError(f"adapter {name!r} already loaded")
        allowed = set(self._LORA_MLA_TARGETS if self.mcfg.mla
                      else self._LORA_ATTN_TARGETS)
        if self.mcfg.num_experts == 0:
            allowed |= set(self._LORA_MLP_TARGETS)
        L = self.mcfg.num_layers
        base = self.params["blocks"]
        for tgt, (A, B) in adapter.items():
            if tgt not in allowed:
                raise ValueError(
                    f"adapter {name!r}: unsupported target {tgt!r} "
                    f"(supported here: {sorted(allowed)})")
            if A.shape[0] != L or B.shape[0] != L or A.shape[2] != B.shape[1]:
                raise ValueError(
                    f"adapter {name!r} target {tgt!r}: bad shapes "
                    f"{tuple(A.shape)} / {tuple(B.shape)}")
            bw = base[tgt]
            if A.shape[1] != bw.shape[1] or B.shape[2] != bw.shape[2]:
                raise ValueError(
                    f"adapter {name!r} target {tgt!r}: dims {A.shape[1]}→"
                    f"{B.shape[2]} do not match base weight "
                    f"{bw.shape[1]}→{bw.shape[2]} (wrong base model?)")
        # Registered only after the stack is built: a name resolving past
        # the stack would serve another adapter's rows.
        self._lora_raw.append((adapter, float(alpha)))
        try:
            self._rebuild_lora_stack()
        except Exception:
            self._lora_raw.pop()
            raise
        self._lora_slots[name] = len(self._lora_raw)

    def _rebuild_lora_stack(self) -> None:
        """{target: (A [L, n, d_in, rmax], B [L, n, rmax, d_out])} in the
        model dtype: rank-padded, alpha/r of THAT target folded into B in
        float32 before the cast, slot 0 zeros (no adapter).

        Nothing in flight is dropped: a pending decode window keeps its
        rows' slots (new adapters take new slots) and each forward reads
        the stack when it runs, so the window's tokens are emitted by the
        next step as always."""
        L = self.mcfg.num_layers
        n = len(self._lora_raw) + 1
        targets = sorted({t for ad, _ in self._lora_raw for t in ad})
        rmax = max(A.shape[2] for ad, _ in self._lora_raw for A, _B in ad.values())
        stack = {}
        for tgt in targets:
            d_in, d_out = next((ad[tgt][0].shape[1], ad[tgt][1].shape[2])
                               for ad, _ in self._lora_raw if tgt in ad)
            As = np.zeros((L, n, d_in, rmax), np.float32)
            Bs = np.zeros((L, n, rmax, d_out), np.float32)
            for i, (ad, alpha) in enumerate(self._lora_raw):
                if tgt in ad:
                    A, B = (np.asarray(torch.as_tensor(x).float().cpu())
                            for x in ad[tgt])
                    r = A.shape[2]
                    As[:, i + 1, :, :r] = A
                    Bs[:, i + 1, :r, :] = B * (alpha / r)
            dt = self.mcfg.torch_dtype
            stack[tgt] = (torch.from_numpy(As).to(self.device, dt),
                          torch.from_numpy(Bs).to(self.device, dt))
        self.lora_stack = stack

    def _resolve_lora(self, sampling: SamplingParams) -> int:
        if sampling.lora is None:
            return 0
        slot = self._lora_slots.get(sampling.lora)
        if slot is None:
            raise ValueError(
                f"unknown LoRA adapter {sampling.lora!r}; loaded: "
                f"{sorted(self._lora_slots) or 'none'}")
        return slot

    def _lora_rows(self, reqs: List[Request], B: int) -> Optional[torch.Tensor]:
        """[B] adapter slot per row on the device, or None when no row
        names an adapter (the forward then runs without the stack)."""
        if self.lora_stack is None or not any(r.lora_idx for r in reqs):
            return None
        ids = np.zeros(B, np.int64)
        ids[:len(reqs)] = [r.lora_idx for r in reqs]
        return torch.from_numpy(ids).to(self.device)

    def _lora_kw(self, lids: Optional[torch.Tensor]) -> dict:
        return {} if lids is None else {"lora": self.lora_stack, "lora_ids": lids}

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
        blocked = False
        while self.waiting:
            if len(self.running) >= self.cfg.max_batch:
                blocked = True   # a batch slot is the missing resource
                break
            req = self.waiting[0]
            matched, shared_pages = 0, []
            if (self.radix is not None and req.state == "waiting"
                    and req.lora_idx == 0):
                # Keep at least the prompt's last token for prefill (logits).
                # Adapter requests skip the cache: their KV is not the base
                # model's for the same tokens.
                matched, shared_pages = self.radix.match(req.prompt[:-1])
            # Pages for the prompt + first token only: decode grows page by
            # page, and preemption reclaims on exhaustion.
            need = (pages_for_tokens(len(req.prompt) + 1, self.cfg.page_size)
                    - len(shared_pages))
            pages = self._alloc(need)
            if pages is None:
                if shared_pages:
                    self.allocator.release(shared_pages)
                blocked = True
                break  # no capacity — stay queued
            self.waiting.pop(0)
            # Admitted at the first step after enqueue: waited 0.
            wait = max(0, self.metrics["steps"] - req.enqueue_step - 1)
            excess = max(0, wait - req.blocked_steps)
            self.metrics["join_wait_steps_max"] = max(
                self.metrics["join_wait_steps_max"], wait)
            self.metrics["join_excess_steps_max"] = max(
                self.metrics["join_excess_steps_max"], excess)
            self.last_join_waits.append(time.perf_counter() - req.t_enqueue)
            # Bounded for callers that step the engine without draining it.
            del self.last_join_waits[:-1024]
            req.blocked_steps = 0
            self.metrics["joins"] += 1
            self.metrics["radix_hit_tokens"] += matched
            req.pages = shared_pages + pages
            req.prefill_pos = matched
            req.seq_len = matched
            req.state = "prefill"
            self.running.append(req)
        if blocked:
            # Every request still waiting sat this step out for capacity.
            for r in self.waiting:
                r.blocked_steps += 1

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n <= 0:
            return []
        pages = self.allocator.alloc(n)
        if pages is None and self.radix is not None:
            self.radix.evict(n - self.allocator.free_pages)
            pages = self.allocator.alloc(n)
        return pages

    # ---- ragged unified prefill/decode step ----

    def _unified_eligible(self) -> bool:
        """One ragged dispatch for the whole batch this step: some row
        prefills, ``ragged="auto"``, not speculative, and no row names an
        adapter (the pack's batch axis is 1, while adapters are gathered per
        batch row)."""
        if self.cfg.ragged == "off" or self.cfg.speculative != "off":
            return False
        if not any(r.state == "prefill" for r in self.running):
            return False
        return not any(r.lora_idx for r in self.running)

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
            self.cache.v_pages, max_q_len=self.cfg.prefill_chunk,
            k_scales=self.cache.k_scales, v_scales=self.cache.v_scales)

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

    # ---- split prefill ----

    def _prefill_step(self) -> List[StepEvent]:
        """Every prefilling row advances by one chunk in ONE batched
        (B bucket, prefill_chunk) ``forward_paged``; rows whose prompt
        ends sample their first token together."""
        batch = [r for r in self.running if r.state == "prefill"]
        if not batch:
            return []
        chunk = self.cfg.prefill_chunk
        rows = [(r, r.prefill_pos, min(r.prefill_pos + chunk, len(r.prompt)))
                for r in batch]
        logits = self._run([(r, r.prompt[s:e], s) for r, s, e in rows],
                           self._bucket(len(batch)), chunk)
        finishing = []
        for i, (req, start, end) in enumerate(rows):
            req.prefill_pos = end
            req.seq_len = end
            self.metrics["prefill_tokens"] += end - start
            if end == len(req.prompt):
                finishing.append((i, end - start - 1, req))
        if not finishing:
            return []

        reqs = [req for _, _, req in finishing]
        Bs = self._bucket(len(finishing))
        pad = Bs - len(finishing)
        dev = self.device
        row_idx = torch.tensor([i for i, _, _ in finishing] + [0] * pad, device=dev)
        tok_idx = torch.tensor([j for _, j, _ in finishing] + [0] * pad, device=dev)
        key_pos = np.zeros(Bs, np.int32)
        key_pos[:len(reqs)] = [r.seq_len for r in reqs]  # the sampled token's position
        srows = self._sampling_rows(reqs, Bs)
        out_counts = self._penalty_counts(reqs, Bs) if srows["pen"] else None
        toks, lps = self._sample(logits[row_idx, tok_idx], srows,
                                 torch.from_numpy(key_pos).to(dev), out_counts)
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy() if lps is not None else None
        events = []
        for n, req in enumerate(reqs):
            req.state = "running"
            req.t_first = time.perf_counter()
            events.append(self._emit(req, int(toks[n]),
                                     float(lps[n]) if lps is not None
                                     and req.sampling.logprobs else None))
        return events

    def _run(self, entries: List[Tuple[Request, List[int], int]], B: int,
             T: int) -> torch.Tensor:
        """One [B, T] ``forward_paged`` (the split prefill chunk, the
        speculative verify): entry i = (request, its tokens, the position of
        the first), padded to T tokens and B rows, each row with its
        adapter; the cache length after the step is start + len(tokens).
        Pads are token_mask False at position 0, which the forward hands to
        the attention at -1. Returns logits [B, T, V]."""
        P = self.cfg.max_pages_per_seq
        tok = np.zeros((B, T), np.int32)
        pos = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), bool)
        kvl = np.zeros(B, np.int32)
        table = np.zeros((B, P), np.int32)
        for i, (r, ts, s0) in enumerate(entries):
            n = len(ts)
            tok[i, :n] = ts
            pos[i, :n] = np.arange(s0, s0 + n)
            mask[i, :n] = True
            kvl[i] = s0 + n
            table[i, :len(r.pages)] = r.pages
        dev = self.device
        lids = self._lora_rows([r for r, _, _ in entries], B)
        return forward_paged(
            self.params, self.mcfg, torch.from_numpy(tok).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(kvl).to(dev), torch.from_numpy(table).to(dev),
            self.cache.k_pages, self.cache.v_pages, k_scales=self.cache.k_scales,
            v_scales=self.cache.v_scales, **self._lora_kw(lids))

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
        slot) and work is waiting, so the join lands next step. Under
        ``ragged="off"`` always K (the window-boundary baseline)."""
        K = self.cfg.multi_step
        if K == 1 or self.cfg.ragged == "off":
            return K
        if len(self.running) < self.cfg.max_batch and (self.join_hint or self.waiting):
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
              "sampling": self._sampling_rows(batch, B), "pending": None,
              "lids": self._lora_rows(batch, B)}
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
                kvl, st["table"], self.cache.k_pages, self.cache.v_pages,
                k_scales=self.cache.k_scales, v_scales=self.cache.v_scales,
                **self._lora_kw(st["lids"]))
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

    def _decode_step(self) -> List[StepEvent]:
        if self.cfg.speculative == "ngram":
            return self._drain_decode() + self._spec_decode_step()
        return self._fused_decode_step()

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

    # ---- speculative decode (prompt-lookup drafting) ----

    def _ensure_ngram(self, req: Request) -> None:
        """Build or extend the request's n-gram index over its logical
        sequence (prompt + output: preemption only moves tokens between
        the two)."""
        if req.ngram is None:
            req.ngram = NGramIndex(self.cfg.spec_ngram)
        have = len(req.ngram.tokens)
        if have < len(req.prompt) + len(req.output):
            req.ngram.extend((req.prompt + req.output)[have:])

    def _spec_decode_step(self) -> List[StepEvent]:
        """Draft up to spec_k tokens per row from its n-gram index, run one
        (B, spec_k + 1) ``forward_paged`` over [last token, drafts], sample
        every position t with the key of position pos_t + 1 (the keys the
        sequential path uses), and accept drafts while they equal the
        samples; the sample at the first mismatch (or after the last draft)
        is the next token. Penalized rows never draft (their counts change
        token by token). KV written for rejected drafts lies past the new
        seq_len and is overwritten later."""
        events: List[StepEvent] = []
        batch = [r for r in self.running if r.state == "running"
                 and len(r.output) < r.sampling.max_new_tokens]
        if not batch:
            return events
        K = self.cfg.spec_k
        ps = self.cfg.page_size
        drafts: Dict[int, List[int]] = {}
        # Oldest first: a row sheds its drafts before it preempts the
        # youngest for pages.
        for req in sorted(batch, key=lambda r: r.t_submit):
            if req.state != "running":
                continue
            cap = min(K, req.sampling.max_new_tokens - len(req.output) - 1,
                      self.cfg.max_seq_len - req.seq_len - 1)
            d: List[int] = []
            if cap > 0 and not req.sampling.needs_penalties():
                self._ensure_ngram(req)
                d = req.ngram.draft(cap)
            while True:
                need = pages_for_tokens(req.seq_len + 1 + len(d), ps) - len(req.pages)
                if need <= 0:
                    break
                extra = self._alloc(need)
                if extra is not None:
                    req.pages.extend(extra)
                    break
                if d:
                    d = []
                    continue
                if self._preempt_youngest(exclude=req) is None:
                    self._preempt(req)
                    break
            if req.state == "running":
                drafts[id(req)] = d
        batch = [r for r in batch if r.state == "running"]
        if not batch:
            return events

        B, T = self._bucket(len(batch)), K + 1
        logits = self._run([(r, [r.last_token] + drafts[id(r)], r.seq_len)
                            for r in batch], B, T)
        # One sampler call over the T positions: position-major rows, each
        # row's sampling state tiled T times; input t of a row samples the
        # token at position seq_len + t + 1.
        key_pos = np.zeros((T, B), np.int32)
        key_pos[:, :len(batch)] = (np.asarray([r.seq_len for r in batch])[None]
                                   + np.arange(1, T + 1)[:, None])
        rows = self._sampling_rows(batch, B)
        tiled = {k: (v.repeat(T, *([1] * (v.dim() - 1)))
                     if isinstance(v, torch.Tensor) else v) for k, v in rows.items()}
        out_counts = None
        if rows["pen"]:
            out_counts = self._penalty_counts(batch, B).repeat(T, 1)
        toks, lps = self._sample(logits.transpose(0, 1).reshape(T * B, -1), tiled,
                                 torch.from_numpy(key_pos.reshape(-1)).to(self.device),
                                 out_counts)
        vals = toks.reshape(T, B).cpu().numpy()
        lpv = lps.reshape(T, B).cpu().numpy() if lps is not None else None
        self.metrics["spec_steps"] += 1
        for i, req in enumerate(batch):
            d = drafts[id(req)]
            m = 0
            while m < len(d) and int(vals[m, i]) == d[m]:
                m += 1
            self.metrics["spec_drafted"] += len(d)
            self.metrics["spec_accepted"] += m
            # KV is valid through the last accepted input.
            req.seq_len += m + 1
            for t in range(m + 1):
                if req.state != "running":
                    break           # a stop token cut the accepted run short
                self.metrics["decode_tokens"] += 1
                lpt = (float(lpv[t, i])
                       if lpv is not None and req.sampling.logprobs else None)
                events.append(self._emit(req, int(vals[t, i]), lpt))
        return events

    def _emit(self, req: Request, tok: int,
              logprob: Optional[float] = None) -> StepEvent:
        req.output.append(tok)
        if req.ngram is not None:
            req.ngram.append(tok)
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
        if self.radix is not None and req.lora_idx == 0:
            # Cache the full sequence (prompt + output) for future prefixes;
            # adapter KV must not match base requests.
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
        # Re-queued: join accounting restarts here.
        req.enqueue_step = self.metrics["steps"]
        req.blocked_steps = 0
        req.t_enqueue = time.perf_counter()
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
