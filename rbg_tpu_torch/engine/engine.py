"""Serving engine: continuous batching over a paged KV pool
(``rbg_tpu/engine/engine.py``).

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

A PD role changes two things (``engine/pd.py`` drives them): in
``prefill`` mode a finished request stays ``exported`` with its pages held
until the prefill worker has copied them out and calls
``release_request``; a prefill worker may admit a request whose prefix KV
came from the shared pool (``add_request_with_prefix``). A decode worker
imports KV and appends running rows itself; tokens it emits outside
``step()`` (the layer-sliced first step) wait in ``_deferred_events`` and
come out first from the next ``step()``.

Grammar-constrained rows (``json_mode`` / ``regex`` / ``json_schema``,
after ``enable_json_grammar``) mask their logits before sampling. A
finite-state grammar within ``grammar_state_budget`` compiles to device
tables (``next_state`` / ``legal`` [S, V]) and its rows decode inside the
fused window, the state advanced on the device; the pushdown JSON
grammar, a grammar over the budget and ``grammar_table="off"`` take a
host-masked verify with no drafts (K = 0) instead. The unified and split
prefill steps mask on the host: they fetch every token anyway.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rbg_tpu_torch.engine.config import (EngineConfig, SamplingParams,
                                         resolve_device)
from rbg_tpu_torch.engine.grammar import (JsonGrammar, JsonSchemaGrammar,
                                          NfaGrammar, RegexGrammar,
                                          TokenGrammar, TokenTrie,
                                          compile_token_table,
                                          token_bytes_for)
from rbg_tpu_torch.engine.kvcache import (PageAllocator, PagedKVCache,
                                          pages_for_tokens)
from rbg_tpu_torch.engine.radix_cache import RadixCache
from rbg_tpu_torch.engine.sampler import NEG_INF, row_keys, sample
from rbg_tpu_torch.engine.spec import NGramIndex
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged, init_params
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY


@dataclasses.dataclass
class StepEvent:
    request_id: int
    token: int
    finished: bool
    logprob: Optional[float] = None


class Request:
    _ids = itertools.count()

    def __init__(self, prompt: List[int], sampling: SamplingParams):
        # Ids follow submission order. The scheduler orders rows by id, not
        # by t_submit, so the ranks of a mesh, making the same calls, agree.
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
        self.gstate = None                        # grammar state (host)
        self.grammar = None                       # this request's TokenGrammar
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
                 device=None, mesh=None, sliced: bool = False):
        """``mesh`` (``parallel.make_mesh`` in every rank) serves the model
        tensor-parallel, SPMD: every rank builds this engine and makes the
        same calls with the same inputs. Each rank keeps its slices of the
        weights and its share of the pools (``_shard_state``), and every
        forward runs its own heads with ``ModelParallel``; the logits are
        gathered whole, so every rank samples the same tokens and its host
        state stays in step. ``sliced``: ``params`` already hold this rank's
        slices (a PD pair's decode worker takes its prefill worker's)."""
        cfg.validate()
        self.cfg = cfg
        self.mcfg = cfg.model_config
        self.device = resolve_device(device if device is not None else cfg.device)
        self.mesh = mesh
        self.par = None
        self.tp = 1
        if mesh is not None:
            self._check_mesh(mesh)
            from rbg_tpu_torch.parallel.sharding import ModelParallel
            self.par = ModelParallel.of(mesh)
            self.tp = self.par.tp if self.par is not None else 1
        if params is None and cfg.checkpoint_path:
            from rbg_tpu_torch.models.checkpoint import load_params
            # Under a mesh that splits weights each rank reads only its
            # slices, from the mapped file straight to its device.
            params = load_params(cfg.checkpoint_path, self.mcfg, device=self.device,
                                 mesh=mesh if self.par else None)
            if params["embed"].dtype != self.mcfg.torch_dtype:
                raise TypeError(f"checkpoint {cfg.checkpoint_path} holds "
                                f"{params['embed'].dtype} weights; {self.mcfg.name} "
                                f"serves {self.mcfg.torch_dtype}")
            params = self._shard_state(params, sliced=self.par is not None)
        elif params is None:
            params = init_params(self.mcfg, cfg.seed, self.device,
                                 mesh=mesh if self.par else None)
        else:
            params = self._shard_state(params, sliced)
        self.params = params
        # A request without a seed samples with fold_in(key(this), its id),
        # as the reference does.
        self._sample_base = cfg.seed + 1
        self.cache = PagedKVCache.create(self.mcfg, cfg.num_pages,
                                         cfg.page_size, device=self.device,
                                         quantize=(cfg.kv_dtype == "int8"),
                                         tp=self.tp)
        self.allocator = PageAllocator(cfg.num_pages)
        self.radix = (RadixCache(self.allocator, cfg.page_size)
                      if cfg.enable_radix_cache else None)
        # Host-DRAM spill tier under the device pool (engine/kvtier.py):
        # radix evictions spill into it, admission promotes out of it. Under
        # tp each rank spills and promotes its own KV heads, so its tier is
        # charged 1/heads_tp of the budget: the same pages stay resident,
        # spill and are evicted as in a tier of whole pages under the whole
        # budget, with no collective on the admission path.
        self.host_tier = None
        if cfg.host_tier_bytes and self.radix is not None \
                and not self.cache.quantized:
            from rbg_tpu_torch.engine.kvtier import HostKVTier
            self.host_tier = HostKVTier(cfg.page_size,
                                        cfg.host_tier_bytes // self.cache.heads_tp)
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
        # Grammar: the JSON grammar (enable_json_grammar), the tokenizer's
        # token bytes, EOS and trie, the per-pattern/schema LRU, and the
        # device tables of multi-grammar batches (_device_grammar_tables).
        self.grammar: Optional[TokenGrammar] = None
        self._token_bytes = None
        self._grammar_eos = None
        self._token_trie = None
        self._regex_grammars = collections.OrderedDict()
        self._gtable_dev = collections.OrderedDict()
        # Events emitted outside step() (a decode worker's layer-sliced
        # first step) come out first from the NEXT step(), in order.
        self._deferred_events: List[StepEvent] = []
        self.metrics = {"steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                        "radix_hit_tokens": 0, "host_hit_tokens": 0,
                        "preemptions": 0,
                        "unified_steps": 0, "decode_windows": 0, "joins": 0,
                        "join_wait_steps_max": 0, "join_excess_steps_max": 0,
                        "spec_drafted": 0, "spec_accepted": 0, "spec_steps": 0}

    # ---- tensor parallelism ----

    def _check_mesh(self, mesh) -> None:
        """Refuse, before any launch, a mesh this engine cannot serve on."""
        from rbg_tpu_torch.parallel.mesh import axis_size

        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve an engine "
                             f"on {self.device}")
        tp, ep, m = axis_size(mesh, "tp"), axis_size(mesh, "ep"), self.mcfg
        uneven = "ROADMAP.md queue 1 item 8: uneven tensor-parallel splits"
        for name, n in (("vocab_size", m.vocab_size), ("num_heads", m.num_heads),
                        ("num_kv_heads", 0 if m.mla else m.num_kv_heads)):
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {name}={n} ({uneven})")
        if m.num_experts % ep:
            raise ValueError(f"ep={ep} does not divide num_experts={m.num_experts} "
                             f"({uneven})")
        if ep > 1 and not m.num_experts:
            raise ValueError(f"ep={ep} on {m.name}, a dense model: an ep axis "
                             "splits experts, and this model has none")

    def _shard_state(self, params: dict, sliced: bool = False) -> dict:
        """This rank's weights (the reference's ``_shard_state``): a whole
        tree's slices by ``param_specs``, as copies on the engine's device
        that own their memory (the caller's whole tensors may be freed);
        with ``sliced``, a tree that already holds this rank's slices, as
        it is. The pools are made at this rank's KV heads
        (``PagedKVCache.create`` with tp)."""
        if self.par is not None and not sliced:
            from rbg_tpu_torch.parallel.sharding import param_specs, shard_pytree

            def own(t):
                return torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
            local = shard_pytree(params, param_specs(self.mcfg, params), self.mesh)
            return {k: ({n: own(w) for n, w in v.items()} if k == "blocks" else own(v))
                    for k, v in local.items()}
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        return params

    def local_heads(self, host: np.ndarray) -> np.ndarray:
        """This rank's KV heads of host pages [..., KV, hd] that carry every
        head (a view)."""
        if self.cache.heads_tp == 1:
            return host
        return host[..., self.par.tp_slice(host.shape[-2]), :]

    def whole_heads(self, pages: torch.Tensor) -> torch.Tensor:
        """Device pages [L, n, page, KV / tp, hd] of this rank with every
        rank's heads joined (an all-gather over tp, so every rank calls it
        at the same point); an MLA latent pool's pages as they are."""
        return pages if self.cache.heads_tp == 1 else self.par.gather_tp(pages, 3)

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
        self._check_prompt(prompt)
        self._grammar_check(sampling)
        if len(prompt) + sampling.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens {len(prompt)}+{sampling.max_new_tokens} "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        req = Request(prompt, sampling)
        req.lora_idx = self._resolve_lora(sampling)
        req.enqueue_step = self.metrics["steps"]
        g = self._grammar_for(sampling)
        if g is not None:
            req.grammar = g
            req.gstate = g.initial()
        self.requests[req.id] = req
        self.waiting.append(req)
        return req.id

    def add_request_with_prefix(self, prompt: List[int],
                                sampling: Optional[SamplingParams],
                                prefix_len: int,
                                k_data, v_data) -> Optional[int]:
        """Admit a request whose first ``prefix_len`` tokens' KV arrives
        precomputed (host pages fetched from the shared KV pool, ``[L,
        n_pages, page, KV, hd]`` numpy, bfloat16 as int16 bits): the pages
        are copied into this engine's pools in place and prefill resumes at
        ``prefix_len``. ``prefix_len`` must be page-aligned and <
        len(prompt) (the last token always prefills, for its logits).
        Returns None when no pages are free (the caller falls back to a
        cold prefill through the normal admission queue)."""
        from rbg_tpu_torch.engine.kvtier import _to_device

        sampling = sampling or SamplingParams()
        self._check_prompt(prompt)
        self._grammar_check(sampling)
        lora_idx = self._resolve_lora(sampling)  # before alloc: no page leak
        ps = self.cfg.page_size
        if prefix_len % ps or not 0 < prefix_len < len(prompt):
            raise ValueError(f"prefix_len {prefix_len} must be page-aligned "
                             f"and in (0, {len(prompt)})")
        if len(prompt) + sampling.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError("prompt+max_new_tokens exceeds max_seq_len")
        n_prefix = prefix_len // ps
        c = self.cache
        for name, data, pool in (("k", k_data, c.k_pages), ("v", v_data, c.v_pages)):
            want = (pool.shape[0], n_prefix) + c.whole_page_shape(pool)
            if (tuple(data.shape) != want
                    or data.dtype.itemsize != pool.element_size()):
                # Foreign pool data (a replica of another model geometry
                # sharing the pool): refused before any page is taken.
                raise ValueError(
                    f"prefix KV rejected: {name} pages {tuple(data.shape)} "
                    f"{data.dtype} do not fit the pool's {want} {pool.dtype}")
        need = pages_for_tokens(len(prompt) + 1, ps)
        pages = self._alloc(need)
        if pages is None:
            return None
        ids = torch.tensor(pages[:n_prefix], dtype=torch.long, device=self.device)
        for data, pool in ((k_data, c.k_pages), (v_data, c.v_pages)):
            pool.index_copy_(1, ids, _to_device(
                np.ascontiguousarray(self.local_heads(data)), pool))
        req = Request(prompt, sampling)
        req.lora_idx = lora_idx
        g = self._grammar_for(sampling)
        if g is not None:
            req.grammar = g
            req.gstate = g.initial()
        req.pages = pages
        req.prefill_pos = prefix_len
        req.seq_len = prefix_len
        req.state = "prefill"
        self.requests[req.id] = req
        self.running.append(req)
        self.metrics["pool_hit_tokens"] = (
            self.metrics.get("pool_hit_tokens", 0) + prefix_len)
        return req.id

    def prefix_peek(self, prompt: List[int]) -> int:
        """Prefix-hit depth (device radix + host tier) this prompt would
        get at admission. Read from submitter threads by the TTFT predictor
        while the loop thread owns the trie: a stale or zero answer only
        skews one prediction."""
        if self.radix is None or len(prompt) < 2:
            return 0
        try:
            m = self.radix.peek(prompt[:-1])
            if self.host_tier is not None:
                m += self.host_tier.peek(prompt[:-1], m)
            return m
        except Exception:  # noqa: BLE001 — racy read, degrade to a miss
            return 0

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self) -> List[StepEvent]:
        """One scheduler iteration: admit, then the ragged unified step while
        any row prefills (``_unified_eligible``), else the split paths:
        the batched prefill step, then the decode step. Events deferred
        since the last call come out first."""
        events, self._deferred_events = self._deferred_events, []
        self.metrics["steps"] += 1
        self._admit()
        if self._unified_eligible():
            self.metrics["unified_steps"] += 1
            events += self._unified_step()
        else:
            events += self._prefill_step() + self._decode_step()
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
        for tgt, (A, B) in adapter.items():
            if tgt not in allowed:
                raise ValueError(
                    f"adapter {name!r}: unsupported target {tgt!r} "
                    f"(supported here: {sorted(allowed)})")
            if A.shape[0] != L or B.shape[0] != L or A.shape[2] != B.shape[1]:
                raise ValueError(
                    f"adapter {name!r} target {tgt!r}: bad shapes "
                    f"{tuple(A.shape)} / {tuple(B.shape)}")
            d_in, d_out = self._whole_dims(tgt)
            if A.shape[1] != d_in or B.shape[2] != d_out:
                raise ValueError(
                    f"adapter {name!r} target {tgt!r}: dims {A.shape[1]}→"
                    f"{B.shape[2]} do not match base weight "
                    f"{d_in}→{d_out} (wrong base model?)")
        # Registered only after the stack is built: a name resolving past
        # the stack would serve another adapter's rows.
        self._lora_raw.append((adapter, float(alpha)))
        try:
            self._rebuild_lora_stack()
        except Exception:
            self._lora_raw.pop()
            raise
        self._lora_slots[name] = len(self._lora_raw)

    def _whole_dims(self, tgt: str) -> Tuple[int, int]:
        """(d_in, d_out) of base weight ``tgt`` in the whole model (a rank
        holds a slice of it under tensor parallelism)."""
        w = self.params["blocks"][tgt]
        f = (1, 1, 1)
        if self.mesh is not None:
            from rbg_tpu_torch.parallel.sharding import param_specs, split_factor
            f = split_factor(param_specs(self.mcfg)["blocks"][tgt], self.mesh)
        return w.shape[1] * f[1], w.shape[2] * f[2]

    def _rebuild_lora_stack(self) -> None:
        """{target: (A [L, n, d_in, rmax], B [L, n, rmax, d_out])} in the
        model dtype: rank-padded, alpha/r of THAT target folded into B in
        float32 before the cast, slot 0 zeros (no adapter). Under a mesh
        each rank keeps its share (``lora_specs``): B's columns of a column
        target, A's rows of a row target.

        Nothing in flight is dropped: a pending decode window keeps its
        rows' slots (new adapters take new slots) and each forward reads
        the stack when it runs, so the window's tokens are emitted by the
        next step as always."""
        L = self.mcfg.num_layers
        n = len(self._lora_raw) + 1
        targets = sorted({t for ad, _ in self._lora_raw for t in ad})
        rmax = max(A.shape[2] for ad, _ in self._lora_raw for A, _B in ad.values())
        specs = None
        if self.mesh is not None:
            from rbg_tpu_torch.parallel.sharding import local_shard, lora_specs
            specs = lora_specs(targets)
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
            A_t, B_t = torch.from_numpy(As), torch.from_numpy(Bs)
            if specs is not None:
                A_t = local_shard(A_t, specs[tgt][0], self.mesh)
                B_t = local_shard(B_t, specs[tgt][1], self.mesh)
            stack[tgt] = (A_t.to(self.device, dt).contiguous(),
                          B_t.to(self.device, dt).contiguous())
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

    # ---- grammar-constrained decoding ----

    _REGEX_GRAMMAR_CACHE = 64
    # Multi-grammar combinations held on the device: each entry duplicates
    # its grammars' blocks, so only the current one and one predecessor.
    _GTABLE_DEV_CACHE = 2

    def enable_json_grammar(self, tokenizer) -> None:
        """Wire grammar-constrained decoding (json_mode, regex and
        json_schema requests) to a tokenizer's token→bytes table. Without
        it a constrained request is refused at admission."""
        self._token_bytes = token_bytes_for(tokenizer)
        self._grammar_eos = tokenizer.eos_id
        # One trie per tokenizer, shared by the JSON grammar and every
        # cached regex / schema grammar (it depends only on the vocab).
        self._token_trie = TokenTrie(self._token_bytes)
        self.grammar = TokenGrammar(JsonGrammar(), self._token_bytes,
                                    self._grammar_eos, trie=self._token_trie)
        self._regex_grammars = collections.OrderedDict()
        self._gtable_dev = collections.OrderedDict()

    def _regex_grammar(self, pattern: str) -> TokenGrammar:
        return self._compiled_grammar(("re", pattern))

    def _compiled_grammar(self, key, schema: Optional[dict] = None) -> TokenGrammar:
        """The compiled TokenGrammar of a pattern (``("re", pattern)``) or
        schema (``("schema", json.dumps(schema))``), LRU-bounded: repeat
        constraints pay compilation once. Device blocks hang off the
        grammar object, so they go when the LRU drops it. Raises
        ValueError on an unsupported construct (an admission error)."""
        tg = self._regex_grammars.get(key)
        if tg is not None:
            self._regex_grammars.move_to_end(key)
            return tg
        byte_grammar = (RegexGrammar(key[1]) if key[0] == "re"
                        else JsonSchemaGrammar(schema))
        tg = TokenGrammar(byte_grammar, self._token_bytes, self._grammar_eos,
                          trie=self._token_trie)
        if len(self._regex_grammars) >= self._REGEX_GRAMMAR_CACHE:
            self._regex_grammars.popitem(last=False)
        self._regex_grammars[key] = tg
        return tg

    def _grammar_for(self, sampling: SamplingParams) -> Optional[TokenGrammar]:
        if sampling.json_mode:
            return self.grammar
        if sampling.regex is not None:
            return self._regex_grammar(sampling.regex)
        if sampling.json_schema is not None:
            if not sampling.json_schema:
                return self.grammar     # {} = any JSON
            # Property order is kept in the key: properties are emitted in
            # declaration order, so reordered schemas are other grammars.
            key = ("schema", json.dumps(sampling.json_schema))
            return self._compiled_grammar(key, sampling.json_schema)
        return None

    def _grammar_check(self, sampling: SamplingParams) -> None:
        constrained = (sampling.json_mode or sampling.regex is not None
                       or sampling.json_schema is not None)
        if constrained and self.grammar is None:
            raise ValueError(
                "json_mode/regex/json_schema require a grammar table — the "
                "server wires it from the tokenizer (enable_json_grammar)")
        if constrained:
            self._grammar_for(sampling)     # a bad pattern fails admission

    def _gmask(self, grammar: TokenGrammar, state) -> np.ndarray:
        """The grammar's mask padded to the MODEL vocab: ids past the
        tokenizer's vocab are never legal constrained output."""
        V = self.mcfg.vocab_size
        m = grammar.mask(state)
        if len(m) == V:
            return m
        out = np.zeros(V, bool)
        out[:min(len(m), V)] = m[:V]
        return out

    def _grammar_table(self, tg: TokenGrammar):
        """The host GrammarTable of a grammar, or None when its rows take
        the host-masked verify (tables off, the pushdown JSON grammar, or
        the state budget exceeded). The compile, and a budget failure, is
        cached on the grammar object."""
        if self.cfg.grammar_table == "off" or not isinstance(tg.grammar, NfaGrammar):
            return None
        budget = self.cfg.grammar_state_budget
        cached = getattr(tg, "_table_cache", None)
        if cached is not None and cached[0] == budget:
            return cached[1]
        table = compile_token_table(tg, budget, self.mcfg.vocab_size)
        tg._table_cache = (budget, table)
        return table

    def _row_fusable(self, r: Request) -> bool:
        """True when the row decodes inside the fused window: no grammar,
        or a grammar with a device table."""
        return r.grammar is None or self._grammar_table(r.grammar) is not None

    def _grammar_dev_block(self, tg: TokenGrammar):
        """A grammar's tables on the device: next_state [S, V] int32 (-1 =
        illegal) and legal [S, V] bool, S the table's states padded to a
        power of 2 (padding rows unreachable), so similar grammars share
        shapes without a budget-sized block each. One upload per grammar,
        cached on it."""
        budget = self.cfg.grammar_state_budget
        cached = getattr(tg, "_dev_block", None)
        if cached is not None and cached[0] == budget:
            return cached[1], cached[2]
        t = self._grammar_table(tg)
        V = self.mcfg.vocab_size
        S = 1
        while S < t.num_states:
            S *= 2
        nxt = np.full((S, V), -1, np.int32)
        leg = np.zeros((S, V), bool)
        nxt[:t.num_states] = t.next_state
        leg[:t.num_states] = t.legal
        nxt_dev = torch.from_numpy(nxt).to(self.device)
        leg_dev = torch.from_numpy(leg).to(self.device)
        tg._dev_block = (budget, nxt_dev, leg_dev)
        return nxt_dev, leg_dev

    def _device_grammar_tables(self, grammars):
        """(next_state [S, V], legal [S, V], offsets) for a batch's
        grammars: one grammar's own block as it is, several concatenated
        on the device with per-grammar state offsets (a row's device state
        = offset + its table's state id). Combinations sit in a shallow
        LRU holding the grammars, so the id() keys stay valid."""
        uniq = list({id(g): g for g in grammars}.values())
        if len(uniq) == 1:
            nxt, leg = self._grammar_dev_block(uniq[0])
            return nxt, leg, {id(uniq[0]): 0}
        key = tuple(sorted(id(g) for g in uniq))
        hit = self._gtable_dev.get(key)
        if hit is not None:
            self._gtable_dev.move_to_end(key)
            return hit[0], hit[1], hit[2]
        offsets: Dict[int, int] = {}
        nexts, legals = [], []
        off = 0
        for g in uniq:
            nxt, leg = self._grammar_dev_block(g)
            offsets[id(g)] = off
            nexts.append(torch.where(nxt >= 0, nxt + off, -1))
            legals.append(leg)
            off += nxt.shape[0]
        entry = (torch.cat(nexts), torch.cat(legals), offsets, uniq)
        self._gtable_dev[key] = entry
        if len(self._gtable_dev) > self._GTABLE_DEV_CACHE:
            self._gtable_dev.popitem(last=False)
        return entry[0], entry[1], entry[2]

    def grammar_table_bytes(self) -> int:
        """Device bytes held by grammar tables: the blocks of the grammars
        in the LRU plus the cached multi-grammar combinations."""
        held = [getattr(tg, "_dev_block", None)
                for tg in self._regex_grammars.values()]
        tensors = [t for b in held if b is not None for t in b[1:]]
        tensors += [t for e in self._gtable_dev.values() for t in e[:2]]
        return sum(t.numel() * t.element_size() for t in tensors)

    def _grammar_masked(self, logits: torch.Tensor, reqs: List[Request]):
        """Host-masked logits [B, V] for the rows of ``reqs`` (row n of
        ``logits`` is reqs[n]; pad rows stay as they are): each grammar
        row keeps only its state's legal tokens."""
        if not any(r.gstate is not None for r in reqs):
            return logits
        gm = np.ones(tuple(logits.shape), bool)
        for n, req in enumerate(reqs):
            if req.gstate is not None:
                gm[n] = self._gmask(req.grammar, req.gstate)
        return torch.where(torch.from_numpy(gm).to(logits.device), logits,
                           NEG_INF)

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
            radix_matched = host_matched = 0
            if (self.radix is not None and req.state == "waiting"
                    and req.lora_idx == 0):
                # Keep at least the prompt's last token for prefill (logits).
                # Adapter requests skip the cache (and the host tier): their
                # KV is not the base model's for the same tokens.
                matched, shared_pages = self.radix.match(req.prompt[:-1])
                radix_matched = matched
                if self.host_tier is not None:
                    matched, shared_pages = self._promote_host(
                        req, matched, shared_pages)
                    host_matched = matched - radix_matched
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
            req.pages = shared_pages + pages
            req.prefill_pos = matched
            req.seq_len = matched
            req.state = "prefill"
            self.running.append(req)
            # Hit accounting on admission success only, the two tiers'
            # counters summing to the request's hit: a promotion whose
            # request then fails its remaining alloc counts nothing (the
            # promoted pages entered the radix, so the retry's match
            # re-finds them), and a blocked request re-attempting every
            # step must not inflate the tier counters.
            self.metrics["radix_hit_tokens"] += radix_matched
            self.metrics["host_hit_tokens"] += host_matched
            if self.host_tier is not None and req.lora_idx == 0:
                if host_matched:
                    REGISTRY.inc(obs_names.KVC_TIER_HITS_TOTAL, tier="host")
                elif radix_matched:
                    REGISTRY.inc(obs_names.KVC_TIER_HITS_TOTAL,
                                 tier="device")
                else:
                    REGISTRY.inc(obs_names.KVC_TIER_MISSES_TOTAL)
        if blocked:
            # Every request still waiting sat this step out for capacity.
            for r in self.waiting:
                r.blocked_steps += 1

    def _promote_host(self, req: Request, matched: int,
                      shared_pages: List[int]):
        """Extend a radix hit from the host spill tier: promoted pages
        move onto freshly allocated device pages and enter the radix
        cache, so this request — and every later one — device-hits them.
        Token accounting is the caller's, on admission success only."""
        h_tokens, h_pages, self.cache = self.host_tier.promote_to_device(
            req.prompt[:-1], matched, self._alloc, self.cache,
            release_fn=self.allocator.release)
        if h_tokens:
            # The radix insert takes the cache's own reference on the
            # promoted pages (share()); the request's ref stays separate,
            # exactly like a radix hit.
            self.radix.insert(req.prompt[:matched + h_tokens],
                              shared_pages + h_pages)
            shared_pages = shared_pages + h_pages
            matched += h_tokens
        self._publish_tier_gauges()
        return matched, shared_pages

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n <= 0:
            return []
        pages = self.allocator.alloc(n)
        if pages is None and self.radix is not None:
            self.radix.evict(
                n - self.allocator.free_pages,
                on_evict=(self._spill_evicted if self.host_tier is not None
                          else None))
            pages = self.allocator.alloc(n)
            if self.host_tier is not None:
                self._publish_tier_gauges()
        return pages

    def _spill_evicted(self, prefix_tokens: List[int],
                       page_ids: List[int]) -> None:
        """Radix eviction hook: copy the evicted leaf's device pages into
        the host tier BEFORE their allocator release (device contents are
        still valid here; ids may recycle right after).

        Pages a RUNNING request still pins (refcount > 1: the cache's ref
        plus the request's) are NOT spilled: they stay device-resident and
        re-enter the radix when that request finishes — a copy would leave
        the same content resident in both tiers. A request's match/share
        always takes a PREFIX of a node's pages, so the pinned region is a
        prefix of ``page_ids`` and the free tail is contiguous. A pending
        decode window writes only its rows' own pages, never a radix page
        at refcount 1, and the tier's gather runs on the engine's stream,
        after that window's kernels."""
        k = 0
        while k < len(page_ids) \
                and self.allocator.refcount(page_ids[k]) > 1:
            k += 1
        if k == len(page_ids):
            return
        self.host_tier.spill_from_device(prefix_tokens, page_ids[k:],
                                         self.cache)

    def _publish_tier_gauges(self) -> None:
        if self.radix is None or self.host_tier is None:
            return
        pages = self.radix.cached_pages
        c = self.cache
        per_page = ((c.k_pages.nbytes + c.v_pages.nbytes)
                    / max(1, c.k_pages.shape[1]))
        REGISTRY.set_gauge(obs_names.KVC_TIER_PAGES, float(pages),
                           tier="device")
        REGISTRY.set_gauge(obs_names.KVC_TIER_BYTES,
                           float(pages * per_page), tier="device")

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
        for req in sorted(rows, key=lambda r: r.id):
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
            k_scales=self.cache.k_scales, v_scales=self.cache.v_scales,
            par=self.par)

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
        # Grammar rows mask on the host (this step fetches every token
        # anyway), before the penalties inside the sampler.
        sel = self._grammar_masked(logits[0, idx], reqs)
        toks, lps = self._sample(sel, rows, torch.from_numpy(key_pos).to(dev),
                                 out_counts)
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
        # The first output token already obeys the grammar.
        sel = self._grammar_masked(logits[row_idx, tok_idx], reqs)
        toks, lps = self._sample(sel, srows, torch.from_numpy(key_pos).to(dev),
                                 out_counts)
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
            v_scales=self.cache.v_scales, par=self.par, **self._lora_kw(lids))

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
        already spent by pending tokens can only finish. Table-less grammar
        rows take the host-masked verify instead (``_decode_step``), except
        in speculative mode, where the verify owns every row."""
        pend = self._pending_counts()
        spec = self.cfg.speculative == "ngram"
        return [r for r in self.running
                if r.state == "running"
                and (spec or r.gstate is None or self._row_fusable(r))
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
        if any(r.gstate is not None for r in batch):
            # Grammar rows: each row's state id into the batch's stacked
            # tables. Rebuilt from req.gstate, which _emit advances token
            # by token: every state it reaches is in the table.
            gnext, glegal, offsets = self._device_grammar_tables(
                [r.grammar for r in batch if r.gstate is not None])
            gstate = np.zeros(B, np.int64)
            gactive = np.zeros(B, bool)
            for i, r in enumerate(batch):
                if r.gstate is not None:
                    t = self._grammar_table(r.grammar)
                    gstate[i] = offsets[id(r.grammar)] + t.state_ids[r.gstate]
                    gactive[i] = True
            st.update(gnext=gnext, glegal=glegal,
                      gstate=torch.from_numpy(gstate).to(dev),
                      gactive=torch.from_numpy(gactive).to(dev))
        return st

    def _run_window(self, st: dict, K: int):
        """K decode steps on the device, each = forward + sampling +
        position/length advance, the sampled token fed straight back. Rows
        at their length limit stop writing KV and stop advancing; their
        samples are discarded host-side. Keys are (row key, OUTPUT position
        pos + 1). Grammar rows mask with their state's legal row before
        sampling (penalties come after, inside the sampler) and move to
        ``next_state[state, token]``, all on the device; a -1 transition
        keeps the state, as ``_emit`` does. Returns (tokens [K, B],
        logprobs [K, B] or None)."""
        rows = st["sampling"]
        tok, pos, kvl = st["tok"], st["pos"], st["kvl"]
        gs = st.get("gstate")
        toks_seq, lps_seq = [], []
        for _ in range(K):
            write_ok = st["mask"] & (pos < st["limit"])[:, None]     # [B, 1]
            logits = forward_paged(
                self.params, self.mcfg, tok[:, None], pos[:, None], write_ok,
                kvl, st["table"], self.cache.k_pages, self.cache.v_pages,
                k_scales=self.cache.k_scales, v_scales=self.cache.v_scales,
                par=self.par, **self._lora_kw(st["lids"]))
            lg = logits[:, 0]
            if gs is not None:
                lg = torch.where(st["glegal"][gs] | ~st["gactive"][:, None],
                                 lg, NEG_INF)
            toks, lps = self._sample(lg, rows, pos + 1, st.get("ocounts"))
            active = write_ok[:, 0]
            if rows["pen"]:
                st["ocounts"][torch.arange(st["B"], device=self.device),
                              toks] += active.long()
            if gs is not None:
                ns = st["gnext"][gs, toks]
                gs = torch.where(st["gactive"] & active & (ns >= 0), ns, gs)
            pos = torch.where(active, pos + 1, pos)
            kvl = torch.where(active, kvl + 1, kvl)
            tok = torch.where(active, toks, tok)
            toks_seq.append(toks)
            if lps is not None:
                lps_seq.append(lps)
        st["tok"], st["pos"], st["kvl"] = tok, pos, kvl
        if gs is not None:
            st["gstate"] = gs
        return (torch.stack(toks_seq),
                torch.stack(lps_seq) if lps_seq else None)

    def _decode_step(self) -> List[StepEvent]:
        if self.cfg.speculative == "ngram":
            return self._drain_decode() + self._spec_decode_step()
        if any(r.gstate is not None and not self._row_fusable(r)
               for r in self.running if r.state == "running"):
            # Only table-less grammar rows pay the host-masked verify; the
            # rest, tabled grammar rows too, keep the fused window (whose
            # _decode_batch leaves those rows out).
            events = self._spec_decode_step(grammar_only=True)
            return events + self._fused_decode_step()
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
        for req in sorted(batch, key=lambda r: r.id):
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

    def _spec_decode_step(self, grammar_only: bool = False) -> List[StepEvent]:
        """Draft up to spec_k tokens per row from its n-gram index, run one
        (B, spec_k + 1) ``forward_paged`` over [last token, drafts], sample
        every position t with the key of position pos_t + 1 (the keys the
        sequential path uses), and accept drafts while they equal the
        samples; the sample at the first mismatch (or after the last draft)
        is the next token. Penalized rows never draft (their counts change
        token by token). KV written for rejected drafts lies past the new
        seq_len and is overwritten later.

        Grammar rows walk their drafts along the automaton, cut at the
        first illegal one, and mask position t with the state after the
        first t drafts: exact for every accepted prefix. ``grammar_only``
        (not speculative) verifies just the table-less grammar rows, with
        no drafts (K = 0)."""
        events: List[StepEvent] = []
        batch = [r for r in self.running if r.state == "running"
                 and (not grammar_only
                      or (r.gstate is not None and not self._row_fusable(r)))
                 and len(r.output) < r.sampling.max_new_tokens]
        if not batch:
            return events
        K = self.cfg.spec_k if self.cfg.speculative == "ngram" else 0
        ps = self.cfg.page_size
        drafts: Dict[int, List[int]] = {}
        gmask_rows: Dict[int, List[np.ndarray]] = {}
        # Oldest first: a row sheds its drafts before it preempts the
        # youngest for pages.
        for req in sorted(batch, key=lambda r: r.id):
            if req.state != "running":
                continue
            cap = min(K, req.sampling.max_new_tokens - len(req.output) - 1,
                      self.cfg.max_seq_len - req.seq_len - 1)
            d: List[int] = []
            if cap > 0 and not req.sampling.needs_penalties():
                self._ensure_ngram(req)
                d = req.ngram.draft(cap)
            if req.gstate is not None:
                g, gs = req.grammar, req.gstate
                masks = [self._gmask(g, gs)]
                kept = []
                for dt in d:
                    gs = g.advance_token(gs, dt)
                    if gs is None:
                        break           # the draft leaves the grammar
                    kept.append(dt)
                    masks.append(self._gmask(g, gs))
                d = kept
                gmask_rows[id(req)] = masks
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
        lg = logits.transpose(0, 1).reshape(T * B, -1)
        if gmask_rows:
            # Masks along each row's draft path: [T, B, V] → the sampler's
            # position-major rows. A dropped draft's slots are never read.
            gm = np.ones((T, B, self.mcfg.vocab_size), bool)
            for i, r in enumerate(batch):
                for t, m in enumerate(gmask_rows.get(id(r), ())):
                    gm[t, i] = m
            lg = torch.where(torch.from_numpy(gm.reshape(T * B, -1)).to(
                self.device), lg, NEG_INF)
        toks, lps = self._sample(lg, tiled,
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
        if req.gstate is not None:
            nxt = req.grammar.advance_token(req.gstate, tok)
            if nxt is not None:     # EOS keeps the state
                req.gstate = nxt
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
        if self.cfg.mode == "prefill":
            # Disaggregated prefill: the pages ARE the product — the PD layer
            # exports them to a decode peer, then calls release_request().
            req.state = "exported"
            return
        if self.radix is not None and req.lora_idx == 0:
            # Cache the full sequence (prompt + output) for future prefixes;
            # adapter KV must not match base requests.
            self.radix.insert(req.prompt + req.output[:-1], req.pages)
            if self.host_tier is not None:
                self._publish_tier_gauges()
        self.allocator.release(req.pages)
        req.pages = []
        self.requests.pop(req.id, None)

    def release_request(self, req_id: int):
        """Release an exported request's pages (prefill mode)."""
        req = self.requests.pop(req_id)
        if req.pages:
            self.allocator.release(req.pages)
            req.pages = []

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
        victim = max(candidates, key=lambda r: r.id)
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
