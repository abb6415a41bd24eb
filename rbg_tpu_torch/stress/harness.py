"""Serving-plane stress drills (``rbg_tpu/stress/harness.py``): the
scenarios that drive the engine, the KV transfer plane and the chaos plane
and build no control plane. Names, report keys and invariants are the
reference's.

* ``overload``: over-demand against one ``EngineService``; it must shed,
  bound its queue, account every request, admit continuously and judge
  every finished request against its SLO once.
* ``kvstream``: a ``PDStreamPair`` streams chunked KV over a slow, lossy,
  reordering link with one stream cut; decode must start before each
  stream closes, the prefix directory must agree with the pool, and every
  output must equal a unified engine's.
* ``prefixcache``: an undersized device pool over the host KV tier, then
  a burst against the early-rejection gate; the tiers must account every
  page once, rejected requests must spend no prefill, and every output
  must equal a cold engine's.
* ``partition``: the chaos plane's corruption leg (bytes flipped under a
  PD pair, caught at commit and replayed token-exactly), directory leg
  (the directory wire partitions, the client's breaker degrades and
  recovers) and peer-staleness leg (a router-tier member goes silent and
  comes back). The reference's fourth leg, the leader lease, belongs to
  the control plane, which this package does not carry: its
  ``leader_self_demoted_before_ttl`` and ``recovery_bounded_lease`` are
  not reported, and ``all_faults_counted`` counts the kinds the three
  legs inject (partition, corrupt, brownout; no skew).

Every ``run_*`` takes ``params`` (a weights tree in the port's layout,
shared by every engine the drill builds; ``None`` initialises the
model's from seed 0) and ``device`` (``None`` is the card, and raises
without one). On the card the drills launch the attention kernels; on
the CPU the kernels' plain versions run. kvstream, prefixcache and
partition compare greedy tokens bit for bit across batches, chunkings, PD
and tier hits, so their engines serve batch-invariant
(``EngineConfig.batch_invariant``, ``ops/rows.py``: without it a bf16
model's tokens on the card depend on the requests beside them); overload
drives the default forwards.

    python -m rbg_tpu_torch.stress.harness --scenario overload --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from rbg_tpu_torch.obs import names as metric_names
from rbg_tpu_torch.obs.metrics import REGISTRY

SCENARIOS = ("overload", "kvstream", "prefixcache", "partition")


def _pcts(samples: List[float]) -> Dict[str, float]:
    if not samples:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "n": 0}
    s = sorted(samples)

    def pct(q):
        i = min(len(s) - 1, int(q * len(s)))
        return round(s[i] * 1000, 2)  # ms

    return {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "n": len(s), "max": round(s[-1] * 1000, 2)}


def _wait(fn, timeout_s: float, desc: str, interval: float = 0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(interval)
    raise TimeoutError(f"timed out waiting for {desc}")


def _unified_engine(params, device, **cfg):
    """An engine without the radix cache (the drills' reference outputs)
    and the weights every other engine of the drill shares."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine

    eng = Engine(EngineConfig(enable_radix_cache=False, **cfg), params=params,
                 device=device)
    return eng, eng.params


# ---- serving-plane overload scenario ---------------------------------------


@dataclasses.dataclass
class OverloadConfig:
    """Sustained over-demand against ONE in-process EngineService: more
    concurrent demand than its batch and queue hold, so the admission
    gates must shed."""

    clients: int = 6
    requests_per_client: int = 6
    max_queue: int = 4
    max_batch: int = 2
    max_new_tokens: int = 24
    prompt_len: int = 8
    timeout_s: float = 60.0        # per-request deadline budget
    model: str = "tiny"
    # Per-request prompt lengths cycle through this tuple, so prefill-heavy
    # and decode-heavy rows share steps and continuous admission is
    # exercised. A prompt_len other than its default with this left at its
    # default gives fixed-length prompts (__post_init__).
    mixed_prompt_lens: tuple = (4, 12, 24, 40)
    slo_ttft_s: float = 10.0
    slo_tpot_s: float = 1.0

    def __post_init__(self):
        fields = type(self).__dataclass_fields__
        if (self.prompt_len != fields["prompt_len"].default
                and self.mixed_prompt_lens
                == fields["mixed_prompt_lens"].default):
            self.mixed_prompt_lens = ()


def run_serving_overload(cfg: OverloadConfig, service=None, params=None,
                         device=None) -> dict:
    """Fire ``clients`` threads of back-to-back generates at an undersized
    service and report what the overload machinery did: admitted-request
    latency percentiles, shed and deadline counts, and the deepest queue
    observed."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, CODE_OVERLOADED,
                                               DeadlineExceeded, Overloaded)
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.obs import timeseries, trace

    own = service is None
    if own:
        service = EngineService(
            EngineConfig(model=cfg.model, page_size=8, num_pages=256,
                         max_batch=cfg.max_batch, max_seq_len=256,
                         prefill_chunk=16, decode_buckets=(cfg.max_batch,),
                         slo_ttft_s=cfg.slo_ttft_s, slo_tpot_s=cfg.slo_tpot_s),
            params=params, device=device, max_queue=cfg.max_queue)
    sampler = timeseries.ensure_started()
    totals_before = service.slo.totals()
    outcomes = {"ok": 0, CODE_OVERLOADED: 0, CODE_DEADLINE: 0, "error": 0}
    latencies: List[float] = []
    retry_hints: List[float] = []
    olock = threading.Lock()
    depth_max = [0]
    stop_probe = threading.Event()

    def probe_depth():
        while not stop_probe.is_set():
            with service._lock:
                d = len(service._queue)
            depth_max[0] = max(depth_max[0], d)
            time.sleep(0.002)

    def client(ci: int):
        sp = SamplingParams(max_new_tokens=cfg.max_new_tokens)
        for ri in range(cfg.requests_per_client):
            plen = (cfg.mixed_prompt_lens[(ci + ri) % len(cfg.mixed_prompt_lens)]
                    if cfg.mixed_prompt_lens else cfg.prompt_len)
            prompt = [(ci * 17 + ri * 5 + j) % 200 + 1 for j in range(plen)]
            t0 = time.monotonic()
            # The service's queue-wait and scan spans, and its rejections,
            # parent under this root.
            root = trace.start_trace(metric_names.SPAN_STRESS_REQUEST,
                                     client=ci, request=ri)
            try:
                service.submit_wait(prompt, sp, deadline=t0 + cfg.timeout_s,
                                    span=root)
            except Overloaded as e:
                root.end(outcome=CODE_OVERLOADED)
                with olock:
                    outcomes[CODE_OVERLOADED] += 1
                    if e.retry_after_s is not None:
                        retry_hints.append(e.retry_after_s)
                continue
            except DeadlineExceeded:
                root.end(outcome=CODE_DEADLINE)
                with olock:
                    outcomes[CODE_DEADLINE] += 1
                continue
            except Exception:  # noqa: BLE001 — account, don't crash
                root.end(outcome="error")
                with olock:
                    outcomes["error"] += 1
                continue
            root.end(outcome="ok")
            with olock:
                outcomes["ok"] += 1
                latencies.append(time.monotonic() - t0)

    prober = threading.Thread(target=probe_depth, daemon=True)
    prober.start()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(cfg.clients)]
    # Every request is deadline-bounded, so a client that outlives its
    # whole budget is wedged: all_accounted fails instead of the drill
    # hanging.
    client_budget_s = cfg.requests_per_client * cfg.timeout_s + 30.0
    try:
        for t in threads:
            t.start()
        join_deadline = time.monotonic() + client_budget_s
        for t in threads:
            t.join(timeout=max(0.1, join_deadline - time.monotonic()))
    finally:
        stop_probe.set()
        prober.join(timeout=5.0)
        if own:
            service.stop()
    stats = service.service_stats()
    total = cfg.clients * cfg.requests_per_client
    em = service.engine.metrics
    svc_label = type(service).__name__.lower()
    elapsed_s = time.perf_counter() - t_start
    sampler.sample_now()
    slo_snap = service.slo.snapshot(group_by=("role",))
    slo_deltas = {k: slo_snap["totals"][k] - totals_before[k]
                  for k in slo_snap["totals"]}
    judged = slo_deltas["judged"]
    throughput_rps = outcomes["ok"] / elapsed_s if elapsed_s else 0.0
    goodput_rps = slo_deltas["goodput"] / elapsed_s if elapsed_s else 0.0

    def _q(name, q):
        v = REGISTRY.quantile(name, q, service=svc_label)
        return round(v, 4) if v is not None else None

    return {
        "scenario": "overload",
        "config": dataclasses.asdict(cfg),
        "elapsed_s": round(elapsed_s, 3),
        "outcomes": outcomes,
        "admitted_latency_ms": _pcts(latencies),
        "retry_after_hint_s": (round(min(retry_hints), 3)
                               if retry_hints else None),
        "max_queue_depth_observed": depth_max[0],
        "service": stats,
        "continuous_batching": {
            "joins": em.get("joins", 0),
            "unified_steps": em.get("unified_steps", 0),
            "join_wait_steps_max": em.get("join_wait_steps_max", 0),
            "join_excess_steps_max": em.get("join_excess_steps_max", 0),
            "batch_occupancy_p50": _q(metric_names.SERVING_BATCH_OCCUPANCY, 0.5),
            "join_latency_p50_s": _q(metric_names.SERVING_JOIN_LATENCY_SECONDS, 0.5),
            "join_latency_p95_s": _q(metric_names.SERVING_JOIN_LATENCY_SECONDS, 0.95),
        },
        "slo": {
            "targets": slo_snap["targets"],
            "judged": judged,
            "verdicts": slo_deltas,
            "per_role_60s": slo_snap["windows"]["60s"],
        },
        "goodput_vs_throughput": {
            "throughput_rps": round(throughput_rps, 3),
            "goodput_rps": round(goodput_rps, 3),
            "goodput_fraction": (round(slo_deltas["goodput"] / judged, 4)
                                 if judged else None),
        },
        "invariants": {
            "queue_bounded": depth_max[0] <= cfg.max_queue,
            "all_accounted": sum(outcomes.values()) == total,
            "shed_instead_of_queued": (outcomes[CODE_OVERLOADED] == 0
                                       or stats["shed_total"] > 0),
            # No admitted request waited more than one step beyond page or
            # slot availability.
            "continuous_admission": em.get("join_excess_steps_max", 0) <= 1,
            # Every finished request was SLO-judged exactly once.
            "slo_accounted": judged == outcomes["ok"],
        },
    }


# ---- KV transfer plane scenario --------------------------------------------


@dataclasses.dataclass
class KVStreamConfig:
    """A PD pair streams chunked KV over a slow, lossy, reordering link,
    one stream cut mid-transfer:

    * ``kv_stream_overlap``: each row's first decode step lands before its
      stream's close frame (coverage-based admission);
    * ``directory_consistent``: no prefix-directory lookup returns an
      evicted prefix or an invalidated slice;
    * ``zero_dropped_streams``: the cut stream is retried token-exactly and
      every output equals a unified engine's.
    """

    requests: int = 6
    prompt_len: int = 48            # several pages at page_size 8
    max_new_tokens: int = 8
    slow_link_delay_s: float = 0.05  # per frame
    dup_rate: float = 0.25
    # Adjacent frames still swap at window 1; the window must stay smaller
    # than the chunks after the first token, or the FIN flush delivers the
    # whole tail and the close frame as one burst and no admission can
    # overlap it.
    reorder_window: int = 1
    truncate_nth_stream: int = 2    # this stream dies mid-transfer
    model: str = "tiny"
    # Layer-ordered chunks (layer_split) and admission at layer-k coverage
    # (admit_layers > 0; 0 = whole coverage).
    layer_split: int = 1
    admit_layers: int = 1
    # The inner link's pacing; without it the lossy wrapper's flushes
    # deliver the transfer tail as one burst.
    link_bytes_per_s: float = 2e5
    # The shared prefix store's byte budget (the reference's constant):
    # small enough that later puts evict earlier prefixes, whose directory
    # keys must go with them. Like link_bytes_per_s, it holds tiny's pages;
    # a wider model's run scales both by its KV bytes per token.
    pool_bytes: int = 1 << 18


def run_kv_stream(cfg: KVStreamConfig, params=None, device=None) -> dict:
    import numpy as np

    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.kvpool import KVPoolStore
    from rbg_tpu_torch.engine.pd import PDStreamPair
    from rbg_tpu_torch.kvtransfer import (FakeICITransport, PrefixDirectory,
                                          SlowLossyTransport)

    page_size = 8
    ecfg = dict(model=cfg.model, page_size=page_size, num_pages=256,
                max_batch=4, max_seq_len=256, prefill_chunk=16,
                batch_invariant=True)
    rng = np.random.RandomState(11)
    eng_ref, params = _unified_engine(params, device, **ecfg)
    vocab = eng_ref.mcfg.vocab_size
    prompts = [rng.randint(1, vocab, size=cfg.prompt_len).tolist()
               for _ in range(cfg.requests)]
    sp = SamplingParams(max_new_tokens=cfg.max_new_tokens)
    expect = eng_ref.generate(prompts, sp)
    del eng_ref

    directory = PrefixDirectory(page_size=page_size)
    pool = KVPoolStore(page_size, max_bytes=cfg.pool_bytes, directory=directory)
    link = SlowLossyTransport(FakeICITransport(bytes_per_s=cfg.link_bytes_per_s,
                                               latency_s=0.0005),
                              delay_s=cfg.slow_link_delay_s,
                              reorder_window=cfg.reorder_window,
                              dup_rate=cfg.dup_rate,
                              truncate_nth_stream=cfg.truncate_nth_stream,
                              truncate_after_bytes=1 << 12, seed=7)
    pair = PDStreamPair(EngineConfig(**ecfg), params=params, device=device,
                        transport=link, layer_split=cfg.layer_split,
                        admit_layers=cfg.admit_layers)
    pair.prefill.pool = pool
    pool.page_size = page_size
    pair.prefill.directory = directory
    pair.prefill.advertise_addr = "10.0.0.1:9000"
    pair.prefill.slice_id = "slice-a"

    # Two warm passes of one prompt through the same plane: the second
    # takes the pool prefix the first published. The layer-window chain
    # may not engage on them, so it is run once on its own (masked
    # writes; the live pool is unchanged).
    warm_prompt = rng.randint(1, vocab, size=cfg.prompt_len).tolist()
    for _ in range(2):
        pair.generate_one(warm_prompt, sp, stream=True, recv_timeout=120.0,
                          max_retries=2)
    if cfg.admit_layers > 0:
        pair.decode.warm_layer_sliced(cfg.admit_layers)

    results = []
    failures = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        try:
            results.append(pair.generate_one(p, sp, stream=True,
                                             recv_timeout=60.0, max_retries=2))
        except Exception as e:  # noqa: BLE001 — account, don't crash
            failures.append(f"request {i}: {type(e).__name__}: {e}")
            results.append(None)
    elapsed = time.perf_counter() - t0

    bit_identical = all(r is not None and r["tokens"] == e
                        for r, e in zip(results, expect))
    overlaps = [bool(r and r.get("overlap")) for r in results]
    retried = sum(r["retries"] for r in results if r)

    # Every holder claim the directory still makes is backed by the pool
    # holding at least that many prefix tokens.
    dir_vs_pool_ok = True
    for p in prompts:
        matched, holders = directory.lookup(p)
        if matched and holders and pool.match(p)[0] < matched:
            dir_vs_pool_ok = False
    # Invalidating the slice (a preemption) empties every lookup.
    directory.invalidate_slice("slice-a", reason="preemption")
    post_preempt_ok = all(directory.lookup(p)[1] == [] for p in prompts)

    return {
        "scenario": "kvstream",
        "config": dataclasses.asdict(cfg),
        "elapsed_s": round(elapsed, 3),
        "requests": {
            "total": cfg.requests,
            "completed": sum(1 for r in results if r),
            "stream_retries": retried,
            "failures": failures,
        },
        "transfer": {
            "bytes_per_request": (results[0]["bytes"]
                                  if results and results[0] else 0),
            "overlap_requests": sum(overlaps),
            "admit_lead_ms": _pcts([r["admit_lead_s"] for r in results
                                    if r and r["admit_lead_s"] is not None]),
            "t_first_decode_ms": _pcts([r["t_first_decode"] for r in results
                                        if r and r["t_first_decode"]]),
            # Device coverage when each row was admitted (None: the stream
            # reached full coverage first and took the plain path).
            "layer_admit": {
                "admit_layers": cfg.admit_layers,
                "engaged_requests": sum(
                    1 for r in results
                    if r and r.get("layers_at_admit") is not None),
                "coverage_at_admit": [
                    (None if not r or r.get("layers_at_admit") is None
                     else [r["layers_at_admit"], r["total_layers"]])
                    for r in results],
            },
        },
        "pool": pool.stats(),
        "directory": directory.stats(),
        "bit_identical": bit_identical,
        "invariants": {
            "kv_stream_overlap": bool(overlaps) and all(
                o for o, r in zip(overlaps, results) if r),
            "directory_consistent": dir_vs_pool_ok and post_preempt_ok,
            "zero_dropped_streams": (not failures and bit_identical
                                     and retried >= 1),
        },
    }


# ---- KV cache-hierarchy scenario -------------------------------------------


@dataclasses.dataclass
class PrefixCacheConfig:
    """An undersized device page pool serves traffic of long shared
    prefixes and unique suffixes, round-robin across prefix groups (each
    admission evicts another group's prefix), over the host spill tier and
    with early rejection at admission:

    * ``tier_accounting``: the host tier's lifetime identity closes and no
      prompt's pages live in both tiers at once;
    * ``directory_consistent``: every directory claim is backed by the
      tiers' actual coverage;
    * ``early_reject_before_prefill``: rejected requests spent no prefill;
    * ``zero_dropped_streams``: every submission completes with a cold
      engine's output or is an overload rejection with a retry hint.
    """

    system_prompts: int = 3
    prefix_len: int = 64            # shared prefix (pages of 8)
    suffix_len: int = 16
    requests_per_prefix: int = 4
    max_new_tokens: int = 6
    num_pages: int = 40             # undersized on purpose: ~1.2 prompts
    host_tier_bytes: int = 1 << 26
    burst_clients: int = 10         # early-rejection burst
    # The gate's TTFT target. The reference's 0.6 s lies above what its own
    # engine's gate predicts for the warm requests (nothing ahead of them)
    # and below what it predicts for the burst. None: the same rule on the
    # engine at hand, the gate's own prediction for one of the next prefix
    # group's prompts with one request ahead, read on the burst's service
    # after its warm requests (an engine of another speed; report:
    # burst.slo_ttft_s).
    slo_ttft_s: Optional[float] = 0.6
    early_reject_factor: float = 1.0
    model: str = "tiny"


def prefix_cache_prompts(cfg: PrefixCacheConfig, vocab: int) -> List[List[int]]:
    """The drill's prompts: ``requests_per_prefix`` rounds over the prefix
    groups, each a group's prefix and a fresh suffix."""
    import numpy as np

    rng = np.random.RandomState(17)
    prefixes = [rng.randint(1, vocab, size=cfg.prefix_len).tolist()
                for _ in range(cfg.system_prompts)]
    return [pre + rng.randint(1, vocab, size=cfg.suffix_len).tolist()
            for _ in range(cfg.requests_per_prefix) for pre in prefixes]


def run_prefix_cache(cfg: PrefixCacheConfig, params=None, device=None) -> dict:
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import Overloaded
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.kvtransfer import PrefixDirectory

    page_size = 8
    base = dict(model=cfg.model, page_size=page_size, max_batch=4,
                max_seq_len=256, prefill_chunk=16,
                batch_invariant=True)
    probe, params = _unified_engine(params, device, num_pages=256, **base)
    prompts = prefix_cache_prompts(cfg, probe.mcfg.vocab_size)
    sp = SamplingParams(max_new_tokens=cfg.max_new_tokens)
    expect = {tuple(p): probe.generate([p], sp)[0] for p in prompts}
    del probe

    # --- phase A: hierarchy correctness and accounting under churn ---
    directory = PrefixDirectory(page_size=page_size)
    eng = Engine(EngineConfig(num_pages=cfg.num_pages,
                              host_tier_bytes=cfg.host_tier_bytes, **base),
                 params=params, device=device)
    eng.host_tier.wire_directory(directory, "10.0.0.1:9000", slice_id="slice-a")
    t0 = time.perf_counter()
    outs = [eng.generate([p], sp)[0] for p in prompts]
    outs += [eng.generate([p], sp)[0] for p in prompts]   # host-hit pass
    elapsed = time.perf_counter() - t0
    bit_identical = all(o == expect[tuple(p)]
                        for o, p in zip(outs, prompts + prompts))
    tier = eng.host_tier.stats()
    # Exactly one tier: no prompt has pages on the device and on the host
    # at once (radix eviction is leaf-first, so the device keeps a prefix
    # of the path and the host the rest).
    overlap_free = True
    dir_ok = True
    for p in prompts:
        d = eng.radix.peek(p)
        if d > 0 and eng.host_tier.peek(p, 0) > 0:
            overlap_free = False
        dir_matched, _detail = directory.lookup_detail(p)
        if dir_matched > d + eng.host_tier.peek(p, d):
            dir_ok = False
    accounting = (eng.host_tier.accounting_closes()
                  and tier["spilled_pages"] > 0
                  and tier["promoted_pages"] > 0)
    hierarchy = {
        "requests": len(prompts) * 2,
        "host_tier": tier,
        "device_tier_pages": eng.radix.cached_pages,
        "radix_hit_tokens": eng.metrics["radix_hit_tokens"],
        "host_hit_tokens": eng.metrics["host_hit_tokens"],
        "directory": directory.stats(),
    }
    del eng

    # --- phase B: predictive early rejection under a burst ---
    gate = cfg.slo_ttft_s
    svc = EngineService(EngineConfig(
        num_pages=cfg.num_pages, host_tier_bytes=cfg.host_tier_bytes,
        early_reject="auto", slo_ttft_s=float("inf") if gate is None else gate,
        early_reject_factor=cfg.early_reject_factor, **base),
        params=params, device=device)
    try:
        # Warm first, then let the predictor learn the completion and
        # prefill rates on real sequential requests.
        svc.warmup(input_len=32, out_len=2)
        for p in prompts[:4]:
            svc.submit(p, sp, timeout=120.0)
        if gate is None:
            pred = sorted(svc.predicted_ttft_s(p, depth=1) or 0.0
                          for p in prompts[4:4 + cfg.system_prompts])
            gate = pred[len(pred) // 2]
            svc.set_early_reject_target(gate)
        m = svc.engine.metrics
        pf_base = m["prefill_tokens"]
        hit_base = m["radix_hit_tokens"] + m["host_hit_tokens"]
        results = {}
        lock = threading.Lock()

        def client(i: int, prompt):
            try:
                tokens, _ = svc.submit(prompt, sp, timeout=120.0)
                out = ("ok", tokens)
            except Overloaded as e:
                out = ("shed", getattr(e, "retry_after_s", None))
            except Exception as e:  # noqa: BLE001 — account, don't crash
                out = ("error", f"{type(e).__name__}: {e}")
            with lock:
                results[i] = out
        burst = [prompts[i % len(prompts)] for i in range(cfg.burst_clients * 2)]
        threads = [threading.Thread(target=client, args=(i, p), daemon=True)
                   for i, p in enumerate(burst)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
        wedged = [t for t in threads if t.is_alive()]
        completed = [(i, burst[i]) for i, (kind, _) in results.items()
                     if kind == "ok"]
        shed = [(i, r) for i, (kind, r) in results.items() if kind == "shed"]
        errors = [(i, r) for i, (kind, r) in results.items() if kind == "error"]
        early_rejects = svc.counters["early_rejects"]
        # Every prefill token the burst spent belongs to a completed
        # request's prompt net of its prefix hits.
        pf_spent = m["prefill_tokens"] - pf_base
        hits = m["radix_hit_tokens"] + m["host_hit_tokens"] - hit_base
        pf_expected = sum(len(p) for _, p in completed) - hits
        burst_identical = all(results[i][1] == expect[tuple(p)]
                              for i, p in completed)
        shed_have_hints = all(r is not None and r > 0 for _, r in shed)
    finally:
        svc.stop()

    return {
        "scenario": "prefixcache",
        "config": dataclasses.asdict(cfg),
        "elapsed_s": round(elapsed, 3),
        "hierarchy": hierarchy,
        "burst": {
            "slo_ttft_s": gate,
            "submitted": len(burst),
            "completed": len(completed),
            "shed": len(shed),
            "early_rejects": early_rejects,
            "errors": [f"client {i}: {msg}" for i, msg in errors],
            "wedged_clients": len(wedged),
            "prefill_tokens_spent": pf_spent,
            "prefill_tokens_expected": pf_expected,
        },
        "bit_identical": bit_identical and burst_identical,
        "invariants": {
            "tier_accounting": accounting and overlap_free,
            "directory_consistent": dir_ok,
            "early_reject_before_prefill": (
                early_rejects > 0 and pf_spent == pf_expected
                and shed_have_hints),
            "zero_dropped_streams": (
                not errors and not wedged and bit_identical
                and burst_identical and len(completed) > 0),
        },
    }


# ---- partition-tolerance scenario (deterministic chaos plane) --------------


@dataclasses.dataclass
class PartitionConfig:
    """The chaos plane's faults thrown at the serving plane's seams, with
    recovery asserted (legs: corruption, directory, peer staleness)."""

    requests: int = 4
    prompt_len: int = 48
    max_new_tokens: int = 8
    corrupt_chunks: int = 2         # scheduled corrupt-chunk budget
    model: str = "tiny"
    stale_ttl_s: float = 2.0        # peer-feed staleness TTL (drill clock)
    lease_ttl_s: float = 1.0        # the lease leg's; kept for the config's shape
    recovery_bound_s: float = 5.0   # post-heal reconnect must beat this
    timeout_s: float = 120.0
    seed: int = 23


# The fault kinds the three legs inject.
PARTITION_KINDS = ("partition", "corrupt", "brownout")


def run_partition(cfg: PartitionConfig, params=None, device=None) -> dict:
    report: Dict[str, object] = {"scenario": "partition",
                                 "config": dataclasses.asdict(cfg)}
    inv: Dict[str, bool] = {}
    t_run = time.perf_counter()
    faults_before = {k: REGISTRY.counter(
        metric_names.CHAOS_FAULTS_INJECTED_TOTAL, kind=k) for k in PARTITION_KINDS}
    report["corruption"] = _partition_corruption_leg(cfg, inv, params, device)
    report["directory"] = _partition_directory_leg(cfg, inv)
    report["peer_staleness"] = _partition_staleness_leg(cfg, inv)
    # Every fault kind the drill injected counted itself.
    injected = {k: round(REGISTRY.counter(
        metric_names.CHAOS_FAULTS_INJECTED_TOTAL, kind=k) - faults_before[k], 1)
        for k in PARTITION_KINDS}
    report["faults_injected"] = injected
    inv["all_faults_counted"] = all(v >= 1.0 for v in injected.values())
    report["elapsed_s"] = round(time.perf_counter() - t_run, 3)
    report["invariants"] = inv
    return report


def _partition_corruption_leg(cfg: PartitionConfig, inv: Dict[str, bool],
                              params=None, device=None) -> dict:
    import numpy as np

    from rbg_tpu_torch.chaos import (BROWNOUT, CORRUPT, ChaosClock,
                                     ChaosTransport, FaultSchedule, FaultWindow)
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.pd import PDStreamPair
    from rbg_tpu_torch.kvtransfer import FakeICITransport

    page_size = 8
    ecfg = dict(model=cfg.model, page_size=page_size, num_pages=256,
                max_batch=4, max_seq_len=256, prefill_chunk=16,
                batch_invariant=True)
    rng = np.random.RandomState(cfg.seed)
    eng_ref, params = _unified_engine(params, device, **ecfg)
    vocab = eng_ref.mcfg.vocab_size
    prompts = [rng.randint(1, vocab, size=cfg.prompt_len).tolist()
               for _ in range(cfg.requests)]
    sp = SamplingParams(max_new_tokens=cfg.max_new_tokens)
    expect = eng_ref.generate(prompts, sp)
    del eng_ref

    # The clock starts before the corrupt window, so the warm passes ride a
    # clean link; one clock set opens it, and exactly the first
    # corrupt_chunks drill chunks are hit.
    clock = ChaosClock(t0=-1.0)
    sched = FaultSchedule(
        [FaultWindow(CORRUPT, 0.0, float("inf"),
                     params={"max_faults": cfg.corrupt_chunks}),
         # Brownout covers the first request only (the clock jumps past it
         # after request 0): detection and replay on a slow link too.
         FaultWindow(BROWNOUT, 0.0, 5.0, params={"delay_s": 0.004})],
        clock=clock, seed=cfg.seed)
    detected_before = REGISTRY.counter(
        metric_names.KVT_INTEGRITY_FAILURES_TOTAL, surface="chunk")
    link = ChaosTransport(FakeICITransport(bytes_per_s=1e9, latency_s=1e-4), sched)
    pair = PDStreamPair(EngineConfig(**ecfg), params=params, device=device,
                        transport=link)
    warm = rng.randint(1, vocab, size=cfg.prompt_len).tolist()
    for _ in range(2):
        pair.generate_one(warm, sp, stream=True, recv_timeout=60.0, max_retries=2)
    clock.set(0.0)

    results: list = []
    failures: list = []
    for i, p in enumerate(prompts):
        try:
            results.append(pair.generate_one(p, sp, stream=True,
                                             recv_timeout=60.0, max_retries=3))
        except Exception as e:  # noqa: BLE001 — account, don't crash
            failures.append(f"request {i}: {type(e).__name__}: {e}")
            results.append(None)
        if i == 0:
            clock.set(10.0)   # the brownout closes; CORRUPT stays open, spent

    bit_identical = all(r is not None and r["tokens"] == e
                        for r, e in zip(results, expect))
    detected = REGISTRY.counter(metric_names.KVT_INTEGRITY_FAILURES_TOTAL,
                                surface="chunk") - detected_before
    retried = sum(r["retries"] for r in results if r)
    # Every corrupted chunk detected at commit, every hit stream replayed,
    # every output equal to the unified engine's.
    inv["no_silent_corruption"] = (detected >= 1.0 and retried >= 1
                                   and bit_identical)
    inv["zero_dropped_streams"] = not failures and bit_identical
    return {
        "requests": cfg.requests,
        "completed": sum(1 for r in results if r),
        "corrupted_chunks_injected": cfg.corrupt_chunks,
        "integrity_failures_detected": round(detected, 1),
        "stream_retries": retried,
        "bit_identical": bit_identical,
        "failures": failures,
    }


def _partition_directory_leg(cfg: PartitionConfig, inv: Dict[str, bool]) -> dict:
    from rbg_tpu_torch.chaos import (PARTITION, ChaosClock, FaultSchedule,
                                     FaultWindow, directory_fault)
    from rbg_tpu_torch.engine.kvpool import KVPoolServer, KVPoolStore
    from rbg_tpu_torch.kvtransfer import DirectoryClient, PrefixDirectory

    d = PrefixDirectory(page_size=8)
    store = KVPoolStore(8, directory=d)
    srv = KVPoolServer(("127.0.0.1", 0), store)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out: Dict[str, object] = {}
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        clock = ChaosClock(t0=0.0)
        sched = FaultSchedule(
            [FaultWindow(PARTITION, 1.0, 2.0,
                         params={"dead": ["router->directory"]})],
            clock=clock, seed=cfg.seed)
        c = DirectoryClient(addr, timeout=2.0, page_size=8, token="",
                            backoff_s=0.1, backoff_max_s=1.0,
                            chaos=directory_fault(sched))
        toks = list(range(24))
        if c.register(toks, "10.0.0.5:9000", slice_id="sl-a") != 3:
            raise AssertionError("register before the partition")
        if c.lookup(toks) != (24, ["10.0.0.5:9000"]):
            raise AssertionError("lookup before the partition")

        # ---- the partition opens: degraded, not down ----
        clock.set(1.0)
        lat = []
        for _ in range(8):
            t0 = time.perf_counter()
            got = c.lookup(toks)
            lat.append(time.perf_counter() - t0)
            if got != (0, []):
                raise AssertionError("partitioned lookup must degrade")
        out["degraded_lookup_ms"] = _pcts(lat)
        degraded_gauge = REGISTRY.gauge(metric_names.DEGRADED_MODE,
                                        ladder="directory")
        # The degraded answer comes at once (the breaker short-circuits),
        # never after the wire timeout.
        inv["degraded_not_down"] = max(lat) < 0.5 and degraded_gauge == 1.0

        # ---- heal: bounded recovery through the half-open probe ----
        clock.set(2.0)
        t0 = time.perf_counter()
        _wait(lambda: c.lookup(toks) == (24, ["10.0.0.5:9000"]),
              cfg.recovery_bound_s, "directory reconnect after heal")
        recovery_s = time.perf_counter() - t0
        out["recovery_s"] = round(recovery_s, 3)
        out["breaker_opens"] = round(REGISTRY.counter(
            metric_names.KVT_DIR_BREAKER_OPEN_TOTAL), 1)
        inv["recovery_bounded_directory"] = (
            recovery_s <= cfg.recovery_bound_s
            and REGISTRY.gauge(metric_names.DEGRADED_MODE,
                               ladder="directory") == 0.0)
    except (AssertionError, TimeoutError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
        inv.setdefault("degraded_not_down", False)
        inv.setdefault("recovery_bounded_directory", False)
    finally:
        srv.shutdown()
        srv.server_close()
    return out


def _partition_staleness_leg(cfg: PartitionConfig, inv: Dict[str, bool]) -> dict:
    from rbg_tpu_torch.engine.routertier import EV_HEALTH, RouterTier

    clock = {"t": 100.0}
    tier = RouterTier(name="part", clock=lambda: clock["t"],
                      peer_stale_after_s=cfg.stale_ttl_s)
    for n in ("ra", "rb", "rc"):
        tier.register(n)
    keys = [f"sess-{i}" for i in range(64)]
    served0 = {tier.route(k) for k in keys}

    # rb goes silent on the peer feed past the TTL while ra and rc keep
    # speaking: its ranges spill to ring successors.
    clock["t"] += cfg.stale_ttl_s + 0.5
    for n in ("ra", "rc"):
        tier.publish(n, EV_HEALTH, {"ok": True})
    served_stale = {tier.route(k) for k in keys}
    stale_excluded = "rb" not in served_stale and served_stale <= {"ra", "rc"}
    gauge_stale = REGISTRY.gauge(metric_names.DEGRADED_MODE, ladder="peer_feed")

    # Heal: one event from rb re-admits it at once.
    tier.publish("rb", EV_HEALTH, {"ok": True})
    served_healed = {tier.route(k) for k in keys}
    gauge_healed = REGISTRY.gauge(metric_names.DEGRADED_MODE, ladder="peer_feed")

    inv["stale_peer_excluded"] = stale_excluded and gauge_stale == 1.0
    inv["recovery_bounded_peer_feed"] = ("rb" in served_healed
                                         and gauge_healed == 0.0)
    snap = tier.snapshot()
    return {
        "served_before": sorted(served0),
        "served_while_stale": sorted(served_stale),
        "served_after_heal": sorted(served_healed),
        "stale_ttl_s": cfg.stale_ttl_s,
        "members": snap.get("members"),
    }


# ---- command line ----------------------------------------------------------


def run_scenario(args) -> dict:
    """One scenario's report from parsed command-line arguments."""
    if args.scenario == "overload":
        report = run_serving_overload(OverloadConfig(
            clients=args.clients, requests_per_client=args.requests,
            max_queue=args.max_queue, max_batch=args.max_batch,
            timeout_s=args.timeout_s, slo_ttft_s=args.slo_ttft_s,
            slo_tpot_s=args.slo_tpot_s, model=args.model), device=args.device)
        if args.kv_slow_link is not None:
            # The transfer-plane drill rides along; its invariants merge in.
            kv = run_kv_stream(KVStreamConfig(
                slow_link_delay_s=args.kv_slow_link,
                admit_layers=args.kv_admit_layers, model=args.model),
                device=args.device)
            report["kvstream"] = {k: v for k, v in kv.items()
                                  if k != "invariants"}
            report["invariants"].update(kv["invariants"])
        return report
    if args.scenario == "kvstream":
        return run_kv_stream(KVStreamConfig(
            slow_link_delay_s=(args.kv_slow_link
                               if args.kv_slow_link is not None else 0.02),
            admit_layers=args.kv_admit_layers, model=args.model),
            device=args.device)
    if args.scenario == "prefixcache":
        return run_prefix_cache(PrefixCacheConfig(slo_ttft_s=None, model=args.model),
                                device=args.device)
    return run_partition(PartitionConfig(timeout_s=args.timeout_s,
                                         model=args.model), device=args.device)


def main(argv=None, run=run_scenario) -> int:
    """The CLI; ``run`` maps parsed arguments to a report. Returns 1 when
    any invariant of the report is false."""
    import argparse

    from rbg_tpu_torch.engine.config import resolve_device

    ap = argparse.ArgumentParser(prog="python -m rbg_tpu_torch.stress.harness")
    ap.add_argument("--scenario", default="overload", choices=SCENARIOS,
                    help="overload = admission-control drill (sheds, "
                         "deadlines, queue bound); kvstream = KV transfer-"
                         "plane drill (chunked PD streaming over a slow, "
                         "lossy link: overlap, directory consistency, zero "
                         "dropped streams); prefixcache = host-tier cache "
                         "hierarchy and early rejection; partition = chaos "
                         "plane (chunk corruption caught at commit and "
                         "replayed, directory breaker degrade and recover, "
                         "peer-feed staleness)")
    ap.add_argument("--model", default="tiny",
                    help="model preset of every engine the drill builds")
    ap.add_argument("--device", default=None,
                    help="torch device of the drill's engines (default: the "
                         "card; without one the drill refuses to start)")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-queue", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--timeout-s", type=float, default=60.0)
    ap.add_argument("--slo-ttft-s", type=float, default=10.0,
                    help="TTFT target of the overload drill's SLO judgment "
                         "(0 disables the dimension); prefixcache calibrates "
                         "its gate on its own service (PrefixCacheConfig."
                         "slo_ttft_s = None)")
    ap.add_argument("--slo-tpot-s", type=float, default=1.0,
                    help="per-output-token target of the overload drill's "
                         "SLO judgment (0 disables)")
    ap.add_argument("--kv-slow-link", type=float, default=None,
                    metavar="DELAY_S",
                    help="per-frame delay of the slow KV link (kvstream, "
                         "default 0.02; with --scenario overload the "
                         "kvstream drill runs alongside and its invariants "
                         "merge in)")
    ap.add_argument("--kv-admit-layers", type=int, default=1, metavar="K",
                    help="kvstream: admit at layer-K coverage and run the "
                         "first decode step as a layer-windowed chain (0 = "
                         "whole-coverage admission)")
    ap.add_argument("--json", action="store_true", help="one-line JSON output")
    ap.add_argument("--json-out", metavar="FILE",
                    help="also write the JSON report to FILE")
    ap.add_argument("--html", metavar="FILE", help="also write an HTML report")
    ap.add_argument("--locktrace", action="store_true",
                    help="arm the lock-order detector (RBG_LOCKTRACE=1) "
                         "before anything is built; an inversion fails the "
                         "run (lock_order_acyclic)")
    ap.add_argument("--trace", action="store_true",
                    help="arm request tracing: the slowest request's "
                         "waterfall in the report and a trace_complete "
                         "invariant (overload also trace_hops_cover_root)")
    ap.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help="head-sampling rate for --trace (default 1.0)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"stress: {e}", file=sys.stderr)
        return 2
    if args.trace_sample is not None:
        args.trace = True
    if args.locktrace:
        # Read when a lock is built: set before the drill builds anything.
        os.environ["RBG_LOCKTRACE"] = "1"
    if args.trace:
        from rbg_tpu_torch.obs import trace as _trace
        _trace.configure(enabled=True, sample=(1.0 if args.trace_sample is None
                                               else args.trace_sample))
        _trace.SINK.reset()
        # Counter baseline so only this run's finalizations are judged.
        args._trace_counter_base = {
            r: REGISTRY.counter(metric_names.TRACE_TRACES_TOTAL, result=r)
            for r in ("complete", "incomplete", "leaked")}
    load1 = os.getloadavg()[0]
    report = run(args)
    report["load1_before"] = round(load1, 2)
    _attach_locktrace(report, args)
    _attach_trace(report, args)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.html:
        write_html_report(report, args.html)
    print(json.dumps(report) if args.json else json.dumps(report, indent=2))
    # The drill asserts its invariants: a false one fails the run.
    if not all(report.get("invariants", {}).values()):
        return 1
    return 0


def _attach_locktrace(report: dict, args) -> None:
    """With --locktrace: the lock-order graph and an invariant that fails
    the drill on an inversion."""
    if not getattr(args, "locktrace", False):
        return
    from rbg_tpu_torch.utils import locktrace
    report["locktrace"] = {"order_graph": locktrace.snapshot(),
                           "inversions": locktrace.inversions()}
    if "invariants" in report:
        report["invariants"]["lock_order_acyclic"] = not locktrace.inversions()


def _attach_trace(report: dict, args) -> None:
    """With --trace: the slowest request's waterfall, per-trace summaries,
    ``trace_complete`` (every sampled request formed one rooted span tree)
    and, for overload, ``trace_hops_cover_root`` (the union of the slowest
    request's hop intervals covers at least 90% of its root span)."""
    if not getattr(args, "trace", False):
        return
    from rbg_tpu_torch.obs import trace
    recent = trace.SINK.recent(64)
    slowest = trace.SINK.slowest(10)
    active = trace.SINK.active_count()
    cov = trace.hop_coverage(slowest[0]) if slowest else None
    # Judged from the per-finalization counters: the recent ring holds
    # 64, and an evicted orphan must still count.
    base = getattr(args, "_trace_counter_base", {})
    totals = {r: max(0.0, REGISTRY.counter(metric_names.TRACE_TRACES_TOTAL,
                                           result=r) - base.get(r, 0.0))
              for r in ("complete", "incomplete", "leaked")}
    seen = {r["trace_id"]: r for r in recent + slowest}
    report["trace"] = {
        "sampled_finalized": int(sum(totals.values())),
        "finalized_by_result": {k: int(v) for k, v in totals.items()},
        "active_unfinalized": active,
        "incomplete": [tid for tid, r in seen.items() if not trace.complete(r)],
        "slowest": slowest[:5],
        "waterfall": trace.waterfall(slowest[0]) if slowest else [],
        "hop_coverage": round(cov, 4) if cov is not None else None,
    }
    if "invariants" in report:
        report["invariants"]["trace_complete"] = (
            totals["complete"] > 0 and totals["incomplete"] == 0
            and totals["leaked"] == 0 and active == 0)
        if getattr(args, "scenario", "") == "overload":
            report["invariants"]["trace_hops_cover_root"] = (
                cov is not None and cov >= 0.9)


# ---- HTML report -----------------------------------------------------------


def _kv_table(d: dict) -> str:
    return ("<table><tr><th>key</th><th>value</th></tr>"
            + "".join(f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in d.items())
            + "</table>")


def _invariants_table(inv: dict) -> str:
    rows = "".join(
        f"<tr><td>{k}</td><td style=\"color:{'#070' if v else '#b00'}\">"
        f"{'PASS' if v else 'FAIL'}</td></tr>"
        for k, v in inv.items())
    return f"<table><tr><th>invariant</th><th>result</th></tr>{rows}</table>"


def _slo_sections(report: dict) -> str:
    slo = report.get("slo") or {}
    if not slo:
        return ""
    gvt = report.get("goodput_vs_throughput") or {}
    roles = slo.get("per_role_60s") or {}
    rows = "".join(
        f"<tr><td>{gk}</td><td>{g.get('judged', 0)}</td>"
        f"<td>{g.get('ttft_attainment')}</td>"
        f"<td>{g.get('tpot_attainment')}</td>"
        f"<td>{g.get('goodput_rps')}</td></tr>"
        for gk, g in sorted(roles.items()))
    out = (f"<h2>SLO attainment (targets: {json.dumps(slo.get('targets'))}, "
           f"judged: {slo.get('judged')})</h2>"
           f"<table><tr><th>role</th><th>judged</th><th>ttft att</th>"
           f"<th>tpot att</th><th>goodput rps</th></tr>{rows}</table>")
    if gvt:
        out += f"<h2>goodput vs throughput</h2>{_kv_table(gvt)}"
    return out


def _overload_sections(report: dict) -> str:
    lat = report.get("admitted_latency_ms") or {}
    return f"""<h2>outcomes</h2>{_kv_table(report.get("outcomes") or {})}
<h2>admitted-request latency (ms)</h2>{_kv_table(lat)}
<h2>continuous batching</h2>{_kv_table(report.get("continuous_batching") or {})}
<h2>service counters</h2>{_kv_table(report.get("service") or {})}
<p>max queue depth observed: {report.get("max_queue_depth_observed")}
&nbsp; retry_after hint: {report.get("retry_after_hint_s")}</p>
{_slo_sections(report)}
<h2>invariants</h2>{_invariants_table(report.get("invariants") or {})}"""


def _kvstream_sections(report: dict) -> str:
    tr = report.get("transfer") or {}
    la = tr.get("layer_admit") or {}
    return f"""<h2>requests</h2>{_kv_table(report.get("requests") or {})}
<h2>transfer (slow link)</h2>{_kv_table(
        {k: v for k, v in tr.items() if not isinstance(v, dict)})}
<h2>admit lead ms (ready → stream close)</h2>{_kv_table(
        tr.get("admit_lead_ms") or {})}
<h2>layer-sliced admission (coverage at admit)</h2>{_kv_table(
        {k: v for k, v in la.items() if not isinstance(v, list)})}
<p>per-stream [layers_at_admit, total_layers] (null = plain path):
{la.get("coverage_at_admit")}</p>
<h2>prefix pool</h2>{_kv_table(report.get("pool") or {})}
<h2>prefix directory</h2>{_kv_table(report.get("directory") or {})}
<p>bit_identical: {report.get("bit_identical")}</p>
<h2>invariants</h2>{_invariants_table(report.get("invariants") or {})}"""


def write_html_report(report: dict, path: str) -> None:
    """Each scenario renders its own sections; prefixcache and partition
    render their JSON, as the reference's report does."""
    scenario = report.get("scenario") or "unknown"
    if scenario == "overload":
        body = _overload_sections(report)
    elif scenario == "kvstream":
        body = _kvstream_sections(report)
    else:
        body = f"<pre>{json.dumps(report, indent=2)}</pre>"
    tr = report.get("trace")
    if tr:
        wf = "\n".join(tr.get("waterfall") or ["(no sampled traces)"])
        body += (f"<h2>slowest-request waterfall (hop coverage: "
                 f"{tr.get('hop_coverage')})</h2><pre>{wf}</pre>")
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>rbg-tpu stress report — {scenario}</title>
<style>body{{font-family:sans-serif;margin:2rem}}table{{border-collapse:collapse;margin-bottom:1rem}}
td,th{{border:1px solid #999;padding:4px 10px;text-align:right}}
th{{background:#eee}}td:first-child{{text-align:left}}</style></head><body>
<h1>rbg-tpu stress report — scenario: {scenario}</h1>
<p>config: {json.dumps(report.get("config", {}))}</p>
{body}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)


if __name__ == "__main__":
    sys.exit(main())
