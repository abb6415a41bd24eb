#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rbg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card (nvidia-smi name and power limit, torch's name).
2. build   — nvcc builds every CUDA kernel from rbg_tpu_torch/csrc (A-I,
             one library each, all at once).
3. kernels — each kernel against its plain PyTorch version on the card, in
             bfloat16: A-D and I at llama3-8b and qwen2-0.5b shapes (C and D
             on int8 pools made by the port's quantize_kv; I on B's pack),
             E-H at deepseek-v2-lite (H=16) and deepseek-v3 (H=128) shapes
             and at a tp 2 rank's (deepseek-v2-lite: H=8; llama3-8b: KV=4 for
             A-D)
             (G and H on the same latent pools quantized): error, kernel
             time (ms: CUDA events, so whatever wrapper host time the L2
             flush does not hide counts), the kernel's own device time
             (device_ms, torch.profiler), plain time, one PyTorch library
             call on the same inputs (SDPA on the gathered view, a
             yardstick the port never calls) and the least time the card
             could take (bound). Every kernel also gives host_us, the
             host's time per call; A-I give work_items and grid_blocks as
             the kernel wrote them back, and their time on the same case in
             a table WIDE_P pages wide (output equal bit for bit); A and C
             also a B=64 decode bucket of short rows (bucket64); A-D and I
             also the llama3-8b case at page size 128 (page128: pages
             larger than their 64-slot KV block).
   gpucheck — ``python -m rbg_tpu_torch.cli.gpucheck`` as a subprocess
             (probe; kernels A-I at small shapes against their plain
             versions; bench_serving at qwen2-0.5b; a qwen2-0.5b engine
             launching A and B): exit 0 with every stage ok.
4. tiny    — tiny and tiny-moe (float32, hd 32; kernels A, B), tiny-mla
             (float32 latents; kernels E, F) and tiny at page size 128
             through Engine on the card, greedy tokens equal to the CPU
             port's on the same weights; then ``python -m
             rbg_tpu_torch.engine.server`` with its defaults (tiny on the
             card), two requests whose greedy tokens equal the CPU port's.
5. training and checkpoints (before any serving phase holds weights: the
   checkpoint file may live in the machine's memory):
   train   — tiny (float32) trained 3 steps on the card and on the CPU
             from the same weights (params_from_numpy), plain and with
             remat: losses and every parameter within TRAIN_REL; llama3-8b
             at full width, 2 layers, float32: remat gradients equal plain
             ones (REMAT_REL); the trainer's leaf layout at 8 layers
             (stacked against per-layer: backward ms and peak, a reading);
             llama3-8b at full width and depth, bf16, remat, 5 steps on
             one [1, 512] batch at TRAIN_LR: finite and falling at every
             step; step ms, tokens/s, model FLOPs as a share of the bf16
             peak, peak memory, a sixth step's forward / backward /
             optimizer ms; one step through parallel.make_mesh() at world
             size 1 on nccl gives the first step's loss.
   checkpoint — the trained llama3-8b saved (save_checkpoint, 16 GB) and
             served by Engine(checkpoint_path=...) with the greedy tokens
             of an engine on the same weights in memory (kernels A, B);
             write and read GB/s. Then, while the file exists, two
             processes of this script (``ckpt_rank``, a gloo world on the
             one card) each build Engine(checkpoint_path=...) on a tp 2
             mesh, reading only its slices from the file: bytes copied
             (its weight bytes, every weight bit-equal to local_shard of
             the file's tensor), seconds, RssAnon and device peaks beside
             the whole path's cost, the first steps within TP_FIRST_BAND of
             the unsharded engine's, kernels A and B on both ranks; the
             same ranks read a qwen2-0.5b HF directory (bf16, q/k/v biases,
             tied head) rank-locally and whole (read to the host, then
             sliced) in turns, bit-equal. That directory served by
             ``python -m rbg_tpu_torch.engine.server --checkpoint-path`` as
             a process with the greedy tokens of an in-process engine on it.
6. llama3-8b at full width and depth, random weights from a seed:
   engine  — Engine (bf16 pools; kernels A, B): a request steps into
             decode, a second joins so one ragged step holds a decode row
             and a prefill chunk, both run to completion (multi_step 1
             and 4); greedy is repeatable; a seeded sampled request gives
             the same stream twice, and the Gumbel noise is timed.
   witness — one forward_ragged (ragged_compare) and one forward_paged
             decode step over rows whose walks split (decode_compare),
             each with kernels against the plain version on the same pool,
             in float32 (tight) and in bfloat16 (against a float32
             control).
   block   — one forward_paged over an [8, 64] block with pads (the split
             prefill's and the verify's shape: kernel B as a pack of 8
             rows) against the plain version on the same pool, in float32
             and bfloat16 as the other witnesses (block_compare).
   server  — the port's engine server in this process on a free port,
             answering 4 concurrent generate requests (one streamed).
   split   — Engine with ragged="off" (split prefill steps: kernel B or D;
             decode windows: A or C) over bf16 and then int8 pools, two
             requests decoding together: greedy tokens equal between
             multi_step 1 and 4, no unified step.
   spec    — speculative="ngram" against "off", greedy and seeded
             sampled: tiny (float32) on the card equal to the
             non-speculative and the CPU port's streams with drafts
             accepted; llama3-8b (bf16) streams each judged token by token
             against a float32 forward of themselves (SPEC_LOGIT_BAND; a
             stream shifted by one must fail the judge), the verify through
             kernel B alone; drafts and acceptance printed.
   lora    — two rank-16 adapters on all seven targets written to .npz and
             loaded through the server's --lora parsing into a server in
             this process: a base request alone equal to an engine without
             adapters, adapters a and b and a base row in one batch, each
             stream its own; an unknown adapter refused.
   grammar — grammar-constrained decoding (the byte tokenizer's grammar
             wired with enable_json_grammar): one batch of 8 (two regex
             rows, two bounded json_schema rows, a json_mode row, a
             json_schema row over grammar_state_budget, two free rows;
             greedy and seeded) through Engine at multi_step 4 with device
             tables ("auto") and without ("off"): every constrained token
             legal, finished rows fullmatch their regex or conform to their
             schema, greedy rows equal between auto and off, kernels A and B
             launched; then one decode step at B = 8 (multi_step 1) with 0
             grammar rows, 4 tabled rows and 1 table-less row, in turns:
             wall and device ms, the table bytes held, and the sync warnings
             of a 4-step window with and without its grammar rows (the
             grammar may add none).
   frontend — the port's OpenAI front end in front of the port's server
             (grammar wired): /healthz, /v1/models, a guided_regex
             completion, a response_format json_schema chat and a free
             completion, each also streamed (equal text), TTFT and total
             latency, /v1/embeddings, and a 400 for an unsupported
             response_format.
   tier    — the host KV tier: TIER_PROMPT_LENS (1024-1920 tokens) through
             an engine whose pool holds about two of them, with a 2 GiB
             host tier, twice, one request at a time (kernels A, B). Pass
             1 spills, pass 2 promotes; every promoted page's checksum,
             taken on the card, equals the page's before its spill; pass
             2's greedy tokens equal a device-radix-hit engine's at the
             same hit depth; the accounting closes. TTFT cold, device hit
             and host hit; spill and promote GB/s beside one pinned
             ``copy_`` of the same bytes each way.
   router  — the port's router (``rbg_tpu_torch.engine.router``) in front
             of two servers on one params dict: bench_serving --addr with
             BENCH_ARGS straight at one server, through a router with that
             server alone, and through the router with both (every request
             completes, both serve; kernels A, B); a repeated prefix sticks
             to one server with radix hits there; a greedy stream cut after
             3 token frames by a relay that resets the connection resumes
             on the sibling equal to the uninterrupted stream (B = 1, idle
             servers); the OpenAI front end through the router (a
             guided_regex completion, a streamed chat).
   pd      — prefill/decode disaggregation in process (engine/pd.py, one
             weights dict): PD_PROMPT_LENS (1100-2032 tokens) one at a
             time through a unified Engine, then PDPair (whole bundles) and
             PDStreamPair (layer_split 4; admit_layers 0 and 8) over an
             in-process link and a paced one (0.5 GB/s, 5 ms a frame): greedy
             tokens equal the unified engine's on every path, every
             imported page's payload checksum equals its exported page's,
             the layer-sliced admission engages on the paced link (kernels
             A, B); then, without that witness's probe, TTFT through PD
             against unified, export and commit GB/s by the workers' own
             clocks beside one pinned copy_, and the first decode token
             with and without layer slicing beside the layer-admit lead.
   int8    — the same engine script with kv_dtype="int8" (kernels C, D),
             multi_step 4, its three witnesses on int8 pools and the server
             over int8 pools.
7. pd_servers (after the phases above free their llama3-8b weights): ``python
   -m rbg_tpu_torch.engine.server --mode prefill`` and ``--mode decode`` at
   llama3-8b as processes on the card (random weights from seed 0), warmed,
   behind the port's router with --kv-stream auto (pushed chunk streams)
   and then off (whole bundles): 8 requests one at a time each, every one
   completes, greedy tokens equal between the two, and the first 3 equal
   to the in-process unified engine's on the same weights.
8. serving (llama3-8b at full width and depth, random weights from a seed,
   after the phases above free theirs):
   bench_serving   — ``rbg_tpu_torch.engine.bench_serving.run`` with
             BENCH_ARGS (16 Poisson requests of 512-token prompts and 64 new
             tokens at 4/s, bf16 pools, multi_step 4), in process and then
             with --addr (and an auth token) against the port's server in
             this process: every request completes, kernels A and B launch;
             TTFT, ITL, e2e, tokens/s and goodput at the default SLO targets.
   serving_surface — that server's generate_text (traced), embed (4
             prompts of 100-500 tokens, 4096-wide, batched against singles),
             slo, traces, an auth refusal, start_drain refusing a new
             generate while a stream finishes; tiny's embeddings on the card
             against the CPU port.
   bench_slo — ``rbg_tpu_torch.engine.bench_slo --setups unified,pd`` at
             llama3-8b with BENCH_SLO_ARGS (24 Poisson requests of
             512-token prompts and 32 new tokens at 1/s): a spawned server
             on the card, then a spawned PD group (kv pool, prefill and
             decode servers on the card, the router): every request
             completes on both; TTFT, ITL and goodput of each.
9. deepseek-v2-lite (MLA + MoE) at full width and depth, random weights
   from a seed, after llama3-8b is freed: engine (kernels E, F; multi_step
   1 and 4), witnesses (ragged_compare, decode_compare and block_compare:
   F at T > 1) and server, as for llama3-8b; then on the same weights over
   int8 latent pools (kernels G, H): engine (multi_step 4), int8 witnesses
   (H at T > 1) and server.
10. tp — tensor-parallel serving (Engine(mesh=...)) at tp 2: a gloo world
   of two processes of this script (``--tp-rank``) on the one card, its
   collectives staged through the host. tiny, tiny-moe (tp 2 and ep 2) and
   tiny-mla (f32; A, B; E, F) with greedy tokens equal to the unsharded
   engine's on the card; llama3-8b (A, B; int8 pools: C, D) and
   deepseek-v2-lite (E, F; G, H) from the rank-local init, two requests
   through a unified step and decode windows, each token judged against a
   float32 forward (SPEC_LOGIT_BAND), the first step's logits against the
   unsharded engine's (TP_FIRST_BAND for every token whose kept experts
   agree in every layer, by the moe_masks recording, and for every token
   of deepseek-v2-lite with tp's experts forced on the unsharded engine;
   at most TP_MOE_MOST_PAST of the tokens past it unforced;
   BF16_VS_CONTROL), each rank's split weights and GQA pools half the
   unsharded engine's, every kernel launched on the ranks; a decode
   step's wall and device ms per rank against tp 1; which first-step
   tokens of deepseek-v2-lite swapped an expert, their router margins,
   and the same for two bfloat16 paths without tp (TP_MOE_CONTROLS).
   Then the serving loops over the mesh (rank 0
   leads, engine/lockstep.py): tiny's two-rank EngineService (8
   submissions from threads: 5 greedy, 1 seeded, 1 cancelled, 1 deadline
   abort; the 6 uncut streams equal a one-rank service's), DecodeService
   (2 bundles and a stream) and PDStreamPair(layer_split=1,
   admit_layers=1) on a paced link, equal to one-rank counterparts; and at
   llama3-8b the host tier at tp 2 (promoted pages' checksums per rank,
   pass 2 equal to a device-hit tp 2 engine, page counts equal to one
   rank's), PDStreamPair(PD_LAYER_SPLIT, PD_ADMIT_LAYERS) on the paced
   link engaging on both ranks with admit_layers 0's tokens, a 512-token
   bundle through a two-rank DecodeService (its plan's bytes and
   seconds), and a two-rank EngineService of 8 requests (every token
   judged against a float32 forward; TTFT, ITL and TPOT p50 beside a
   one-rank service). Both ranks' engine metrics equal and no row left.
   A rank that fails or a phase past TP_TIMEOUT_S fails it.
11. ragged_ab — rbg_tpu_torch.bench.block_ragged_probe: kernel I against
   kernel B on a prefill-heavy pack, both checked against the plain
   version, then interleaved timed reps; then each kernel's device ms on
   the probe's pack (the probe's calls/s read host time at its size).

Then a line {"kernels": [...]} (launches counted over the phases that drive
each kernel's path: the llama3-8b server, tier, router, pd and checkpoint
phases (the checkpoint's tp ranks too) for A and B, the int8 engine for C and D, the deepseek-v2-lite server for E and F, its int8 engine for G
and H, the tp phase's ranks for A-H, the probe for I) and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before the last line; without a CUDA device nothing
runs.
"""

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
# Kernel vs plain, both f32-accumulated and rounded to bf16 once: at most
# one bf16 rounding step apart, |d| <= 2^-7 |ref| (+1e-3 near zero).
KERNEL_RTOL, KERNEL_ATOL = 2 ** -7, 1e-3
# forward_ragged at full depth, kernels vs plain (see ragged_compare). In
# float32 the two differ only in summation order (about 1e-6 relative per
# attention output); 1e-3 on the logits leaves room for its growth through
# 32 layers and is far below what a wrong mask, page or head mapping gives.
F32_LOGIT_ATOL = 1e-3
# In bfloat16 the kernel path must stray from the float32 logits no more
# than the plain bfloat16 path does, up to this factor on the mean.
BF16_VS_CONTROL = 1.25
# MoE models: the router keeps an expert when its probability is >= the
# k-th largest, so a float32 ulp can swap one expert of one token, which
# moves that token's logits by far more than 1e-3. There the float32 half
# holds at least MOE_F32_SHARE of the tokens to F32_LOGIT_ATOL and every
# token to MOE_F32_STD_FRAC x the logits' std (a wrong mask, page or head
# mapping moves every token by the order of the std).
MOE_F32_SHARE, MOE_F32_STD_FRAC = 0.9, 0.25
# int8 pools: each path writes the step's own K/V from its own hidden
# states, so a last-ulp difference upstream can round a quantized value to
# the neighbouring integer. Both halves are therefore control ratios: the
# int8 kernel path's mean distance from the float32 logits of a model-dtype
# pool must be at most this factor times the int8 plain path's.
INT8_VS_CONTROL = 1.25

LLAMA_KERNELS = ("paged_decode", "ragged_paged")
INT8_KERNELS = ("paged_decode_q", "ragged_paged_q")
MLA_KERNELS = ("paged_mla_decode", "ragged_paged_mla")
MLA_INT8_KERNELS = ("paged_mla_decode_q", "ragged_paged_mla_q")
PROBE_KERNELS = ("ragged_paged_tokengrid",)


_T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line; ``t_s``: seconds since this script started."""
    print(json.dumps({"phase": phase, **kw, "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def cuda_ms(torch, fn, flush, iters=20, warm=3):
    """Median device time of one call, L2 flushed before each launch (when
    a flush buffer is given)."""
    times = []
    for i in range(warm + iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= warm:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_us(torch, fn, n=200):
    """Host time of one call in microseconds: n calls issued back to back,
    the card running behind them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def device_ms(torch, fn, flush, kernel, n=20, tries=3):
    """Mean device time of the kernel named ``kernel`` over n calls of
    ``fn``, each launching it once (torch.profiler, L2 flushed before each
    call): the kernel's own time, without the wrapper's host time that
    cuda_ms also counts where the flush does not hide it. A profile that
    did not record exactly n launches of the kernel is discarded and taken
    again; after ``tries`` such profiles this raises, so no partial or
    empty reading is ever returned."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in ev)
        if count == n:
            return sum(e.self_device_time_total for e in ev) / n / 1e3
        seen.append(count)
    raise RuntimeError(f"device_ms: the profiler recorded {seen} launches of {kernel!r} "
                       f"in {tries} profiles of {n} calls, never {n}")


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_checked(torch, name, got, ref):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool(torch.all(err <= KERNEL_RTOL * ref.abs() + KERNEL_ATOL))
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {float(err.max())})")
    return float(err.max())


def pages_of(lens, page=16):
    return sum(-(-n // page) for n in lens)


# ---- phase 3: kernels against their plain versions ----

DECODE_LENS = [2048, 1900, 1536, 1200, 1024, 700, 333, 65]
# Mixed pack: 64-token prefill chunks and decode tokens; the decode token
# first puts every chunk across a tile boundary.
RAGGED_SPEC = [(1, 2048), (64, 64), (1, 1500), (64, 512), (1, 800), (64, 1024),
               (1, 100), (64, 2000)]
WIDE_P = 512     # a table of 8192 slots (--max-seq-len 8192), 4x the longest row
BUCKET64_LENS = [64 + 10 * i for i in range(64)]   # a B=64 decode bucket of short rows


def decode_case(torch, np, KV, G, hd, lens, page=16):
    dev = "cuda"
    B, P = len(lens), max(-(-n // page) for n in lens)
    NP = B * P + 1
    rng = np.random.RandomState(KV * 100 + G)
    g = torch.Generator(device=dev).manual_seed(KV * 100 + G)
    k = torch.randn(NP, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(NP, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=dev).to(torch.bfloat16)
    table = torch.from_numpy((rng.permutation(NP - 1)[:B * P] + 1)
                             .reshape(B, P).astype(np.int32)).to(dev)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, table, (kv_lens - 1)[:, None], kv_lens


def pack_rows(torch, rows_spec, dev="cuda"):
    """rows_spec: (q_len, kv_len) per row, packed in order, then pads to the
    engine's power-of-two token bucket (row 0, position -1). Returns
    (q_positions [1, T], kv_lens [R], row_ids [T])."""
    rows, pos = [], []
    for r, (ql, kv) in enumerate(rows_spec):
        rows += [r] * ql
        pos += list(range(kv - ql, kv))
    T = 8
    while T < len(rows):
        T *= 2
    rows += [0] * (T - len(rows))
    pos += [-1] * (T - len(pos))
    return (torch.tensor([pos], dtype=torch.int32, device=dev),
            torch.tensor([kv for _, kv in rows_spec], dtype=torch.int32, device=dev),
            torch.tensor(rows, dtype=torch.int32, device=dev))


def ragged_case(torch, np, KV, G, hd, rows_spec, page=16):
    dev = "cuda"
    R = len(rows_spec)
    P = max(-(-kv // page) for _, kv in rows_spec)
    NP = R * P + 1
    rng = np.random.RandomState(KV * 1000 + G)
    g = torch.Generator(device=dev).manual_seed(KV * 1000 + G)
    k = torch.randn(NP, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(NP, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    table = torch.from_numpy((rng.permutation(NP - 1)[:R * P] + 1)
                             .reshape(R, P).astype(np.int32)).to(dev)
    qpos, kv_lens, rows = pack_rows(torch, rows_spec)
    q = torch.randn(1, rows.numel(), KV * G, hd, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, table, qpos, kv_lens, rows


def padded_queries(torch, q, qpos, rows, R, Tm=64):
    """The pack scattered into a padded [R, Tm] batch (the plain version's
    layout) for the SDPA yardstick: (queries, positions)."""
    from rbg_tpu_torch.ops.ragged_paged_attention import _unpack_offsets
    real = qpos[0] >= 0
    idx = _unpack_offsets(rows, real).clamp(max=Tm - 1)
    qp = torch.zeros(R, Tm, *q.shape[2:], dtype=q.dtype, device="cuda")
    pp = torch.full((R, Tm), -1, dtype=torch.int32, device="cuda")
    qp[rows[real].long(), idx[real]] = q[0, real]
    pp[rows[real].long(), idx[real]] = qpos[0, real]
    return qp, pp


def decode_kernel_cases(torch, np, flush, model, KV, G, hd, lens, wide=False, page=16):
    """Kernels A and C (on the same pools quantized) against their plain
    versions on one decode case at page size ``page``: {name: record}, each
    with host_us and the kernel's own report of its launch (work_items,
    grid_blocks); with ``wide`` also the same case in a table WIDE_P pages
    wide, whose output must be the same bit for bit."""
    import torch.nn.functional as F

    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    from rbg_tpu_torch.ops.kernels.paged_decode_q import paged_decode_attention_q
    from rbg_tpu_torch.ops.paged_attention import (gather_kv, paged_attention_plain,
                                                   quantize_kv)

    q, k, v, table, pos, kv_lens = decode_case(torch, np, KV, G, hd, lens, page)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    B, S, tokens = len(lens), table.shape[1] * page, sum(lens)
    qh = q.permute(0, 2, 1, 3)                                       # [B,H,1,hd]
    mask = (torch.arange(S, device="cuda")[None, :] < kv_lens[:, None])[:, None, None]
    meta = pages_of(lens, page) * 4 + B * 4
    flops = 4 * tokens * KV * G * hd
    out = {}
    for name, elem, fn, plain, kv_pair in (
            ("paged_decode", 2,
             lambda t=table: paged_decode_attention(q, k, v, t, kv_lens),
             lambda: paged_attention_plain(q, k, v, table, pos, kv_lens), (k, v)),
            ("paged_decode_q", 1,
             lambda t=table: paged_decode_attention_q(q, k8, v8, ks, vs, t, kv_lens),
             lambda: paged_attention_plain(q, k8, v8, table, pos, kv_lens, ks, vs),
             None)):
        got = fn()
        report = launch_report(q.device)
        err = max_err_checked(torch, f"{name} {model} B={B} page {page}", got, plain())
        extra = {}
        if wide:
            wt = F.pad(table, (0, WIDE_P - table.shape[1]))
            if not torch.equal(fn(wt), got):
                raise AssertionError(f"{name} {model}: output moved with the table width")
            extra["wide_table"] = dict(P=WIDE_P, **launch_report(q.device),
                                       ms=cuda_ms(torch, lambda: fn(wt), flush))
        if kv_pair is None:     # SDPA on the pre-dequantized bf16 view
            kv_pair = ((k8.float() * ks).to(torch.bfloat16),
                       (v8.float() * vs).to(torch.bfloat16))
        kg = gather_kv(kv_pair[0], table).permute(0, 2, 1, 3).contiguous()
        vg = gather_kv(kv_pair[1], table).permute(0, 2, 1, 3).contiguous()
        nbytes = (2 * tokens * KV * hd * elem + 2 * q.numel() * 2 + meta
                  + (2 * tokens * KV * 4 if elem == 1 else 0))
        b_ms, b_by = bound(nbytes, flops)
        out[name] = dict(
            model=model, KV=KV, G=G, hd=hd, B=B, kv_lens=lens, page=page, max_abs_err=err,
            host_us=host_us(torch, fn), **report, **extra, ms=cuda_ms(torch, fn, flush),
            device_ms=device_ms(torch, fn, flush, "paged_decode_kernel"),
            plain_ms=cuda_ms(torch, plain, flush, iters=5),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask, enable_gqa=True), flush),
            library="sdpa, gathered bf16 view" + (
                " dequantized beforehand" if elem == 1 else ""),
            bound_ms=b_ms, bound_by=b_by)
        del kg, vg
    return out


# The sub-records a page-128 case (kernels A-D and I) adds to its page-16
# record.
PAGE128_KEYS = ("page", "max_abs_err", "ms", "device_ms", "host_us", "work_items",
                "grid_blocks")


def ragged_kernel_cases(torch, np, flush, model, KV, G, hd, names, page=16,
                        spec=RAGGED_SPEC):
    """Kernels B and D (on the same pools quantized) and I (B's function on
    a token grid) against their plain versions on the pack ``spec`` (the
    mixed pack by default) at page size ``page``: {name: record} for
    ``names``, each with the kernel's own report of its launch and the
    same pack in a table WIDE_P pages wide (output equal bit for bit)."""
    import torch.nn.functional as F

    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_q import ragged_paged_attention_q_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
        ragged_paged_attention_tokengrid_cuda)
    from rbg_tpu_torch.ops.paged_attention import gather_kv, quantize_kv
    from rbg_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention_plain

    q, k, v, table, qpos, kv_lens, rows = ragged_case(torch, np, KV, G, hd, spec, page)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    R, S = len(spec), table.shape[1] * page
    qp, pp = padded_queries(torch, q, qpos, rows, R)
    slot = torch.arange(S, device="cuda")
    mask = ((slot[None, None] <= pp[:, :, None])
            & (slot[None, None] < kv_lens[:, None, None]))[:, None]
    qh = qp.permute(0, 2, 1, 3)
    lim = torch.minimum(kv_lens[rows.long()], qpos[0] + 1).clamp(min=0)
    flops = 4 * int(lim.sum()) * KV * G * hd
    row_extent = sum(kv for _, kv in spec)          # each row's pages once
    meta = pages_of([kv for _, kv in spec], page) * 4 + rows.numel() * 8 + R * 4
    out = {}
    for name, elem, fn, plain, kv_pair in (
            ("ragged_paged", 2,
             lambda t=table: ragged_paged_attention_cuda(q, k, v, t, qpos, kv_lens, rows),
             lambda: ragged_paged_attention_plain(q, k, v, table, qpos, kv_lens,
                                                  rows, 64), (k, v)),
            ("ragged_paged_q", 1,
             lambda t=table: ragged_paged_attention_q_cuda(q, k8, v8, ks, vs, t, qpos,
                                                           kv_lens, rows),
             lambda: ragged_paged_attention_plain(q, k8, v8, table, qpos, kv_lens,
                                                  rows, 64, ks, vs), None),
            ("ragged_paged_tokengrid", 2,
             lambda t=table: ragged_paged_attention_tokengrid_cuda(q, k, v, t, qpos,
                                                                   kv_lens, rows),
             lambda: ragged_paged_attention_plain(q, k, v, table, qpos, kv_lens,
                                                  rows, 64), (k, v))):
        if name not in names:
            continue
        err = max_err_checked(torch, f"{name} {model} page {page}", fn(), plain())
        if kv_pair is None:
            kv_pair = ((k8.float() * ks).to(torch.bfloat16),
                       (v8.float() * vs).to(torch.bfloat16))
        kg = gather_kv(kv_pair[0], table).permute(0, 2, 1, 3).contiguous()
        vg = gather_kv(kv_pair[1], table).permute(0, 2, 1, 3).contiguous()
        nbytes = (2 * row_extent * KV * hd * elem + 2 * q.numel() * 2 + meta
                  + (2 * row_extent * KV * 4 if elem == 1 else 0))
        b_ms, b_by = bound(nbytes, flops)
        extra = {"host_us": host_us(torch, fn)}
        # The kernel's own report of its last launch, then the same pack in
        # a wider table: the same items and the same output.
        got = fn()
        extra.update(launch_report(q.device))
        wide = F.pad(table, (0, WIDE_P - table.shape[1]))
        if not torch.equal(fn(wide), got):
            raise AssertionError(f"{name} {model}: output moved with the table width")
        extra["wide_table"] = dict(P=WIDE_P, **launch_report(q.device),
                                   ms=cuda_ms(torch, lambda: fn(wide), flush))
        symbol = ("ragged_paged_tokengrid_kernel" if name == "ragged_paged_tokengrid"
                  else "ragged_paged_kernel")
        out[name] = dict(
            model=model, KV=KV, G=G, hd=hd, T=int(q.shape[1]), rows=spec, page=page, **extra,
            max_abs_err=err, ms=cuda_ms(torch, fn, flush),
            device_ms=device_ms(torch, fn, flush, symbol),
            plain_ms=cuda_ms(torch, plain, flush, iters=5),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask, enable_gqa=True), flush),
            library="sdpa, padded [R, 64] batch on the gathered bf16 view" + (
                " dequantized beforehand" if elem == 1 else ""),
            bound_ms=b_ms, bound_by=b_by)
        del kg, vg
    return out


def gqa_kernel_cases(torch, np, flush, out):
    """Kernels A-D and I at the llama3-8b and qwen2-0.5b shapes (page 16);
    A-D and I also at page 128 on llama3-8b (a page larger than their
    64-slot KV block), as a ``page128`` sub-record."""
    shapes = {"llama3-8b": (8, 4, 128), "qwen2-0.5b": (2, 7, 64)}
    for model, (KV, G, hd) in shapes.items():
        # -- A and C: decode, B=8, kv_len up to 2048; then a B=64 bucket --
        decode = decode_kernel_cases(torch, np, flush, model, KV, G, hd, DECODE_LENS,
                                     wide=True)
        bucket = decode_kernel_cases(torch, np, flush, model, KV, G, hd, BUCKET64_LENS)
        for name, rec in decode.items():
            b = bucket[name]
            rec["bucket64"] = {"B": b["B"], "kv_lens": "64 + 10 i, i < 64",
                               **{k: b[k] for k in (
                                   "max_abs_err", "ms", "device_ms", "library_ms", "bound_ms",
                                   "bound_by", "plain_ms", "host_us", "work_items",
                                   "grid_blocks")}}
        # -- B, D and I (B's function on a token grid): the mixed pack --
        ragged = ragged_kernel_cases(torch, np, flush, model, KV, G, hd,
                                     ("ragged_paged", "ragged_paged_q",
                                      "ragged_paged_tokengrid"))
        recs = {**decode, **ragged}
        if model == "llama3-8b":
            big = {**decode_kernel_cases(torch, np, flush, model, KV, G, hd, DECODE_LENS,
                                         page=128),
                   **ragged_kernel_cases(torch, np, flush, model, KV, G, hd,
                                         ("ragged_paged", "ragged_paged_q",
                                          "ragged_paged_tokengrid"), page=128)}
            for name, rec in big.items():
                recs[name]["page128"] = {k: rec[k] for k in PAGE128_KEYS}
        for name, rec in recs.items():
            out[name].append(rec)
    # A tp 2 rank of llama3-8b: its 4 KV heads, G unchanged.
    model, (KV, G, hd) = "llama3-8b tp 2 rank", (4, 4, 128)
    for name, rec in {**decode_kernel_cases(torch, np, flush, model, KV, G, hd, DECODE_LENS),
                      **ragged_kernel_cases(torch, np, flush, model, KV, G, hd,
                                            ("ragged_paged", "ragged_paged_q"))}.items():
        out[name].append(rec)


def latent_pools(torch, NP, dc, dr, seed, page=16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randn(NP, page, 1, dc, generator=g, device="cuda").to(torch.bfloat16)
    pe = torch.randn(NP, page, 1, dr, generator=g, device="cuda").to(torch.bfloat16)
    return c, pe, g


def mla_kernel_cases(torch, np, flush, out):
    """Kernels E and F, and G and H on the same latent pools quantized, at
    the deepseek-v2-lite and deepseek-v3 shapes. Each also gives host_us,
    the work items and grid its launch reported, and the same case in a
    table WIDE_P pages wide (output equal bit for bit)."""
    import torch.nn.functional as F

    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.paged_mla_decode import paged_mla_decode_attention
    from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
        ragged_paged_mla_attention_q_cuda)
    from rbg_tpu_torch.ops.mla_attention import (_gather, paged_mla_attention_plain,
                                                 ragged_paged_mla_attention_plain)
    from rbg_tpu_torch.ops.paged_attention import quantize_kv

    def dequantized(x8, s):
        return (x8.float() * s).to(torch.bfloat16)

    dc, dr, dn = 512, 64, 128
    scale = (dn + dr) ** -0.5
    for model, H in (("deepseek-v2-lite", 16), ("deepseek-v3", 128),
                     ("deepseek-v2-lite tp 2 rank", 8)):
        # -- E: decode, B=8 --
        lens = DECODE_LENS
        B, P = len(lens), max(-(-n // 16) for n in lens)
        NP = B * P + 1
        c, pe, g = latent_pools(torch, NP, dc, dr, H)
        rng = np.random.RandomState(H)
        table = torch.from_numpy((rng.permutation(NP - 1)[:B * P] + 1)
                                 .reshape(B, P).astype(np.int32)).to("cuda")
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        pos = (kv_lens - 1)[:, None]
        q_lat = torch.randn(B, 1, H, dc, generator=g, device="cuda").to(torch.bfloat16)
        q_pe = torch.randn(B, 1, H, dr, generator=g, device="cuda").to(torch.bfloat16)
        (c8, cs), (pe8, ps) = quantize_kv(c), quantize_kv(pe)
        S, tokens = P * 16, sum(lens)
        qh = torch.cat([q_lat, q_pe], -1).permute(0, 2, 1, 3)        # [B,H,1,576]
        mask = (torch.arange(S, device="cuda")[None, :] < kv_lens[:, None])[:, None, None]
        # E on bf16 latent pools; G on the same pools quantized by quantize_kv.
        for name, elem, fn, plain, view in (
                ("paged_mla_decode", 2,
                 lambda t=table: paged_mla_decode_attention(q_lat, q_pe, c, pe, t, kv_lens,
                                                            scale),
                 lambda: paged_mla_attention_plain(q_lat, q_pe, c, pe, table, pos,
                                                   kv_lens, scale), (c, pe)),
                ("paged_mla_decode_q", 1,
                 lambda t=table: paged_mla_decode_attention_q(q_lat, q_pe, c8, pe8, cs, ps,
                                                              t, kv_lens, scale),
                 lambda: paged_mla_attention_plain(q_lat, q_pe, c8, pe8, table, pos,
                                                   kv_lens, scale, cs, ps), None)):
            got = fn()
            report = launch_report(q_lat.device)
            err = max_err_checked(torch, f"{name} {model}", got, plain())
            wt = F.pad(table, (0, WIDE_P - table.shape[1]))
            if not torch.equal(fn(wt), got):
                raise AssertionError(f"{name} {model}: output moved with the table width")
            wide = dict(P=WIDE_P, **launch_report(q_lat.device),
                        ms=cuda_ms(torch, lambda: fn(wt), flush),
                        device_ms=device_ms(torch, lambda: fn(wt), flush,
                                            "paged_mla_decode_kernel"))
            if view is None:        # SDPA on the view dequantized to bf16 beforehand
                view = (dequantized(c8, cs), dequantized(pe8, ps))
            kg = torch.cat([_gather(view[0], table), _gather(view[1], table)], -1)[:, None]
            vg = _gather(view[0], table)[:, None]                    # [B,1,S,dc]
            nbytes = (tokens * (dc + dr) * elem + B * H * (2 * dc + dr) * 2
                      + pages_of(lens) * 4 + B * 4 + (tokens * 8 if elem == 1 else 0))
            b_ms, b_by = bound(nbytes, tokens * H * (4 * dc + 2 * dr))
            out[name].append(dict(
                model=model, H=H, dc=dc, dr=dr, B=B, kv_lens=lens, max_abs_err=err,
                host_us=host_us(torch, fn), **report, wide_table=wide,
                ms=cuda_ms(torch, fn, flush),
                device_ms=device_ms(torch, fn, flush, "paged_mla_decode_kernel"),
                plain_ms=cuda_ms(torch, plain, flush, iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), flush),
                library="sdpa, q=[q_lat|q_pe], k=[c|pe], v=c on the gathered view" + (
                    " dequantized to bf16 beforehand" if elem == 1 else ""),
                bound_ms=b_ms, bound_by=b_by))
            del kg, vg

        # -- F: the mixed pack --
        spec = RAGGED_SPEC
        R, P = len(spec), max(-(-kv // 16) for _, kv in spec)
        NP = R * P + 1
        c, pe, g = latent_pools(torch, NP, dc, dr, 1000 + H)
        table = torch.from_numpy((rng.permutation(NP - 1)[:R * P] + 1)
                                 .reshape(R, P).astype(np.int32)).to("cuda")
        qpos, kv_lens, rows = pack_rows(torch, spec)
        T = rows.numel()
        q_lat = torch.randn(1, T, H, dc, generator=g, device="cuda").to(torch.bfloat16)
        q_pe = torch.randn(1, T, H, dr, generator=g, device="cuda").to(torch.bfloat16)
        (c8, cs), (pe8, ps) = quantize_kv(c), quantize_kv(pe)
        S = P * 16
        qp, pp = padded_queries(torch, torch.cat([q_lat, q_pe], -1), qpos, rows, R)
        slot = torch.arange(S, device="cuda")
        mask = ((slot[None, None] <= pp[:, :, None])
                & (slot[None, None] < kv_lens[:, None, None]))[:, None]
        qh = qp.permute(0, 2, 1, 3)
        lim = torch.minimum(kv_lens[rows.long()], qpos[0] + 1).clamp(min=0)
        row_extent = sum(kv for _, kv in spec)
        # F on bf16 latent pools; H on the same pools quantized by quantize_kv.
        for name, elem, fn, plain, view in (
                ("ragged_paged_mla", 2,
                 lambda t=table: ragged_paged_mla_attention_cuda(q_lat, q_pe, c, pe, t, qpos,
                                                                 kv_lens, rows, scale),
                 lambda: ragged_paged_mla_attention_plain(q_lat, q_pe, c, pe, table,
                                                          qpos, kv_lens, rows, scale,
                                                          max_q_len=64), (c, pe)),
                ("ragged_paged_mla_q", 1,
                 lambda t=table: ragged_paged_mla_attention_q_cuda(q_lat, q_pe, c8, pe8, cs,
                                                                   ps, t, qpos, kv_lens,
                                                                   rows, scale),
                 lambda: ragged_paged_mla_attention_plain(q_lat, q_pe, c8, pe8, table,
                                                          qpos, kv_lens, rows, scale, cs,
                                                          ps, max_q_len=64), None)):
            got = fn()
            report = launch_report(q_lat.device)
            err = max_err_checked(torch, f"{name} {model}", got, plain())
            wt = F.pad(table, (0, WIDE_P - table.shape[1]))
            if not torch.equal(fn(wt), got):
                raise AssertionError(f"{name} {model}: output moved with the table width")
            wide = dict(P=WIDE_P, **launch_report(q_lat.device),
                        ms=cuda_ms(torch, lambda: fn(wt), flush),
                        device_ms=device_ms(torch, lambda: fn(wt), flush,
                                            "ragged_paged_mla_kernel"))
            if view is None:        # SDPA on the view dequantized to bf16 beforehand
                view = (dequantized(c8, cs), dequantized(pe8, ps))
            kg = torch.cat([_gather(view[0], table), _gather(view[1], table)], -1)[:, None]
            vg = _gather(view[0], table)[:, None]
            nbytes = (row_extent * (dc + dr) * elem + T * H * (2 * dc + dr) * 2
                      + pages_of([kv for _, kv in spec]) * 4 + T * 8 + R * 4
                      + (row_extent * 8 if elem == 1 else 0))
            b_ms, b_by = bound(nbytes, int(lim.sum()) * H * (4 * dc + 2 * dr))
            out[name].append(dict(
                model=model, H=H, dc=dc, dr=dr, T=T, rows=spec, max_abs_err=err,
                host_us=host_us(torch, fn), **report, wide_table=wide,
                ms=cuda_ms(torch, fn, flush),
                device_ms=device_ms(torch, fn, flush, "ragged_paged_mla_kernel"),
                plain_ms=cuda_ms(torch, plain, flush, iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), flush),
                library="sdpa, padded [R, 64] batch, q=[q_lat|q_pe], k=[c|pe], v=c" + (
                    " dequantized to bf16 beforehand" if elem == 1 else ""),
                bound_ms=b_ms, bound_by=b_by))
            del kg, vg
        del qp


def kernels_phase(torch, np):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {k: [] for k in (LLAMA_KERNELS + INT8_KERNELS + MLA_KERNELS
                           + MLA_INT8_KERNELS + PROBE_KERNELS)}
    gqa_kernel_cases(torch, np, flush, out)
    mla_kernel_cases(torch, np, flush, out)
    torch.cuda.empty_cache()
    for name, rs in out.items():
        emit("kernels", kernel=name, tolerance=f"|d| <= {KERNEL_RTOL}*|ref| + "
             f"{KERNEL_ATOL} (f32 accumulation, one bf16 rounding of the output)",
             shapes=rs)
    return out


# ---- phases 4 and 5: the engines at full width and depth ----

class _Float32Layers:
    """A stacked weight whose layer ``l`` is cast to float32 when indexed:
    a full-depth float32 forward holds one layer in float32 at a time."""

    def __init__(self, w):
        self.w = w

    def __getitem__(self, l):
        return self.w[l].float()


def float32_params(params):
    return {"blocks": {k: _Float32Layers(w) for k, w in params["blocks"].items()},
            **{k: w.float() for k, w in params.items() if k != "blocks"}}


def logit_stats(a, b):
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean()),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


def per_draw_ratios(kernel, control, ref, draws):
    """The control ratio of each of ``draws`` equal runs of compared tokens
    (a reading of the judged ratio's spread, not a check)."""
    return [float((k - r).abs().mean() / (c - r).abs().mean())
            for k, c, r in zip(kernel.chunk(draws), control.chunk(draws), ref.chunk(draws))]


def compare_paths(torch, params, model, kv_dtype, run, phase, tokens, draws=1):
    """A witness's judgment: ``run(params, cfg, quantize)`` gives the
    kernel path's and the plain path's logits of the compared steps, each on
    a pool of its own that the same context wrote. The float32 runs use the
    same weights cast to float32 one layer at a time. With ``draws`` > 1
    the compared tokens are that many equal runs, whose own control ratios
    are recorded beside the judged one.

    Model-dtype pools. float32: kernel and plain differ only in summation
    order, so their logits must agree within F32_LOGIT_ATOL (MoE models:
    see MOE_F32_SHARE); a wrong mask, page or head mapping moves them by
    the order of their spread. bfloat16 (the served dtype): the kernel path
    must be as close to the float32 plain logits as the bfloat16 plain path
    is (the control): mean |bf16 - f32| of the kernel path <=
    BF16_VS_CONTROL x the plain path's.
    int8 pools: in float32 and in bfloat16, the int8 kernel path's mean
    distance from the float32 plain logits on a model-dtype pool must be at
    most INT8_VS_CONTROL x the int8 plain path's."""
    from rbg_tpu_torch.models.config import get_config

    cfg16 = get_config(model)
    p32, cfg32 = float32_params(params), get_config(model, dtype="float32")
    res = {}
    if kv_dtype == "model":
        k16, p16 = run(params, cfg16, False)
        k32, r32 = run(p32, cfg32, False)
        res.update({"f32_kernel_vs_plain": logit_stats(k32, r32),
                    "bf16_kernel_vs_plain": logit_stats(k16, p16),
                    "bf16_kernel_vs_f32": logit_stats(k16, r32),
                    "bf16_plain_vs_f32 (control)": logit_stats(p16, r32)})
        ratio = res["bf16_kernel_vs_f32"]["mean"] / res["bf16_plain_vs_f32 (control)"]["mean"]
        res["bf16_mean_ratio_to_control"] = ratio
        if draws > 1:
            res["bf16_ratio_per_draw"] = per_draw_ratios(k16, p16, r32, draws)
        tok_max = (k32 - r32).abs().amax(-1)
        if cfg16.num_experts:
            share = float((tok_max <= F32_LOGIT_ATOL).float().mean())
            res["f32_share_within_atol"] = share
            f32_ok = (share >= MOE_F32_SHARE and float(tok_max.max())
                      <= MOE_F32_STD_FRAC * float(r32.std()))
            limit = (f32_ok, f"f32: >= {MOE_F32_SHARE} of tokens max |d| <= "
                     f"{F32_LOGIT_ATOL}, every token <= {MOE_F32_STD_FRAC} x logit std")
        else:
            f32_ok = float(tok_max.max()) <= F32_LOGIT_ATOL
            limit = (f32_ok, f"f32 max |d| <= {F32_LOGIT_ATOL}")
        ok = limit[0] and ratio <= BF16_VS_CONTROL
        tol = f"{limit[1]}; bf16 mean |d vs f32| <= {BF16_VS_CONTROL} x control's"
        tensors = (k16, p16, k32, r32)
    else:
        k8_16, p8_16 = run(params, cfg16, True)
        k8_32, p8_32 = run(p32, cfg32, True)
        _, r32 = run(p32, cfg32, False)
        res.update({"f32_int8_kernel_vs_plain": logit_stats(k8_32, p8_32),
                    "bf16_int8_kernel_vs_plain": logit_stats(k8_16, p8_16),
                    "f32_int8_kernel_vs_f32": logit_stats(k8_32, r32),
                    "f32_int8_plain_vs_f32 (control)": logit_stats(p8_32, r32),
                    "bf16_int8_kernel_vs_f32": logit_stats(k8_16, r32),
                    "bf16_int8_plain_vs_f32 (control)": logit_stats(p8_16, r32)})
        r_32 = (res["f32_int8_kernel_vs_f32"]["mean"]
                / res["f32_int8_plain_vs_f32 (control)"]["mean"])
        r_16 = (res["bf16_int8_kernel_vs_f32"]["mean"]
                / res["bf16_int8_plain_vs_f32 (control)"]["mean"])
        res.update(f32_mean_ratio_to_control=r_32, bf16_mean_ratio_to_control=r_16)
        if draws > 1:
            res["bf16_ratio_per_draw"] = per_draw_ratios(k8_16, p8_16, r32, draws)
        ok = r_32 <= INT8_VS_CONTROL and r_16 <= INT8_VS_CONTROL
        tol = (f"f32 and bf16: int8 kernel mean |d vs f32 model-dtype pool| <= "
               f"{INT8_VS_CONTROL} x the int8 plain path's")
        tensors = (k8_16, p8_16, k8_32, p8_32, r32)
    del p32
    torch.cuda.empty_cache()
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    res.update(logit_std_f32=float(r32.std()), logit_absmax_f32=float(r32.abs().max()))
    emit(phase, model=model, kv_dtype=kv_dtype, layers=cfg16.num_layers,
         tokens=tokens, tolerance=tol, **res)
    if not (finite and ok):
        raise AssertionError(f"{phase}: kernels vs plain ({model}, {kv_dtype}): {res}")


def ragged_compare(torch, np, params, model, kv_dtype="model", dev="cuda"):
    """forward_ragged with kernels against use_kernels='never' on the same
    pool, at full width and depth: a decode row and a 64-token prefill chunk
    over context that an earlier kernel call wrote. Limits: compare_paths."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_ragged

    V = get_config(model).vocab_size
    rng = np.random.RandomState(5)
    table = torch.zeros(2, 11, dtype=torch.int32, device=dev)
    table[0, :5] = torch.arange(1, 6)            # row 0: 65 slots
    table[1, :11] = torch.arange(6, 17)          # row 1: 164 slots

    def pack(parts, T):
        rows, pos = [], []
        for r, (lo, hi) in enumerate(parts):
            rows += [r] * (hi - lo)
            pos += list(range(lo, hi))
        n = len(rows)
        rows += [0] * (T - n)
        pos += [-1] * (T - n)
        tok = torch.from_numpy(rng.randint(0, V, (1, T))).to(dev)
        pos = torch.tensor([pos], dtype=torch.int32, device=dev)
        return (tok, pos, pos >= 0, torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor([hi for _, hi in parts], dtype=torch.int32, device=dev))

    context = pack([(0, 64), (0, 100)], 256)
    step = pack([(64, 65), (100, 164)], 128)
    mask = step[2][0]

    def run(p, cfg, quantize):
        """(kernel logits, plain logits) of the compared step, real tokens."""
        c = PagedKVCache.create(cfg, 17, 16, device=dev, quantize=quantize)
        pools = (c.k_pages, c.v_pages)
        kw = dict(k_scales=c.k_scales, v_scales=c.v_scales)
        forward_ragged(p, cfg, *context, table, *pools, **kw)
        lk = forward_ragged(p, cfg, *step, table, *pools, max_q_len=64, **kw)
        lp = forward_ragged(p, cfg, *step, table, *pools, use_kernels="never",
                            max_q_len=64, **kw)
        return lk[0][mask], lp[0][mask]

    compare_paths(torch, params, model, kv_dtype, run, "ragged_compare", int(mask.sum()))


# The decode witness's rows: their context lengths before the compared
# step. At B = 3 the first two walks split 9 and 12 ways on llama3-8b
# (kernels A, C), 16 and 16 ways on deepseek-v2-lite (E, G). The step is
# taken DECODE_WITNESS_DRAWS times from the same context, each time with
# other random tokens, so the bf16 halves' mean distances are taken over
# 3 x 16 tokens: one step's 3 tokens put the control ratio of an MoE
# model anywhere in a wide spread (each draw's own ratio is recorded).
DECODE_WITNESS_LENS = [1100, 1500, 65]
DECODE_WITNESS_DRAWS = 16


def decode_compare(torch, np, params, model, kv_dtype="model", dev="cuda"):
    """forward_paged (one decode step: kernel A, or C on int8 pools; E or G
    on MLA latent pools) with
    kernels against use_kernels='never' on the same pool, at full width and
    depth, over context that an earlier forward_ragged call wrote: rows of
    DECODE_WITNESS_LENS slots, long enough that their walks split. Limits:
    compare_paths."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_paged, forward_ragged

    V = get_config(model).vocab_size
    rng = np.random.RandomState(6)
    lens = DECODE_WITNESS_LENS
    pages = [-(-(n + 1) // 16) for n in lens]
    table = torch.zeros(len(lens), max(pages), dtype=torch.int32, device=dev)
    for r, n in enumerate(pages):
        table[r, :n] = torch.arange(1 + sum(pages[:r]), 1 + sum(pages[:r + 1]))

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    rows = ints([r for r, n in enumerate(lens) for _ in range(n)])
    pos = ints([[i for n in lens for i in range(n)]])
    context = (torch.from_numpy(rng.randint(0, V, (1, rows.numel()))).to(dev), pos,
               pos >= 0, rows, ints(lens))
    pos = ints([[n] for n in lens])
    steps = [(torch.from_numpy(rng.randint(0, V, (len(lens), 1))).to(dev), pos, pos >= 0,
              ints([n + 1 for n in lens])) for _ in range(DECODE_WITNESS_DRAWS)]

    def run(p, cfg, quantize):
        """(kernel logits, plain logits) of the decode steps, [draws x B, V]:
        each step writes its token's slot before it reads it, so every draw
        sees the same context."""
        c = PagedKVCache.create(cfg, 1 + sum(pages), 16, device=dev, quantize=quantize)
        pools = (c.k_pages, c.v_pages)
        kw = dict(k_scales=c.k_scales, v_scales=c.v_scales)
        forward_ragged(p, cfg, *context, table, *pools, **kw)
        lk, lp = [], []
        for step in steps:
            lk.append(forward_paged(p, cfg, *step, table, *pools, **kw)[:, 0])
            lp.append(forward_paged(p, cfg, *step, table, *pools, use_kernels="never",
                                    **kw)[:, 0])
        return torch.cat(lk), torch.cat(lp)

    compare_paths(torch, params, model, kv_dtype, run, "decode_compare",
                  len(lens) * DECODE_WITNESS_DRAWS, draws=DECODE_WITNESS_DRAWS)


# The T > 1 witness's rows: context slots before the compared [8, 64]
# block, and the block's real tokens in each row (pads after them): full
# prefill chunks, a chunk's tail, verify-shaped rows and a row of pads only.
BLOCK_CONTEXT = [0, 64, 130, 300, 17, 500, 1000, 0]
BLOCK_REAL = [64, 64, 50, 5, 64, 2, 64, 0]


def block_compare(torch, np, params, model, kv_dtype="model", dev="cuda"):
    """forward_paged over an [8, 64] block with pads (the split prefill's
    and the verify's shape; kernel B, D on int8 pools, F, H for MLA) with
    kernels against use_kernels='never' on the same pool, at full width and
    depth, over context that an earlier forward_ragged call wrote. Pads
    come at position 0 as the engine builds them. Limits: compare_paths."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_paged, forward_ragged

    V = get_config(model).vocab_size
    rng = np.random.RandomState(8)
    B, T = len(BLOCK_CONTEXT), 64
    pages = [-(-(c + T) // 16) for c in BLOCK_CONTEXT]
    table = torch.zeros(B, max(pages), dtype=torch.int32, device=dev)
    for r, n in enumerate(pages):
        table[r, :n] = torch.arange(1 + sum(pages[:r]), 1 + sum(pages[:r + 1]))

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    rows = ints([r for r, n in enumerate(BLOCK_CONTEXT) for _ in range(n)])
    pos = ints([[i for n in BLOCK_CONTEXT for i in range(n)]])
    context = (torch.from_numpy(rng.randint(0, V, (1, rows.numel()))).to(dev), pos,
               pos >= 0, rows, ints(BLOCK_CONTEXT))
    real = torch.arange(T, device=dev)[None] < ints(BLOCK_REAL)[:, None]
    bpos = torch.where(real, ints(BLOCK_CONTEXT)[:, None] + torch.arange(T, device=dev), 0)
    step = (torch.from_numpy(rng.randint(0, V, (B, T))).to(dev), bpos.to(torch.int32), real,
            ints([c + n for c, n in zip(BLOCK_CONTEXT, BLOCK_REAL)]))

    def run(p, cfg, quantize):
        """(kernel logits, plain logits) of the block's real tokens."""
        c = PagedKVCache.create(cfg, 1 + sum(pages), 16, device=dev, quantize=quantize)
        pools = (c.k_pages, c.v_pages)
        kw = dict(k_scales=c.k_scales, v_scales=c.v_scales)
        forward_ragged(p, cfg, *context, table, *pools, **kw)
        lk = forward_paged(p, cfg, *step, table, *pools, **kw)[real]
        lp = forward_paged(p, cfg, *step, table, *pools, use_kernels="never", **kw)[real]
        return lk, lp

    compare_paths(torch, params, model, kv_dtype, run, "block_compare", int(real.sum()))


def split_phase(torch, np, params, model, kernels, kv_dtype="model"):
    """Engine with ragged="off" (the split path): two requests admitted
    together (100 and 120 prompt tokens: two [2, 64] prefill steps, kernel
    B or D), then decode windows (A or C) for both rows to the end, at
    multi_step 1 and 4. Both rows decode in one batch throughout, so the
    two runs take the same forwards and their greedy tokens must be equal;
    no unified step is taken."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    V = params["embed"].shape[0]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, V, n).tolist() for n in (100, 120)]
    runs = {}
    for ms in (1, 4):
        eng = Engine(EngineConfig(model=model, num_pages=2048, max_seq_len=2048,
                                  multi_step=ms, kv_dtype=kv_dtype, ragged="off"),
                     params=params)
        reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, SamplingParams(max_new_tokens=16))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check_launches(launches, kernels)
        m = dict(eng.metrics)
        runs[ms] = toks
        emit("split", model=model, kv_dtype=kv_dtype, multi_step=ms, tokens=toks,
             wall_s=wall, launches={k: launches[k] for k in kernels},
             steps=m["steps"], unified_steps=m["unified_steps"],
             decode_windows=m["decode_windows"])
        if m["unified_steps"] or [len(t) for t in toks] != [16, 16]:
            raise AssertionError(f"split path ({kv_dtype}, multi_step {ms}): {m} {toks}")
        del eng
        torch.cuda.empty_cache()
    if runs[1] != runs[4]:
        raise AssertionError(f"split path ({kv_dtype}): multi_step 1 {runs[1]} vs 4 {runs[4]}")


# The speculative streams at llama3-8b are judged token by token against
# a float32 forward of the same stream: each token must be the float32
# choice up to this band of logit (sampled: of logit / temperature plus the
# same Gumbel noise). About twice the largest bfloat16-vs-float32 logit
# distance the block witness reads at llama3-8b (0.42-0.45); a token that
# is not the path's choice at its position (an unverified draft, a sample
# taken at another position's key) lies ~4 logit std below the best.
SPEC_LOGIT_BAND = 1.0
# The tp phase's first step (a 64-token prefill chunk): tp 2 and the
# unsharded engine are two bfloat16 paths (the ranks' partial sums meet in a
# bfloat16 all-reduce), each within ~0.45 logit of float32 at llama3-8b (the
# block witness), so within this band of each other at every logit of every
# token whose computation is the same on both: every token of a dense
# model, every token of a MoE model whose kept experts (the router's mask,
# recorded by ``moe_masks``) agree in every layer, and every token of a MoE
# model when the unsharded engine is made to keep tp's experts
# (``moe_masks(force=...)``): a wrong head, page or reduce in tp fails it
# there. On the mean both stay within BF16_VS_CONTROL x the unsharded
# engine's distance from the float32 forward (every model). Unforced, a
# MoE token whose mask differs in some layer runs another expert there and
# is held to no band of its own; but a fault that moves most tokens past
# the band fails TP_MOE_MOST_PAST (at most half the tokens past it).
TP_FIRST_BAND = SPEC_LOGIT_BAND
TP_MOE_MOST_PAST = 0.5
# Two bfloat16 paths without tp, read against the unsharded engine's first
# step (how often the MoE router swaps experts without tp):
# first_step_logits's options for each.
TP_MOE_CONTROLS = {"chunks_of_16": {"chunk": 16}, "plain_attention": {"use_kernels": "never"}}


def f32_logits(torch, params, model, seq, kv_dtype="model", dev="cuda"):
    """Logits [len(seq), V] of one float32 forward over ``seq`` (the weights
    cast to float32 one layer at a time) on a pool of ``kv_dtype``."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_ragged

    cfg = get_config(model, dtype="float32")
    n = len(seq)
    pages = -(-n // 16)
    c = PagedKVCache.create(cfg, pages + 1, 16, device=dev, quantize=kv_dtype == "int8")
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    pos = ints([list(range(n))])
    return forward_ragged(float32_params(params), cfg, torch.tensor([seq], device=dev),
                          pos, pos >= 0, ints([0] * n), ints([n]),
                          ints([list(range(1, pages + 1))]), c.k_pages, c.v_pages,
                          k_scales=c.k_scales, v_scales=c.v_scales)[0]


def stream_judge(torch, params, model, prompt, tokens, sp, dev="cuda"):
    """Whether every output token of ``tokens`` (a greedy or seeded sampled
    stream of ``prompt``) is within SPEC_LOGIT_BAND of the float32 choice
    at its position (the weights cast to float32 one layer at a time), and
    the smallest margin."""
    lg = f32_logits(torch, params, model, prompt + tokens[:-1], dev=dev)
    return judge(torch, lg[len(prompt) - 1:], len(prompt), tokens, sp, dev)


def judge(torch, lg, P0, tokens, sp, dev="cuda"):
    """``stream_judge`` on float32 logits ``lg`` [len(tokens), V], row t the
    logits that choose output token t (at position P0 + t)."""
    from rbg_tpu_torch.engine.sampler import gumbel_noise, row_keys

    tok = torch.tensor(tokens, device=dev)[:, None]
    band = SPEC_LOGIT_BAND
    if sp.temperature > 0:
        # A seeded row's key is key(seed); output token t samples at
        # position len(prompt) + t.
        keys = row_keys([sp.seed] * len(tokens), 0, [0] * len(tokens), dev)
        noise = gumbel_noise(keys, torch.arange(P0, P0 + len(tokens), device=dev),
                             lg.shape[-1])
        band = band / sp.temperature
        scaled = lg / sp.temperature
        kth = torch.topk(scaled, sp.top_k, dim=-1).values[:, -1:]
        if bool((scaled.gather(1, tok) < kth - band).any()):
            return False, float("-inf")             # outside the top-k set
        # The competitors: tokens in the top-k set beyond the band's doubt
        # (a token near the k-th value may be in one path's set and not in
        # the other's, and its noise then decides nothing).
        best = torch.where(scaled >= kth + band, scaled + noise,
                           torch.tensor(float("-inf"), device=dev)).amax(-1, keepdim=True)
        margin = ((scaled + noise).gather(1, tok) - best)[:, 0]
        return bool((margin >= -band).all()), float(margin.min())
    margin = (lg.gather(1, tok) - lg.amax(-1, keepdim=True))[:, 0]
    return bool((margin >= -band).all()), float(margin.min())


def spec_phase(torch, np, params, model):
    """speculative="ngram" (spec_k 4) against speculative="off", both
    multi_step 1, greedy and seeded sampled (temperature 0.9, top_k 40).
    tiny (float32) on the card, on weights drawn on the CPU: the
    speculative streams equal the non-speculative ones and the CPU port's,
    with drafts accepted (greedy). ``model`` (bf16) on two requests: any two bf16
    paths pick another token at ~10-15% of positions (the block witness's
    argmax agreement), and the verify (kernel B at T = 5) is another path
    than the decode (kernel A), so each stream is judged token by token
    against a float32 forward of itself (``stream_judge``); equality and
    the first difference are printed, with drafts and acceptance."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    samplings = (("greedy", SamplingParams(max_new_tokens=32)),
                 ("sampled", SamplingParams(max_new_tokens=32, temperature=0.9,
                                            top_k=40, seed=5)))
    tiny = init_params(get_config("tiny"), 0, "cpu")
    rng = np.random.RandomState(12)
    prompts = [[1, 2, 3, 4] * 6, rng.randint(0, 256, 30).tolist()]
    for label, sp in samplings:
        runs = {}
        for mode, dev in (("off", "cuda"), ("ngram", "cuda"), ("ngram", "cpu")):
            eng = Engine(EngineConfig(model="tiny", num_pages=256, max_seq_len=256,
                                      speculative=mode, device=dev),
                         params=tiny if dev == "cpu" else params_to(tiny, "cuda"))
            runs[mode, dev] = (eng.generate(prompts, sp), dict(eng.metrics))
        (got, m), want = runs["ngram", "cuda"], runs["off", "cuda"][0]
        emit("spec", model="tiny", sampling=label, tokens=got, equal_to_non_spec=got == want,
             equal_to_cpu=got == runs["ngram", "cpu"][0], spec_steps=m["spec_steps"],
             drafted=m["spec_drafted"], accepted=m["spec_accepted"])
        if got != want or got != runs["ngram", "cpu"][0] or (
                label == "greedy" and m["spec_accepted"] == 0):
            raise AssertionError(f"tiny spec ({label}): {got} vs non-spec {want}, "
                                 f"cpu {runs['ngram', 'cpu'][0]}, {m}")

    V = params["embed"].shape[0]
    seg = rng.randint(0, V, 16).tolist()
    prompts = [seg * 6, rng.randint(0, V, 90).tolist()]
    for label, sp in samplings:
        out = {}
        for mode in ("off", "ngram"):
            eng = Engine(EngineConfig(model=model, num_pages=2048, max_seq_len=2048,
                                      speculative=mode), params=params)
            reset_launches()
            t0 = time.perf_counter()
            toks = eng.generate(prompts, sp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            judged = [stream_judge(torch, params, model, p, t, sp)
                      for p, t in zip(prompts, toks)]
            out[mode] = (toks, wall, dict(eng.metrics), dict(LAUNCHES), judged)
            del eng
            torch.cuda.empty_cache()
        # The judge's own check: each stream shifted by one token (every
        # token judged at the next position) must leave the band.
        planted = [stream_judge(torch, params, model, p, t[:1] + t[:-1], sp)
                   for p, t in zip(prompts, out["off"][0])]
        (toks, _, m, launches, judged), plain = out["ngram"], out["off"][0]
        emit("spec", model=model, sampling=label, tokens=toks,
             equal_to_non_spec=toks == plain,
             first_difference=[next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                               for a, b in zip(toks, plain)],
             band=SPEC_LOGIT_BAND,
             judged={k: [{"ok": ok, "min_margin": mg} for ok, mg in v[4]]
                     for k, v in out.items()},
             planted_shift=[{"ok": ok, "min_margin": mg} for ok, mg in planted],
             wall_s={k: v[1] for k, v in out.items()}, spec_steps=m["spec_steps"],
             drafted=m["spec_drafted"], accepted=m["spec_accepted"],
             acceptance=m["spec_accepted"] / max(1, m["spec_drafted"]),
             launches={k: launches[k] for k in LLAMA_KERNELS})
        if launches["ragged_paged"] == 0 or launches["paged_decode"] or m["spec_steps"] == 0:
            raise AssertionError(f"spec ({label}): the verify did not go through kernel B "
                                 f"alone: {launches} {m}")
        if any(ok for ok, _ in planted):
            raise AssertionError(f"spec ({label}): the judge passed a shifted stream: "
                                 f"{planted}")
        if not all(ok for v in out.values() for ok, _ in v[4]) or \
                [len(t) for t in toks] != [32, 32]:
            raise AssertionError(f"spec ({label}): a stream left the float32 band: "
                                 f"{[(k, v[4]) for k, v in out.items()]}")


def lora_phase(torch, np, params, model, card):
    """Two rank-16 adapters on all seven targets, drawn from a seed and
    written to .npz files, loaded by the port's server flags (``--lora
    NAME=PATH``) into a server in this process on the same weights: a base
    request alone gives the tokens of an engine without adapters, then
    adapter a, adapter b and a base request on one prompt decode in one
    batch, each row's tokens differing from the others'; an unknown
    adapter gets an error reply."""
    from concurrent.futures import ThreadPoolExecutor

    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import (build_config, lora_specs, parse_args,
                                             start_server)
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    blocks, V = params["blocks"], params["embed"].shape[0]
    L = blocks["wq"].shape[0]
    prompt = np.random.RandomState(13).randint(0, V, 80).tolist()
    with tempfile.TemporaryDirectory() as tmp:
        flags = []
        for i, name in enumerate(("a", "b")):
            g = np.random.default_rng(20 + i)
            arrays = {}
            for t in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                arrays[f"{t}.A"] = g.normal(size=(L, blocks[t].shape[1], 16)).astype(
                    np.float32) * 0.05
                arrays[f"{t}.B"] = g.normal(size=(L, 16, blocks[t].shape[2])).astype(
                    np.float32) * 0.05
            path = os.path.join(tmp, f"{name}.npz")
            np.savez(path, alpha=np.float32(32.0), **arrays)
            flags += ["--lora", f"{name}={path}"]
        args = parse_args(["--model", model, "--num-pages", "2048", "--max-seq-len", "2048",
                           "--multi-step", "4", *flags])
        cfg = build_config(args)
        svc = EngineService(cfg, params=params, lora=lora_specs(args.lora))
    want_base = Engine(cfg, params=params).generate([prompt], SamplingParams(
        max_new_tokens=16))[0]
    srv = start_server(svc)
    try:
        msg = {"op": "generate", "prompt": prompt, "max_new_tokens": 16}
        base = request_obj(srv.addr, msg, timeout=300)
        reset_launches()
        with ThreadPoolExecutor(3) as ex:
            mixed = list(ex.map(lambda n: request_obj(
                srv.addr, {**msg, **({"lora": n} if n else {})}, timeout=300),
                ("a", "b", None)))
        launches = dict(LAUNCHES)
        bad = request_obj(srv.addr, {**msg, "lora": "nope"}, timeout=60)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()
    toks = [r.get("tokens") for r in mixed]
    emit("lora", card=card, model=model, rank=16, adapters=["a", "b"],
         base_alone=base.get("tokens"), base_without_adapters=want_base,
         mixed={"a": toks[0], "b": toks[1], "base": toks[2]}, unknown_reply=bad,
         launches={k: launches[k] for k in LLAMA_KERNELS})
    check_launches(launches, LLAMA_KERNELS)
    if (base.get("tokens") != want_base or any(t is None or len(t) != 16 for t in toks)
            or len({tuple(t) for t in toks}) != 3 or "unknown LoRA" not in bad.get("error", "")):
        raise AssertionError(f"lora phase: base {base} vs {want_base}, mixed {mixed}, "
                             f"unknown {bad}")


# ---- grammar-constrained decoding and the OpenAI front end ----

# A bounded schema (an enum field and an integer field; 33 table states at
# the byte tokenizer) and one over GRAMMAR_BUDGET (55 states): the first
# decodes inside the fused window, the second through the K = 0 verify.
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "state": {"enum": ["on", "off", "idle"]},
    "id": {"type": "integer"},
}}
GRAMMAR_BIG_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 2},
    "n": {"type": "number"},
}}
GRAMMAR_REGEX = r"[0-9]{3}-[0-9]{4}"
GRAMMAR_BUDGET = 40
GRAMMAR_STEPS = 12               # decode steps timed per case and turn


def grammar_rows(SamplingParams, eos):
    """The grammar phase's batch of 8: two regex rows, two bounded-schema
    rows, a json_mode row, an over-budget schema row, two free rows;
    greedy and seeded."""
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    enc = lambda s: ByteTokenizer().encode(s, add_bos=False)  # noqa: E731
    hot = dict(temperature=0.9, top_k=40)
    return [
        (enc("Call "), SamplingParams(max_new_tokens=16, regex=GRAMMAR_REGEX, stop_token=eos)),
        (enc("Fax "), SamplingParams(max_new_tokens=16, regex=GRAMMAR_REGEX, seed=3,
                                     stop_token=eos, **hot)),
        (enc("Device: "), SamplingParams(max_new_tokens=48, json_schema=GRAMMAR_SCHEMA,
                                         stop_token=eos)),
        (enc("Lamp: "), SamplingParams(max_new_tokens=48, json_schema=GRAMMAR_SCHEMA,
                                       seed=4, stop_token=eos, **hot)),
        (enc("JSON: "), SamplingParams(max_new_tokens=24, json_mode=True, stop_token=eos)),
        (enc("Tags: "), SamplingParams(max_new_tokens=32, json_schema=GRAMMAR_BIG_SCHEMA,
                                       seed=5, stop_token=eos, **hot)),
        (enc("Once upon a time"), SamplingParams(max_new_tokens=20)),
        (enc("The weather"), SamplingParams(max_new_tokens=20, seed=6, **hot)),
    ]


def grammar_engine(params, model, dev, **kw):
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = dict(model=model, num_pages=512, max_seq_len=1024, decode_buckets=(8,),
               device=dev)
    eng = Engine(EngineConfig(**{**cfg, **kw}), params=params)
    eng.enable_json_grammar(ByteTokenizer())
    return eng


def run_rows(eng, rows):
    ids = [eng.add_request(p, sp) for p, sp in rows]
    out = {i: [] for i in ids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append(ev.token)
    return [out[i] for i in ids]


def check_grammar_rows(eng, rows, streams, eos):
    """Every constrained token legal under the port's grammar (EOS only at
    an accepting state); regex rows ending on EOS fullmatch, schema rows
    ending on EOS parse and conform. Returns each row's text and whether
    it finished on EOS."""
    import re

    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    out = []
    for (_, sp), toks in zip(rows, streams):
        g = eng._grammar_for(sp)
        ended = bool(toks) and toks[-1] == eos
        text = tok.decode(toks[:-1] if ended else toks)
        out.append({"text": text, "eos": ended, "n": len(toks)})
        if g is None:
            continue
        s = g.initial()
        for i, t in enumerate(toks):
            if t == eos:
                if not (g.grammar.is_complete(s) and i == len(toks) - 1):
                    raise AssertionError(f"grammar: EOS at a non-accepting state: {sp} {toks}")
                continue
            s = g.advance_token(s, t)
            if s is None:
                raise AssertionError(f"grammar: token {i} ({t}) illegal: {sp} {toks}")
        if not ended:
            continue
        if sp.regex is not None and not re.fullmatch(sp.regex, text):
            raise AssertionError(f"grammar: {text!r} does not fullmatch {sp.regex!r}")
        if sp.json_schema is not None or sp.json_mode:
            doc = json.loads(text)
            if sp.json_schema == GRAMMAR_SCHEMA and not (
                    list(doc) == ["state", "id"] and doc["state"] in ("on", "off", "idle")
                    and isinstance(doc["id"], int)):
                raise AssertionError(f"grammar: {doc} does not conform")
            if sp.json_schema == GRAMMAR_BIG_SCHEMA and not (
                    list(doc) == ["ok", "tags", "n"] and isinstance(doc["ok"], bool)
                    and len(doc["tags"]) <= 2 and set(doc["tags"]) <= {"a", "b"}
                    and isinstance(doc["n"], (int, float))):
                raise AssertionError(f"grammar: {doc} does not conform")
    return out


def grammar_gap(torch, eng, prompt, toks, j, sp, dev):
    """Top-2 gap of the grammar-masked logits before token j of a row (one
    forward_ragged of prompt + toks[:j] on a fresh pool)."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.llama import forward_ragged

    seq = list(prompt) + list(toks[:j])
    n, page = len(seq), 16
    P = -(-n // page)
    cache = PagedKVCache.create(eng.mcfg, P + 1, page, device=dev)
    logits = forward_ragged(
        eng.params, eng.mcfg, torch.tensor([seq], device=dev),
        torch.arange(n, dtype=torch.int32, device=dev)[None],
        torch.ones(1, n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.tensor([n], dtype=torch.int32, device=dev),
        torch.arange(1, P + 1, dtype=torch.int32, device=dev)[None],
        cache.k_pages, cache.v_pages, max_q_len=n)[0, -1].float()
    g = eng._grammar_for(sp)
    if g is not None:
        s = g.initial()
        for t in toks[:j]:
            s = g.advance_token(s, t) or s
        logits = torch.where(torch.from_numpy(eng._gmask(g, s)).to(dev), logits,
                             float("-inf"))
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def window_sync_warnings(torch, eng, with_grammar, K=4):
    """Sync warnings (torch.cuda.set_sync_debug_mode("warn")) raised by one
    K-step fused window over the engine's current decode batch, with its
    grammar rows' device tables or with the grammar keys dropped. Runs on
    a copy of the window state, on pages past every row's length."""
    import warnings

    from rbg_tpu_torch.engine.kvcache import pages_for_tokens

    eng._drain_decode()
    batch = eng._decode_batch()
    for r in batch:
        need = pages_for_tokens(r.seq_len + K, eng.cfg.page_size) - len(r.pages)
        if need > 0:
            r.pages.extend(eng._alloc(need))
    st = eng._build_decode_state(batch)
    if not with_grammar:
        st = {k: v for k, v in st.items()
              if k not in ("gnext", "glegal", "gstate", "gactive")}
    eng._run_window(dict(st), K)            # warm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._run_window(dict(st), K)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # The mode's one-time notice that it is a prototype is no sync.
    return [str(w.message)[:200] for w in caught
            if "called a synchronizing" in str(w.message)]


def step_times(torch, eng, n):
    """Wall ms (host clock to a synchronize) and device ms (sum of the
    CUDA kernels' and copies' own times, torch.profiler) per engine step,
    each over n steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, dev / n / 1e3


def grammar_timing(torch, params, model, card, dev="cuda"):
    """One decode step (multi_step 1) at B = 8 with 0 grammar rows, with 4
    tabled grammar rows and with 1 table-less row, in turns (two turns):
    wall and device ms per step. Each case's rows are in steady decode
    (after their prefill and three warm steps) for the whole reading; the
    tabled rows' regexes ([a-f]{40,60}, [g-p]{40,60}) fit the budget of
    128 states, the table-less row's ([0-9]{150,200}) does not. The
    tabled case also counts the sync warnings of one 4-step window with
    and without its grammar rows."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = grammar_engine(params, model, dev, multi_step=1, grammar_state_budget=128,
                         decode_buckets=(1, 2, 4, 8, 16, 32, 64))
    n_new = 1 + 3 + 2 * GRAMMAR_STEPS + 8
    free = lambda i: (tok.encode(f"Row {i}:", add_bos=False),  # noqa: E731
                      SamplingParams(max_new_tokens=n_new))
    tabled = [(tok.encode(f"Hex {i}:", add_bos=False),
               SamplingParams(max_new_tokens=n_new, stop_token=tok.eos_id,
                              regex=("[a-f]{40,60}", "[g-p]{40,60}")[i % 2]))
              for i in range(4)]
    loose = (tok.encode("Digits:", add_bos=False),
             SamplingParams(max_new_tokens=n_new, regex="[0-9]{150,200}",
                            stop_token=tok.eos_id))
    cases = {"grammar_0": [free(i) for i in range(8)],
             "tabled_4": tabled + [free(i) for i in range(4)],
             "tableless_1": [loose] + [free(i) for i in range(7)]}
    out = {c: [] for c in cases}
    sync = None
    for turn in range(2):
        for name, rows in cases.items():
            ids = [eng.add_request(p, sp) for p, sp in rows]
            while any(eng.requests[i].state != "running" for i in ids):
                eng.step()
            for _ in range(3):
                eng.step()
            wall, dev = step_times(torch, eng, GRAMMAR_STEPS)
            running = sum(eng.requests.get(i) is not None
                          and eng.requests[i].state == "running" for i in ids)
            if running != 8:
                raise AssertionError(f"grammar timing {name}: {running} of 8 rows "
                                     "still decoding")
            if name == "tabled_4" and turn == 0:
                sync = {"with_grammar": window_sync_warnings(torch, eng, True),
                        "without": window_sync_warnings(torch, eng, False)}
            out[name].append({"wall_ms": wall, "device_ms": dev})
            while eng.has_work():
                eng.step()
    if len(sync["with_grammar"]) > len(sync["without"]):
        raise AssertionError(f"the grammar window adds host syncs: {sync}")
    emit("grammar_step", card=card, model=model, batch=8, multi_step=1,
         steps_per_reading=GRAMMAR_STEPS, turns=out,
         sync_warnings={k: len(v) for k, v in sync.items()},
         sync_messages=sync["with_grammar"][:3],
         table_bytes=eng.grammar_table_bytes())
    del eng
    torch.cuda.empty_cache()


def grammar_phase(torch, np, params, model, card, dev="cuda"):
    """Grammar-constrained decoding at full width: the batch of
    grammar_rows through Engine (multi_step 4, budget GRAMMAR_BUDGET, one
    decode bucket of 8) with device tables ("auto") and without ("off"):
    every constrained token legal, finished rows match their regex or
    schema, greedy rows equal between the two, kernels A and B launched;
    then grammar_timing."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    eos = ByteTokenizer().eos_id
    rows = grammar_rows(SamplingParams, eos)
    streams, metrics, launches, table_bytes = {}, {}, {}, 0
    for mode in ("auto", "off"):
        eng = grammar_engine(params, model, dev, multi_step=4,
                             grammar_state_budget=GRAMMAR_BUDGET, grammar_table=mode)
        reset_launches()
        t0 = time.perf_counter()
        streams[mode] = run_rows(eng, rows)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = dict(LAUNCHES)
        if dev == "cuda":
            check_launches(launches[mode], LLAMA_KERNELS)
        metrics[mode] = dict(eng.metrics, wall_s=wall)
        texts = check_grammar_rows(eng, rows, streams[mode], eos)
        if mode == "auto":
            tabled = [eng._grammar_for(sp) is not None
                      and eng._grammar_table(eng._grammar_for(sp)) is not None
                      for _, sp in rows]
            if tabled != [True, True, True, True, False, False, False, False]:
                raise AssertionError(f"grammar: tabled rows {tabled}")
            table_bytes = eng.grammar_table_bytes()
            auto_eng, auto_texts = eng, texts
        else:
            del eng
    for i, ((prompt, sp), a, b) in enumerate(zip(rows, streams["auto"], streams["off"])):
        if sp.temperature == 0 and a != b:
            j = next(k for k in range(max(len(a), len(b)))
                     if k >= min(len(a), len(b)) or a[k] != b[k])
            gap = grammar_gap(torch, auto_eng, prompt, a, j, sp, dev)
            raise AssertionError(f"grammar: row {i} greedy tokens differ between "
                                 f"tables auto and off at step {j} ({a[j:j + 1]} vs "
                                 f"{b[j:j + 1]}); masked top-2 logit gap {gap:.4g}")
    same_seeded = [a == b for (_, sp), a, b in zip(rows, streams["auto"], streams["off"])
                   if sp.temperature > 0]
    emit("grammar", card=card, model=model, layers=auto_eng.mcfg.num_layers,
         rows=[{"constraint": ("regex" if sp.regex is not None else "json_schema"
                               if sp.json_schema is not None else "json_mode"
                               if sp.json_mode else "free"),
                "seeded": sp.temperature > 0, **t} for (_, sp), t in zip(rows, auto_texts)],
         greedy_equal_auto_off=True, seeded_equal_auto_off=same_seeded,
         launches=launches, metrics=metrics, budget=GRAMMAR_BUDGET,
         table_bytes=table_bytes)
    del auto_eng
    if dev == "cuda":
        torch.cuda.empty_cache()
        grammar_timing(torch, params, model, card)


def sse_request(port, path, body, timeout=600):
    """POST a streaming request; returns (status, text, seconds to the
    first non-empty text chunk, total seconds). A 200 stream that ends
    without ``data: [DONE]`` raises."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps({**body, "stream": True}).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            return r.status, r.read().decode(), None, time.perf_counter() - t0
        text, ttft, done = "", None, False
        while True:
            line = r.readline()
            if not line:
                break
            line = line.rstrip(b"\n")
            if line == b"data: [DONE]":
                done = True
                continue
            if not line.startswith(b"data: "):
                continue
            c = json.loads(line[6:])["choices"][0]
            piece = c.get("text") or (c.get("delta") or {}).get("content") or ""
            if piece and ttft is None:
                ttft = time.perf_counter() - t0
            text += piece
        if not done:
            raise AssertionError(f"{path}: stream ended without [DONE] after {text!r}")
        return 200, text, ttft, time.perf_counter() - t0
    finally:
        conn.close()


def http_json(port, method, path, body=None, timeout=600):
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read()), time.perf_counter() - t0
    finally:
        conn.close()


def frontend_phase(torch, np, params, model, card, dev="cuda"):
    """The port's OpenAI front end (``rbg_tpu_torch.engine.http_frontend``,
    a thread of this process) in front of the port's server on the model
    (grammar wired from the byte tokenizer): /healthz, /v1/models; a
    guided_regex completion, a response_format json_schema chat and a
    free completion, each non-streamed and streamed (greedy: the streamed
    text equals the other) with TTFT and total latency; /v1/embeddings; an
    unsupported response_format is a 400 with the reference's type."""
    import re
    import threading

    from rbg_tpu_torch.engine import http_frontend
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tok = ByteTokenizer()
    # No radix cache: a request and its streamed twin prefill alike.
    svc = EngineService(EngineConfig(model=model, num_pages=512, max_seq_len=1024,
                                     multi_step=4, enable_radix_cache=False,
                                     device=dev), params=params)
    svc.engine.enable_json_grammar(tok)
    srv = start_server(svc, tokenizer=tok)
    ns = type("Args", (), {})()
    ns.host, ns.port, ns.backend = "127.0.0.1", 0, srv.addr
    ns.model, ns.tokenizer_path, ns.default_max_tokens = model, "", 16
    fe = http_frontend.serve(ns)
    threading.Thread(target=fe.serve_forever, daemon=True).start()
    port = fe.server_address[1]
    try:
        st, health, _ = http_json(port, "GET", "/healthz")
        st2, models, _ = http_json(port, "GET", "/v1/models")
        if st != 200 or not health["ok"] or st2 != 200 or models["data"][0]["id"] != model:
            raise AssertionError(f"frontend: healthz {health}, models {models}")
        cases = {
            "guided_regex": ("/v1/completions", {"prompt": "Call me at ",
                                                 "guided_regex": GRAMMAR_REGEX,
                                                 "max_tokens": 16}),
            "json_schema": ("/v1/chat/completions", {
                "messages": [{"role": "user", "content": "Lamp state?"}],
                "max_tokens": 48, "response_format": {
                    "type": "json_schema",
                    "json_schema": {"name": "lamp", "schema": GRAMMAR_SCHEMA}}}),
            "free": ("/v1/completions", {"prompt": "Hello, ", "max_tokens": 24}),
        }
        reset_launches()
        report = {}
        for name, (path, body) in cases.items():
            st, resp, total = http_json(port, "POST", path, body)
            if st != 200:
                raise AssertionError(f"frontend {name}: {st} {resp}")
            c = resp["choices"][0]
            text = c["text"] if "text" in c else c["message"]["content"]
            sst, stext, ttft, stotal = sse_request(port, path, body)
            if sst != 200 or stext != text:
                raise AssertionError(f"frontend {name}: streamed {stext!r} != {text!r}")
            if name == "guided_regex" and not (c["finish_reason"] == "stop"
                                               and re.fullmatch(GRAMMAR_REGEX, text)):
                raise AssertionError(f"frontend guided_regex: {c}")
            if name == "json_schema" and c["finish_reason"] == "stop":
                doc = json.loads(text)
                if list(doc) != ["state", "id"] or doc["state"] not in ("on", "off", "idle"):
                    raise AssertionError(f"frontend json_schema: {doc}")
            report[name] = {"text": text, "finish_reason": c["finish_reason"],
                            "completion_tokens": resp["usage"]["completion_tokens"],
                            "total_s": total, "stream_ttft_s": ttft,
                            "stream_total_s": stotal}
        launches = dict(LAUNCHES)
        if dev == "cuda":
            check_launches(launches, LLAMA_KERNELS)
        st, emb, emb_s = http_json(port, "POST", "/v1/embeddings",
                                   {"input": ["grammar on the card", "front end"]})
        if st != 200 or len(emb["data"]) != 2 or len(emb["data"][0]["embedding"]) != \
                svc.engine.mcfg.hidden_size:
            raise AssertionError(f"frontend embeddings: {st}")
        st, bad, _ = http_json(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}],
            "response_format": {"type": "xml"}})
        if st != 400 or bad["error"]["type"] != "invalid_request_error":
            raise AssertionError(f"frontend: unsupported response_format gave {st} {bad}")
        emit("frontend", card=card, model=model, requests=report, launches=launches,
             embeddings_s=emb_s, bad_response_format={"status": st, **bad["error"]})
    finally:
        fe.shutdown()
        fe.server_close()
        srv.shutdown()
        srv.server_close()
        svc.stop()


# tier phase: six prompts of 1024-1920 tokens (544 pages at page 16)
# against a device pool of 300 usable pages, so admissions evict; a host
# tier of 2 GiB (1024 llama3-8b pages) keeps every spilled page.
TIER_PROMPT_LENS = [1024, 1920, 1280, 1792, 1536, 1152]
TIER_NUM_PAGES = 301
TIER_HOST_BYTES = 2 << 30


def page_checksums(torch, pool, ids):
    """Per-page checksum of pool pages taken on the card: the page's raw
    16-bit words, weighted by position (a swap of two words changes it),
    summed in int64. [len(ids)] int64 on the host."""
    x = pool.index_select(1, torch.tensor(ids, device=pool.device))
    w = x.view(torch.int16).transpose(0, 1).reshape(len(ids), -1).to(torch.int64)
    pos = torch.arange(w.shape[1], device=pool.device, dtype=torch.int64) % 65521 + 1
    return (w * pos).sum(1).tolist()


def tier_probe(torch, tier, page_size, sync):
    """Wrap a HostKVTier's spill and promote: checksums of the leaf's pages
    taken on the card before each spill, keyed by their prefix key, are
    held against the promoted pages' checksums after each promotion; each
    call's seconds (the card synchronized around it, a spill nested in a
    promotion's alloc subtracted) and pages are recorded."""
    from rbg_tpu_torch.kvtransfer.chunks import prefix_keys

    rec = {"before": {}, "checked": 0, "mismatch": [], "spill": [], "promote": [],
           "nested": 0.0, "probe_s": 0.0}
    spill, promote = tier.spill_from_device, tier.promote_to_device

    def sums(cache, ids):
        return list(zip(page_checksums(torch, cache.k_pages, ids),
                        page_checksums(torch, cache.v_pages, ids)))

    def spill_probe(prefix, page_ids, cache):
        t_in = time.perf_counter()
        keys = prefix_keys(prefix, page_size)
        first = len(prefix) // page_size - len(page_ids)
        for j, c in enumerate(sums(cache, page_ids)):
            rec["before"][keys[first + j]] = c
        sync()
        t0 = time.perf_counter()
        n = spill(prefix, page_ids, cache)
        t1 = time.perf_counter()
        rec["spill"].append((len(page_ids), t1 - t0))
        rec["probe_s"] += t0 - t_in
        rec["nested"] += t1 - t_in
        return n

    def promote_probe(tokens, start, alloc_fn, cache, release_fn=None):
        sync()
        rec["nested"] = 0.0
        t0 = time.perf_counter()
        extra, pages, out = promote(tokens, start, alloc_fn, cache, release_fn)
        sync()
        dt = time.perf_counter() - t0 - rec["nested"]
        if extra:
            t1 = time.perf_counter()
            rec["promote"].append((len(pages), dt))
            keys = prefix_keys(tokens[:start + extra], page_size)
            first = start // page_size
            for j, c in enumerate(sums(out, pages)):
                want = rec["before"].get(keys[first + j])
                rec["checked"] += 1
                if want != c:
                    rec["mismatch"].append((first + j, want, c))
            rec["probe_s"] += time.perf_counter() - t1
        return extra, pages, out

    tier.spill_from_device, tier.promote_to_device = spill_probe, promote_probe
    return rec


def timed_generate(eng, prompt, sp, rec=None):
    """(tokens, seconds to the first token, prefix-hit tokens) of one
    request run alone; the checksum time of a ``tier_probe`` record is
    taken out of the TTFT."""
    hits = eng.metrics["radix_hit_tokens"] + eng.metrics["host_hit_tokens"]
    probe0 = rec["probe_s"] if rec else 0.0
    t0 = time.perf_counter()
    rid = eng.add_request(prompt, sp)
    out, ttft = [], None
    while eng.has_work():
        for ev in eng.step():
            if ev.request_id == rid:
                if ttft is None:
                    ttft = time.perf_counter() - t0 - (
                        rec["probe_s"] - probe0 if rec else 0.0)
                out.append(ev.token)
    return out, ttft, (eng.metrics["radix_hit_tokens"]
                       + eng.metrics["host_hit_tokens"] - hits)


def copy_gbps(torch, nbytes, dev="cuda"):
    """One plain pinned ``copy_`` of ``nbytes`` each way (device to host,
    host to device), the tier link's yardstick: GB/s, median of 5."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    on_dev = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=dev == "cuda")
    out = {}
    for name, dst, src in (("d2h", host, on_dev), ("h2d", on_dev, host)):
        times = []
        for _ in range(6):
            sync()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            sync()
            times.append(time.perf_counter() - t0)
        out[name] = nbytes / statistics.median(times[1:]) / 1e9
    return out


def tier_phase(torch, np, params, card, model="llama3-8b", dev="cuda"):
    """The host KV tier at llama3-8b (bf16 pools): TIER_PROMPT_LENS through
    an engine whose pool holds about two of them, twice, one request at a
    time. Pass 1 runs cold and spills; pass 2 promotes. Promoted pages must
    equal, checksum for checksum on the card, the pages before their spill;
    pass 2's greedy tokens must equal a device-radix-hit run's (an engine
    with a pool for all six, its second pass) at the same hit depth.
    Returns the tier path's launches (the tier engine's two passes). On
    the CPU (``dev="cpu"``, a rehearsal at tiny) no kernel launches."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    rng = np.random.RandomState(12)
    V = params["embed"].shape[0]
    prompts = [rng.randint(1, V, n).tolist() for n in TIER_PROMPT_LENS]
    sp = SamplingParams(max_new_tokens=16)
    cfg = dict(model=model, max_seq_len=2048, prefill_chunk=512, multi_step=4,
               device=dev)
    eng = Engine(EngineConfig(num_pages=TIER_NUM_PAGES, host_tier_bytes=TIER_HOST_BYTES,
                              **cfg), params=params)
    ps = eng.cfg.page_size
    page_bytes = (eng.cache.k_pages[:, 0].nbytes + eng.cache.v_pages[:, 0].nbytes)
    rec = tier_probe(torch, eng.host_tier, ps, sync)
    reset_launches()
    cold = [timed_generate(eng, p, sp, rec) for p in prompts]
    after1 = dict(eng.host_tier.stats())
    host = [timed_generate(eng, p, sp, rec) for p in prompts]
    sync()
    launches = dict(LAUNCHES)
    if dev == "cuda":
        check_launches(launches, LLAMA_KERNELS)
    stats = eng.host_tier.stats()
    closes = eng.host_tier.accounting_closes()
    del eng
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    ref = Engine(EngineConfig(num_pages=2048, **cfg), params=params)
    ref_cold = [timed_generate(ref, p, sp) for p in prompts]
    hit = [timed_generate(ref, p, sp) for p in prompts]
    del ref
    gc.collect()

    spill_pages = sum(n for n, _ in rec["spill"])
    promote_pages = sum(n for n, _ in rec["promote"])
    biggest = max(n for n, _ in rec["spill"] + rec["promote"])
    link = copy_gbps(torch, biggest * page_bytes, dev)
    spill_s = sum(t for _, t in rec["spill"])
    promote_s = sum(t for _, t in rec["promote"])

    def ttft(runs):
        v = [r[1] for r in runs]
        return {"median_s": statistics.median(v), "each_s": v}

    agree = [sum(a == b for a, b in zip(h[0], c[0])) for h, c in zip(host, cold)]
    emit("tier", card=card, model=model, prompt_lens=TIER_PROMPT_LENS,
         num_pages=TIER_NUM_PAGES, host_tier_bytes=TIER_HOST_BYTES,
         page_bytes=page_bytes, stats_after_pass1=after1, stats=stats,
         accounting_closes=closes, launches=launches,
         pages_checked=rec["checked"], checksum_mismatches=rec["mismatch"][:4],
         hit_tokens={"host_pass2": [h[2] for h in host],
                     "device_pass2": [d[2] for d in hit]},
         pass2_vs_cold_agree=agree, of=sp.max_new_tokens,
         ttft={"cold": ttft(cold), "device_hit": ttft(hit), "host_hit": ttft(host),
               "cold_ref_engine": ttft(ref_cold)},
         spill={"calls": len(rec["spill"]), "pages_copied": spill_pages, "seconds": spill_s,
                "s_per_page": spill_s / max(1, spill_pages),
                "gbps": spill_pages * page_bytes / spill_s / 1e9 if spill_s else None},
         promote={"calls": len(rec["promote"]), "pages_copied": promote_pages,
                  "seconds": promote_s, "s_per_page": promote_s / max(1, promote_pages),
                  "gbps": (promote_pages * page_bytes / promote_s / 1e9
                           if promote_s else None)},
         pinned_copy={"bytes": biggest * page_bytes, **link})
    if not (stats["spilled_pages"] > 0 and stats["promoted_pages"] > 0 and closes):
        raise AssertionError(f"tier: no spill/promote round trip or open "
                             f"accounting: {stats}")
    if rec["mismatch"] or rec["checked"] != stats["promoted_pages"]:
        raise AssertionError(f"tier: promoted pages differ from the spilled ones "
                             f"({len(rec['mismatch'])} of {rec['checked']} checked, "
                             f"{stats['promoted_pages']} promoted)")
    if [h[2] for h in host] != [d[2] for d in hit] or \
            [h[0] for h in host] != [d[0] for d in hit]:
        raise AssertionError("tier: host-hit tokens differ from device-hit tokens")
    return launches


class CutProxy:
    """A TCP relay in front of one engine server. Once armed with ``k``, the
    next streamed request is cut after k token frames: the relay resets
    both connections, as a backend that died mid-stream would."""

    def __init__(self, upstream):
        import socketserver
        import threading

        from rbg_tpu_torch.engine.protocol import recv_obj, send_msg

        proxy = self
        self.cut_after = None
        self.cuts = 0

        class Relay(socketserver.BaseRequestHandler):
            def handle(self):
                obj = recv_obj(self.request)
                if obj is None:
                    return
                host, port = upstream.rsplit(":", 1)
                with socket.create_connection((host, int(port)), timeout=600) as up:
                    send_msg(up, obj)
                    frames = 0
                    while True:
                        f = recv_obj(up)
                        if f is None:
                            return
                        if (obj.get("stream") and f.get("tokens")
                                and proxy.cut_after is not None
                                and frames >= proxy.cut_after):
                            proxy.cut_after = None
                            proxy.cuts += 1
                            for s in (self.request, up):
                                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                             struct.pack("ii", 1, 0))
                            return
                        send_msg(self.request, f)
                        frames += bool(f.get("tokens"))
                        if not obj.get("stream") or f.get("done") or "error" in f:
                            return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server(("127.0.0.1", 0), Relay)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def start_router(backends):
    """The port's router (``rbg_tpu_torch.engine.router``) in this process
    with static unified backends; returns (server, address)."""
    import threading

    from rbg_tpu_torch.engine import router

    rs = router.RouterServer(("127.0.0.1", 0), router.Handler)
    rs.state = router.RouterState(router.Registry(None), None,
                                  {"worker": list(backends)})
    threading.Thread(target=rs.serve_forever, daemon=True).start()
    return rs, f"127.0.0.1:{rs.server_address[1]}"


def stream_tokens(addr, req):
    from rbg_tpu_torch.engine.protocol import recv_obj, send_msg

    host, port = addr.rsplit(":", 1)
    tokens = []
    with socket.create_connection((host, int(port)), timeout=600) as s:
        send_msg(s, {**req, "stream": True})
        while True:
            f = recv_obj(s)
            if f is None or "error" in f:
                raise AssertionError(f"stream through the router broke: {f}")
            tokens.extend(f.get("tokens") or [])
            if f.get("done"):
                return tokens


def router_phase(torch, np, params, card, model="llama3-8b", dev="cuda", **engine_kw):
    """The port's router in front of two llama3-8b servers on the card (one
    params dict, a pool each): bench_serving --addr with BENCH_ARGS straight
    at one server, through a router with that server alone, and through
    the router with both (radix caches emptied before each run, the same
    prompts and arrivals), every request completing and both servers
    serving; a repeated prefix sticking to one server with
    radix hits there; a greedy stream cut after 3 token frames (B = 1, idle
    servers) resumed on the sibling equal to the uninterrupted stream; the
    OpenAI front end through the router. Returns the router path's
    launches (the bench through the router). On the CPU (``dev="cpu"``, a
    rehearsal at tiny) no kernel launches."""
    import re
    import threading

    from rbg_tpu_torch.engine import bench_serving, http_frontend
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    args = bench_serving.parse_args(BENCH_ARGS)
    svcs = [EngineService(EngineConfig(
        model=model, page_size=args.page_size, num_pages=args.num_pages,
        max_seq_len=args.max_seq_len, max_batch=args.max_batch,
        prefill_chunk=args.prefill_chunk, multi_step=args.multi_step,
        device=dev, **engine_kw), params=params) for _ in range(2)]
    tok = ByteTokenizer()
    for s in svcs:
        s.engine.enable_json_grammar(tok)
    srvs = [start_server(s, tokenizer=tok) for s in svcs]
    proxy = CutProxy(srvs[0].addr)
    rs, raddr = start_router([s.addr for s in srvs])
    closers = [rs, proxy.server] + srvs

    def empty_radix():
        # Both servers idle: empty their prefix caches so a run prefills
        # what an earlier run left cached.
        for s in svcs:
            s.engine.radix.evict(s.engine.allocator.num_pages)

    try:
        for s in srvs:
            w = request_obj(s.addr, {"op": "warmup", "input_len": args.input_len},
                             timeout=600)
            if not w.get("ok"):
                raise AssertionError(f"warmup {w}")
        empty_radix()
        direct = bench_serving.run(bench_serving.parse_args(
            BENCH_ARGS + ["--addr", srvs[0].addr]))
        # The router's own cost: the same run through a router whose only
        # backend is that server.
        one_rs, one_addr = start_router([srvs[0].addr])
        closers.insert(0, one_rs)
        empty_radix()
        via_one = bench_serving.run(bench_serving.parse_args(
            BENCH_ARGS + ["--addr", one_addr]))
        empty_radix()
        joins = [s.engine.metrics["joins"] for s in svcs]
        reset_launches()
        routed = bench_serving.run(bench_serving.parse_args(
            BENCH_ARGS + ["--addr", raddr]))
        launches = dict(LAUNCHES)
        served = [s.engine.metrics["joins"] - j for s, j in zip(svcs, joins)]
        if routed["completed"] != routed["requests"] or min(served) == 0:
            raise AssertionError(f"router bench: {routed}, served {served}")
        if dev == "cuda":
            check_launches(launches, LLAMA_KERNELS)

        V = params["embed"].shape[0]
        rng = np.random.RandomState(13)
        shared = rng.randint(1, V, 512).tolist()
        hits = [s.engine.metrics["radix_hit_tokens"] for s in svcs]
        joins = [s.engine.metrics["joins"] for s in svcs]
        for tail in range(3):
            r = request_obj(raddr, {"op": "generate", "max_new_tokens": 4,
                                     "prompt": shared + rng.randint(1, V, 16).tolist()},
                             timeout=600)
            if r.get("error"):
                raise AssertionError(f"affinity request: {r}")
        hit = [s.engine.metrics["radix_hit_tokens"] - h for s, h in zip(svcs, hits)]
        took = [s.engine.metrics["joins"] - j for s, j in zip(svcs, joins)]
        if sorted(took) != [0, 3] or hit[took.index(3)] < 2 * 512 - 32:
            raise AssertionError(f"repeated prefix: requests {took}, radix hits {hit}")

        # The cut: a router of its own whose first pick is the relayed server.
        cut_rs, cut_addr = start_router([proxy.addr, srvs[1].addr])
        closers.insert(0, cut_rs)
        req = {"op": "generate", "prompt": rng.randint(1, V, 300).tolist(),
               "max_new_tokens": 64}
        whole = stream_tokens(cut_addr, req)
        empty_radix()
        proxy.cut_after = 3
        resumed = stream_tokens(cut_addr, req)
        # The router counts the failover just after relaying the last frame.
        t_wait = time.monotonic() + 5
        while cut_rs.state.metrics["failovers"] < 1 and time.monotonic() < t_wait:
            time.sleep(0.01)
        cut_metrics = dict(cut_rs.state.metrics)
        if proxy.cuts != 1 or cut_metrics["failovers"] != 1 or resumed != whole:
            raise AssertionError(f"cut stream: cuts {proxy.cuts}, {cut_metrics}, "
                                 f"resumed {resumed} vs {whole}")

        ns = type("Args", (), {})()
        ns.host, ns.port, ns.backend = "127.0.0.1", 0, raddr
        ns.model, ns.tokenizer_path, ns.default_max_tokens = model, "", 16
        fe = http_frontend.serve(ns)
        closers.insert(0, fe)
        threading.Thread(target=fe.serve_forever, daemon=True).start()
        port = fe.server_address[1]
        st, health, _ = http_json(port, "GET", "/healthz")
        # guided_regex on both: random weights' free tokens mostly lie
        # outside the byte tokenizer's 256 bytes and decode to nothing.
        st1, comp, comp_s = http_json(port, "POST", "/v1/completions", {
            "prompt": "Routed to ", "guided_regex": GRAMMAR_REGEX, "max_tokens": 12})
        st2, chat, chat_ttft, chat_s = sse_request(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Which server?"}],
            "guided_regex": GRAMMAR_REGEX, "max_tokens": 12})
        text = comp["choices"][0]["text"] if st1 == 200 else None
        if st != 200 or not health.get("ok") or st1 != 200 or st2 != 200 \
                or not re.fullmatch(GRAMMAR_REGEX, text) \
                or not re.fullmatch(GRAMMAR_REGEX, chat) or chat_ttft is None:
            raise AssertionError(f"front end through the router: {st} {health}, "
                                 f"{st1} {comp}, {st2} {chat!r}")
        m = request_obj(raddr, {"op": "health"}, timeout=30)
        emit("router", card=card, model=model, args=" ".join(BENCH_ARGS),
             launches={k: launches[k] for k in LLAMA_KERNELS},
             served_per_backend=served,
             ttft_s={"direct": direct["ttft_s"], "router_one": via_one["ttft_s"],
                     "router": routed["ttft_s"]},
             itl_ms={"direct": direct["itl_ms"], "router_one": via_one["itl_ms"],
                     "router": routed["itl_ms"]},
             tokens_per_s={"direct": direct.get("output_tok_per_s"),
                           "router_one": via_one.get("output_tok_per_s"),
                           "router": routed.get("output_tok_per_s")},
             direct=direct, router_one=via_one, routed=routed,
             affinity={"requests": took, "radix_hit_tokens": hit},
             cut={"after_frames": 3, "tokens": len(whole), "equal": True,
                  "metrics": cut_metrics},
             frontend={"completion": text, "completion_s": comp_s,
                       "chat_stream": chat, "chat_ttft_s": chat_ttft, "chat_s": chat_s},
             router_metrics=m["metrics"])
        return launches
    finally:
        for c in closers:
            c.shutdown()
            c.server_close()
        for s in svcs:
            s.stop()


PD_PROMPT_LENS = [1536, 1100, 2032]
PD_NEW_TOKENS = 16
PD_NUM_PAGES = 1024
PD_LAYER_SPLIT = 4
PD_ADMIT_LAYERS = 8
# The paced in-process link of the layer-slicing witness and reading. The
# first-token frame follows every page but the last (the prefill's last
# step exports the pages it finalized first), so layer slicing overlaps
# decode with that page's layer chunks only: 8 frames of 256 KiB at
# layer_split 4. A per-frame latency keeps them on the wire for 40 ms, so
# the row is admitted at 8 layers with 6 frames to go (2032 tokens of
# llama3-8b KV are 254 MiB: 0.53 s at 0.5 GB/s, a 4 Gbit/s link).
PD_LINK_BYTES_PER_S = 5e8
PD_LINK_LATENCY_S = 0.005


def paced_link():
    from rbg_tpu_torch.kvtransfer.transport import FakeICITransport
    return FakeICITransport(bytes_per_s=PD_LINK_BYTES_PER_S, latency_s=PD_LINK_LATENCY_S)

# The across-process group: 8 requests one after another (batch 1, so the
# greedy tokens of the two wire paths compare bit for bit).
PD_SERVER_PROMPT_LENS = [1024, 700, 1500, 333, 1200, 900, 1400, 640]
PD_SERVER_NEW_TOKENS = 32
PD_WARM_LEN = 1024
PD_SERVER_ARGS = ["--num-pages", "1024", "--max-seq-len", "2080", "--max-batch",
                  "8", "--prefill-chunk", "512", "--multi-step", "4"]


def pd_probe(torch, pair, sync):
    """Wrap a PD pair's export and import for the witness: the bytes of
    every export, the ``payload_checksum`` of every exported page (keyed
    by prompt and page index) and of every imported page read back from
    the decode pool when its row is admitted (after a layer-sliced
    admission's window chain: its pages but the one that now holds the
    decode token's KV). It synchronizes the card around each commit and
    takes host time in the path, so a run that reads times goes without
    it."""
    from rbg_tpu_torch.engine.kvtier import _to_host
    from rbg_tpu_torch.kvtransfer.chunks import payload_checksum

    rec = {"export_bytes": [], "sums": {}, "checked": 0, "mismatch": [],
           "sliced": False}
    pf, dw = pair.prefill, pair.decode

    def sums(k, v):
        return [payload_checksum(k[:, j].tobytes(), v[:, j].tobytes())
                for j in range(k.shape[1])]

    def check(prompt, pages, n):
        cache = dw.engine.cache
        ids = torch.tensor(pages[:n], dtype=torch.long, device=cache.k_pages.device)
        got = sums(_to_host(cache.k_pages.index_select(1, ids)),
                   _to_host(cache.v_pages.index_select(1, ids)))
        for j, c in enumerate(got):
            want = rec["sums"].get((tuple(prompt), j))
            rec["checked"] += 1
            if want != c:
                rec["mismatch"].append((len(prompt), j))

    export, commit = pf._export_pages, dw._commit_pages
    admit, sliced = dw._admit_row, dw.finalize_stream_layer_sliced

    def export_probe(req, lo, hi):
        k, v = export(req, lo, hi)
        rec["export_bytes"].append(k.nbytes + v.nbytes)
        for j, c in enumerate(sums(k, v)):
            rec["sums"][(tuple(req.prompt), lo + j)] = c
        return k, v

    def commit_probe(pages, k_host, v_host, wire, layer_lo=None, layer_hi=None):
        sync()
        commit(pages, k_host, v_host, wire, layer_lo, layer_hi)
        sync()

    def admit_probe(prompt, first_token, pages, sampling):
        if not rec["sliced"]:
            check(prompt, pages, -(-len(prompt) // pf.engine.cfg.page_size))
        return admit(prompt, first_token, pages, sampling)

    def sliced_probe(receiver, sampling=None, min_layers=1, deadline=None):
        rec["sliced"] = True
        try:
            rid = sliced(receiver, sampling, min_layers, deadline)
        finally:
            rec["sliced"] = False
        req = dw.engine.requests.get(rid)
        if req is not None:
            prompt = receiver.assembler.meta.prompt
            check(prompt, req.pages, len(prompt) // pf.engine.cfg.page_size)
        return rid

    pf._export_pages, dw._commit_pages = export_probe, commit_probe
    dw._admit_row, dw.finalize_stream_layer_sliced = admit_probe, sliced_probe
    return rec


def rate(nbytes, secs):
    return {"bytes": nbytes, "seconds": secs,
            "gbps": nbytes / secs / 1e9 if secs else None}


def pd_phase(torch, np, params, card, model="llama3-8b", dev="cuda"):
    """PD disaggregation in process at llama3-8b (bf16 pools, one weights
    dict): PD_PROMPT_LENS one at a time through a unified Engine, then
    through ``PDPair`` (whole bundles) and ``PDStreamPair`` (layer_split
    PD_LAYER_SPLIT, admit_layers 0 and PD_ADMIT_LAYERS) over an in-process
    link and over one paced to PD_LINK_BYTES_PER_S and PD_LINK_LATENCY_S a
    frame, each under ``pd_probe`` (checksums);
    then, without the probe, the bundle pair and the paced stream pairs
    again for their times. Every request's greedy tokens must equal the
    unified engine's; every imported page's payload checksum must equal
    its exported page's; on the paced link the layer-sliced admission must
    engage (a row admitted below full layer coverage) at least once;
    kernels A and B must launch. Prints TTFT through PD against unified,
    export and commit GB/s (the workers' ``transfer_s`` / ``commit_s``)
    beside one pinned ``copy_`` of the same bytes, and the first decode
    token's time with and without layer slicing beside the layer-admit
    lead (full coverage less layer-k coverage: the time slicing lets the
    first step overlap the transfer).
    Returns (launches of the PD path, the prompts and unified tokens). On
    the CPU (``dev="cpu"``, a rehearsal at tiny) no kernel launches."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.pd import PDPair, PDStreamPair
    from rbg_tpu_torch.kvtransfer.transport import InProcTransport
    from rbg_tpu_torch.obs import names as obs_names
    from rbg_tpu_torch.obs.metrics import REGISTRY
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    rng = np.random.RandomState(17)
    V = params["embed"].shape[0]
    prompts = [rng.randint(1, V, n).tolist() for n in PD_PROMPT_LENS]
    sp = SamplingParams(max_new_tokens=PD_NEW_TOKENS)
    cfg = EngineConfig(model=model, num_pages=PD_NUM_PAGES, max_seq_len=2048,
                       prefill_chunk=512, multi_step=4, device=dev)
    uni = Engine(dataclasses.replace(cfg, enable_radix_cache=False), params=params)
    uni.generate([prompts[1][:64]], sp)      # first use of the card's libraries
    unified = [timed_generate(uni, p, sp) for p in prompts]
    want = [u[0] for u in unified]
    del uni
    gc.collect()

    # Witness runs (checksums on every page) on every path, then timing
    # runs without checksums: the bundle pair's TTFT, export and commit
    # rates, and the paced link's first decode token with and without
    # layer slicing.
    arms = [("bundle", None, 0, True)]
    arms += [(f"stream_{link}_admit{admit}", make, admit, True)
             for link, make in (("inproc", InProcTransport), ("paced", paced_link))
             for admit in (0, PD_ADMIT_LAYERS)]
    arms += [("timed_bundle", None, 0, False),
             ("timed_paced_admit0", paced_link, 0, False),
             (f"timed_paced_admit{PD_ADMIT_LAYERS}", paced_link, PD_ADMIT_LAYERS, False)]
    lead_key = (obs_names.KVT_LAYER_ADMIT_LEAD_SECONDS, ())
    reset_launches()
    runs, recs, rates, leads = {}, {}, {}, {}
    for name, make, admit, witness in arms:
        if make is None:
            pair = PDPair(cfg, params=params)
        else:
            pair = PDStreamPair(cfg, params=params, transport=make(),
                                layer_split=PD_LAYER_SPLIT, admit_layers=admit)
        if witness:
            recs[name] = pd_probe(torch, pair, sync)
        lead0 = REGISTRY.snapshot_values()[1].get(lead_key, (0.0, 0))
        if make is None:
            out = [pair.generate([p], sp, collect_ttft=True) for p in prompts]
            runs[name] = {"tokens": [o[0][0] for o in out],
                          "ttft_s": [o[1][0] for o in out]}
        else:
            rs = [pair.generate_one(p, sp) for p in prompts]
            runs[name] = {"tokens": [r["tokens"] for r in rs],
                          "t_first_decode_s": [r["t_first_decode"] for r in rs],
                          "layers_at_admit": [r["layers_at_admit"] for r in rs],
                          "overlap": [r["overlap"] for r in rs]}
        if not witness:
            # The workers' own clocks: the export's gather and pinned copy,
            # the commit's staging and index_copy_ (enqueued, not waited).
            pm, dm = pair.prefill.metrics, pair.decode.metrics
            rates[name] = {"export": rate(pm["bytes_out"], pm["transfer_s"]),
                           "commit": rate(dm["bytes_in"], dm["commit_s"])}
            lead1 = REGISTRY.snapshot_values()[1].get(lead_key, (0.0, 0))
            leads[name] = {"sum_s": lead1[0] - lead0[0], "count": lead1[1] - lead0[1]}
        del pair
        gc.collect()
    sync()
    launches = dict(LAUNCHES)
    if dev == "cuda":
        torch.cuda.empty_cache()

    L = int(params["blocks"]["wq"].shape[0])
    biggest = max(b for r in recs.values() for b in r["export_bytes"])
    link = copy_gbps(torch, biggest, dev)
    checked = sum(r["checked"] for r in recs.values())
    mismatch = [m for r in recs.values() for m in r["mismatch"]]
    engaged = [a for name in (f"stream_paced_admit{PD_ADMIT_LAYERS}",
                              f"timed_paced_admit{PD_ADMIT_LAYERS}")
               for a in runs[name]["layers_at_admit"] if a is not None and a < L]
    equal = {name: r["tokens"] == want for name, r in runs.items()}
    emit("pd", card=card, model=model, prompt_lens=PD_PROMPT_LENS,
         new_tokens=PD_NEW_TOKENS, layer_split=PD_LAYER_SPLIT,
         admit_layers=PD_ADMIT_LAYERS, link_bytes_per_s=PD_LINK_BYTES_PER_S,
         link_latency_s=PD_LINK_LATENCY_S,
         launches={k: launches.get(k, 0) for k in LLAMA_KERNELS},
         tokens_equal_to_unified=equal, pages_checked=checked,
         checksum_mismatches=mismatch[:4],
         ttft_s={"unified": [u[1] for u in unified],
                 "pd_bundle": runs["timed_bundle"]["ttft_s"]},
         t_first_decode_s={name: r["t_first_decode_s"] for name, r in runs.items()
                           if "ttft_s" not in r},
         layers_at_admit={name: r["layers_at_admit"] for name, r in runs.items()
                          if "ttft_s" not in r},
         overlap={name: r["overlap"] for name, r in runs.items() if "ttft_s" not in r},
         layer_admit_lead=leads, rates=rates, pinned_copy={"bytes": biggest, **link})
    if not all(equal.values()):
        raise AssertionError(f"pd: tokens differ from the unified engine's: {equal}")
    if mismatch or checked == 0:
        raise AssertionError(f"pd: {len(mismatch)} of {checked} imported pages differ "
                             f"from their exported pages")
    if not engaged:
        raise AssertionError("pd: layer-sliced admission never admitted below full "
                             "layer coverage on the paced link")
    if dev == "cuda":
        check_launches(launches, LLAMA_KERNELS)
    return {k: launches.get(k, 0) for k in LLAMA_KERNELS}, (prompts, want)


def _spawn_server(args, root, env, log):
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "rbg_tpu_torch.engine.server",
                             "--port", str(port)] + args, cwd=root, env=env,
                            stdout=subprocess.DEVNULL, stderr=log)
    return proc, f"127.0.0.1:{port}"


def _wait_healthy(procs, addrs, log, timeout=600):
    from rbg_tpu_torch.engine.protocol import request_obj

    t0 = time.perf_counter()
    for proc, addr in zip(procs, addrs):
        while True:
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                log.seek(0)
                raise AssertionError(f"server {addr} never became healthy: "
                                     + log.read().decode()[-3000:])
            try:
                if (request_obj(addr, {"op": "health"}, timeout=5) or {}).get("ok"):
                    break
            except OSError:
                pass
            time.sleep(0.5)
    return time.perf_counter() - t0


def pd_process_phase(torch, np, card, model="llama3-8b", dev="cuda", ref=None):
    """A PD group across processes: ``python -m rbg_tpu_torch.engine.server
    --mode prefill`` and ``--mode decode`` at llama3-8b on the card (random
    weights from seed 0, as init_phase draws them), each warmed, behind
    the port's router with --kv-stream auto (KV pushed prefill→decode as
    chunk streams) and then off (whole bundles over the wire): every one
    of the 8 requests completes on both, and each request's greedy tokens
    are equal between the two, and the first ``len(ref[0])`` requests'
    tokens begin with ``ref``'s: (prompts, tokens) of the in-process
    unified engine on the same weights. The caller has
    freed its own llama3-8b weights and emptied the allocator's cache."""
    import threading

    from rbg_tpu_torch.engine import router
    from rbg_tpu_torch.engine.protocol import request_obj

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("RBG_SERVE_PORT", "RBG_PORT_SERVE", "RBG_KV_POOL_ADDR")}
    env["PYTHONPATH"] = str(root)
    args = ["--model", model] + PD_SERVER_ARGS + (["--device", "cpu"] if dev == "cpu" else [])
    from rbg_tpu_torch.models.config import get_config

    rng = np.random.RandomState(23)
    V = get_config(model).vocab_size
    prompts = [rng.randint(1, V, n).tolist() for n in PD_SERVER_PROMPT_LENS]
    if ref is not None:
        prompts = list(ref[0]) + prompts[len(ref[0]):]
    closers, procs = [], []
    with tempfile.TemporaryFile() as log:
        try:
            for mode in ("prefill", "decode"):
                proc, addr = _spawn_server(["--mode", mode] + args, root, env, log)
                procs.append((proc, addr))
            ready_s = _wait_healthy([p for p, _ in procs], [a for _, a in procs], log)
            (_, paddr), (_, daddr) = procs
            warm = {}
            for _, addr in procs:
                w = request_obj(addr, {"op": "warmup", "input_len": PD_WARM_LEN},
                                timeout=900)
                if not (w or {}).get("ok"):
                    raise AssertionError(f"pd server warmup {addr}: {w}")
                warm[addr] = w["elapsed_s"]
            health = {a: request_obj(a, {"op": "health"}, timeout=30) for _, a in procs}
            results = {}
            for setting in ("auto", "off"):
                rs = router.RouterServer(("127.0.0.1", 0), router.Handler)
                rs.state = router.RouterState(router.Registry(None), None,
                                              {"prefill": [paddr], "decode": [daddr]},
                                              kv_stream=setting == "auto")
                threading.Thread(target=rs.serve_forever, daemon=True).start()
                closers.append(rs)
                raddr = f"127.0.0.1:{rs.server_address[1]}"
                outs, walls = [], []
                for p in prompts:
                    t0 = time.perf_counter()
                    r = request_obj(raddr, {"op": "generate", "prompt": p,
                                            "max_new_tokens": PD_SERVER_NEW_TOKENS},
                                    timeout=600)
                    walls.append(time.perf_counter() - t0)
                    outs.append(r)
                results[setting] = {"replies": outs, "wall_s": walls,
                                    "router": dict(rs.state.metrics)}
            metrics = {a: request_obj(a, {"op": "metrics"}, timeout=30)["metrics"]
                       for _, a in procs}
        finally:
            for c in closers:
                c.shutdown()
                c.server_close()
            for proc, _ in procs:
                proc.terminate()
            for proc, _ in procs:
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    toks = {s: [r.get("tokens") for r in res["replies"]] for s, res in results.items()}
    done = {s: sum(1 for r in res["replies"]
                   if isinstance(r.get("tokens"), list)
                   and len(r["tokens"]) == PD_SERVER_NEW_TOKENS)
            for s, res in results.items()}
    same = [a == b for a, b in zip(toks["auto"], toks["off"])]
    vs_ref = ([t is not None and t[:len(w)] == w for t, w in zip(toks["auto"], ref[1])]
              if ref is not None else None)
    emit("pd_servers", card=card, model=model, args=" ".join(args),
         prompt_lens=[len(p) for p in prompts], new_tokens=PD_SERVER_NEW_TOKENS,
         ready_s=ready_s, warmup_s=warm, modes=[h.get("mode") for h in health.values()],
         devices=[h.get("device") for h in health.values()], completed=done,
         tokens_equal_auto_off=same, first_tokens_equal_inprocess_unified=vs_ref,
         ttft_s={s: [r.get("ttft_s") for r in res["replies"]] for s, res in results.items()},
         wall_s={s: res["wall_s"] for s, res in results.items()},
         router={s: {k: res["router"].get(k) for k in
                     ("pd_requests", "kv_stream_routed", "kv_stream_fallbacks",
                      "kv_bytes_routed", "failovers")}
                 for s, res in results.items()},
         prefill_metrics={k: metrics[paddr].get(k) for k in
                          ("streams", "bundles", "bytes_out", "transfer_s",
                           "stream_chunks")},
         decode_metrics={k: metrics[daddr].get(k) for k in
                         ("streams_in", "bundles", "bytes_in", "stream_commits",
                          "commit_s", "stream_errors", "free_pages")})
    n = len(prompts)
    if done != {"auto": n, "off": n}:
        raise AssertionError(f"pd servers: not every request completed: {done}, "
                             f"{[r for res in results.values() for r in res['replies'] if 'error' in r][:2]}")
    if not all(same):
        raise AssertionError(f"pd servers: tokens differ between --kv-stream auto and "
                             f"off: {same}")
    if vs_ref is not None and not all(vs_ref):
        raise AssertionError(f"pd servers: tokens differ from the in-process unified "
                             f"engine's: {vs_ref}")
    if results["auto"]["router"]["kv_stream_routed"] != n \
            or results["off"]["router"]["kv_stream_routed"] != 0:
        raise AssertionError(f"pd servers: stream routing {results['auto']['router']} / "
                             f"{results['off']['router']}")


def check_launches(launches, kernels):
    if min(launches[k] for k in kernels) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")


def sampled_check(torch, eng, prompt):
    """One seeded sampled request (temperature 0.9, top_k 40, seed 5)
    generated twice must give the same stream; also the Gumbel noise's
    device time per sampled step at batch 1 and 8 (the port's threefry in
    torch ops)."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.sampler import gumbel_noise, row_keys

    sp = SamplingParams(max_new_tokens=16, temperature=0.9, top_k=40, seed=5)
    s1 = eng.generate([prompt], sp)[0]
    s2 = eng.generate([prompt], sp)[0]
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"seeded sampled stream not repeatable: {s1} vs {s2}")
    V = eng.mcfg.vocab_size
    noise_ms = {}
    for B in (1, 8):
        keys = row_keys([5] * B, 1, list(range(B)), "cuda")
        pos = torch.arange(B, device="cuda") + 100
        noise = gumbel_noise(keys, pos, V)
        if noise.shape != (B, V) or not bool(torch.isfinite(noise).all()):
            raise AssertionError("bad Gumbel noise")
        noise_ms[f"B{B}"] = cuda_ms(torch, lambda: gumbel_noise(keys, pos, V), None)
    return {"tokens": s1, "noise_ms_per_sampled_step": noise_ms, "vocab": V}


def engine_phase(torch, np, params, model, kernels, kv_dtype="model",
                 multi_steps=(1, 4), sampled=False):
    """The engine script: returns {multi_step: (tokens, launches)}. With
    ``sampled`` it also runs ``sampled_check``."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.RandomState(1)
    eng = None
    V = params["embed"].shape[0]
    pa, pb = rng.randint(0, V, 100).tolist(), rng.randint(0, V, 150).tolist()
    runs = {}
    for ms in multi_steps:
        eng = Engine(EngineConfig(model=model, num_pages=2048, max_seq_len=2048,
                                  multi_step=ms, kv_dtype=kv_dtype), params=params)
        reset_launches()
        t0 = time.perf_counter()
        a = eng.add_request(pa, SamplingParams(max_new_tokens=24))
        out = {a: []}

        def run(events):
            for e in events:
                out[e.request_id].append(e.token)
            return events

        while not out[a]:                 # A's prefill (ragged steps)
            run(eng.step())
        run(eng.step())                   # A alone: a fused decode window
        b = eng.add_request(pb, SamplingParams(max_new_tokens=16))
        out[b] = []
        n_unified, seq_a = eng.metrics["unified_steps"], eng.requests[a].seq_len
        run(eng.step())                   # A's decode token + B's first chunk
        if not (eng.metrics["unified_steps"] == n_unified + 1
                and eng.requests[b].state == "prefill"
                and eng.requests[a].seq_len > seq_a):
            raise AssertionError("no ragged step held both a decode row and "
                                 "a prefill chunk")
        while eng.has_work():
            run(eng.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check_launches(launches, kernels)
        if len(out[a]) != 24 or len(out[b]) != 16 or not all(
                0 <= t < V for t in out[a] + out[b]):
            raise AssertionError(f"bad tokens {out}")
        g1 = eng.generate([pa], SamplingParams(max_new_tokens=8))
        g2 = eng.generate([pa], SamplingParams(max_new_tokens=8))
        if g1 != g2:
            raise AssertionError(f"greedy not repeatable: {g1} vs {g2}")
        tokens = {"a": out[a], "b": out[b]}
        metrics = dict(eng.metrics)
        extra = {"seeded_sampled": sampled_check(torch, eng, pb)} if sampled else {}
        emit("engine", model=model, kv_dtype=kv_dtype, layers=eng.mcfg.num_layers,
             multi_step=ms, launches=launches, tokens=tokens, wall_s=wall,
             metrics=metrics, greedy_repeat=g1[0], **extra)
        runs[ms] = (tokens, launches)
        del eng
        torch.cuda.empty_cache()
    return runs


def server_phase(torch, np, params, model, kernels, card, kv_dtype="model"):
    from concurrent.futures import ThreadPoolExecutor

    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.protocol import request_obj, request_stream
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    V = params["embed"].shape[0]
    svc = EngineService(EngineConfig(model=model, num_pages=2048,
                                     max_seq_len=2048, multi_step=4,
                                     kv_dtype=kv_dtype),
                        params=params)
    srv = start_server(svc)
    try:
        h = request_obj(srv.addr, {"op": "health"}, timeout=30)
        if not (h and h["ok"]):
            raise AssertionError(f"health {h}")
        w = request_obj(srv.addr, {"op": "warmup", "input_len": 32}, timeout=600)
        if not w.get("ok"):
            raise AssertionError(f"warmup {w}")
        rng = np.random.RandomState(2)
        reqs = [(7, 16, False), (40, 24, True), (130, 32, False), (300, 20, False)]

        def call(spec):
            plen, n, stream = spec
            msg = {"op": "generate", "prompt": rng.randint(0, V, plen).tolist(),
                   "max_new_tokens": n}
            if stream:
                frames, final = request_stream(srv.addr, {**msg, "stream": True},
                                               timeout=600)
                toks = [t for f in frames for t in f.get("tokens", [])]
                return {"tokens": toks, "ttft_s": final.get("ttft_s"),
                        "error": final.get("error"), "frames": len(frames)}
            return request_obj(srv.addr, msg, timeout=600)

        reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(call, reqs))
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        for (plen, n, _), r in zip(reqs, res):
            if r.get("error") or len(r["tokens"]) != n or not (r["ttft_s"] or 0) > 0 \
                    or not all(0 <= t < V for t in r["tokens"]):
                raise AssertionError(f"request (prompt {plen}): {r}")
        check_launches(launches, kernels)
        m = request_obj(srv.addr, {"op": "metrics"}, timeout=30)
        total = sum(n for _, n, _ in reqs)
        if svc.engine.cache.quantized != (kv_dtype == "int8"):
            raise AssertionError(f"server pool is not {kv_dtype}")
        emit("server", card=card, model=model, kv_dtype=kv_dtype,
             layers=svc.engine.mcfg.num_layers,
             requests=len(reqs), prompt_lens=[p for p, _, _ in reqs],
             new_tokens=total, wall_s=wall, tokens_per_s=total / wall,
             ttft_s=[r["ttft_s"] for r in res], stream_frames=res[1]["frames"],
             launches=launches, warmup_s=w["elapsed_s"], metrics=m["metrics"])
        return launches
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()


def params_to(params, dev):
    return {k: ({n: w.to(dev) for n, w in v.items()} if k == "blocks" else v.to(dev))
            for k, v in params.items()}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_phase(torch, np):
    """tiny and tiny-moe (float32, hd 32: kernels A and B), tiny-mla
    (float32 latents: kernels E and F) and tiny at page size 128 on the
    card. Engine at multi_step 1 and 4 on weights drawn on the CPU: greedy
    tokens equal to the CPU port's on the same weights, and both kernels
    of the model's path launched.
    Then the server as a user starts it, ``python -m
    rbg_tpu_torch.engine.server`` with its defaults (tiny on the card,
    random weights from seed 0), answering two generate requests whose
    greedy tokens equal the CPU port's on those weights."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import build_config, parse_args
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 40, 23, 70)]
    sp = SamplingParams(max_new_tokens=16)
    for model, page in (("tiny", 16), ("tiny-moe", 16), ("tiny-mla", 16), ("tiny", 128)):
        params = init_params(get_config(model), 0, "cpu")
        kernels = MLA_KERNELS if model == "tiny-mla" else LLAMA_KERNELS
        for ms in (1, 4):
            kw = dict(model=model, num_pages=256, max_seq_len=256, multi_step=ms,
                      page_size=page)
            want = Engine(EngineConfig(**kw, device="cpu"), params=params).generate(
                prompts, sp)
            reset_launches()
            got = Engine(EngineConfig(**kw), params=params_to(params, "cuda")).generate(
                prompts, sp)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            check_launches(launches, kernels)
            emit("tiny_engine", model=model, page_size=page, multi_step=ms, tokens=got,
                 equal_to_cpu=got == want, launches={k: launches[k] for k in kernels})
            if got != want:
                raise AssertionError(f"{model} page {page} multi_step {ms}: card {got} "
                                     f"vs cpu {want}")

    root = Path(__file__).resolve().parent
    port = free_port()
    addr = f"127.0.0.1:{port}"
    t0 = time.perf_counter()
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "rbg_tpu_torch.engine.server", "--port", str(port)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
            stdout=subprocess.DEVNULL, stderr=log)
        try:
            health = None
            while not (health and health.get("ok")):
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    log.seek(0)
                    raise AssertionError("default server never became healthy: "
                                         + log.read().decode()[-3000:])
                try:
                    health = request_obj(addr, {"op": "health"}, timeout=5)
                except OSError:
                    time.sleep(0.5)
            ready_s = time.perf_counter() - t0
            replies = [request_obj(addr, {"op": "generate", "prompt": p,
                                           "max_new_tokens": 16}, timeout=300)
                       for p in prompts[:2]]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    cfg = build_config(parse_args(["--device", "cpu"]))
    params = params_to(init_params(cfg.model_config, cfg.seed, "cuda"), "cpu")
    eng = Engine(cfg, params=params)
    want = [eng.generate([p], sp)[0] for p in prompts[:2]]
    got = [r.get("tokens") for r in replies]
    emit("tiny_server", model=cfg.model, device=health.get("device"), ready_s=ready_s,
         tokens=got, ttft_s=[r.get("ttft_s") for r in replies], equal_to_cpu=got == want)
    if not str(health.get("device")).startswith("cuda") or got != want:
        raise AssertionError(f"default server: {health}, card {replies} vs cpu {want}")


def ptxas_summary(report):
    """Per kernel instance of one library: its template arguments as
    mangled (e.g. ``13__nv_bfloat16S1_Li512ELi64``: bf16 queries and pools,
    512, 64), then registers, shared memory and spills as ptxas -v printed
    them."""
    out, entry, spill = {}, "", ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entry = name.split("kernelI", 1)[-1].split("EEv", 1)[0]
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used " in ln:
            out[entry] = f"{ln.split('Used ')[1].strip()}; {spill}"
    return out


def init_phase(torch, model):
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params

    t0 = time.perf_counter()
    params = init_params(get_config(model), seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("init", model=model, seconds=time.perf_counter() - t0,
         param_bytes=sum(t.numel() * t.element_size() for t in
                         [*params["blocks"].values(), *(
                             w for k, w in params.items() if k != "blocks")]),
         cuda_allocated_bytes=torch.cuda.memory_allocated())
    return params


def llama_phases(torch, np, card):
    """llama3-8b: bf16 engine, witness and server (A, B), the tier, router
    and in-process PD phases (A, B), then the int8 engine, witness and
    server (C, D). Returns ({kernel: launches on its path}, the PD
    phase's prompts and unified tokens)."""
    params = init_phase(torch, "llama3-8b")
    bf16 = engine_phase(torch, np, params, "llama3-8b", LLAMA_KERNELS, sampled=True)
    ragged_compare(torch, np, params, "llama3-8b")
    decode_compare(torch, np, params, "llama3-8b")
    block_compare(torch, np, params, "llama3-8b")
    launches = {k: v for k, v in server_phase(torch, np, params, "llama3-8b",
                                              LLAMA_KERNELS, card).items()
                if k in LLAMA_KERNELS}
    split_phase(torch, np, params, "llama3-8b", LLAMA_KERNELS)
    split_phase(torch, np, params, "llama3-8b", INT8_KERNELS, kv_dtype="int8")
    spec_phase(torch, np, params, "llama3-8b")
    lora_phase(torch, np, params, "llama3-8b", card)
    grammar_phase(torch, np, params, "llama3-8b", card)
    frontend_phase(torch, np, params, "llama3-8b", card)
    gc.collect()
    torch.cuda.empty_cache()
    paths = [tier_phase(torch, np, params, card), router_phase(torch, np, params, card)]
    gc.collect()
    torch.cuda.empty_cache()
    pd_launches, pd_ref = pd_phase(torch, np, params, card)
    paths.append(pd_launches)
    for k in LLAMA_KERNELS:
        launches[k] += sum(p[k] for p in paths)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = engine_phase(torch, np, params, "llama3-8b", INT8_KERNELS,
                        kv_dtype="int8", multi_steps=(4,))
    (t8, l8), (t16, _) = int8[4], bf16[4]
    same = [sum(x == y for x, y in zip(t8[r], t16[r])) for r in ("a", "b")]
    emit("int8_vs_bf16_tokens", model="llama3-8b", multi_step=4,
         same_position=same, of=[len(t16["a"]), len(t16["b"])],
         note="a reading of the int8 pool's effect, not a check")
    launches.update({k: l8[k] for k in INT8_KERNELS})
    ragged_compare(torch, np, params, "llama3-8b", kv_dtype="int8")
    decode_compare(torch, np, params, "llama3-8b", kv_dtype="int8")
    block_compare(torch, np, params, "llama3-8b", kv_dtype="int8")
    server_phase(torch, np, params, "llama3-8b", INT8_KERNELS, card, kv_dtype="int8")
    return launches, pd_ref


def deepseek_phases(torch, np, card):
    """deepseek-v2-lite (MLA + MoE): engine, witness and server over bf16
    latent pools (E, F), then over int8 latent pools on the same weights
    (G, H). Returns {kernel: launches on its path}."""
    model = "deepseek-v2-lite"
    params = init_phase(torch, model)
    engine_phase(torch, np, params, model, MLA_KERNELS)
    ragged_compare(torch, np, params, model)
    decode_compare(torch, np, params, model)
    block_compare(torch, np, params, model)
    launches = server_phase(torch, np, params, model, MLA_KERNELS, card)
    launches = {k: launches[k] for k in MLA_KERNELS}
    int8 = engine_phase(torch, np, params, model, MLA_INT8_KERNELS, kv_dtype="int8",
                        multi_steps=(4,))
    launches.update({k: int8[4][1][k] for k in MLA_INT8_KERNELS})
    ragged_compare(torch, np, params, model, kv_dtype="int8")
    decode_compare(torch, np, params, model, kv_dtype="int8")
    block_compare(torch, np, params, model, kv_dtype="int8")
    server_phase(torch, np, params, model, MLA_INT8_KERNELS, card, kv_dtype="int8")
    return launches


BENCH_ARGS = ["--model", "llama3-8b", "--requests", "16", "--rate", "4",
              "--input-len", "512", "--output-len", "64", "--num-pages", "2048",
              "--max-seq-len", "2048", "--max-batch", "8", "--multi-step", "4",
              "--slo-ttft-s", "2.0", "--slo-tpot-s", "0.5", "--json"]
# bench_slo's two setups at llama3-8b, one low rate (the pd setup runs two
# llama3-8b servers on the card: 1024 pages, 2 GiB, each).
BENCH_SLO_ARGS = ["--setups", "unified,pd", "--model", "llama3-8b", "--rates", "1",
                  "--requests", "24", "--input-len", "512", "--output-len", "32",
                  "--num-pages", "1024", "--max-seq-len", "1024", "--max-batch", "8",
                  "--prefill-chunk", "512", "--slo-ttft-s", "2.0", "--slo-tpot-s", "0.5"]
# Auth token of the in-process llama3-8b server (bench --addr and the
# serving-surface checks).
SMOKE_TOKEN = "chip-smoke-token"
# Embeddings of one prompt alone against the same prompt in a batch of 4:
# relative L2 distance, worst of the 4 prompts. At llama3-8b (H100,
# scripts/embed_tolerance.py) the 100-token prompt reads 0.0213: alone it
# runs at T 128, where cuBLAS takes another algorithm for the MLP's down
# projection (K 14336) than at 512 or more rows, and each of the two bf16
# paths is 0.029 from the float32 forward. The other three read 0. Planted
# faults read 0.77 (pads pooled) and 3.45 (attention unmasked, not causal).
EMBED_BF16_REL = 0.03
# tiny (float32) embeddings on the card against the CPU port.
EMBED_F32_ATOL = 1e-4


def bench_record(out, launches, mode, card, **extra):
    """Fail unless every request completed and kernels A and B launched;
    print the readings."""
    if out["completed"] != out["requests"]:
        raise AssertionError(f"bench_serving {mode}: {out}")
    check_launches(launches, LLAMA_KERNELS)
    emit("bench_serving", mode=mode, card=card, args=" ".join(BENCH_ARGS),
         launches={k: launches[k] for k in LLAMA_KERNELS}, **extra, **out)


def serving_phases(torch, np, card):
    """bench_serving at llama3-8b (full depth, bf16 pools): in process, then
    with --addr against the port's server in this process (auth token on);
    then the serving surface on that server and bench_slo at llama3-8b."""
    from rbg_tpu_torch.engine import bench_serving
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    args = bench_serving.parse_args(BENCH_ARGS)
    reset_launches()
    out = bench_serving.run(args)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    bench_record(out, launches, "inprocess", card)
    gc.collect()
    torch.cuda.empty_cache()

    svc = bench_serving.build_service(args)
    srv = start_server(svc, auth_token=SMOKE_TOKEN)
    try:
        w = request_obj(srv.addr, {"op": "warmup", "input_len": args.input_len,
                                    "token": SMOKE_TOKEN}, timeout=600)
        if not w.get("ok"):
            raise AssertionError(f"warmup {w}")
        remote = bench_serving.parse_args(BENCH_ARGS + ["--addr", srv.addr,
                                                        "--token", SMOKE_TOKEN])
        judged = svc.slo.judged_total()
        reset_launches()
        out = bench_serving.run(remote)
        torch.cuda.synchronize()
        # Judging precedes each request's completion on the loop thread.
        judged = svc.slo.judged_total() - judged
        if judged != out["completed"]:
            raise AssertionError(f"bench_serving --addr: {judged} requests "
                                 f"SLO-judged of {out['completed']}")
        bench_record(out, dict(LAUNCHES), "addr", card, slo_judged=judged)
        surface_phase(torch, np, svc, srv)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    bench_slo_phase(card)


def surface_phase(torch, np, svc, srv):
    """The server's other ops at llama3-8b: generate_text (traced), embed
    (4 prompts of 100-500 tokens, batched against singles), slo, traces, an
    auth refusal, and start_drain refusing a new generate while a stream
    runs on; then tiny's embeddings on the card against the CPU port."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import (
        CODE_DRAINING, recv_obj, request_obj, send_msg)
    from rbg_tpu_torch.engine.server import start_drain
    from rbg_tpu_torch.engine.service import embed_prompts
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.obs import trace

    def ask(obj, token=SMOKE_TOKEN):
        return request_obj(srv.addr, {**obj, "token": token} if token else obj,
                            timeout=600)

    V = svc.engine.mcfg.vocab_size
    trace.configure(enabled=True, sample=1.0)
    judged = svc.slo.judged_total()
    try:
        t0 = time.perf_counter()
        gt = ask({"op": "generate_text", "text": "The H100 serves", "max_new_tokens": 16})
        gt_s = time.perf_counter() - t0
    finally:
        trace.configure(enabled=False)
    gt_judged = svc.slo.judged_total() - judged
    if gt_judged != 1 or gt.get("error") or not isinstance(gt.get("text"), str) or not (
            0 < len(gt["tokens"]) <= 16 and all(0 <= t < V for t in gt["tokens"])):
        raise AssertionError(f"generate_text {gt}, SLO-judged {gt_judged}")
    # The op's span ends just after its reply is sent.
    for _ in range(50):
        traces = ask({"op": "traces", "n": 4})
        if traces.get("recent"):
            break
        time.sleep(0.02)
    rec = traces["recent"][-1] if traces.get("recent") else {}
    if not (rec.get("complete") and rec.get("root") == "engine.op"):
        raise AssertionError(f"traces {traces}")

    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, V, n).tolist() for n in (100, 230, 377, 500)]
    t0 = time.perf_counter()
    batched = ask({"op": "embed", "prompts": prompts})
    embed_s = time.perf_counter() - t0
    singles = [ask({"op": "embed", "prompt": p})["embedding"] for p in prompts]
    b, s1 = np.asarray(batched["embeddings"]), np.asarray(singles)
    rel = (np.linalg.norm(b - s1, axis=1) / np.linalg.norm(s1, axis=1)).tolist()
    if b.shape != (4, svc.engine.mcfg.hidden_size) or not np.isfinite(b).all() \
            or max(rel) > EMBED_BF16_REL:
        raise AssertionError(f"embed: shape {b.shape}, relative distance {rel}")

    slo = ask({"op": "slo", "window": 300}, token=None)
    tracker = [t for t in slo["trackers"] if t["component"] == "engineservice"][-1]
    refused = ask({"op": "generate", "prompt": [1, 2], "max_new_tokens": 2},
                  token="wrong")
    health = ask({"op": "health"}, token=None)
    if tracker["totals"]["judged"] != svc.slo.judged_total() \
            or refused != {"error": "unauthorized"} or not health.get("ok"):
        raise AssertionError(f"slo {tracker}, auth {refused}, health {health}")

    cfg = dict(model="tiny", num_pages=64, max_seq_len=256)
    params = init_params(get_config("tiny"), 0, "cpu")
    tiny_prompts = [rng.randint(1, 256, n).tolist() for n in (5, 40, 130)]
    want = np.asarray(embed_prompts(Engine(EngineConfig(**cfg, device="cpu"),
                                           params=params), tiny_prompts))
    got = np.asarray(embed_prompts(Engine(EngineConfig(**cfg),
                                          params=params_to(params, "cuda")),
                                   tiny_prompts))
    tiny_err = float(np.max(np.abs(got - want)))
    if tiny_err > EMBED_F32_ATOL:
        raise AssertionError(f"tiny embed on the card vs cpu: {tiny_err}")

    host, port = srv.addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=600) as s:
        send_msg(s, {"op": "generate", "prompt": prompts[0], "stream": True,
                     "max_new_tokens": 64, "token": SMOKE_TOKEN})
        if "error" in recv_obj(s):
            raise AssertionError("stream refused")
        start_drain(srv, 120.0)
        drained = ask({"op": "generate", "prompt": [1, 2], "max_new_tokens": 2})
        n = 0
        while True:
            frame = recv_obj(s)
            if frame is None or "error" in frame:
                raise AssertionError(f"stream cut by the drain: {frame}")
            n += len(frame.get("tokens", []))
            if frame.get("done"):
                break
    if drained.get("code") != CODE_DRAINING:
        raise AssertionError(f"draining server took a generate: {drained}")
    emit("serving_surface", model=svc.engine.cfg.model, generate_text=gt["text"],
         generate_text_tokens=len(gt["tokens"]), generate_text_s=gt_s,
         trace_spans=[sp["name"] for sp in rec["spans"]],
         embed_dim=batched["dim"], embed_prompt_lens=[len(p) for p in prompts],
         embed_s=embed_s, embed_batched_vs_singles_rel=rel,
         embed_bound=EMBED_BF16_REL, tiny_embed_card_vs_cpu=tiny_err,
         slo_judged=tracker["totals"]["judged"], slo_windows=tracker["windows"],
         auth_refusal=refused, drain_refusal=drained,
         stream_tokens_through_drain=n)


TRAIN_T = 512                    # one fixed [1, TRAIN_T] batch at llama3-8b
TRAIN_STEPS = 5
TRAIN_LR = 1e-6                  # llama3-8b on one batch (3e-4 diverges, PERF.md)
TRAIN_REL = 1e-4                 # tiny on the card against the CPU port
REMAT_REL = 1e-5                 # remat against plain gradients, float32
LAYOUT_LAYERS = 8                # depth of the stacked-vs-per-layer reading


class Clock:
    """Marks on the device's clock: CUDA events on the card, the host clock
    elsewhere (a CPU rehearsal)."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, torch.device(dev).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i, j):
        """Milliseconds from mark i to mark j (waits for mark j)."""
        a, b = self.marks[i], self.marks[j]
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def free(torch, dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def peak_reset(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch, dev):
    return torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else None


def rel_err(a, b):
    """max |a - b| over max |b|."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else float((a - b).abs().max())


def train_flops(cfg, T):
    """(model FLOPs of one step, FLOPs the remat step computes): 6·N·T for
    the weights (2 forward + 4 backward per parameter and token) and the
    attention's two [T, T] products per head and layer, 2·2·T²·hd forward,
    three times that for a step; remat runs each block's forward once
    more."""
    n = cfg.num_params
    attn = 4 * cfg.num_layers * cfg.num_heads * T * T * cfg.head_dim_
    return 6 * n * T + 3 * attn, 8 * n * T + 4 * attn


def batch(torch, np, cfg, seed, dev, B=1, T=TRAIN_T):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, T))).to(dev)


def train_tiny(torch, np, dev="cuda"):
    """(a) tiny (float32): three make_train_step steps on ``dev`` from
    weights carried across by params_from_numpy, plain and with remat,
    against the CPU port on the same weights and tokens: losses and every
    parameter within TRAIN_REL of the CPU's (relative to each leaf's
    largest magnitude)."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.convert import params_from_numpy
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import make_train_step, param_leaves

    cfg = get_config("tiny")
    tree = {k: ({n: w.numpy() for n, w in v.items()} if k == "blocks" else v.numpy())
            for k, v in init_params(cfg, 11, "cpu").items()}
    tokens = batch(torch, np, cfg, 11, "cpu", B=4, T=64)
    for remat in (False, True):
        out = {}
        for d in ("cpu", dev):
            init_fn, step = make_train_step(cfg, remat=remat, device=d)
            params, opt = init_fn(params_from_numpy(tree, cfg, d))
            losses = []
            for _ in range(3):
                params, opt, loss = step(params, opt, tokens)
                losses.append(float(loss))
            out[d] = (losses, param_leaves(params))
        (lc, pc), (lg, pg) = out["cpu"], out[dev]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        param_err = max(rel_err(g.detach().cpu(), c.detach()) for g, c in zip(pg, pc))
        emit("train", case="tiny_card_vs_cpu", device=dev, remat=remat, losses=lg,
             cpu_losses=lc, loss_rel_err=loss_err, max_param_rel_err=param_err,
             tolerance=TRAIN_REL)
        if loss_err > TRAIN_REL or param_err > TRAIN_REL or not lg[2] < lg[0]:
            raise AssertionError(f"tiny training on {dev} vs the CPU port: "
                                 f"{loss_err}, {param_err}")


def per_layer(params, clone=False):
    """A stacked tree as the trainer holds it: one dict of leaves per layer."""
    L = next(iter(params["blocks"].values())).shape[0]
    return dict(params, blocks=[{k: (w[l].clone() if clone else w[l])
                                 for k, w in params["blocks"].items()} for l in range(L)])


def train_remat_check(torch, np, model="llama3-8b", dev="cuda"):
    """(c) ``model`` at full width, 2 layers, float32: the gradient of
    every leaf with remat equals the plain gradient within REMAT_REL."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import next_token_loss, param_leaves

    cfg = get_config(model, num_layers=2, dtype="float32")
    tokens = batch(torch, np, cfg, 12, dev)
    tree = per_layer(init_params(cfg, 0, dev))
    leaves = param_leaves(tree)
    for t in leaves:
        t.requires_grad_()
    grads = []
    for remat in (False, True):
        next_token_loss(tree, cfg, tokens, remat=remat).backward()
        grads.append([t.grad for t in leaves])
        for t in leaves:
            t.grad = None
    err = max(rel_err(b, a) for a, b in zip(*grads))
    emit("train", case="remat_grads", model=model, layers=2, dtype="float32",
         tokens=TRAIN_T, max_rel_err=err, tolerance=REMAT_REL)
    if err > REMAT_REL:
        raise AssertionError(f"remat gradients differ from plain ones: {err}")


def backward_reading(torch, cfg, tree, leaves, tokens, dev):
    """One forward and backward (remat): (forward ms, backward ms, peak
    bytes)."""
    from rbg_tpu_torch.models.training import next_token_loss

    for t in leaves:
        t.grad = None
    sync(torch, dev)
    peak_reset(torch, dev)
    clock = Clock(torch, dev)
    clock.mark()
    loss = next_token_loss(tree, cfg, tokens, remat=True)
    clock.mark()
    loss.backward()
    clock.mark()
    return clock.ms(0, 1), clock.ms(1, 2), peak_bytes(torch, dev)


def train_layout(torch, np, model="llama3-8b", dev="cuda", layers=LAYOUT_LAYERS):
    """The trainer's leaves at ``model``'s width and ``layers`` layers
    (its dtype, remat, one [1, TRAIN_T] batch, no optimizer): stacked
    [L, ...] leaves read per layer against one leaf per layer and weight;
    the backward's time and the peak of each (the second of two passes).
    A reading, not a check."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import param_leaves

    cfg = get_config(model, num_layers=layers)
    tokens = batch(torch, np, cfg, 13, dev)
    rows = {}
    for layout in ("stacked", "per_layer"):
        # Each layout alone on the card: the per-layer tree is drawn anew
        # and the stacked tensors it came from are dropped.
        tree = (init_params(cfg, 0, dev) if layout == "stacked"
                else per_layer(init_params(cfg, 0, dev), clone=True))
        free(torch, dev)
        leaves = ([v for k, v in tree.items() if k != "blocks"]
                  + list(tree["blocks"].values()) if layout == "stacked"
                  else param_leaves(tree))
        for t in leaves:
            t.requires_grad_()
        backward_reading(torch, cfg, tree, leaves, tokens, dev)
        fwd, bwd, peak = backward_reading(torch, cfg, tree, leaves, tokens, dev)
        rows[layout] = {"forward_ms": fwd, "backward_ms": bwd, "peak_bytes": peak}
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        del tree, leaves
        free(torch, dev)
    emit("train", case="leaf_layout", model=model, layers=layers, tokens=TRAIN_T, **rows)


def train_llama(torch, np, card, model="llama3-8b", dev="cuda"):
    """(b) ``model`` at full width and depth, its dtype, random weights
    from seed 0: TRAIN_STEPS make_train_step steps (learning rate
    TRAIN_LR) with remat on one fixed [1, TRAIN_T] batch. The loss must be
    finite and fall at every step. Step wall ms
    (median of steps 2-5), tokens/s, model FLOPs/s as a share of the bf16
    peak, peak memory; then one more step by hand, timed in its forward,
    backward and optimizer. Returns (the trained per-layer params, the
    first loss, the batch)."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import make_train_step, next_token_loss, param_leaves

    cfg = get_config(model)
    tokens = batch(torch, np, cfg, 14, dev)
    init_fn, step = make_train_step(cfg, learning_rate=TRAIN_LR, remat=True, device=dev)
    params, opt = init_fn(init_params(cfg, 0, dev))   # only the trainer's copy stays
    free(torch, dev)
    peak_reset(torch, dev)
    losses, wall = [], []
    for _ in range(TRAIN_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))              # waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = peak_bytes(torch, dev)
    clock = Clock(torch, dev)
    opt.zero_grad(set_to_none=True)
    clock.mark()
    extra = next_token_loss(params, cfg, tokens, remat=True)
    clock.mark()
    extra.backward()
    clock.mark()
    opt.step()
    clock.mark()
    step_ms = statistics.median(wall[1:])
    model_flops, remat_flops = train_flops(cfg, TRAIN_T)
    emit("train", case="full_depth", model=model, card=card, layers=cfg.num_layers,
         dtype=cfg.dtype, tokens=TRAIN_T, remat=True, learning_rate=TRAIN_LR,
         losses=losses, step_wall_ms=wall,
         step_ms_median_2_5=step_ms, tokens_per_s=TRAIN_T / step_ms * 1e3,
         model_flops_per_step=model_flops, remat_flops_per_step=remat_flops,
         model_flops_share_of_989tf=model_flops / (step_ms * 1e-3) / BF16_FLOPS,
         peak_bytes=peak, step6_ms={"forward": clock.ms(0, 1), "backward": clock.ms(1, 2),
                                    "optimizer": clock.ms(2, 3)},
         step6_loss=float(extra.detach()))
    if not all(np.isfinite(losses)) or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{model} training: losses {losses}")
    del opt, extra
    for t in param_leaves(params):
        t.grad = None
        t.requires_grad_(False)
    free(torch, dev)
    return params, losses[0], tokens


def train_mesh(torch, np, first_loss, tokens, model="llama3-8b", dev="cuda"):
    """(d) parallel.make_mesh() at world size 1 (nccl on the card) and one
    step of make_train_step over it, from (b)'s seed-0 weights and batch:
    its loss is (b)'s first."""
    import torch.distributed as dist

    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import make_train_step
    from rbg_tpu_torch.parallel import make_mesh

    cfg = get_config(model)
    mesh = make_mesh(device=dev)
    try:
        init_fn, step = make_train_step(cfg, mesh, learning_rate=TRAIN_LR, remat=True)
        params, opt = init_fn(init_params(cfg, 0, dev))
        free(torch, dev)
        _, _, loss = step(params, opt, tokens)
        loss = float(loss)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    rel = abs(loss - first_loss) / abs(first_loss)
    emit("train", case="mesh_world_1", backend=backend, mesh=str(mesh), loss=loss,
         unsharded_first_loss=first_loss, rel_err=rel)
    del params, opt
    free(torch, dev)
    if rel > 1e-6:
        raise AssertionError(f"a step through the world-1 mesh: {loss} vs {first_loss}")


def host_available():
    """MemAvailable of /proc/meminfo in bytes (None where it is absent)."""
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemAvailable:"):
                    return int(ln.split()[1]) * 1024
    except OSError:
        pass
    return None


def checkpoint_dir(nbytes):
    """A scratch directory with room for ``nbytes`` and a margin: the temp
    directory, else beside this script. Returns (path, which)."""
    import shutil

    for where, root in (("tmpdir", tempfile.gettempdir()),
                        ("checkout", str(Path(__file__).resolve().parent))):
        if shutil.disk_usage(root).free > 1.2 * nbytes:
            return tempfile.mkdtemp(prefix="rbg-ckpt-", dir=root), where
    raise AssertionError(f"no directory has room for a {nbytes}-byte checkpoint")


def checkpoint_llama(torch, np, card, params, hf, model="llama3-8b", hf_model="qwen2-0.5b",
                     dev="cuda"):
    """save_checkpoint of (b)'s trained params, then Engine(EngineConfig(
    model=..., checkpoint_path=...)): greedy tokens equal to an engine on
    the trained params in memory, through kernels A and B on the card;
    write and read GB/s (the read is the engine's construction, with the
    file fresh in the host's page cache). Then, while the file exists, the
    rank-local reads at tp 2 (``checkpoint_tp``, with the HF directory
    ``hf``). Returns the launches of the loaded engines' paths."""
    import shutil

    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.checkpoint import save_checkpoint
    from rbg_tpu_torch.models.training import param_leaves, stack_params
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    nbytes = sum(t.numel() * t.element_size() for t in param_leaves(params))
    host = {"available_before": host_available()}
    if host["available_before"] is not None and host["available_before"] < 1.5 * nbytes:
        raise AssertionError(f"the host has {host['available_before']} bytes free for a "
                             f"{nbytes}-byte checkpoint")
    d, where = checkpoint_dir(nbytes)
    try:
        t0 = time.perf_counter()
        written = save_checkpoint(d, params)
        write_s = time.perf_counter() - t0
        host["available_after_write"] = host_available()
        stacked = stack_params(params)
        params.clear()
        free(torch, dev)
        kw = dict(model=model, num_pages=512, max_seq_len=1024, device=dev)
        rng = np.random.RandomState(15)
        V = stacked["embed"].shape[0]
        prompts = [rng.randint(0, V, n).tolist() for n in (300, 77)]
        sp = SamplingParams(max_new_tokens=16)
        want = Engine(EngineConfig(**kw), params=stacked).generate(prompts, sp)
        del stacked
        free(torch, dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        eng = Engine(EngineConfig(**kw, checkpoint_path=d))
        sync(torch, dev)
        read_s = time.perf_counter() - t0
        reset_launches()
        got = eng.generate(prompts, sp)
        sync(torch, dev)
        launches = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
        emit("checkpoint", case="native", model=model, card=card, dir=where,
             host_bytes=host, bytes=written, write_s=write_s,
             write_gb_per_s=written / write_s / 1e9, read_s=read_s,
             read_gb_per_s=written / read_s / 1e9, tokens=got,
             equal_to_in_memory=got == want, launches=launches)
        if torch.device(dev).type == "cuda":
            check_launches(launches, LLAMA_KERNELS)
        if got != want:
            raise AssertionError(f"engine from the checkpoint: {got} vs in memory {want}")
        # The unsharded engine's first steps, for the tp ranks to hold theirs
        # against; then the ranks read their slices of the same file.
        ref = os.path.join(d, "first_step.npz")
        np.savez(ref, prompts=np.array(json.dumps(prompts)),
                 **{f"logits{i}": first_step_logits(torch, eng, p).float().cpu().numpy()
                    for i, p in enumerate(prompts)})
        del eng
        free(torch, dev)
        for k, n in checkpoint_tp(torch, np, card, d, ref, hf, model, hf_model,
                                  dev).items():
            launches[k] += n
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


CKPT_TIMEOUT_S = 600
CKPT_HF_TURNS = ("local", "whole", "local", "whole")


def rss_anon():
    """RssAnon of /proc/self/status (anonymous resident bytes: the heap,
    not the mapped file's pages, which VmHWM and VmRSS count); None where
    the kernel does not give it."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("RssAnon:"):
                return int(ln.split()[1]) * 1024
    return None


@functools.lru_cache(maxsize=None)
def _mallinfo2():
    """glibc's ``mallinfo2`` with its result type, or None."""
    import ctypes

    class Info(ctypes.Structure):
        _fields_ = [(n, ctypes.c_size_t) for n in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
            "uordblks", "fordblks", "keepcost")]

    fn = getattr(ctypes.CDLL(None), "mallinfo2", None)
    if fn is not None:
        fn.restype = Info
    return fn


def malloc_in_use():
    """Bytes glibc's malloc holds in use (mallinfo2: uordblks + hblkhd),
    torch's host tensors among them; None without mallinfo2. Where a
    kernel's /proc has no RssAnon and counts mapped file pages as resident
    and unshared (statm), as some sandboxed kernels do, this is the heap
    reading."""
    fn = _mallinfo2()
    if fn is None:
        return None
    info = fn()
    return info.uordblks + info.hblkhd


class HostPeak:
    """RssAnon and malloc's in-use bytes sampled by a thread every
    ``period`` s inside a with-block: {name: (before, peak)}."""

    READINGS = {"rss_anon": rss_anon, "malloc_in_use": malloc_in_use}

    def __init__(self, period=0.002):
        import threading

        self.period, self.stop = period, threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)

    def _read(self):
        for k, fn in self.READINGS.items():
            v = fn()
            if v is not None:
                self.peak[k] = max(self.peak.get(k, v), v)

    def _sample(self):
        while not self.stop.wait(self.period):
            self._read()

    def __enter__(self):
        self.before = {k: fn() for k, fn in self.READINGS.items()}
        self.peak = {}
        self._read()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self._read()

    def record(self):
        return {k: {"before": self.before[k], "peak": self.peak.get(k),
                    "added": self.peak[k] - self.before[k] if k in self.peak else None}
                for k in self.READINGS}


def timed_read(torch, dev, build):
    """``build()`` (an engine that reads a checkpoint), timed to the card's
    last copy, with what it copied out of the file, its host staging, its
    host memory (``HostPeak``) and the device's peak. Returns (engine,
    record)."""
    from rbg_tpu_torch.models import safetensors_io

    free(torch, dev)
    sync(torch, dev)
    peak_reset(torch, dev)
    safetensors_io.reset_reads()
    with HostPeak() as host:
        t0 = time.perf_counter()
        eng = build()
        sync(torch, dev)
        secs = time.perf_counter() - t0
    return eng, {"seconds": secs, "bytes_copied": safetensors_io.READS["bytes"],
                 "tensors": safetensors_io.READS["tensors"],
                 "staging_max": safetensors_io.READS["staging_max"],
                 "host": host.record(), "device_peak": peak_bytes(torch, dev)}


def flat_params(params):
    out = {k: v for k, v in params.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def bits(t):
    """A tensor's bytes (bit-for-bit comparisons)."""
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8)


def slices_of_file(torch, eng, path, mesh):
    """Names of the engine's weights that are not, bit for bit,
    ``local_shard`` of the native file's tensor: each file tensor read
    whole onto the engine's device, one at a time, and freed."""
    from rbg_tpu_torch.models import safetensors_io
    from rbg_tpu_torch.models.checkpoint import NATIVE_FILE
    from rbg_tpu_torch.parallel.sharding import leaf_spec, local_shard

    have = flat_params(eng.params)
    with safetensors_io.SafeFile(os.path.join(path, NATIVE_FILE), eng.device) as f:
        bad = sorted(set(have) ^ set(f))
        for name in f:
            whole = f[name]
            if name in have and not torch.equal(
                    bits(local_shard(whole, leaf_spec(name), mesh)), bits(have[name])):
                bad.append(name)
            del whole
    return bad


def ckpt_rank(torch, np, world, rank, port, out_path, native, ref_path, hf,
              model="llama3-8b", hf_model="qwen2-0.5b", dev="cuda"):
    """One rank of the checkpoint phase's tp world (``checkpoint_tp``):
    ``Engine(EngineConfig(checkpoint_path=native), mesh=...)`` reads this
    rank's slices of the native file (every weight held against
    ``local_shard`` of the file's tensor; the first steps' logits against
    the unsharded engine's in ``ref_path``; two greedy streams with the
    launches counted from 0), then the HF directory ``hf`` rank-locally and
    through the whole path (the tree read to the host, then sliced), in
    turns, each engine's weights bit-equal to the first's. Writes its
    results to ``out_path``."""
    import torch.distributed as dist

    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.checkpoint import load_params
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rbg_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if dev == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(tp=world, device=dev)
    kw = dict(model=model, num_pages=512, max_seq_len=1024, device=dev)
    eng, rec = timed_read(torch, dev, lambda: Engine(EngineConfig(**kw, checkpoint_path=native),
                                                     mesh=mesh))
    rec["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in flat_params(eng.params).values())
    rec["not_file_slices"] = slices_of_file(torch, eng, native, mesh)
    ref = np.load(ref_path)
    prompts = json.loads(str(ref["prompts"]))
    rec["first_step_max_abs"] = [
        float(np.abs(first_step_logits(torch, eng, p).float().cpu().numpy()
                     - ref[f"logits{i}"]).max()) for i, p in enumerate(prompts)]
    reset_launches()
    rec["tokens"] = eng.generate(prompts, SamplingParams(max_new_tokens=16))
    sync(torch, dev)
    rec["launches"] = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
    res = {"rank": rank, "native": rec}
    del eng
    free(torch, dev)
    hkw = dict(model=hf_model, num_pages=256, max_seq_len=1024, device=dev)
    first, res["hf"] = None, []
    for path in CKPT_HF_TURNS:
        if path == "local":
            build = lambda: Engine(EngineConfig(**hkw, checkpoint_path=hf), mesh=mesh)  # noqa: E731
        else:
            build = lambda: Engine(EngineConfig(**hkw), mesh=mesh,  # noqa: E731
                                   params=load_params(hf, get_config(hf_model), device="cpu"))
        eng, rec = timed_read(torch, dev, build)
        got = flat_params(eng.params)
        if first is None:
            first = {k: bits(v).clone() for k, v in got.items()}
        rec["path"] = path
        rec["equal_to_first"] = sorted(got) == sorted(first) and all(
            torch.equal(bits(v), first[k]) for k, v in got.items())
        res["hf"].append(rec)
        del eng, got
        free(torch, dev)
    np.savez(out_path, results=np.array(json.dumps(res)))
    dist.barrier()
    dist.destroy_process_group()


def checkpoint_tp(torch, np, card, native, ref, hf, model="llama3-8b",
                  hf_model="qwen2-0.5b", dev="cuda"):
    """The native file at tp 2 (``ckpt_rank`` in a gloo world of two
    processes on the one card): each rank copies out its share (its weight
    bytes) with every weight bit-equal to the file's slice, its first steps
    within TP_FIRST_BAND of the unsharded engine's, kernels A and B
    launched on each rank; the HF directory's rank-local and whole reads
    bit-equal on both ranks. Emits each rank's bytes, seconds, RssAnon and
    device peaks beside the whole path's cost (the file's tensors, held in
    host memory by every rank). Returns the ranks' launches of A and B."""
    from rbg_tpu_torch.models import safetensors_io
    from rbg_tpu_torch.models.checkpoint import NATIVE_FILE

    with safetensors_io.SafeFile(os.path.join(native, NATIVE_FILE)) as f:
        whole = sum(math.prod(f.shape(k)) * f.dtype(k).itemsize for k in f)
    with tempfile.TemporaryDirectory() as d:
        ranks, seconds = spawn_ranks(d, "ckpt_rank", (native, ref, hf, model, hf_model, dev),
                                     timeout=CKPT_TIMEOUT_S)
    recs = [r["native"] for r, _ in ranks]
    hf_turns = [r["hf"] for r, _ in ranks]
    emit("checkpoint", case="native_tp", model=model, card=card, tp=TP_WORLD,
         seconds_ranks=seconds, whole_path_host_bytes_per_rank=whole, ranks=recs)
    emit("checkpoint", case="hf_tp", model=hf_model, card=card, tp=TP_WORLD,
         turns=hf_turns)
    launches = {k: sum(r["launches"][k] for r in recs) for k in LLAMA_KERNELS}
    for r, rec in enumerate(recs):
        if rec["not_file_slices"] or rec["bytes_copied"] != rec["weight_bytes"]:
            raise AssertionError(f"rank {r}: weights not the file's slices "
                                 f"{rec['not_file_slices'][:4]}, {rec['bytes_copied']} "
                                 f"bytes copied for {rec['weight_bytes']}")
        if max(rec["first_step_max_abs"]) > TP_FIRST_BAND:
            raise AssertionError(f"rank {r}: first steps {rec['first_step_max_abs']} "
                                 f"past {TP_FIRST_BAND} of the unsharded engine's")
        if torch.device(dev).type == "cuda":
            check_launches(rec["launches"], LLAMA_KERNELS)
    if recs[0]["tokens"] != recs[1]["tokens"]:
        raise AssertionError(f"the ranks' streams differ: {recs[0]['tokens']} vs "
                             f"{recs[1]['tokens']}")
    if not all(t["equal_to_first"] for turns in hf_turns for t in turns):
        raise AssertionError(f"{hf_model}: rank-local and whole reads differ: {hf_turns}")
    return launches


def hf_dir(torch, d, model="qwen2-0.5b", seed=16, dev="cuda"):
    """An HF-layout directory of ``model``: bf16 weights from a seed, the
    q/k/v biases, a tied head (no lm_head), one model.safetensors written
    by the port's safetensors_io. Returns its bytes."""
    from rbg_tpu_torch.models import safetensors_io
    from rbg_tpu_torch.models.config import get_config

    cfg = get_config(model)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hq, hk = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, scale=0.02, base=0.0):
        x = base + scale * torch.randn(shape, generator=g, device=dev)
        return x.to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D, base=1.0)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": w(D, base=1.0),
                   p + "post_attention_layernorm.weight": w(D, base=1.0),
                   p + "self_attn.q_proj.weight": w(hq, D),
                   p + "self_attn.k_proj.weight": w(hk, D),
                   p + "self_attn.v_proj.weight": w(hk, D),
                   p + "self_attn.o_proj.weight": w(D, hq),
                   p + "self_attn.q_proj.bias": w(hq, scale=0.5),
                   p + "self_attn.k_proj.bias": w(hk, scale=0.5),
                   p + "self_attn.v_proj.bias": w(hk, scale=0.5),
                   p + "mlp.gate_proj.weight": w(F, D),
                   p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
    return safetensors_io.save_file(sd, os.path.join(d, "model.safetensors"))


def checkpoint_hf_server(torch, np, card, d, nbytes, model="qwen2-0.5b", dev="cuda",
                         extra=()):
    """The HF directory ``d`` (``hf_dir``, ``nbytes``) served by ``python -m
    rbg_tpu_torch.engine.server --model qwen2-0.5b --checkpoint-path DIR``
    as a process (on the card): two requests' greedy tokens equal an
    in-process engine's on the same directory and flags."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import build_config, parse_args

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    args = ["--model", model, "--checkpoint-path", d, *extra]
    rng = np.random.RandomState(17)
    V = build_config(parse_args(args)).model_config.vocab_size
    prompts = [rng.randint(0, V, n).tolist() for n in (40, 129)]
    with tempfile.TemporaryFile() as log:
        proc, addr = _spawn_server(args, root, {**os.environ, "PYTHONPATH": str(root)},
                                   log)
        try:
            ready_s = _wait_healthy([proc], [addr], log, timeout=300)
            replies = [request_obj(addr, {"op": "generate", "prompt": p,
                                          "max_new_tokens": 16}, timeout=300)
                       for p in prompts]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    eng = Engine(build_config(parse_args(args)))
    if "bq" not in eng.params["blocks"]:
        raise AssertionError("the directory's q/k/v biases were not loaded")
    sp = SamplingParams(max_new_tokens=16)
    want = [eng.generate([p], sp)[0] for p in prompts]
    got = [r.get("tokens") for r in replies]
    emit("checkpoint", case="hf_server", model=model, card=card, bytes=nbytes,
         ready_s=ready_s, seconds=time.perf_counter() - t0, tokens=got,
         equal_to_in_process=got == want)
    if got != want:
        raise AssertionError(f"{model} server from the HF directory: {replies} vs {want}")
    del eng
    free(torch, dev)


def train_checkpoint_phases(torch, np, card, model="llama3-8b", hf_model="qwen2-0.5b",
                            dev="cuda"):
    """The ``train`` and ``checkpoint`` phases, run before any serving
    phase holds weights on the card or host memory: the 16 GB checkpoint
    file may live in the machine's memory (a memory-backed root
    filesystem), so it is written while the host holds least. Returns the
    launches of kernels A and B on the checkpoint's serving path.
    ``model="tiny", hf_model="tiny", dev="cpu"`` rehearses them on the
    CPU."""
    import shutil

    t0 = time.perf_counter()
    train_tiny(torch, np, dev)
    train_remat_check(torch, np, model, dev)
    free(torch, dev)
    train_layout(torch, np, model, dev)
    params, first_loss, tokens = train_llama(torch, np, card, model, dev)
    hf = tempfile.mkdtemp(prefix="rbg-hf-")
    try:
        hf_bytes = hf_dir(torch, hf, hf_model, dev=dev)
        launches = checkpoint_llama(torch, np, card, params, hf, model, hf_model, dev)
        del params
        free(torch, dev)
        train_mesh(torch, np, first_loss, tokens, model, dev)
        checkpoint_hf_server(torch, np, card, hf, hf_bytes, hf_model, dev,
                             extra=("--device", "cpu") if dev == "cpu" else ())
    finally:
        shutil.rmtree(hf, ignore_errors=True)
    emit("train_checkpoint", seconds=time.perf_counter() - t0)
    return launches


def bench_slo_phase(card):
    """bench_slo --setups unified,pd at llama3-8b (BENCH_SLO_ARGS): a
    spawned server on the card, then a spawned PD group (kv pool, prefill
    and decode servers on the card, the router), one low rate each through
    bench_serving --addr: every request completes; TTFT, ITL and goodput
    of both setups."""
    from rbg_tpu_torch.engine import bench_slo

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slo.json")
        t0 = time.perf_counter()
        bench_slo.main(BENCH_SLO_ARGS + ["--json-out", path])
        with open(path) as f:
            art = json.load(f)
    res = art["results"]
    emit("bench_slo", card=card, seconds=time.perf_counter() - t0,
         rows=res["unified"], pd_rows=res["pd"],
         slo_targets=art["slo_targets"], pd_over_unified=art["pd_over_unified"],
         readings={s: [{"rate_rps": r["offered_rate_rps"], "ttft_s": r["ttft_s"],
                        "itl_ms": r["itl_ms"], "goodput_rps": r.get("goodput_rps")}
                       for r in rows] for s, rows in res.items()})
    n = int(BENCH_SLO_ARGS[BENCH_SLO_ARGS.index("--requests") + 1])
    for setup, rows in res.items():
        if [r["completed"] for r in rows] != [n]:
            raise AssertionError(f"bench_slo {setup}: {rows}")


GPUCHECK_TIMEOUT_S = 600


def gpucheck_phase(card):
    """``python -m rbg_tpu_torch.cli.gpucheck`` as a subprocess: exit 0 and
    every stage ok (all nine kernels within tolerance of their plain
    versions, the bench's requests complete, kernels A and B launched by the
    engine stage). Emits the verdict."""
    from rbg_tpu_torch.cli.gpucheck import STAGES

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "rbg_tpu_torch.cli.gpucheck"], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
                         text=True, timeout=GPUCHECK_TIMEOUT_S)
    lines = out.stdout.strip().splitlines()
    doc = json.loads(lines[-1]) if lines else {}
    emit("gpucheck", card=card, rc=out.returncode, seconds=time.perf_counter() - t0,
         verdict=doc)
    stages = doc.get("stages", {})
    kernels = stages.get("kernels", {}).get("kernels", {})
    if (out.returncode != 0 or list(stages) != list(STAGES)
            or not all(st.get("ok") for st in stages.values()) or len(kernels) != 9
            or not all(k["ok"] for k in kernels.values())):
        raise AssertionError(f"gpucheck: rc {out.returncode}, {doc or out.stderr[-2000:]}")


def probe_phase(torch):
    """The block_ragged probe (kernel I against kernel B on a prefill-heavy
    pack); its launches of kernel I are that path's. Returns them. Then
    each kernel's own device time on the probe's pack (``device_ms``, one
    launch per call), which tells the two grid shapes apart where the
    probe's calls per second read the host."""
    from rbg_tpu_torch.bench import block_ragged_pack, block_ragged_probe
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
        ragged_paged_attention_tokengrid_cuda)

    reset_launches()
    out = block_ragged_probe()
    launches = dict(LAUNCHES)
    if not (out["measurable"] and out["bit_identical"]):
        emit("ragged_ab", launches=launches, **out)
        raise AssertionError(f"block_ragged probe: kernels disagree with the "
                             f"plain version: {out}")
    check_launches(launches, PROBE_KERNELS)
    args = block_ragged_pack(torch.device("cuda"))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    dev_ms = {
        "tokengrid": device_ms(torch, lambda: ragged_paged_attention_tokengrid_cuda(*args),
                               flush, "ragged_paged_tokengrid_kernel"),
        "block_ragged": device_ms(torch, lambda: ragged_paged_attention_cuda(*args),
                                  flush, "ragged_paged_kernel")}
    emit("ragged_ab", launches=launches, **out, device_ms=dev_ms,
         device_speedup=dev_ms["tokengrid"] / dev_ms["block_ragged"])
    return {k: launches[k] for k in PROBE_KERNELS}


# ---- the tp phase: tensor-parallel serving over a gloo world on one card ----

TP_WORLD = 2
TP_TIMEOUT_S = 900
TP_TINY_CASES = (("tiny", {"tp": 2}, LLAMA_KERNELS), ("tiny-moe", {"tp": 2}, LLAMA_KERNELS),
                 ("tiny-moe", {"ep": 2}, LLAMA_KERNELS), ("tiny-mla", {"tp": 2}, MLA_KERNELS))
TP_MODELS = ("llama3-8b", "deepseek-v2-lite")
TP_NUM_PAGES = 512
TP_DECODE_STEPS = 4              # decode steps a reading averages (twice: wall, device)


def tp_prompts(np, V):
    """The two requests of a big model's streams: A steps into decode, then
    B joins, so one ragged step holds A's decode row and B's first chunk."""
    rng = np.random.RandomState(1)
    return rng.randint(0, V, 100).tolist(), rng.randint(0, V, 150).tolist()


def tp_pools(cfg):
    """(kv_dtype, kernels of its path) of a tp model's two pool kinds."""
    if cfg.mla:
        return (("model", MLA_KERNELS), ("int8", MLA_INT8_KERNELS))
    return (("model", LLAMA_KERNELS), ("int8", INT8_KERNELS))


def tp_streams(torch, np, eng):
    """A (24 new tokens) into its first decode window alone, then B (16)
    joins; both run to completion (multi_step 4: unified steps, then decode
    windows). Returns {"a": tokens, "b": tokens}."""
    from rbg_tpu_torch.engine.config import SamplingParams

    pa, pb = tp_prompts(np, eng.mcfg.vocab_size)
    a = eng.add_request(pa, SamplingParams(max_new_tokens=24))
    out = {a: []}
    while not out[a]:
        for e in eng.step():
            out[e.request_id].append(e.token)
    for e in eng.step():
        out[e.request_id].append(e.token)
    b = eng.add_request(pb, SamplingParams(max_new_tokens=16))
    out[b] = []
    while eng.has_work():
        for e in eng.step():
            out[e.request_id].append(e.token)
    sync(torch, eng.device)
    return {"a": out[a], "b": out[b]}


@contextlib.contextmanager
def moe_masks(torch, force=None):
    """Record the kept-expert mask of every ``_moe_mlp`` call while the
    block runs, as ``models/llama.py`` keeps experts (``probs >=
    threshold``): ``masks``, one bool array [tokens, E] per call (a
    forward's calls are its layers, in order), and ``margins``, each
    token's router-logit gap between its k-th and (k+1)-th expert in
    bfloat16 ulps of the k-th logit (0: a tie). Wraps the module's
    function; changes no model code.

    ``force`` ([calls, tokens, E] bool): each call keeps those experts
    (ties and all) instead of its own top k, weighted by its own
    probabilities as the model weights its kept experts: for that call
    the module's ``softmax`` is masked and its ``topk`` threshold is the
    least kept probability, so ``_moe_mlp`` itself runs unchanged. The
    recorded masks are the experts it then kept."""
    import rbg_tpu_torch.models.llama as llama

    rec, inner, module_torch = {"masks": [], "margins": []}, llama._moe_mlp, llama.torch

    class Forced:
        """The module's ``torch``, with the router's softmax masked and its
        top-k threshold the least kept probability."""
        mask = None

        def __getattr__(self, name):
            return getattr(torch, name)

        def softmax(self, x, *a, **k):
            p = torch.softmax(x, *a, **k)
            return p if self.mask is None else p * self.mask

        def topk(self, x, k, *a, **kw):
            if self.mask is None:
                return torch.topk(x, k, *a, **kw)
            low = torch.where(self.mask > 0, x, torch.inf).amin(-1, keepdim=True)
            return types.SimpleNamespace(values=low.expand(*low.shape[:-1], k))

    forced = Forced()

    def recording(cfg, blk, xm, par=None):
        K, E = cfg.experts_per_token, cfg.num_experts
        logits = (xm @ blk["router"]).float()
        probs = torch.softmax(logits, dim=-1)
        if force is not None:
            forced.mask = torch.from_numpy(force[len(rec["masks"])]).to(
                probs.device, probs.dtype).reshape(probs.shape)
            probs = forced.softmax(logits, dim=-1)
        threshold = forced.topk(probs, K, dim=-1).values[..., -1:]
        rec["masks"].append((probs >= threshold).reshape(-1, E).cpu().numpy())
        top = torch.topk(logits.reshape(-1, E), K + 1, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top[:, K - 1].abs().clamp_min(1e-30))) - 7)
        rec["margins"].append(((top[:, K - 1] - top[:, K]) / ulp).cpu().numpy())
        try:
            return inner(cfg, blk, xm, par)
        finally:
            forced.mask = None

    llama._moe_mlp = recording
    if force is not None:
        llama.torch = forced
    try:
        yield rec
    finally:
        llama._moe_mlp, llama.torch = inner, module_torch


def swap_reading(np, gap, band, masks_a, masks_b, margins=None):
    """Which tokens of a first step lie past ``band`` (``gap``: each token's
    largest logit distance between two runs) and whether their kept
    experts differ in some layer between the runs' masks ([L, tokens, E]
    each; None for a dense model, where no token swaps). ``margins``
    ([L, tokens], bfloat16 ulps, run B's): for each token past the band,
    its router margin at its first differing layer."""
    n = len(gap)
    differ = (np.zeros((1, n), bool) if masks_a is None
              else (masks_a != masks_b).any(axis=2))              # [L, tokens]
    swapped = differ.any(axis=0)
    # A swap reaches later tokens through attention: a token whose own
    # masks agree but an earlier token's differ is "downstream".
    downstream = ~swapped & (np.cumsum(swapped) > 0)
    past = gap > band
    same = ~swapped
    first = [int(np.argmax(differ[:, t])) for t in np.flatnonzero(past & swapped)]
    return {"tokens": n, "past_band": int(past.sum()),
            "past_band_swapped": int((past & swapped).sum()),
            "past_band_same_masks": int((past & same).sum()),
            "past_band_same_masks_downstream": int((past & downstream).sum()),
            "swapped": int(swapped.sum()),
            "layers_differing": None if masks_a is None else int(differ.any(axis=1).sum()),
            # (token, layer) cells whose kept experts differ, and for each
            # token past the band the first such layer (and the margin
            # there).
            "cells_differing": None if masks_a is None else int(differ.sum()),
            "past_band_first_layer": first,
            "past_band_first_margin_ulps": (
                [] if margins is None else
                [round(float(margins[l, t]), 3)
                 for l, t in zip(first, np.flatnonzero(past & swapped))]),
            "max_abs": float(gap.max()),
            "max_abs_same_masks": float(gap[same].max()) if same.any() else 0.0,
            "max_abs_past_band_same_masks": (float(gap[past & same].max())
                                             if (past & same).any() else None),
            "max_abs_swapped": float(gap[swapped].max()) if swapped.any() else None}


def first_step_logits(torch, eng, prompt, chunk=None, use_kernels="auto"):
    """The logits [n, V] of the engine's first step on ``prompt`` alone: its
    first prefill chunk (n tokens) through the engine's own forward_ragged,
    params, pool kind and ``par``, on a pool of its own. ``chunk``: the
    same n tokens as consecutive forwards of ``chunk`` tokens each (a
    multiple of the page size); ``use_kernels``: forward_ragged's."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.models.llama import forward_ragged

    n, ps = min(len(prompt), eng.cfg.prefill_chunk), eng.cfg.page_size
    pages, chunk = -(-n // ps), chunk or n
    c = PagedKVCache.create(eng.mcfg, pages + 1, ps, device=eng.device,
                            quantize=eng.cache.quantized, tp=eng.tp)
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=eng.device)  # noqa: E731
    out = []
    for s0 in range(0, n, chunk):
        m = min(chunk, n - s0)
        pos = ints([list(range(s0, s0 + m))])
        out.append(forward_ragged(
            eng.params, eng.mcfg, torch.tensor([prompt[s0:s0 + m]], device=eng.device),
            pos, pos >= 0, ints([0] * m), ints([s0 + m]), ints([list(range(1, pages + 1))]),
            c.k_pages, c.v_pages, use_kernels=use_kernels, max_q_len=eng.cfg.prefill_chunk,
            k_scales=c.k_scales, v_scales=c.v_scales, par=eng.par)[0])
    return torch.cat(out)


def decode_reading(torch, np, eng):
    """Wall and device ms of one decode step (multi_step 1) with A and B
    both decoding (``step_times``)."""
    from rbg_tpu_torch.engine.config import SamplingParams

    for p in tp_prompts(np, eng.mcfg.vocab_size):
        eng.add_request(p, SamplingParams(max_new_tokens=8 + 2 * TP_DECODE_STEPS))
    while eng.waiting or any(r.state != "running" for r in eng.running):
        eng.step()
    eng.step()
    if eng.device.type == "cuda":
        wall, dev = step_times(torch, eng, TP_DECODE_STEPS)
    else:                                    # a CPU rehearsal: no device time
        t0 = time.perf_counter()
        for _ in range(TP_DECODE_STEPS):
            eng.step()
        wall, dev = (time.perf_counter() - t0) / TP_DECODE_STEPS * 1e3, None
    while eng.has_work():
        eng.step()
    return {"wall_ms": wall, "device_ms": dev}


def tree_bytes(params, model):
    """{weights, split, rest}: all bytes, those of the leaves tp splits,
    the rest (whole on every rank)."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.parallel import param_specs

    specs = param_specs(get_config(model), params)
    pairs = [(params[k], specs[k]) for k in params if k != "blocks"]
    pairs += [(w, specs["blocks"][k]) for k, w in params["blocks"].items()]
    size = lambda w: w.numel() * w.element_size()  # noqa: E731
    split = sum(size(w) for w, sp in pairs if "tp" in sp)
    total = sum(size(w) for w, _ in pairs)
    return {"weights": total, "split": split, "rest": total - split}


def pool_bytes(eng):
    c = eng.cache
    return sum(t.numel() * t.element_size() for t in
               (c.k_pages, c.v_pages, c.k_scales, c.v_scales) if t is not None)


# ---- the tp phase's serving loops over the mesh (rank 0 leads) ----

# tiny's two-rank services: 8 submissions from threads on rank 0, 20 ms
# apart, into max_batch 4 (the queue forms and the join hint fires): 5
# greedy, 1 seeded, 1 cancelled after its first token, 1 whose deadline
# (TP_SVC_DEADLINE_S after submission) runs out while it decodes
# TP_SVC_LONG tokens.
TP_SVC_PROMPT_LENS = (5, 40, 23, 70, 31, 12, 50, 18)
# tiny's layer-sliced pair: a link slow enough for tiny's KV (a few KB a
# layer) to land a layer at a time.
TP_TINY_LINK = dict(bytes_per_s=2e5, latency_s=0.0005)
TP_SVC_LONG = 200
TP_SVC_DEADLINE_S = 1.5
# llama3-8b's two-rank service: 8 requests of 128-512 random tokens, 32 new.
TP_LLAMA_SVC_LENS = (128, 512, 300, 200, 450, 160, 384, 256)
TP_LLAMA_SVC_NEW = 32
# The tier drive at tp 2: fewer and shorter prompts than the tier phase's
# through a pool that holds about two of them, twice, one at a time, under
# a budget of TP_TIER_HOST_PAGES whole pages: the budget evicts (a page)
# and pass 2 still hits every prompt as deep as the device-hit engine (96
# pages evict 90 and cut every hit short; 152 evict none).
TP_TIER_PROMPT_LENS = (512, 896, 640, 768)
TP_TIER_NUM_PAGES = 100
TP_TIER_HOST_PAGES = 144
TP_TIER_NEW = 8
# The layer-sliced PD drive at tp 2 (PD_LAYER_SPLIT, PD_ADMIT_LAYERS, the pd
# phase's paced link, one per rank; 1 and 1 at a model of fewer layers than
# PD_ADMIT_LAYERS, as the pd phase's CPU rehearsal); its last prompt also goes as a bundle
# through a two-rank DecodeService (llama3-8b's 512 tokens: ~67 MB of whole
# heads in one plan).
TP_PD_PROMPT_LENS = (2032, 1100, 512)


def tp_service_jobs(np, V, lens, new, mix):
    """(prompt, sampling, kind) of a service drive: with ``mix``, tiny's
    (see TP_SVC_PROMPT_LENS), else all greedy."""
    from rbg_tpu_torch.engine.config import SamplingParams

    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, V, n).tolist() for n in lens]
    greedy = SamplingParams(max_new_tokens=new)
    if not mix:
        return [(p, greedy, "run") for p in prompts]
    seeded = SamplingParams(max_new_tokens=new, temperature=0.9, top_k=40, seed=11)
    long = SamplingParams(max_new_tokens=TP_SVC_LONG)
    kinds = ([(greedy, "run")] * 3 + [(seeded, "run"), (long, "cancel")]
             + [(greedy, "run")] * 2 + [(long, "deadline")])
    return [(p, s, k) for p, (s, k) in zip(prompts, kinds)]


def drive_service(svc, jobs):
    """Submit ``jobs`` to ``svc`` from threads, 20 ms apart; a watcher
    stamps each token's arrival (~1 ms). Returns per job its tokens, error,
    TTFT (submission to the first token) and ITL (the gaps after it)."""
    import threading

    pend, out = [None] * len(jobs), [None] * len(jobs)
    stamps = [[] for _ in jobs]
    done = threading.Event()

    def watch():
        while not done.is_set():
            now = time.perf_counter()
            for j, p in enumerate(pend):
                if p is not None and len(p.tokens) > len(stamps[j]):
                    stamps[j].extend([now] * (len(p.tokens) - len(stamps[j])))
            time.sleep(0.001)

    def run(j):
        prompt, sp, kind = jobs[j]
        dl = time.monotonic() + TP_SVC_DEADLINE_S if kind == "deadline" else None
        p = pend[j] = svc.submit_async(prompt, sp, deadline=dl)
        if kind == "cancel":
            while not p.tokens and not p.done.is_set():
                time.sleep(0.001)
            svc.cancel(p)
        err = None
        try:
            svc.wait(p, TP_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 — the drive reads it
            err = f"{type(e).__name__}: {e}"
        out[j] = {"kind": kind, "tokens": list(p.tokens), "error": err,
                  "t_submit": p.t_submit}

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    threads = [threading.Thread(target=run, args=(j,)) for j in range(len(jobs))]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join()
    done.set()
    watcher.join()
    for o, s in zip(out, stamps):
        o["ttft_s"] = s[0] - o.pop("t_submit") if s else None
        o["itl_s"] = [b - a for a, b in zip(s, s[1:])]
    return out


def settle_service(svc):
    """End a service's loop (the leader's stop() sends its last plan; a
    follower's waits for it, and no other collective runs meanwhile), then
    read its rank's engine: metrics, rows and requests left, the plans."""
    svc.stop(timeout=TP_TIMEOUT_S)
    eng = svc.engine
    return {"metrics": {k: eng.metrics[k] for k in ("steps", "joins", "decode_windows",
                                                    "preemptions", "unified_steps")},
            "running": len(eng.running), "waiting": len(eng.waiting),
            "live": sum(r.state != "finished" for r in eng.requests.values()),
            "loop_alive": svc._thread.is_alive(),
            "fault": None if svc.fault is None else repr(svc.fault),
            "plans": None if svc._lockstep is None else svc._lockstep.stats()}


def decode_drive(svc, bundles, stream):
    """Bundles from threads, then ``stream`` (a bundle's KV as chunk stream
    frames, fed on this thread): each one's tokens, the first included."""
    import threading

    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.kvtransfer.chunks import StreamMeta, bundle_to_frames

    sp = SamplingParams(max_new_tokens=16)
    out = [None] * len(bundles)
    threads = [threading.Thread(target=lambda j=j: out.__setitem__(
        j, svc.submit_bundle(bundles[j], sp))) for j in range(len(bundles))]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join()
    if stream is not None:
        meta = StreamMeta(stream_id="tp-stream", prompt=list(stream.prompt),
                          n_pages=stream.k_data.shape[1],
                          k_page_shape=tuple(stream.k_data.shape[2:]),
                          v_page_shape=tuple(stream.v_data.shape[2:]), dtype=stream.dtype,
                          layers=stream.k_data.shape[0], page_size=svc.engine.cfg.page_size)
        rx = svc.kv_streams.get_or_create(meta.stream_id)
        svc.watch_stream(rx)
        for f in bundle_to_frames(meta, stream.k_data, stream.v_data, stream.first_token, 1):
            rx.feed(f)
        rx.wait_ready(60)
        p = svc.submit_stream(rx, sp)
        svc.wait(p, TP_TIMEOUT_S)
        out.append([stream.first_token] + p.tokens)
    return out


def pd_runs(pair, prompts, sp):
    """Each prompt through a PDStreamPair: tokens and layers at admission."""
    runs = [pair.generate_one(p, sp) for p in prompts]
    return {"tokens": [r["tokens"] for r in runs],
            "layers_at_admit": [r["layers_at_admit"] for r in runs]}


def tp_tiny_services(torch, np, mesh, rank, dev, arrays):
    """tiny (f32) through the two-rank services on weights drawn on the
    CPU: EngineService (TP_SVC_PROMPT_LENS' mix), DecodeService (two
    bundles of a tp 2 PDPair, then the first as a chunk stream) and
    PDStreamPair(layer_split=1, admit_layers=1) on a paced link (tiny has 2
    layers: PD_LAYER_SPLIT 4 would send them whole). Rank 0 keeps the
    bundles in ``arrays`` for the one-rank counterparts."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.pd import PDPair, PDStreamPair
    from rbg_tpu_torch.engine.service import DecodeService, EngineService
    from rbg_tpu_torch.kvtransfer.transport import FakeICITransport
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    params = init_params(get_config("tiny"), 0, "cpu")
    cfg = tiny_service_config(dev)
    out = {}
    svc = EngineService(cfg, params=params, device=dev, mesh=mesh)
    reset_launches()
    if rank == 0:
        out["service"] = drive_service(svc, tp_service_jobs(np, 256, TP_SVC_PROMPT_LENS,
                                                            16, True))
    else:
        try:
            svc.submit([1, 2, 3], SamplingParams())
            out["follower_submit"] = None
        except ValueError as e:
            out["follower_submit"] = str(e)
    out["service_state"] = settle_service(svc)
    sync(torch, dev)
    out["launches"] = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
    rng = np.random.RandomState(8)
    pair = PDPair(cfg, params=params, device=dev, mesh=mesh)
    bundles = [pair.prefill.prefill(rng.randint(0, 256, n).tolist()) for n in (37, 21)]
    del pair
    if rank == 0:
        for j, b in enumerate(bundles):
            arrays[f"tiny_bundle{j}/k"], arrays[f"tiny_bundle{j}/v"] = b.k_data, b.v_data
            arrays[f"tiny_bundle{j}/meta"] = np.array(json.dumps(
                [b.prompt, b.first_token, b.dtype]))
    dec = DecodeService(cfg, params=params, device=dev, mesh=mesh)
    if rank == 0:
        out["decode"] = decode_drive(dec, bundles, bundles[0])
    out["decode_state"] = settle_service(dec)
    pair = PDStreamPair(cfg, params=params, device=dev, mesh=mesh, layer_split=1,
                        admit_layers=1,
                        transport=FakeICITransport(**TP_TINY_LINK))
    out["pd"] = pd_runs(pair, [b.prompt for b in bundles], SamplingParams(max_new_tokens=16))
    out["pd_plans"] = pair.lockstep.stats()
    return out


def tiny_service_config(dev):
    from rbg_tpu_torch.engine.config import EngineConfig
    return EngineConfig(model="tiny", num_pages=256, max_seq_len=256, max_batch=4,
                        multi_step=4, device=dev)


def tp_tier_drive(torch, np, params, mesh, dev, model="llama3-8b"):
    """The host tier at tp 2 (each rank its own KV heads, 1/2 the budget):
    TP_TIER_PROMPT_LENS through a pool of TP_TIER_NUM_PAGES, twice, one at a
    time; every promoted page's checksum on this rank against the page's
    before its spill (``tier_probe``); pass 2's tokens against a tp 2
    engine that device-hits them (a pool for all, its second pass), which
    hits every prompt as deep (TP_TIER_HOST_PAGES)."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    sync_ = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    prompts, sp, cfg = tier_drive_inputs(np, model, dev)
    eng = Engine(EngineConfig(num_pages=TP_TIER_NUM_PAGES, **cfg), params=params, mesh=mesh,
                 sliced=True)
    rec = tier_probe(torch, eng.host_tier, eng.cfg.page_size, sync_)
    reset_launches()
    passes = [[timed_generate(eng, p, sp, rec) for p in prompts] for _ in range(2)]
    sync_()
    launches = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
    stats = dict(eng.host_tier.stats())
    out = {"tokens": [[r[0] for r in ps] for ps in passes],
           "hits": [r[2] for r in passes[1]], "stats": stats,
           "closes": eng.host_tier.accounting_closes(),
           "host_hit_tokens": eng.metrics["host_hit_tokens"],
           "checked": rec["checked"], "mismatch": len(rec["mismatch"]), "launches": launches}
    del eng
    free(torch, dev)
    cfg.pop("host_tier_bytes")
    ref = Engine(EngineConfig(num_pages=TP_TIER_NUM_PAGES * len(prompts), **cfg),
                 params=params, mesh=mesh, sliced=True)
    hit = [[timed_generate(ref, p, sp) for p in prompts] for _ in range(2)][1]
    out["device_hit"], out["device_hits"] = [r[0] for r in hit], [r[2] for r in hit]
    del ref
    free(torch, dev)
    return out


def tier_drive_inputs(np, model, dev):
    """The tier drive's prompts, sampling and engine config (its budget
    TP_TIER_HOST_PAGES whole pages of ``model``)."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.models.config import get_config

    m = get_config(model)
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, m.vocab_size, n).tolist() for n in TP_TIER_PROMPT_LENS]
    page = 2 * m.num_layers * 16 * m.num_kv_heads * m.head_dim_ * m.torch_dtype.itemsize
    cfg = dict(model=model, max_seq_len=1024, prefill_chunk=512, multi_step=4, device=dev,
               host_tier_bytes=TP_TIER_HOST_PAGES * page)
    return prompts, SamplingParams(max_new_tokens=TP_TIER_NEW), cfg


def tp_llama_loops(torch, np, mesh, rank, dev, model="llama3-8b"):
    """llama3-8b's serving loops at tp 2, each on weights it draws itself
    from the seed (rank-local): PDStreamPair(PD_LAYER_SPLIT,
    PD_ADMIT_LAYERS) on a paced link, then the same pair at admit_layers
    0; the last prompt's bundle through a two-rank DecodeService; the
    two-rank EngineService on TP_LLAMA_SVC_LENS."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.pd import PDStreamPair
    from rbg_tpu_torch.engine.service import DecodeService, EngineService
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    out = {}
    V = get_config(model).vocab_size
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, V, n).tolist() for n in TP_PD_PROMPT_LENS]
    sp = SamplingParams(max_new_tokens=PD_NEW_TOKENS)
    pd_cfg = EngineConfig(model=model, num_pages=PD_NUM_PAGES, max_seq_len=2080,
                          prefill_chunk=512, multi_step=4, device=dev)
    deep = pd_cfg.model_config.num_layers > PD_ADMIT_LAYERS
    pair = PDStreamPair(pd_cfg, device=dev, mesh=mesh,
                        layer_split=PD_LAYER_SPLIT if deep else 1,
                        admit_layers=PD_ADMIT_LAYERS if deep else 1, transport=paced_link())
    reset_launches()
    out["pd_sliced"] = pd_runs(pair, prompts, sp)
    pair.admit_layers = 0
    out["pd_full"] = pd_runs(pair, prompts, sp)
    sync(torch, dev)
    out["pd_launches"] = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
    out["pd_plans"] = pair.lockstep.stats()
    bundle = pair.prefill.prefill(prompts[-1], sp)
    out["bundle_bytes"] = bundle.nbytes
    del pair
    free(torch, dev)
    dec = DecodeService(pd_cfg, device=dev, mesh=mesh)
    if rank == 0:
        out["decode"] = decode_drive(dec, [bundle], None)[0]
    out["decode_state"] = settle_service(dec)
    del dec, bundle
    free(torch, dev)
    svc = EngineService(llama_service_config(model, dev), device=dev, mesh=mesh)
    reset_launches()
    if rank == 0:
        out["service"] = drive_service(svc, tp_service_jobs(
            np, V, TP_LLAMA_SVC_LENS, TP_LLAMA_SVC_NEW, False))
    out["service_state"] = settle_service(svc)
    sync(torch, dev)
    out["service_launches"] = {k: LAUNCHES[k] for k in LLAMA_KERNELS}
    del svc
    free(torch, dev)
    return out


def serves_loops(model):
    """The tp phase drives the tier, PD and service loops at the dense GQA
    model (llama3-8b; tiny in a CPU rehearsal)."""
    from rbg_tpu_torch.models.config import get_config
    cfg = get_config(model)
    return not cfg.mla and not cfg.num_experts


def llama_service_config(model, dev):
    from rbg_tpu_torch.engine.config import EngineConfig
    return EngineConfig(model=model, num_pages=TP_NUM_PAGES, max_seq_len=1024,
                        max_batch=8, multi_step=4, device=dev)

def tp_rank(torch, np, world, rank, port, out_path, dev="cuda", models=TP_MODELS):
    """One rank of the tp phase (``spawn_ranks``): every rank makes the
    same calls. The tiny models from weights drawn on the CPU
    (kernels A, B; E, F for tiny-mla), then llama3-8b and deepseek-v2-lite
    at tp 2 from the rank-local init (seed 0), each over model-dtype and
    int8 pools: the first step's logits, the two streams (launches counted
    from 0 around them), a decode step's wall and device ms, the bytes held.
    Writes its results to ``out_path``."""
    import torch.distributed as dist

    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rbg_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if dev == "cuda":
        torch.cuda.set_device(0)
    res, arrays = {"rank": rank, "tiny": {}, "big": {}}, {}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 40, 23, 70)]
    for model, axes, kernels in TP_TINY_CASES:
        mesh = make_mesh(**axes, device=dev)
        params = init_params(get_config(model), 0, "cpu")
        eng = Engine(EngineConfig(model=model, num_pages=256, max_seq_len=256, multi_step=4),
                     params=params, device=dev, mesh=mesh)
        reset_launches()
        toks = eng.generate(prompts, SamplingParams(max_new_tokens=16))
        sync(torch, dev)
        res["tiny"][f"{model} {axes}"] = {"tokens": toks,
                                          "launches": {k: LAUNCHES[k] for k in kernels}}
    res["services"] = tp_tiny_services(torch, np, make_mesh(tp=TP_WORLD, device=dev), rank,
                                       dev, arrays)
    for model in models:
        mesh = make_mesh(tp=TP_WORLD, device=dev)
        peak_reset(torch, dev)
        t0 = time.perf_counter()
        params = init_params(get_config(model), 0, dev, mesh=mesh)
        sync(torch, dev)
        init = {"seconds": time.perf_counter() - t0, "peak_bytes": peak_bytes(torch, dev),
                **tree_bytes(params, model)}
        for kv_dtype, kernels in tp_pools(get_config(model)):
            kw = dict(model=model, num_pages=TP_NUM_PAGES, max_seq_len=1024, kv_dtype=kv_dtype,
                      device=dev)
            eng = Engine(EngineConfig(multi_step=4, **kw), params=params, mesh=mesh,
                         sliced=True)
            with moe_masks(torch) as rec:
                first = first_step_logits(torch, eng, tp_prompts(np, eng.mcfg.vocab_size)[0])
            reset_launches()
            streams = tp_streams(torch, np, eng)
            launches = {k: LAUNCHES[k] for k in kernels}
            pools_b = pool_bytes(eng)
            del eng
            reading = decode_reading(torch, np, Engine(EngineConfig(multi_step=1, **kw),
                                                       params=params, mesh=mesh,
                                                       sliced=True))
            key = f"{model}/{kv_dtype}"
            arrays[key] = first.float().cpu().numpy()
            if rec["masks"]:
                arrays[f"{key}/masks"] = np.stack(rec["masks"])
            res["big"][key] = {"tokens": streams, "launches": launches, "pool_bytes": pools_b,
                               "init": init, **reading}
            free(torch, dev)
        loops = serves_loops(model)
        if loops:
            res["tier"] = tp_tier_drive(torch, np, params, mesh, dev, model)
        del params
        free(torch, dev)
        if loops:
            res["loops"] = tp_llama_loops(torch, np, mesh, rank, dev, model)
    np.savez(out_path, results=np.array(json.dumps(res)), **arrays)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(out_dir, fn, args=(), world=TP_WORLD, timeout=TP_TIMEOUT_S):
    """A gloo world of ``world`` processes of this script on the one card,
    rank r running ``fn(torch, numpy, world, r, port, out_dir/rank<r>.npz,
    *args)``. Raises when a rank fails (the others are killed) or they
    outlast ``timeout``; returns each rank's (results, arrays) and the
    seconds they took."""
    import numpy as np

    root = Path(__file__).resolve().parent
    port, procs, logs = free_port(), [], []
    for r in range(world):
        log = tempfile.TemporaryFile()
        logs.append(log)
        code = ("import numpy, torch, chip_smoke as cs; "
                f"cs.{fn}(torch, numpy, {world}, {r}, {port}, "
                f"{str(Path(out_dir) / f'rank{r}.npz')!r}, *{tuple(args)!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=root,
            env={**os.environ, "PYTHONPATH": str(root)},
            stdout=log, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                logs[bad[0] if bad else 0].seek(0)
                raise AssertionError(
                    f"{fn} rank {bad[0] if bad else 'all'} "
                    f"{'failed' if bad else 'timed out'}: "
                    + logs[bad[0] if bad else 0].read().decode()[-4000:])
            time.sleep(0.5)
        if any(p.returncode for p in procs):
            r = next(r for r, p in enumerate(procs) if p.returncode)
            logs[r].seek(0)
            raise AssertionError(f"{fn} rank {r} failed: " + logs[r].read().decode()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r in range(world):
        got = np.load(Path(out_dir) / f"rank{r}.npz")
        out.append((json.loads(str(got["results"])),
                    {k: got[k] for k in got.files if k != "results"}))
    return out, time.perf_counter() - t0


def service_reading(out):
    """TTFT, ITL and TPOT p50 over a service drive's requests (ms). ITL is
    every gap between two tokens as they reached the caller: a decode
    window delivers its multi_step tokens together, so most gaps are ~0
    and TPOT (each request's mean gap after its first token) reads the
    pace."""
    ttft = [o["ttft_s"] for o in out if o["ttft_s"] is not None]
    itl = [g for o in out for g in o["itl_s"]]
    tpot = [sum(o["itl_s"]) / len(o["itl_s"]) for o in out if o["itl_s"]]
    ms = lambda v: statistics.median(v) * 1e3 if v else None  # noqa: E731
    return {"ttft_p50_ms": ms(ttft), "itl_p50_ms": ms(itl), "tpot_p50_ms": ms(tpot),
            "requests": len(out)}


def check_tiny_services(torch, np, ranks, dev, card):
    """The one-rank counterparts on the card of tiny's two-rank services:
    the same submissions through a one-rank EngineService (the 6 uncut
    streams equal), the ranks' bundles and stream through a one-rank
    DecodeService, the same prompts through a one-rank PDStreamPair
    (layer_split 1, admit_layers 1). Both ranks' engines ended with equal
    metrics and no row. Returns the ranks' launches of the service drive."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.pd import KVBundle, PDStreamPair
    from rbg_tpu_torch.engine.service import DecodeService, EngineService
    from rbg_tpu_torch.kvtransfer.transport import FakeICITransport
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params

    got = ranks[0][0]["services"]
    params = params_to(init_params(get_config("tiny"), 0, "cpu"), dev)
    cfg = tiny_service_config(dev)
    svc = EngineService(cfg, params=params, device=dev)
    want = drive_service(svc, tp_service_jobs(np, 256, TP_SVC_PROMPT_LENS, 16, True))
    svc.stop()
    uncut = [j for j, o in enumerate(got["service"]) if o["kind"] == "run"]
    streams_equal = all(got["service"][j]["tokens"] == want[j]["tokens"] for j in uncut)
    cut = {o["kind"]: {"tokens": len(o["tokens"]), "error": o["error"]}
           for o in got["service"] if o["kind"] != "run"}
    cut_ok = (0 < cut["cancel"]["tokens"] < TP_SVC_LONG and cut["cancel"]["error"] is None
              and 0 < cut["deadline"]["tokens"] < TP_SVC_LONG
              and str(cut["deadline"]["error"]).startswith("DeadlineExceeded"))
    states = [r["services"][k] for r, _ in ranks for k in ("service_state", "decode_state")]
    clean = all(st["running"] == st["waiting"] == st["live"] == 0 and not st["loop_alive"]
                and st["fault"] is None for st in states)
    metrics_equal = all(len({json.dumps(r["services"][k]["metrics"]) for r, _ in ranks}) == 1
                        for k in ("service_state", "decode_state"))
    arrays = ranks[0][1]
    bundles = []
    for j in range(2):
        prompt, first, wire = json.loads(str(arrays[f"tiny_bundle{j}/meta"]))
        bundles.append(KVBundle(prompt=prompt, first_token=first, dtype=wire,
                                k_data=arrays[f"tiny_bundle{j}/k"],
                                v_data=arrays[f"tiny_bundle{j}/v"]))
    dec = DecodeService(cfg, params=params, device=dev)
    dec_want = decode_drive(dec, bundles, bundles[0])
    dec.stop()
    pair = PDStreamPair(cfg, params=params, device=dev, layer_split=1, admit_layers=1,
                        transport=FakeICITransport(**TP_TINY_LINK))
    pd_want = pd_runs(pair, [b.prompt for b in bundles], SamplingParams(max_new_tokens=16))
    pd_ranks = [r["services"]["pd"] for r, _ in ranks]
    follower = ranks[1][0]["services"]["follower_submit"]
    emit("tp_services", model="tiny", world=TP_WORLD,
         engine_service={"uncut_streams_equal_one_rank": streams_equal, "cut": cut,
                         "reading_tp2": service_reading(got["service"]),
                         "reading_tp1": service_reading(want)},
         decode_service={"tokens_equal_one_rank": got["decode"] == dec_want,
                         "bundles": 2, "streams": 1},
         pd_layer_sliced={"tokens_equal_one_rank": all(p["tokens"] == pd_want["tokens"]
                                                      for p in pd_ranks),
                          "layers_at_admit": [p["layers_at_admit"] for p in pd_ranks],
                          "one_rank_layers_at_admit": pd_want["layers_at_admit"]},
         ranks_metrics_equal=metrics_equal, no_rows_left=clean,
         follower_submit=follower,
         states=[{k: r["services"][k] for k in ("service_state", "decode_state")}
                 for r, _ in ranks],
         pd_plans=[r["services"]["pd_plans"] for r, _ in ranks],
         launches=[r["services"]["launches"] for r, _ in ranks], card=card)
    engaged = all(any(a is not None for a in p["layers_at_admit"]) for p in pd_ranks)
    if not (streams_equal and cut_ok and clean and metrics_equal and engaged
            and got["decode"] == dec_want and follower and "rank 0" in follower
            and all(p["tokens"] == pd_want["tokens"] for p in pd_ranks)):
        raise AssertionError(f"tp services (tiny): streams {streams_equal}, cut {cut}, "
                             f"clean {clean}, metrics {metrics_equal}, engaged {engaged}, "
                             f"decode {got['decode']} vs {dec_want}, follower {follower}, "
                             f"pd {pd_ranks} vs {pd_want}")
    if dev == "cuda":
        for r, _ in ranks:
            check_launches(r["services"]["launches"], LLAMA_KERNELS)
    return [r["services"]["launches"] for r, _ in ranks]


def check_llama_loops(torch, np, ranks, params, model, dev, card):
    """llama3-8b's loops at tp 2 against the whole model on the card:
    the host tier's promoted pages match their checksums on every rank,
    pass 2 equals a tp 2 device-hit engine's tokens, and the page counts
    equal a one-rank engine's at the same budget; the layer-sliced PD
    admission engaged on both ranks with admit_layers 0's tokens, and a
    DecodeService took the last prompt's bundle to the same tokens; the
    two-rank service completed every request, each token judged against a
    float32 forward (SPEC_LOGIT_BAND), beside a one-rank service's TTFT
    and ITL. Returns the ranks' launches of the three drives."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.models.config import get_config

    prompts, sp, cfg = tier_drive_inputs(np, model, dev)
    one = Engine(EngineConfig(num_pages=TP_TIER_NUM_PAGES, **cfg), params=params)
    for _ in range(2):
        for p in prompts:
            timed_generate(one, p, sp)
    one_stats = one.host_tier.stats()
    del one
    free(torch, dev)
    counts = ("spilled_pages", "promoted_pages", "evicted_pages", "pages")
    tiers = [r["tier"] for r, _ in ranks]
    tier_ok = all(t["mismatch"] == 0 and t["checked"] == t["stats"]["promoted_pages"] > 0
                  and t["hits"] == t["device_hits"] and t["tokens"][1] == t["device_hit"]
                  and t["stats"]["evicted_pages"] > 0 and t["closes"]
                  and all(t["stats"][k] == one_stats[k] for k in counts) for t in tiers)
    loops = [r["loops"] for r, _ in ranks]
    sliced_ok = all(lp["pd_sliced"]["tokens"] == lp["pd_full"]["tokens"]
                    and lp["pd_sliced"]["layers_at_admit"][0] is not None
                    and lp["pd_sliced"]["tokens"] == loops[0]["pd_sliced"]["tokens"]
                    for lp in loops)
    decode_ok = loops[0]["decode"] == loops[0]["pd_full"]["tokens"][-1]
    svc = EngineService(llama_service_config(model, dev), params=params, device=dev)
    jobs = tp_service_jobs(np, get_config(model).vocab_size, TP_LLAMA_SVC_LENS,
                           TP_LLAMA_SVC_NEW, False)
    want = drive_service(svc, jobs)
    svc.stop()
    del svc
    free(torch, dev)
    got = loops[0]["service"]
    complete = all(o["error"] is None and len(o["tokens"]) == TP_LLAMA_SVC_NEW for o in got)
    judged = []
    for (prompt, jsp, _), o in zip(jobs, got):
        lg = f32_logits(torch, params, model, prompt + o["tokens"][:-1], "model", dev)
        judged.append(judge(torch, lg[len(prompt) - 1:], len(prompt), o["tokens"], jsp, dev))
        del lg
    states = [lp[k] for lp in loops for k in ("service_state", "decode_state")]
    clean = all(st["running"] == st["waiting"] == st["live"] == 0 and not st["loop_alive"]
                and st["fault"] is None for st in states)
    metrics_equal = all(len({json.dumps(lp[k]["metrics"]) for lp in loops}) == 1
                        for k in ("service_state", "decode_state"))
    emit("tp_loops", model=model, world=TP_WORLD,
         collectives="gloo over one card (staged through the host)",
         tier={"ranks": [{k: t[k] for k in ("stats", "checked", "mismatch", "host_hit_tokens",
                                            "closes")} for t in tiers],
               "one_rank": {k: one_stats[k] for k in counts + ("bytes", "max_bytes")},
               "hit_depths": [{"host": t["hits"], "device": t["device_hits"]} for t in tiers],
               "pass2_equals_device_hit": [t["tokens"][1] == t["device_hit"] for t in tiers],
               "prompt_lens": TP_TIER_PROMPT_LENS, "num_pages": TP_TIER_NUM_PAGES,
               "host_tier_bytes": cfg["host_tier_bytes"]},
         pd={"layers_at_admit": [lp["pd_sliced"]["layers_at_admit"] for lp in loops],
             "sliced_equals_full": [lp["pd_sliced"]["tokens"] == lp["pd_full"]["tokens"]
                                    for lp in loops],
             "prompt_lens": TP_PD_PROMPT_LENS, "plans": [lp["pd_plans"] for lp in loops]},
         decode_service={"bundle_bytes": loops[0]["bundle_bytes"],
                         "tokens_equal_pd": decode_ok,
                         "plans": [lp["decode_state"]["plans"] for lp in loops]},
         engine_service={"complete": complete,
                         "judged": [{"ok": ok, "min_margin": m} for ok, m in judged],
                         "band": SPEC_LOGIT_BAND,
                         "reading_tp2_gloo": service_reading(got),
                         "reading_tp1": service_reading(want),
                         "plans": [lp["service_state"]["plans"] for lp in loops]},
         ranks_metrics_equal=metrics_equal, no_rows_left=clean,
         states=[{k: lp[k] for k in ("service_state", "decode_state")} for lp in loops],
         card=card)
    if not (tier_ok and sliced_ok and decode_ok and complete and clean and metrics_equal
            and all(ok for ok, _ in judged)):
        raise AssertionError(f"tp loops ({model}): tier {tier_ok}, pd {sliced_ok}, decode "
                             f"{decode_ok}, service {complete} {judged}, clean {clean}, "
                             f"metrics {metrics_equal}")
    launches = []
    for r, _ in ranks:
        for k in ("pd_launches", "service_launches"):
            launches.append(r["loops"][k])
        launches.append(r["tier"]["launches"])
        if dev == "cuda":
            for lc in launches[-3:]:
                check_launches(lc, LLAMA_KERNELS)
    return launches

def tp_phase(torch, np, card, dev="cuda", models=TP_MODELS):
    """Tensor-parallel serving at tp 2 as a gloo world of two processes on
    the one card (gloo stages every collective through the host: the
    timings are gloo over one card, never NVLink). Each rank reports its
    tokens, bytes and launches; here, the unsharded engine on the same
    weights (the same seed) judges them: tiny, tiny-moe (tp 2 and ep 2) and
    tiny-mla tokens equal; llama3-8b and deepseek-v2-lite streams judged
    token by token against a float32 forward (SPEC_LOGIT_BAND, on a pool of
    the stream's kind), their first step's logits against the unsharded
    engine's (TP_FIRST_BAND where the kept experts agree, and at every
    token with tp's experts forced on the unsharded engine; at most
    TP_MOE_MOST_PAST of the tokens past it unforced), their
    split leaves and GQA pools halved, and
    every kernel of each case launched on the ranks. Returns the ranks'
    launches, summed."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks, seconds = spawn_ranks(d, "tp_rank", (dev, tuple(models)))
    launches = {k: 0 for k in LLAMA_KERNELS + INT8_KERNELS + MLA_KERNELS + MLA_INT8_KERNELS}
    for res, _ in ranks:
        for case in list(res["tiny"].values()) + list(res["big"].values()):
            for k, n in case["launches"].items():
                launches[k] += n
    res0 = ranks[0][0]
    if any(r["tiny"] != res0["tiny"] or any(r["big"][k]["tokens"] != res0["big"][k]["tokens"]
                                            for k in res0["big"]) for r, _ in ranks):
        raise AssertionError("tp ranks disagree on their tokens")

    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 40, 23, 70)]
    for model, axes, kernels in TP_TINY_CASES:
        case = res0["tiny"][f"{model} {axes}"]
        want = Engine(EngineConfig(model=model, num_pages=256, max_seq_len=256, multi_step=4,
                                   device=dev),
                      params=params_to(init_params(get_config(model), 0, "cpu"), dev)
                      ).generate(prompts, SamplingParams(max_new_tokens=16))
        emit("tp", model=model, mesh=axes, tokens_equal=case["tokens"] == want,
             launches=[r["tiny"][f"{model} {axes}"]["launches"] for r, _ in ranks])
        if case["tokens"] != want:
            raise AssertionError(f"tp {model} {axes}: {case['tokens']} vs unsharded {want}")
        if dev == "cuda":
            check_launches(case["launches"], kernels)
    drives = check_tiny_services(torch, np, ranks, dev, card)

    greedy = SamplingParams()
    for model in models:
        params = init_params(get_config(model), 0, dev)
        whole = tree_bytes(params, model)
        if serves_loops(model):
            drives += check_llama_loops(torch, np, ranks, params, model, dev, card)
        for kv_dtype, kernels in tp_pools(get_config(model)):
            key = f"{model}/{kv_dtype}"
            rec = res0["big"][key]
            kw = dict(model=model, num_pages=TP_NUM_PAGES, max_seq_len=1024, kv_dtype=kv_dtype,
                      device=dev)
            eng = Engine(EngineConfig(multi_step=1, **kw), params=params)
            pa, pb = tp_prompts(np, eng.mcfg.vocab_size)
            with moe_masks(torch) as rec1:
                first1 = first_step_logits(torch, eng, pa).float()
            first2 = torch.from_numpy(ranks[0][1][key]).to(dev)
            # Rank 0's kept experts (the ranks see the same replicated
            # hidden states and router); None for a dense model.
            tp_masks = ranks[0][1].get(f"{key}/masks")
            masks1 = np.stack(rec1["masks"]) if rec1["masks"] else None
            margins1 = np.stack(rec1["margins"]) if rec1["margins"] else None
            forced, controls = None, {}
            if tp_masks is not None:
                # The unsharded engine with tp's kept experts forced: no
                # token swaps, so tp is held to the dense band at every
                # token; and two other bfloat16 paths without tp (the
                # controls), read against the unsharded engine.
                with moe_masks(torch, force=tp_masks) as recf:
                    gap = (first2 - first_step_logits(torch, eng, pa).float()).abs().amax(-1)
                forced = {"max_abs": float(gap.max()),
                          "past_band": int((gap > TP_FIRST_BAND).sum()),
                          "cells_not_forced": int((np.stack(recf["masks"]) != tp_masks).sum())}
                for name, how in TP_MOE_CONTROLS.items():
                    with moe_masks(torch) as rc:
                        gap = (first_step_logits(torch, eng, pa, **how).float()
                               - first1).abs().amax(-1)
                    # A chunked forward records [chunk][layer]: to [layer, token].
                    calls = np.stack(rc["masks"])
                    calls = calls.reshape(-1, len(masks1), *calls.shape[1:]).swapaxes(0, 1)
                    controls[name] = swap_reading(np, gap.cpu().numpy(), TP_FIRST_BAND,
                                                  calls.reshape(masks1.shape), masks1, margins1)
            pools1 = pool_bytes(eng)
            reading1 = decode_reading(torch, np, eng)
            del eng
            # One float32 forward (on a pool of the stream's kind) over each
            # stream: its rows judge the stream token by token, and stream
            # A's first rows are the first step's float32 reference.
            seqs = {k: p + rec["tokens"][k][:-1] for k, p in (("a", pa), ("b", pb))}
            f32 = {k: f32_logits(torch, params, model, q, kv_dtype, dev) for k, q in seqs.items()}
            r32 = f32["a"][:len(first1)]
            tok_max = (first2 - first1).abs().amax(-1)
            d_max = float(tok_max.max())
            ratio = float((first2 - r32).abs().mean() / (first1 - r32).abs().mean())
            swaps = swap_reading(np, tok_max.cpu().numpy(), TP_FIRST_BAND, tp_masks, masks1,
                                 margins1)
            emit("tp_first_step_swaps", model=model, kv_dtype=kv_dtype, tp=swaps,
                 forced=forced, controls=controls, card=card)
            limits = {"same_masks_max_abs": TP_FIRST_BAND, "forced_max_abs": TP_FIRST_BAND,
                      "past_band_tokens": int(TP_MOE_MOST_PAST * len(first1))}
            banded = (swaps["max_abs_same_masks"] <= limits["same_masks_max_abs"]
                      and swaps["past_band"] <= limits["past_band_tokens"]
                      and (forced is None or (forced["max_abs"] <= limits["forced_max_abs"]
                                              and forced["cells_not_forced"] == 0)))
            judged = [judge(torch, f32[k][len(p) - 1:], len(p), rec["tokens"][k], greedy, dev)
                      for k, p in (("a", pa), ("b", pb))]
            # The judge's own check: stream A with its middle token replaced
            # by one half the vocab away must leave the band (the rows up to
            # that token see the real prefix).
            t, j, V = list(rec["tokens"]["a"]), len(rec["tokens"]["a"]) // 2, r32.shape[-1]
            t[j] = (t[j] + V // 2) % V
            planted = judge(torch, f32["a"][len(pa) - 1:], len(pa), t, greedy, dev)
            halves = [(r["big"][key]["init"]["split"] * TP_WORLD == whole["split"]
                       and r["big"][key]["init"]["rest"] == whole["rest"]
                       and r["big"][key]["pool_bytes"] * (1 if get_config(model).mla
                                                          else TP_WORLD) == pools1)
                      for r, _ in ranks]
            emit("tp", model=model, kv_dtype=kv_dtype, world=TP_WORLD,
                 collectives="gloo over one card (staged through the host)",
                 tokens=rec["tokens"],
                 judged=[{"ok": ok, "min_margin": m} for ok, m in judged],
                 planted={"ok": planted[0], "min_margin": planted[1]},
                 band=SPEC_LOGIT_BAND,
                 first_step={"tokens": len(first1), "max_abs_vs_unsharded": d_max,
                             "band": TP_FIRST_BAND, "swaps": swaps, "forced": forced,
                             "logit_std_f32": float(r32.std()), "limits": limits,
                             "mean_vs_f32_ratio_to_unsharded": ratio,
                             "ratio_limit": BF16_VS_CONTROL},
                 launches=[r["big"][key]["launches"] for r, _ in ranks],
                 bytes={"rank_weights": [r["big"][key]["init"]["weights"] for r, _ in ranks],
                        "rank_split": [r["big"][key]["init"]["split"] for r, _ in ranks],
                        "unsharded_weights": whole["weights"],
                        "unsharded_split": whole["split"],
                        "rank_pools": [r["big"][key]["pool_bytes"] for r, _ in ranks],
                        "unsharded_pools": pools1, "halved": halves},
                 rank_init={"seconds": [r["big"][key]["init"]["seconds"] for r, _ in ranks],
                            "peak_bytes": [r["big"][key]["init"]["peak_bytes"]
                                           for r, _ in ranks]},
                 decode_step={"tp2 (gloo over one card)": [
                     {"wall_ms": r["big"][key]["wall_ms"], "device_ms": r["big"][key]["device_ms"]}
                     for r, _ in ranks], "tp1": reading1},
                 card=card)
            if not (all(ok for ok, _ in judged) and not planted[0] and all(halves)
                    and banded and ratio <= BF16_VS_CONTROL):
                raise AssertionError(f"tp {key}: judged {judged}, planted {planted}, "
                                     f"bytes {halves}, first step {d_max} / {swaps} / "
                                     f"forced {forced} (limits {limits}) / {ratio}")
            if dev == "cuda":
                for r, _ in ranks:
                    check_launches(r["big"][key]["launches"], kernels)
        del params
        free(torch, dev)
    for lc in drives:
        for k, n in lc.items():
            launches[k] += n
    emit("tp_phase", seconds_ranks=seconds, seconds=time.perf_counter() - t_phase,
         launches=launches)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    import rbg_tpu_torch  # noqa: F401 — fail here, before any result, without the repo
    from rbg_tpu_torch.ops.kernels.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = build()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(reports),
         ptxas={k: ptxas_summary(v) for k, v in reports.items()})

    kern = kernels_phase(torch, np)
    gpucheck_phase(card)
    tiny_phase(torch, np)
    checkpoint_launches = train_checkpoint_phases(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches, pd_ref = llama_phases(torch, np, card)
    for k, n in checkpoint_launches.items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    pd_process_phase(torch, np, card, ref=pd_ref)
    serving_phases(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(deepseek_phases(torch, np, card))
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in tp_phase(torch, np, card).items():
        launches[k] += n
    launches.update(probe_phase(torch))

    src = {
        "paged_decode": ("paged_decode.cu", "paged_attention_kernel.py:165"),
        "ragged_paged": ("ragged_paged.cu", "ragged_attention_kernel.py:281"),
        "paged_decode_q": ("paged_decode_q.cu", "paged_attention_kernel.py:260"),
        "ragged_paged_q": ("ragged_paged_q.cu", "ragged_attention_kernel.py:368"),
        "paged_mla_decode": ("paged_mla_decode.cu", "paged_attention_kernel.py:412"),
        "ragged_paged_mla": ("ragged_paged_mla.cu", "ragged_attention_kernel.py:579"),
        "paged_mla_decode_q": ("paged_mla_decode_q.cu", "paged_attention_kernel.py:491"),
        "ragged_paged_mla_q": ("ragged_paged_mla_q.cu", "ragged_attention_kernel.py:595"),
        "ragged_paged_tokengrid": ("ragged_paged_tokengrid.cu",
                                   "ragged_attention_kernel.py:741"),
    }
    rows = []
    for name_, (source, replaces) in src.items():
        r = kern[name_][0]                      # the served model's shape
        rows.append({"name": name_, "route": "cuda",
                     "source": f"rbg_tpu_torch/csrc/{source}",
                     "replaces": f"rbg_tpu/ops/pallas/{replaces}",
                     "launches": launches[name_],
                     "max_abs_err": max(x["max_abs_err"] for x in kern[name_]),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
