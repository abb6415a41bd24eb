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
4. tiny    — tiny and tiny-moe (float32, hd 32; kernels A, B), tiny-mla
             (float32 latents; kernels E, F) and tiny at page size 128
             through Engine on the card, greedy tokens equal to the CPU
             port's on the same weights; then ``python -m
             rbg_tpu_torch.engine.server`` with its defaults (tiny on the
             card), two requests whose greedy tokens equal the CPU port's.
5. llama3-8b at full width and depth, random weights from a seed:
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
   int8    — the same engine script with kv_dtype="int8" (kernels C, D),
             multi_step 4, its three witnesses on int8 pools and the server
             over int8 pools.
6. serving (llama3-8b at full width and depth, random weights from a seed,
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
   bench_slo — ``rbg_tpu_torch.engine.bench_slo --setups unified`` at tiny:
             a spawned server on the card, two rates.
7. deepseek-v2-lite (MLA + MoE) at full width and depth, random weights
   from a seed, after llama3-8b is freed: engine (kernels E, F; multi_step
   1 and 4), witnesses (ragged_compare, decode_compare and block_compare:
   F at T > 1) and server, as for llama3-8b; then on the same weights over
   int8 latent pools (kernels G, H): engine (multi_step 4), int8 witnesses
   (H at T > 1) and server.
8. ragged_ab — rbg_tpu_torch.bench.block_ragged_probe: kernel I against
   kernel B on a prefill-heavy pack, both checked against the plain
   version, then interleaved timed reps; then each kernel's device ms on
   the probe's pack (the probe's calls/s read host time at its size).

Then a line {"kernels": [...]} (launches counted over the phase that drives
each kernel's path: the llama3-8b server for A and B, the int8 engine for
C and D, the deepseek-v2-lite server for E and F, its int8 engine for G
and H, the probe for I) and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before the last line; without a CUDA device nothing
runs.
"""

import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    for model, H in (("deepseek-v2-lite", 16), ("deepseek-v3", 128)):
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


def stream_judge(torch, params, model, prompt, tokens, sp, dev="cuda"):
    """Whether every output token of ``tokens`` (a greedy or seeded sampled
    stream of ``prompt``) is within SPEC_LOGIT_BAND of the float32 choice
    at its position (the weights cast to float32 one layer at a time), and
    the smallest margin."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache
    from rbg_tpu_torch.engine.sampler import gumbel_noise, row_keys
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_ragged

    cfg = get_config(model, dtype="float32")
    seq = prompt + tokens[:-1]
    n, P0 = len(seq), len(prompt)
    pages = -(-n // 16)
    c = PagedKVCache.create(cfg, pages + 1, 16, device=dev)
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    pos = ints([list(range(n))])
    logits = forward_ragged(float32_params(params), cfg, torch.tensor([seq], device=dev),
                            pos, pos >= 0, ints([0] * n), ints([n]),
                            ints([list(range(1, pages + 1))]), c.k_pages, c.v_pages)
    lg = logits[0, P0 - 1:]                                   # rows predicting tokens
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
    from rbg_tpu_torch.engine.protocol import request_once
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
        base = request_once(srv.addr, msg, timeout=300)
        reset_launches()
        with ThreadPoolExecutor(3) as ex:
            mixed = list(ex.map(lambda n: request_once(
                srv.addr, {**msg, **({"lora": n} if n else {})}, timeout=300),
                ("a", "b", None)))
        launches = dict(LAUNCHES)
        bad = request_once(srv.addr, {**msg, "lora": "nope"}, timeout=60)
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
    from rbg_tpu_torch.engine.protocol import request_once, request_stream
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
        h = request_once(srv.addr, {"op": "health"}, timeout=30)
        if not (h and h["ok"]):
            raise AssertionError(f"health {h}")
        w = request_once(srv.addr, {"op": "warmup", "input_len": 32}, timeout=600)
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
            return request_once(srv.addr, msg, timeout=600)

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
        m = request_once(srv.addr, {"op": "metrics"}, timeout=30)
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
    from rbg_tpu_torch.engine.protocol import request_once
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
                    health = request_once(addr, {"op": "health"}, timeout=5)
                except OSError:
                    time.sleep(0.5)
            ready_s = time.perf_counter() - t0
            replies = [request_once(addr, {"op": "generate", "prompt": p,
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
    """llama3-8b: bf16 engine, witness and server (A, B), then the int8
    engine, witness and server (C, D). Returns {kernel: launches on its
    path}."""
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
    return launches


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
    then the serving surface on that server and bench_slo at tiny."""
    from rbg_tpu_torch.engine import bench_serving
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
        w = request_once(srv.addr, {"op": "warmup", "input_len": args.input_len,
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
    bench_slo_phase()


def request_once(addr, obj, timeout=120):
    from rbg_tpu_torch.engine.protocol import request_once as once
    return once(addr, obj, timeout=timeout)


def surface_phase(torch, np, svc, srv):
    """The server's other ops at llama3-8b: generate_text (traced), embed
    (4 prompts of 100-500 tokens, batched against singles), slo, traces, an
    auth refusal, and start_drain refusing a new generate while a stream
    runs on; then tiny's embeddings on the card against the CPU port."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import CODE_DRAINING, recv_msg, send_msg
    from rbg_tpu_torch.engine.server import start_drain
    from rbg_tpu_torch.engine.service import embed_prompts
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.obs import trace

    def ask(obj, token=SMOKE_TOKEN):
        return request_once(srv.addr, {**obj, "token": token} if token else obj,
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
        if "error" in recv_msg(s):
            raise AssertionError("stream refused")
        start_drain(srv, 120.0)
        drained = ask({"op": "generate", "prompt": [1, 2], "max_new_tokens": 2})
        n = 0
        while True:
            frame = recv_msg(s)
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


def bench_slo_phase():
    """bench_slo --setups unified at tiny: a spawned server on the card,
    two rates through bench_serving --addr."""
    from rbg_tpu_torch.engine import bench_slo

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slo.json")
        t0 = time.perf_counter()
        bench_slo.main(["--setups", "unified", "--model", "tiny", "--rates", "4,8",
                        "--requests", "8", "--input-len", "32", "--output-len", "16",
                        "--json-out", path])
        with open(path) as f:
            rows = json.load(f)["results"]["unified"]
    emit("bench_slo", seconds=time.perf_counter() - t0, rows=rows)
    if [r["completed"] for r in rows] != [8, 8]:
        raise AssertionError(f"bench_slo: {rows}")


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
    tiny_phase(torch, np)
    launches = llama_phases(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    serving_phases(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(deepseek_phases(torch, np, card))
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
