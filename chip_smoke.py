#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rbg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card (nvidia-smi name and power limit, torch's name).
2. build   — nvcc builds every CUDA kernel of the serving path from
             rbg_tpu_torch/csrc.
3. kernels — each kernel against its plain PyTorch version on the card, in
             bfloat16, at llama3-8b and qwen2-0.5b shapes: error, kernel
             time, plain time, one PyTorch library call on the same inputs
             (SDPA on the gathered view, a yardstick the port never calls)
             and the least time the card could take (bound).
4. engine  — Engine(llama3-8b) at full width and depth, random weights
             from a seed: a request steps into decode, a second joins so
             one ragged step holds a decode row and a prefill chunk, both
             run to completion (multi_step 1 and 4); greedy is repeatable.
   then      one forward_ragged with kernels against the plain version
             on the same pool, in float32 (tight) and in bfloat16 (against
             a float32 control).
5. server  — the port's engine server in this process on a free port,
             answering 4 concurrent generate requests (one streamed).

Then a line {"kernels": [...]} (launches counted over the server phase,
the main path) and, last, {"ok": true, "device": {...}}. Any failure exits
non-zero before the last line; without a CUDA device nothing runs.
"""

import json
import statistics
import subprocess
import sys
import time

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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(torch, fn, flush, iters=20, warm=3):
    """Median device time of one call, L2 flushed before each launch."""
    times = []
    for i in range(warm + iters):
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


# ---- phase 3: kernels against their plain versions ----

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


def ragged_case(torch, np, KV, G, hd, rows_spec, page=16):
    """rows_spec: (q_len, kv_len) per row, packed in order, then pads to the
    engine's power-of-two token bucket (row 0, position -1)."""
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
    rows, pos = [], []
    for r, (ql, kv) in enumerate(rows_spec):
        rows += [r] * ql
        pos += list(range(kv - ql, kv))
    T = 8
    while T < len(rows):
        T *= 2
    rows += [0] * (T - len(rows))
    pos += [-1] * (T - len(pos))
    q = torch.randn(1, T, KV * G, hd, generator=g, device=dev).to(torch.bfloat16)
    return (q, k, v, table,
            torch.tensor([pos], dtype=torch.int32, device=dev),
            torch.tensor([kv for _, kv in rows_spec], dtype=torch.int32, device=dev),
            torch.tensor(rows, dtype=torch.int32, device=dev))


def kernels_phase(torch, np):
    import torch.nn.functional as F

    from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
    from rbg_tpu_torch.ops.paged_attention import gather_kv, paged_attention_plain
    from rbg_tpu_torch.ops.ragged_paged_attention import (
        _unpack_offsets, ragged_paged_attention_plain)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {"paged_decode": [], "ragged_paged": []}
    shapes = {"llama3-8b": (8, 4, 128), "qwen2-0.5b": (2, 7, 64)}
    for model, (KV, G, hd) in shapes.items():
        # -- A: decode, B=8, kv_len up to 2048 --
        lens = [2048, 1900, 1536, 1200, 1024, 700, 333, 65]
        q, k, v, table, pos, kv_lens = decode_case(torch, np, KV, G, hd, lens)
        got = paged_decode_attention(q, k, v, table, kv_lens)
        ref = paged_attention_plain(q, k, v, table, pos, kv_lens)
        err = max_err_checked(torch, f"paged_decode {model}", got, ref)
        ms = cuda_ms(torch, lambda: paged_decode_attention(q, k, v, table, kv_lens), flush)
        plain_ms = cuda_ms(torch, lambda: paged_attention_plain(
            q, k, v, table, pos, kv_lens), flush, iters=5)
        B, S = len(lens), table.shape[1] * 16
        kg = gather_kv(k, table).permute(0, 2, 1, 3).contiguous()   # [B,KV,S,hd]
        vg = gather_kv(v, table).permute(0, 2, 1, 3).contiguous()
        qh = q.permute(0, 2, 1, 3)                                   # [B,H,1,hd]
        mask = (torch.arange(S, device="cuda")[None, :] < kv_lens[:, None])[:, None, None]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=True), flush)
        tokens = sum(lens)
        elem = 2
        nbytes = (2 * tokens * KV * hd * elem + 2 * q.numel() * elem
                  + sum(-(-n // 16) for n in lens) * 4 + B * 4)
        b_ms, b_by = bound(nbytes, 4 * tokens * KV * G * hd)
        out["paged_decode"].append(dict(
            model=model, KV=KV, G=G, hd=hd, B=B, kv_lens=lens, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by))
        del kg, vg

        # -- B: mixed pack, 64-token prefill chunks and decode tokens; the
        # decode token first puts every chunk across a tile boundary --
        spec = [(1, 2048), (64, 64), (1, 1500), (64, 512), (1, 800), (64, 1024),
                (1, 100), (64, 2000)]
        q, k, v, table, qpos, kv_lens, rows = ragged_case(torch, np, KV, G, hd, spec)
        got = ragged_paged_attention_cuda(q, k, v, table, qpos, kv_lens, rows)
        ref = ragged_paged_attention_plain(q, k, v, table, qpos, kv_lens, rows, 64)
        err = max_err_checked(torch, f"ragged_paged {model}", got, ref)
        ms = cuda_ms(torch, lambda: ragged_paged_attention_cuda(
            q, k, v, table, qpos, kv_lens, rows), flush)
        plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_plain(
            q, k, v, table, qpos, kv_lens, rows, 64), flush, iters=5)
        # Library yardstick: SDPA over the padded [R, 64] batch on the
        # gathered per-row view (what the plain version feeds its einsum).
        R, S, Tm = len(spec), table.shape[1] * 16, 64
        real = qpos[0] >= 0
        idx = _unpack_offsets(rows, real).clamp(max=Tm - 1)
        qp = torch.zeros(R, Tm, KV * G, hd, dtype=q.dtype, device="cuda")
        pp = torch.full((R, Tm), -1, dtype=torch.int32, device="cuda")
        qp[rows[real].long(), idx[real]] = q[0, real]
        pp[rows[real].long(), idx[real]] = qpos[0, real]
        kg = gather_kv(k, table).permute(0, 2, 1, 3).contiguous()
        vg = gather_kv(v, table).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(S, device="cuda")
        mask = ((slot[None, None] <= pp[:, :, None])
                & (slot[None, None] < kv_lens[:, None, None]))[:, None]
        qh = qp.permute(0, 2, 1, 3)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=True), flush)
        lim = torch.minimum(kv_lens[rows.long()], qpos[0] + 1).clamp(min=0)
        flops = 4 * int(lim.sum()) * KV * G * hd
        row_extent = sum(kv for _, kv in spec)          # each row's pages once
        nbytes = (2 * row_extent * KV * hd * 2 + 2 * q.numel() * 2
                  + sum(-(-kv // 16) for _, kv in spec) * 4
                  + rows.numel() * 8 + R * 4)
        b_ms, b_by = bound(nbytes, flops)
        out["ragged_paged"].append(dict(
            model=model, KV=KV, G=G, hd=hd, T=int(q.shape[1]), rows=spec,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))
        del kg, vg, qp
    torch.cuda.empty_cache()
    for name, rs in out.items():
        emit("kernels", kernel=name, tolerance=f"|d| <= {KERNEL_RTOL}*|ref| + "
             f"{KERNEL_ATOL} (f32 accumulation, one bf16 rounding of the output)",
             shapes=rs)
    return out


# ---- phase 4: the engine at full width and depth ----

def ragged_compare(torch, np, params, model="llama3-8b", dev="cuda"):
    """forward_ragged with kernels against use_kernels='never' on the same
    pool, at full width and depth: a decode row and a 64-token prefill chunk
    over context that an earlier kernel call wrote.

    float32 witness: the same weights cast to float32 on a float32 pool.
    There kernel and plain differ only in summation order, so their logits
    must agree within F32_LOGIT_ATOL after 32 layers; a wrong mask, page or
    head mapping moves them by the order of their spread.
    bfloat16 (the served dtype): the kernel path must be as close to the
    float32 plain logits as the bfloat16 plain path is (the control): mean
    |bf16 - f32| of the kernel path <= BF16_VS_CONTROL x the plain path's."""
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import forward_ragged

    cfg16 = get_config(model)
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
        tok = torch.from_numpy(rng.randint(0, cfg16.vocab_size, (1, T))).to(dev)
        pos = torch.tensor([pos], dtype=torch.int32, device=dev)
        return (tok, pos, pos >= 0, torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor([hi for _, hi in parts], dtype=torch.int32, device=dev))

    context = pack([(0, 64), (0, 100)], 256)
    step = pack([(64, 65), (100, 164)], 128)
    mask = step[2][0]

    def run(p, cfg):
        """(kernel logits, plain logits) of the compared step, real tokens."""
        shape = (cfg.num_layers, 17, 16, cfg.num_kv_heads, cfg.head_dim_)
        kp = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        vp = torch.zeros_like(kp)
        forward_ragged(p, cfg, *context, table, kp, vp)
        lk = forward_ragged(p, cfg, *step, table, kp, vp, max_q_len=64)
        lp = forward_ragged(p, cfg, *step, table, kp, vp, use_kernels="never",
                            max_q_len=64)
        return lk[0][mask], lp[0][mask]

    k16, p16 = run(params, cfg16)
    p32 = {"blocks": {k: w.float() for k, w in params["blocks"].items()},
           **{k: w.float() for k, w in params.items() if k != "blocks"}}
    k32, r32 = run(p32, get_config(model, dtype="float32"))
    del p32
    if dev == "cuda":
        torch.cuda.empty_cache()

    def stats(a, b):
        d = (a - b).abs()
        return {"max": float(d.max()), "mean": float(d.mean()),
                "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}

    res = {"f32_kernel_vs_plain": stats(k32, r32),
           "bf16_kernel_vs_plain": stats(k16, p16),
           "bf16_kernel_vs_f32": stats(k16, r32),
           "bf16_plain_vs_f32 (control)": stats(p16, r32),
           "logit_std_f32": float(r32.std()), "logit_absmax_f32": float(r32.abs().max())}
    finite = all(bool(torch.isfinite(t).all()) for t in (k16, p16, k32, r32))
    ratio = res["bf16_kernel_vs_f32"]["mean"] / res["bf16_plain_vs_f32 (control)"]["mean"]
    res["bf16_mean_ratio_to_control"] = ratio
    emit("ragged_compare", model=model, layers=cfg16.num_layers, tokens=int(mask.sum()),
         tolerance=f"f32 max |d| <= {F32_LOGIT_ATOL}; bf16 mean |d vs f32| <= "
                   f"{BF16_VS_CONTROL} x control's", **res)
    if not (finite and res["f32_kernel_vs_plain"]["max"] <= F32_LOGIT_ATOL
            and ratio <= BF16_VS_CONTROL):
        raise AssertionError(f"forward_ragged kernels vs plain: {res}")


def engine_phase(torch, np, params):
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.RandomState(1)
    V = 128256
    pa, pb = rng.randint(0, V, 100).tolist(), rng.randint(0, V, 150).tolist()
    for ms in (1, 4):
        eng = Engine(EngineConfig(model="llama3-8b", num_pages=2048,
                                  max_seq_len=2048, multi_step=ms), params=params)
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
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        if len(out[a]) != 24 or len(out[b]) != 16 or not all(
                0 <= t < V for t in out[a] + out[b]):
            raise AssertionError(f"bad tokens {out}")
        g1 = eng.generate([pa], SamplingParams(max_new_tokens=8))
        g2 = eng.generate([pa], SamplingParams(max_new_tokens=8))
        if g1 != g2:
            raise AssertionError(f"greedy not repeatable: {g1} vs {g2}")
        emit("engine", model="llama3-8b", layers=32, multi_step=ms,
             launches=launches, tokens={"a": out[a], "b": out[b]},
             wall_s=wall, metrics=eng.metrics, greedy_repeat=g1[0])
        del eng
        torch.cuda.empty_cache()


# ---- phase 5: the server ----

def server_phase(torch, np, params, card):
    from concurrent.futures import ThreadPoolExecutor

    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.protocol import request_once, request_stream
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    svc = EngineService(EngineConfig(model="llama3-8b", num_pages=2048,
                                     max_seq_len=2048, multi_step=4),
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
            msg = {"op": "generate", "prompt": rng.randint(0, 128256, plen).tolist(),
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
                    or not all(0 <= t < 128256 for t in r["tokens"]):
                raise AssertionError(f"request (prompt {plen}): {r}")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        m = request_once(srv.addr, {"op": "metrics"}, timeout=30)
        total = sum(n for _, n, _ in reqs)
        emit("server", card=card, model="llama3-8b", layers=32, requests=len(reqs),
             prompt_lens=[p for p, _, _ in reqs], new_tokens=total, wall_s=wall,
             tokens_per_s=total / wall, ttft_s=[r["ttft_s"] for r in res],
             stream_frames=res[1]["frames"], launches=launches,
             warmup_s=w["elapsed_s"], metrics=m["metrics"])
        return launches
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    import rbg_tpu_torch  # noqa: F401 — fail here, before any result, without the repo
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
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
    regs = {k: sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in v.splitlines() if "Used " in ln})
            for k, v in reports.items()}
    emit("build", seconds=time.perf_counter() - t0, built=sorted(reports),
         ptxas=regs)

    kern = kernels_phase(torch, np)

    t0 = time.perf_counter()
    params = init_params(get_config("llama3-8b"), seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("init", model="llama3-8b", seconds=time.perf_counter() - t0,
         param_bytes=sum(t.numel() * t.element_size() for t in
                         [*params["blocks"].values(), params["embed"],
                          params["lm_head"], params["final_norm"]]))
    engine_phase(torch, np, params)
    ragged_compare(torch, np, params)
    launches = server_phase(torch, np, params, card)

    src = {"paged_decode": ("rbg_tpu_torch/csrc/paged_decode.cu",
                            "rbg_tpu/ops/pallas/paged_attention_kernel.py:165"),
           "ragged_paged": ("rbg_tpu_torch/csrc/ragged_paged.cu",
                            "rbg_tpu/ops/pallas/ragged_attention_kernel.py:281")}
    rows = []
    for name_, (source, replaces) in src.items():
        r = kern[name_][0]                      # the llama3-8b shape
        rows.append({"name": name_, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name_],
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
