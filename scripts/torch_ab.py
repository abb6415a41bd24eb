#!/usr/bin/env python3
"""Two trees of the PyTorch/CUDA port in turns on one card: kernels A-I,
one ragged step and one decode step of llama3-8b, the server's TTFT, and
one ragged step and one decode step of deepseek-v2-lite.

    python3 scripts/torch_ab.py [--kernels] BASE_TREE [NEW_TREE]

BASE_TREE and NEW_TREE (default: this checkout) are checkouts of the repo,
for example an older commit unpacked with ``git archive``. The order is
base, new, new, base. Each run is a subprocess that imports ``rbg_tpu_torch``
and ``chip_smoke`` from its own tree, builds that tree's CUDA kernels and
prints, as JSON lines:

- ``kernels``: B, D and I on ``chip_smoke``'s llama3-8b mixed pack: ms
  per call (``chip_smoke.cuda_ms``, CUDA events, L2 flushed), the kernel's
  own device ms (``chip_smoke.device_ms``, torch.profiler) and host
  microseconds per call (median of 3 runs of 200 calls issued back to
  back);
- ``mla_ragged``: F and H the same way on ``chip_smoke``'s mixed pack at
  the deepseek-v2-lite (H = 16) and deepseek-v3 (H = 128) shapes (dc = 512,
  dr = 64), H on the same latent pools quantized;
- ``decode``: A and C the same way on ``chip_smoke.decode_case`` at the
  llama3-8b shape, B = 8 rows of kv_len 2048 .. 65 and a B = 64 bucket of
  kv_len 64 + 10 i (lengths passed here, so an older tree serves too); E
  and G at the deepseek-v2-lite shape (H = 16, dc = 512, dr = 64) on the
  B = 8 rows, G on the same latent pools quantized;
- ``step``: ``forward_ragged`` at full depth (llama3-8b, random weights from
  seed 0, bf16 pools) on the server's first ragged step (7 + 40 + 64 + 64
  tokens in a 256-token bucket): median wall ms of 10 synchronised steps,
  device ms per step summed over the profiler's kernels, the device's busy
  share, the device ms of the attention kernel (B) per step, and the eight
  kernels that take the most device time;
- ``decode_step``: ``forward_paged`` at full depth, one decode step of B = 8
  rows over contexts of kv_len 2048 .. 65, on bf16 and on int8 pools: the
  same readings, the attention kernel being A or C;
- ``server``: ``chip_smoke.server_phase`` (4 concurrent requests, prompts
  of 7, 40, 130 and 300 tokens) over bf16 and then int8 pools;
- ``step`` and ``decode_step`` of deepseek-v2-lite at full depth (random
  weights from seed 0, after llama3-8b is freed): the same ragged pack and
  the same B = 8 decode rows, each over bf16 and int8 latent pools, with
  the device ms of kernel F or H (ragged) and E or G (decode) per step.

With ``--kernels`` each run stops after the ``decode`` record (kernels
alone, ~1 minute a run once built). A last line gives each tree's medians.
Needs one CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = """
import gc, json, statistics, subprocess, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from rbg_tpu_torch.engine.kvcache import PagedKVCache
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged
from rbg_tpu_torch.ops.kernels.build import build
from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
from rbg_tpu_torch.ops.kernels.paged_decode_q import paged_decode_attention_q
from rbg_tpu_torch.ops.kernels.paged_mla_decode import paged_mla_decode_attention
from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import ragged_paged_mla_attention_q_cuda
from rbg_tpu_torch.ops.kernels.ragged_paged_q import ragged_paged_attention_q_cuda
from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
    ragged_paged_attention_tokengrid_cuda)
from rbg_tpu_torch.ops.paged_attention import quantize_kv

torch.backends.cuda.matmul.allow_tf32 = False
build()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]

def emit(what, **kw):
    print(json.dumps({"what": what, "card": card, **kw}), flush=True)

def host_us(fn, n=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t

q, k, v, table, qpos, kv_lens, rows = cs.ragged_case(torch, np, 8, 4, 128, cs.RAGGED_SPEC)
(k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
calls = {"B": lambda: ragged_paged_attention_cuda(q, k, v, table, qpos, kv_lens, rows),
         "D": lambda: ragged_paged_attention_q_cuda(q, k8, v8, ks, vs, table, qpos,
                                                    kv_lens, rows)}

def readings(calls, symbol):
    return {n: {"ms": cs.cuda_ms(torch, f, flush),
                "device_ms": cs.device_ms(torch, f, flush, symbol),
                "host_us": statistics.median(host_us(f) for _ in range(3))}
            for n, f in calls.items()}

emit("kernels", **readings(calls, "ragged_paged_kernel"),
     **readings({"I": lambda: ragged_paged_attention_tokengrid_cuda(
         q, k, v, table, qpos, kv_lens, rows)}, "ragged_paged_tokengrid_kernel"))
# F and H: the mixed pack at deepseek-v2-lite's and deepseek-v3's head counts.
mla = {}
qpos, kv_lens, rows = cs.pack_rows(torch, cs.RAGGED_SPEC)
pages = max(-(-kv // 16) for _, kv in cs.RAGGED_SPEC)
for H in (16, 128):
    NP = len(cs.RAGGED_SPEC) * pages + 1
    c, pe, g = cs.latent_pools(torch, NP, 512, 64, 1000 + H)
    table = torch.from_numpy((np.random.RandomState(H).permutation(NP - 1)[:NP - 1] + 1)
                             .reshape(len(cs.RAGGED_SPEC), pages).astype(np.int32)).to("cuda")
    q_lat = torch.randn(1, rows.numel(), H, 512, generator=g, device="cuda").to(torch.bfloat16)
    q_pe = torch.randn(1, rows.numel(), H, 64, generator=g, device="cuda").to(torch.bfloat16)
    (c8, c_s), (pe8, pe_s) = quantize_kv(c), quantize_kv(pe)
    for name, r in readings({
            "F": lambda: ragged_paged_mla_attention_cuda(q_lat, q_pe, c, pe, table, qpos,
                                                         kv_lens, rows, 192 ** -0.5),
            "H": lambda: ragged_paged_mla_attention_q_cuda(q_lat, q_pe, c8, pe8, c_s, pe_s,
                                                           table, qpos, kv_lens, rows,
                                                           192 ** -0.5)},
            "ragged_paged_mla_kernel").items():
        mla[f"{name}{H}"] = r
    del c, pe, c8, pe8, q_lat, q_pe
emit("mla_ragged", **mla)
DECODE_LENS = [2048, 1900, 1536, 1200, 1024, 700, 333, 65]
dec = {}
for label, lens in (("B8", DECODE_LENS), ("B64", [64 + 10 * i for i in range(64)])):
    q, k, v, table, _, kv_lens = cs.decode_case(torch, np, 8, 4, 128, lens)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    dec[label] = readings({
        "A": lambda: paged_decode_attention(q, k, v, table, kv_lens),
        "C": lambda: paged_decode_attention_q(q, k8, v8, ks, vs, table, kv_lens)},
        "paged_decode_kernel")
del q, k, v, k8, v8
# E and G: deepseek-v2-lite's latent decode on the same B = 8 rows.
pages = [-(-n // 16) for n in DECODE_LENS]
NP, P = len(pages) * max(pages) + 1, max(pages)
c, pe, g = cs.latent_pools(torch, NP, 512, 64, 16)
table = torch.from_numpy((np.random.RandomState(16).permutation(NP - 1)[:len(pages) * P] + 1)
                         .reshape(len(pages), P).astype(np.int32)).to("cuda")
kv_lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
q_lat = torch.randn(len(pages), 1, 16, 512, generator=g, device="cuda").to(torch.bfloat16)
q_pe = torch.randn(len(pages), 1, 16, 64, generator=g, device="cuda").to(torch.bfloat16)
(c8, c_s), (pe8, pe_s) = quantize_kv(c), quantize_kv(pe)
dec["B8"].update(readings({
    "E": lambda: paged_mla_decode_attention(q_lat, q_pe, c, pe, table, kv_lens, 192 ** -0.5),
    "G": lambda: paged_mla_decode_attention_q(q_lat, q_pe, c8, pe8, c_s, pe_s, table,
                                              kv_lens, 192 ** -0.5)},
    "paged_mla_decode_kernel"))
emit("decode", **dec)
del c, pe, c8, pe8, q_lat, q_pe, flush
"""

# The full-depth steps and the server (not run with --kernels).
CHILD_MODELS = """
params = cs.init_phase(torch, "llama3-8b")
cfg = get_config("llama3-8b")
cache = PagedKVCache.create(cfg, 64, 16, device="cuda")
parts, T = [7, 40, 64, 64], 256
rows, pos = [], []
for r, n in enumerate(parts):
    rows += [r] * n
    pos += list(range(n))
rows += [0] * (T - len(rows))
pos += [-1] * (T - len(pos))
g = torch.Generator(device="cuda").manual_seed(0)
tok = torch.randint(0, cfg.vocab_size, (1, T), generator=g, device="cuda")
pos = torch.tensor([pos], dtype=torch.int32, device="cuda")
rows = torch.tensor(rows, dtype=torch.int32, device="cuda")
table = torch.arange(1, 33, dtype=torch.int32, device="cuda").reshape(4, 8)
kv_lens = torch.tensor(parts, dtype=torch.int32, device="cuda")
ragged_pack = (tok, pos, rows, kv_lens, table)

def step(cache):
    forward_ragged(params, cfg, tok, pos, pos >= 0, rows, kv_lens, table,
                   cache.k_pages, cache.v_pages, max_q_len=64, k_scales=cache.k_scales,
                   v_scales=cache.v_scales)

# Median wall ms of 10 synchronised calls of fn, device ms per call by
# kernel over 5 more under the profiler, and that of the kernels whose
# name holds ``attn``.
def profiled(fn, what, attn, **kw):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            kern[e.key[:60]] = kern.get(e.key[:60], 0.0) + e.self_device_time_total / n / 1e3
    wall, dev = statistics.median(walls), sum(kern.values())
    attn_ms = sum(ms for key, ms in kern.items() if attn in key)
    emit(what, **kw, wall_ms=wall, wall_ms_runs=walls, device_ms=dev,
         attn_kernel_ms=attn_ms, device_busy_share=dev / wall,
         top_kernels_ms=sorted(kern.items(), key=lambda kv: -kv[1])[:8])

profiled(lambda: step(cache), "step", "ragged_paged_kernel", model="llama3-8b",
         kv_dtype="model")
del cache

# One decode step of B = 8 rows over contexts of DECODE_LENS slots (the
# pools' contents do not change the kernels' work).
pages = [-(-(n + 1) // 16) for n in DECODE_LENS]
table = torch.zeros(len(pages), max(pages), dtype=torch.int32, device="cuda")
for r, n in enumerate(pages):
    table[r, :n] = torch.arange(1 + sum(pages[:r]), 1 + sum(pages[:r + 1]))
tok = torch.randint(0, cfg.vocab_size, (len(pages), 1), generator=g, device="cuda")
pos = torch.tensor([[n] for n in DECODE_LENS], dtype=torch.int32, device="cuda")
kv_lens = pos[:, 0] + 1
decode_rows = (pos, kv_lens, table)
for kv_dtype in ("model", "int8"):
    cache = PagedKVCache.create(cfg, 1 + sum(pages), 16, device="cuda",
                                quantize=kv_dtype == "int8")
    profiled(lambda: forward_paged(params, cfg, tok, pos, pos >= 0, kv_lens, table,
                                   cache.k_pages, cache.v_pages, k_scales=cache.k_scales,
                                   v_scales=cache.v_scales),
             "decode_step", "paged_decode_kernel", model="llama3-8b", kv_dtype=kv_dtype)
    del cache

cs.server_phase(torch, np, params, "llama3-8b", cs.LLAMA_KERNELS, card)
cs.server_phase(torch, np, params, "llama3-8b", cs.INT8_KERNELS, card, kv_dtype="int8")

# deepseek-v2-lite, llama3-8b freed first: the same ragged pack (kernels F,
# H), then one decode step on the same rows (kernels E, G).
del params
gc.collect()
torch.cuda.empty_cache()
params = cs.init_phase(torch, "deepseek-v2-lite")
cfg = get_config("deepseek-v2-lite")
tok, pos, rows, kv_lens, table = ragged_pack
tok = tok % cfg.vocab_size
for kv_dtype in ("model", "int8"):
    cache = PagedKVCache.create(cfg, 64, 16, device="cuda", quantize=kv_dtype == "int8")
    profiled(lambda: step(cache), "step", "ragged_paged_mla_kernel", model="deepseek-v2-lite",
             kv_dtype=kv_dtype)
    del cache
pos, kv_lens, table = decode_rows
tok = torch.randint(0, cfg.vocab_size, (len(pages), 1), generator=g, device="cuda")
for kv_dtype in ("model", "int8"):
    cache = PagedKVCache.create(cfg, 1 + sum(pages), 16, device="cuda",
                                quantize=kv_dtype == "int8")
    profiled(lambda: forward_paged(params, cfg, tok, pos, pos >= 0, kv_lens, table,
                                   cache.k_pages, cache.v_pages, k_scales=cache.k_scales,
                                   v_scales=cache.v_scales),
             "decode_step", "paged_mla_decode_kernel", model="deepseek-v2-lite",
             kv_dtype=kv_dtype)
    del cache
"""


def run_tree(tree: Path, kernels_only: bool) -> list:
    """The JSON lines of one child run in ``tree``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    child = CHILD if kernels_only else CHILD + CHILD_MODELS
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    kernels_only = "--kernels" in argv[1:]
    args = [a for a in argv[1:] if a != "--kernels"]
    if not 1 <= len(args) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"base": Path(args[0]).resolve(),
             "new": Path(args[1] if len(args) > 1 else Path(__file__).parents[1]).resolve()}
    got = {t: {} for t in trees}

    def keep(which, key, value):
        got[which].setdefault(key, []).append(value)

    for which in ("base", "new", "new", "base"):
        for line in run_tree(trees[which], kernels_only):
            if line.get("what") in ("kernels", "mla_ragged"):
                for k in ("B", "D", "I", "F16", "H16", "F128", "H128"):
                    if k in line:
                        for x in ("ms", "device_ms", "host_us"):
                            keep(which, f"{k}_{x}", line[k][x])
            elif line.get("what") == "decode":
                for label, calls in line.items():
                    if label in ("B8", "B64"):
                        for k, r in calls.items():
                            for x in ("ms", "device_ms", "host_us"):
                                keep(which, f"{label}_{k}_{x}", r[x])
            elif line.get("what") in ("step", "decode_step"):
                name = "/".join([line["what"]] + [line[k] for k in ("model", "kv_dtype")
                                                  if k in line])
                for k in ("wall_ms", "device_ms", "attn_kernel_ms"):
                    keep(which, f"{name}_{k}", line[k])
            elif line.get("phase") == "server":
                keep(which, f"ttft_s/{line['kv_dtype']}", line["ttft_s"])
            else:
                continue
            print(json.dumps({"tree": which, **line}), flush=True)

    def median(runs):
        if isinstance(runs[0], list):
            return [statistics.median(r[i] for r in runs) for i in range(len(runs[0]))]
        return statistics.median(runs)

    print(json.dumps({"median": {t: {k: median(v) for k, v in m.items()}
                                 for t, m in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
