#!/usr/bin/env python3
"""The cost of batch-invariant serving (``EngineConfig.batch_invariant``,
``ops/rows.py``) at llama3-8b on one card, against an older tree.

    python3 scripts/rows_ab.py BASE_TREE [NEW_TREE]

BASE_TREE and NEW_TREE (default: this checkout) are checkouts of the repo,
for example the parent commit unpacked with ``git archive``. The order is
base, new, new, base; each run is a subprocess that imports
``rbg_tpu_torch`` and ``chip_smoke`` from its own tree and builds that
tree's kernels. A tree whose forwards take ``rows`` is read twice, with
``rows`` off (the default path) and on; an older tree only off. Each run
prints, as JSON lines (random weights from seed 0, bf16 pools, page 16):

- ``ragged``: ``forward_ragged`` at full depth on a pack of one 2048-token
  prefill chunk and 8 decode rows (kv_len 512 + 64 i): median wall ms of
  10 synchronised steps and device ms per step (torch.profiler, the
  kernels' self time summed);
- ``decode``: ``forward_paged``'s decode step at B = 8 (kv_len 2048 ..
  65) and B = 64 (kv_len 64 + 10 i), the same readings;
- ``bench``: ``bench_serving`` in process with ``BENCH_ARGS``
  (16 Poisson requests at 4/s of 512-token prompts, 64 new tokens):
  TTFT, ITL and output tokens/s.

A last line gives each tree's medians per reading. Needs one CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

BENCH_ARGS = ["--model", "llama3-8b", "--requests", "16", "--rate", "4",
              "--input-len", "512", "--output-len", "64", "--num-pages", "2048",
              "--max-seq-len", "2048", "--max-batch", "8", "--multi-step", "4",
              "--slo-ttft-s", "2.0", "--slo-tpot-s", "0.5", "--json"]

CHILD = """
import gc, inspect, json, statistics, subprocess, sys, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from rbg_tpu_torch.engine import bench_serving
from rbg_tpu_torch.engine.kvcache import PagedKVCache
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged
from rbg_tpu_torch.ops.kernels.build import build

BENCH_ARGS = json.loads(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
build()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
has_rows = "rows" in inspect.signature(forward_ragged).parameters
modes = (False, True) if has_rows else (False,)

def emit(what, **kw):
    print(json.dumps({"what": what, "card": card, **kw}), flush=True)

def profiled(fn):
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
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3
    return {"wall_ms": statistics.median(walls), "device_ms": dev}

params = cs.init_phase(torch, "llama3-8b")
cfg = get_config("llama3-8b")
g = torch.Generator(device="cuda").manual_seed(0)
page = 16

def pages_for(lens):
    n = [-(-(kl + 1) // page) for kl in lens]
    table = np.zeros((len(n), max(n)), np.int32)
    for r, k in enumerate(n):
        table[r, :k] = np.arange(1 + sum(n[:r]), 1 + sum(n[:r + 1]))
    return table, 1 + sum(n)

# The ragged pack: row 0 prefills 2048 tokens, rows 1..8 decode.
dec = [512 + 64 * i for i in range(8)]
table, NP = pages_for([2048] + dec)
rid = np.asarray([0] * 2048 + list(range(1, 9)), np.int32)
pos = np.asarray([list(range(2048)) + dec], np.int32)
kvl = np.asarray([2048] + [d + 1 for d in dec], np.int32)
cache = PagedKVCache.create(cfg, NP, page, device="cuda")
tok = torch.randint(0, cfg.vocab_size, (1, rid.size), generator=g, device="cuda")
t = {k: torch.from_numpy(v).cuda() for k, v in
     dict(pos=pos, rid=rid, kvl=kvl, table=table).items()}
for rows in modes:
    kw = {}
    if rows:
        from rbg_tpu_torch.ops.ragged_paged_attention import one_token_rows
        kw = dict(rows=True, one_token=one_token_rows(pos, rid, list(range(1, 9)), "cuda"))
    r = profiled(lambda: forward_ragged(params, cfg, tok, t["pos"], t["pos"] >= 0, t["rid"],
                                        t["kvl"], t["table"], cache.k_pages, cache.v_pages,
                                        max_q_len=2048, **kw))
    emit("ragged", rows=rows, tokens=int(rid.size), **r)
del cache

for label, lens in (("B8", [2048, 1900, 1536, 1200, 1024, 700, 333, 65]),
                    ("B64", [64 + 10 * i for i in range(64)])):
    table, NP = pages_for(lens)
    cache = PagedKVCache.create(cfg, NP, page, device="cuda")
    tokd = torch.randint(0, cfg.vocab_size, (len(lens), 1), generator=g, device="cuda")
    posd = torch.tensor([[n] for n in lens], dtype=torch.int32, device="cuda")
    tab = torch.from_numpy(table).cuda()
    for rows in modes:
        kw = {"rows": True} if rows else {}
        r = profiled(lambda: forward_paged(params, cfg, tokd, posd, posd >= 0, posd[:, 0] + 1,
                                           tab, cache.k_pages, cache.v_pages, **kw))
        emit("decode", rows=rows, batch=label, **r)
    del cache

del params
gc.collect()
torch.cuda.empty_cache()
for rows in modes:
    out = bench_serving.run(bench_serving.parse_args(
        BENCH_ARGS + (["--batch-invariant"] if rows else [])))
    gc.collect()
    torch.cuda.empty_cache()
    emit("bench", rows=rows, completed=out["completed"], requests=out["requests"],
         ttft_s=out["ttft_s"], itl_ms=out["itl_ms"],
         output_tok_per_s=out["output_tok_per_s"], duration_s=out["duration_s"])
"""


def run_tree(tree: Path) -> list:
    """The JSON lines of one child run in ``tree``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(BENCH_ARGS)],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"what"')]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("rows_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not 2 <= len(argv) <= 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"base": Path(argv[1]).resolve(),
             "new": Path(argv[2] if len(argv) > 2 else Path(__file__).parents[1]).resolve()}
    got = {}
    for which in ("base", "new", "new", "base"):
        for line in run_tree(trees[which]):
            print(json.dumps({"tree": which, **line}), flush=True)
            key = "/".join(str(line[k]) for k in ("what", "batch", "rows") if k in line)
            for name in ("wall_ms", "device_ms", "output_tok_per_s"):
                if name in line:
                    got.setdefault(which, {}).setdefault(f"{key}/{name}", []).append(line[name])
            for name in ("ttft_s", "itl_ms"):
                if name in line:
                    for p, v in line[name].items():
                        got.setdefault(which, {}).setdefault(f"{key}/{name}_{p}", []).append(v)
    print(json.dumps({"median": {t: {k: statistics.median(v) for k, v in m.items()}
                                 for t, m in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
