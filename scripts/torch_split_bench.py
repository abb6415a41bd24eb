#!/usr/bin/env python3
"""The split prefill path, speculative decoding and multi-LoRA serving of
the PyTorch/CUDA port at llama3-8b (full width and depth, random weights
from seed 0, bf16 pools) on one card, through ``Engine``:

    python3 scripts/torch_split_bench.py [--out FILE]

Every record is one JSON line with the card's name and power limit
(nvidia-smi) beside it:

- ``kernel_b``: kernel B at the shapes the split path and the verify
  launch it, 8 rows x 64 tokens (a prefill chunk after 256 slots of
  context) and 8 rows x 5 tokens (a verify after 544 slots), through
  ``chip_smoke.ragged_kernel_cases`` (ms by CUDA events, device_ms by
  torch.profiler, plain and SDPA times, bound);
- ``ragged``: the same 8 requests (512-token prompts, 64 new tokens;
  num_pages 2048, max_batch 8, page 16, chunk 64, multi_step 4) with
  ``ragged="auto"`` and ``ragged="off"``, in turns auto, off, off, auto:
  each request's first-token wall, the total wall, steps, and the device
  time of the first step (8 x 64 prompt tokens: one unified step, or one
  split prefill step), summed over the profiler's kernels;
- ``spec``: the same requests with ``speculative="ngram"`` (spec_k 4) and
  ``"off"``, both multi_step 1, in turns: drafted and accepted tokens,
  acceptance share, tokens per verify step, walls, and one steady verify
  step's wall and device time against one decode step's; greedy tokens
  of the two compared; then the same on prompts of a repeated 32-token
  segment (prompt lookup's own case);
- ``lora``: one decode step's wall and device time with no adapter, one
  adapter on every row and two adapters mixed across rows (rank 16, all
  seven targets), multi_step 1.
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams  # noqa: E402
from rbg_tpu_torch.engine.engine import Engine  # noqa: E402
from rbg_tpu_torch.ops.kernels.build import build  # noqa: E402

MODEL = "llama3-8b"
ENGINE = dict(model=MODEL, num_pages=2048, max_batch=8, page_size=16,
              prefill_chunk=64, max_seq_len=1024)
N_REQ, PROMPT_LEN, NEW_TOKENS = 8, 512, 64
OUT = None
CARD = ""


def emit(what, **kw):
    line = json.dumps({"what": what, "card": CARD, **kw})
    print(line, flush=True)
    if OUT is not None:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def device_ms_of(fn):
    """(wall ms, device ms summed over the kernels) of one call of fn."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, dev, out


def prompts(kind, V):
    rng = np.random.RandomState(7)
    if kind == "random":
        return [rng.randint(0, V, PROMPT_LEN).tolist() for _ in range(N_REQ)]
    return [(rng.randint(0, V, 32).tolist() * (PROMPT_LEN // 32)) for _ in range(N_REQ)]


def serve(params, reqs, when=None, loras=None, names=None, **kw):
    """Run ``reqs`` to the end on a fresh engine (warmed with one short
    request). ``when(eng, i)`` says whether step i (counted from the
    requests' submission) is profiled. Returns (tokens, first-token walls
    s, total wall s, metrics of the run, [(wall ms, device ms)] of the
    profiled steps)."""
    eng = Engine(EngineConfig(**ENGINE, **kw), params=params)
    for name, ad in (loras or {}).items():
        eng.load_lora(name, ad, alpha=32.0)
    eng.generate([list(range(1, 80))], SamplingParams(max_new_tokens=4))
    m0 = dict(eng.metrics)
    names = names or [None] * len(reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS, lora=n))
           for p, n in zip(reqs, names)]
    toks = {i: [] for i in ids}
    first, prof, i = {}, [], 0
    while eng.has_work():
        if when is not None and when(eng, i):
            wall, dev, events = device_ms_of(eng.step)
            prof.append((wall, dev))
        else:
            events = eng.step()
        now = time.perf_counter() - t0
        for ev in events:
            toks[ev.request_id].append(ev.token)
            first.setdefault(ev.request_id, now)
        i += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = {k: v - m0[k] for k, v in eng.metrics.items()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return [toks[i] for i in ids], [first[i] for i in ids], wall, metrics, prof


def steady_step(after=8):
    """A ``when`` that picks one step: the ``after``-th once every request
    decodes (no row prefills any more)."""
    seen = {}

    def when(eng, i):
        if len(eng.running) == N_REQ and all(r.state == "running" for r in eng.running):
            seen.setdefault("at", i)
            return i - seen["at"] == after
        return False
    return when


def kernel_b():
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for label, spec in (("B8xT64", [(64, 256 + 64)] * 8), ("B8xT5", [(5, 544 + 5)] * 8)):
        rec = cs.ragged_kernel_cases(torch, np, flush, MODEL, 8, 4, 128, ("ragged_paged",),
                                     spec=spec)["ragged_paged"]
        emit("kernel_b", shape=label, **{k: v for k, v in rec.items() if k != "wide_table"})
    del flush


def ragged_ab(params):
    reqs = prompts("random", params["embed"].shape[0])
    runs = {}
    for mode in ("auto", "off", "off", "auto"):
        toks, firsts, wall, m, prof = serve(params, reqs, lambda eng, i: i == 0,
                                            multi_step=4, ragged=mode)
        runs.setdefault(mode, []).append(toks)
        emit("ragged", ragged=mode, multi_step=4, first_token_s=firsts,
             first_token_s_mean=statistics.mean(firsts), first_token_s_max=max(firsts),
             wall_s=wall, steps=m["steps"], unified_steps=m["unified_steps"],
             decode_windows=m["decode_windows"],
             first_step_wall_ms=prof[0][0], first_step_device_ms=prof[0][1])
    emit("ragged_tokens", rows_equal_auto_vs_off=[a == b for a, b in
                                                  zip(runs["auto"][0], runs["off"][0])],
         repeat_equal=runs["auto"][0] == runs["auto"][1] and runs["off"][0] == runs["off"][1])


def spec_ab(params):
    V = params["embed"].shape[0]
    for kind in ("random", "repetitive"):
        reqs = prompts(kind, V)
        toks = {}
        for mode in ("off", "ngram", "ngram", "off"):
            t, firsts, wall, m, prof = serve(params, reqs, steady_step(), multi_step=1,
                                             speculative=mode)
            toks.setdefault(mode, []).append(t)
            rec = dict(prompts=kind, speculative=mode, wall_s=wall, steps=m["steps"],
                       output_tokens=sum(len(x) for x in t),
                       first_token_s_mean=statistics.mean(firsts),
                       steady_step=[{"wall_ms": w, "device_ms": d} for w, d in prof])
            if mode == "ngram":
                rec.update(spec_steps=m["spec_steps"], drafted=m["spec_drafted"],
                           accepted=m["spec_accepted"],
                           acceptance=m["spec_accepted"] / max(1, m["spec_drafted"]),
                           tokens_per_verify_step=m["decode_tokens"] / max(1, m["spec_steps"]))
            emit("spec", **rec)
        emit("spec_tokens", prompts=kind,
             rows_equal=[a == b for a, b in zip(toks["off"][0], toks["ngram"][0])],
             first_difference=[next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                               for a, b in zip(toks["off"][0], toks["ngram"][0])],
             repeat_equal=toks["off"][0] == toks["off"][1] and
             toks["ngram"][0] == toks["ngram"][1])


def lora_ab(params):
    blocks = params["blocks"]
    L = blocks["wq"].shape[0]
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    loras = {}
    for i, name in enumerate(("a", "b")):
        g = np.random.default_rng(100 + i)
        loras[name] = {t: (g.normal(size=(L, blocks[t].shape[1], 16)).astype(np.float32) * 0.01,
                           g.normal(size=(L, 16, blocks[t].shape[2])).astype(np.float32) * 0.01)
                       for t in targets}
    reqs = prompts("random", params["embed"].shape[0])
    for label, names in (("none", None), ("one", ["a"] * N_REQ),
                         ("two_mixed", ["a", "b"] * (N_REQ // 2)), ("none", None)):
        _, _, wall, m, prof = serve(params, reqs, steady_step(), loras=loras, names=names,
                                    multi_step=1)
        emit("lora", adapters=label, rank=16, targets=list(targets), wall_s=wall,
             steps=m["steps"], decode_step=[{"wall_ms": w, "device_ms": d} for w, d in prof])


def main(argv=None) -> int:
    global OUT, CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    OUT = args.out or None
    torch.backends.cuda.matmul.allow_tf32 = False
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build()
    kernel_b()
    params = cs.init_phase(torch, MODEL)
    ragged_ab(params)
    spec_ab(params)
    lora_ab(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
