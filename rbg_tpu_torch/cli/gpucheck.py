"""``python -m rbg_tpu_torch.cli.gpucheck`` — one-command hardware check of
the port on an NVIDIA GPU (``rbg_tpu/cli/tpucheck.py``).

Stages, each in a throwaway subprocess with its own timeout, so a hung
stage cannot hang the check:

1. ``probe``   — a 128×128 matmul on the card; the card's name and power
   limit (``nvidia-smi``), its compute capability (the kernels are built
   for ``sm_90a`` and need 9.0; anything else fails the stage), the torch
   and CUDA versions.
2. ``kernels`` — builds the nine CUDA libraries (``ops/kernels/build.py``,
   cached in the package's ``_build``), then runs each of kernels A–I once
   at a small shape against its plain version, to ``KERNEL_RTOL`` /
   ``KERNEL_ATOL``: its max abs error and CUDA-event ms, beside the card.
3. ``bench``   — ``bench_serving`` with ``BENCH_ARGS`` on the card (qwen2-0.5b
   geometry, as ``python -m rbg_tpu_torch.engine.bench_serving ... --json``
   runs it): passes when every request completes; tokens/s, TTFT and ITL.
4. ``engine``  — qwen2-0.5b through ``Engine`` (page 16, 1024 pages,
   radix cache, multi_step 4): 4 prompts of 64 tokens, 32 new tokens each;
   every output's length, and kernels A and B launched.

Output: one JSON document on stdout, ``{"ok", "stages": {name: {ok,
elapsed_s, timeout_s, ...}}, "no_device"}``. Exit code 0 when every stage
passes, 2 when the probe finds no card or hangs (every later stage is then
``skipped``), 1 on any other failure. No stage runs on the CPU: without a
card the payloads stop at their first line.

Runbook: README.md, "The GPU check".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STAGE_TIMEOUTS = {"probe": 240, "kernels": 420, "bench": 900, "engine": 420}
STAGES = tuple(STAGE_TIMEOUTS)
# Kernel against its plain version, both f32-accumulated and rounded to
# bf16 once (chip_smoke.py's tolerance).
KERNEL_RTOL, KERNEL_ATOL = 2 ** -7, 1e-3
# The reference's headline decode bench geometry, on the card.
BENCH_ARGS = ["--model", "qwen2-0.5b", "--requests", "32", "--rate", "16",
              "--input-len", "128", "--output-len", "64", "--max-batch", "32",
              "--multi-step", "4", "--json"]
# A payload exits with this code when it finds no card.
NO_DEVICE_RC = 3

# ---- stage payloads (run on the card, inside the subprocess) ----

_PRELUDE = f"""
import json, subprocess, sys
import torch
if not torch.cuda.is_available():
    print("no CUDA device: this stage runs only on the card", file=sys.stderr)
    sys.exit({NO_DEVICE_RC})


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {{e}}"
"""

_PROBE = """
x = torch.ones(128, 128, device="cuda")
y = x @ x
torch.cuda.synchronize()
if float(y[0, 0]) != 128.0:
    sys.exit(f"a 128x128 matmul of ones gave {float(y[0, 0])}, not 128")
cap = torch.cuda.get_device_capability(0)
print(json.dumps({"card": card(), "name": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(), "capability": f"{cap[0]}.{cap[1]}",
                  "torch": torch.__version__, "cuda": torch.version.cuda}))
if cap != (9, 0):
    sys.exit(f"compute capability {cap[0]}.{cap[1]}: the kernels are built for sm_90a "
             "and need 9.0")
""".strip()

_KERNELS = f"""
import time
from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
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
from rbg_tpu_torch.ops.mla_attention import (paged_mla_attention_plain,
                                             ragged_paged_mla_attention_plain)
from rbg_tpu_torch.ops.paged_attention import paged_attention_plain, quantize_kv
from rbg_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention_plain

RTOL, ATOL = {KERNEL_RTOL!r}, {KERNEL_ATOL!r}
t0 = time.perf_counter()
built = sorted(build())
build_s = time.perf_counter() - t0
dev, bf = "cuda", torch.bfloat16
g = torch.Generator(device=dev).manual_seed(0)


def randn(*shape):
    return torch.randn(shape, generator=g, device=dev).to(bf)


def ms(fn, iters=20, warm=3):
    times = []
    for i in range(warm + iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= warm:
            times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


# The reference's decode case (B 4, page 16, KV 2, G 4, hd 64; positions
# 37 / 90 / 5 / 127) and a ragged pack of decode tokens and prefill chunks
# over the same pools; E-H at (dc, dr) = (64, 16).
B, P, page, KV, G, hd, NP = 4, 8, 16, 2, 4, 64, 64
k, v, q = randn(NP, page, KV, hd), randn(NP, page, KV, hd), randn(B, 1, KV * G, hd)
table = torch.randint(1, NP, (B, P), generator=g, device=dev, dtype=torch.int32)
pos = torch.tensor([[37], [90], [5], [127]], dtype=torch.int32, device=dev)
lens = pos[:, 0] + 1
(k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
spec = [(1, 38), (16, 91), (1, 6), (32, 128)]
rows = [r for r, (n, _) in enumerate(spec) for _ in range(n)]
qp = [p for n, kv in spec for p in range(kv - n, kv)]
T = 64
rows, qp = rows + [0] * (T - len(rows)), qp + [-1] * (T - len(qp))
row_ids = torch.tensor(rows, dtype=torch.int32, device=dev)
qpos = torch.tensor([qp], dtype=torch.int32, device=dev)
kv_lens = torch.tensor([kv for _, kv in spec], dtype=torch.int32, device=dev)
qr = randn(1, T, KV * G, hd)
H, dc, dr = 4, 64, 16
scale = (32 + dr) ** -0.5
c, pe = randn(NP, page, 1, dc), randn(NP, page, 1, dr)
(c8, cs), (pe8, ps) = quantize_kv(c), quantize_kv(pe)
ql, qe = randn(B, 1, H, dc), randn(B, 1, H, dr)
qlr, qer = randn(1, T, H, dc), randn(1, T, H, dr)
cases = {{
    "paged_decode": (lambda: paged_decode_attention(q, k, v, table, lens),
                     lambda: paged_attention_plain(q, k, v, table, pos, lens)),
    "paged_decode_q": (lambda: paged_decode_attention_q(q, k8, v8, ks, vs, table, lens),
                       lambda: paged_attention_plain(q, k8, v8, table, pos, lens, ks, vs)),
    "ragged_paged": (
        lambda: ragged_paged_attention_cuda(qr, k, v, table, qpos, kv_lens, row_ids),
        lambda: ragged_paged_attention_plain(qr, k, v, table, qpos, kv_lens, row_ids, 32)),
    "ragged_paged_q": (
        lambda: ragged_paged_attention_q_cuda(qr, k8, v8, ks, vs, table, qpos, kv_lens,
                                              row_ids),
        lambda: ragged_paged_attention_plain(qr, k8, v8, table, qpos, kv_lens, row_ids, 32,
                                             ks, vs)),
    "ragged_paged_tokengrid": (
        lambda: ragged_paged_attention_tokengrid_cuda(qr, k, v, table, qpos, kv_lens,
                                                      row_ids),
        lambda: ragged_paged_attention_plain(qr, k, v, table, qpos, kv_lens, row_ids, 32)),
    "paged_mla_decode": (
        lambda: paged_mla_decode_attention(ql, qe, c, pe, table, lens, scale),
        lambda: paged_mla_attention_plain(ql, qe, c, pe, table, pos, lens, scale)),
    "paged_mla_decode_q": (
        lambda: paged_mla_decode_attention_q(ql, qe, c8, pe8, cs, ps, table, lens, scale),
        lambda: paged_mla_attention_plain(ql, qe, c8, pe8, table, pos, lens, scale, cs, ps)),
    "ragged_paged_mla": (
        lambda: ragged_paged_mla_attention_cuda(qlr, qer, c, pe, table, qpos, kv_lens,
                                                row_ids, scale),
        lambda: ragged_paged_mla_attention_plain(qlr, qer, c, pe, table, qpos, kv_lens,
                                                 row_ids, scale, max_q_len=32)),
    "ragged_paged_mla_q": (
        lambda: ragged_paged_mla_attention_q_cuda(qlr, qer, c8, pe8, cs, ps, table, qpos,
                                                  kv_lens, row_ids, scale),
        lambda: ragged_paged_mla_attention_plain(qlr, qer, c8, pe8, table, qpos, kv_lens,
                                                 row_ids, scale, cs, ps, max_q_len=32)),
}}
out, bad = {{}}, []
for name, (fn, plain) in cases.items():
    reset_launches()
    got = fn().float()
    launched = LAUNCHES[name]
    ref = plain().float()
    err = (got - ref).abs()
    ok = (launched == 1 and bool(torch.isfinite(got).all())
          and bool((err <= RTOL * ref.abs() + ATOL).all()))
    out[name] = {{"ok": ok, "launches": launched, "max_abs_err": float(err.max()),
                  "ms": ms(fn)}}
    if not ok:
        bad.append(name)
print(json.dumps({{"card": card(), "built": built, "build_s": build_s,
                  "tolerance": f"|d| <= {{RTOL}}*|ref| + {{ATOL}}", "kernels": out}}))
if bad:
    sys.exit(f"kernels disagree with their plain versions: {{bad}}")
""".strip()

_BENCH = f"""
from rbg_tpu_torch.engine import bench_serving
from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
args = {BENCH_ARGS!r}
reset_launches()
out = bench_serving.run(bench_serving.parse_args(args))
print(json.dumps({{"card": card(), "args": " ".join(args), "bench": out,
                  "launches": {{k: LAUNCHES[k] for k in ("paged_decode", "ragged_paged")}}}}))
if out["completed"] != out["requests"]:
    sys.exit(f"bench: {{out['completed']}} of {{out['requests']}} requests completed")
""".strip()

_ENGINE = """
import numpy as np
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
cfg = EngineConfig(model="qwen2-0.5b", page_size=16, num_pages=1024, max_batch=4,
                   max_seq_len=1024, prefill_chunk=128, enable_radix_cache=True,
                   multi_step=4)
eng = Engine(cfg)
rng = np.random.RandomState(0)
V = cfg.model_config.vocab_size
prompts = [rng.randint(0, V, size=64).tolist() for _ in range(4)]
reset_launches()
outs = eng.generate(prompts, SamplingParams(max_new_tokens=32))
torch.cuda.synchronize()
launches = {k: LAUNCHES[k] for k in ("paged_decode", "ragged_paged")}
print(json.dumps({"card": card(), "decode_tokens": eng.metrics["decode_tokens"],
                  "prefill_tokens": eng.metrics["prefill_tokens"], "launches": launches}))
if any(len(o) != 32 for o in outs):
    sys.exit(f"outputs of {[len(o) for o in outs]} tokens, not 32 each")
if not all(launches.values()):
    sys.exit(f"kernels A and B must launch: {launches}")
""".strip()

PAYLOADS = {"probe": _PROBE, "kernels": _KERNELS, "bench": _BENCH, "engine": _ENGINE}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_stage(name: str, code: str) -> dict:
    """Run a payload (after the prelude) in a throwaway subprocess; its last
    stdout line, a JSON object, is merged into the stage's verdict."""
    timeout = STAGE_TIMEOUTS[name]
    t0 = time.monotonic()
    try:
        out = subprocess.run([sys.executable, "-c", _PRELUDE + code], timeout=timeout,
                             capture_output=True, text=True, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": ROOT})
    except subprocess.TimeoutExpired:
        return {"ok": False, "elapsed_s": round(time.monotonic() - t0, 1),
                "timeout_s": timeout,
                "detail": "stage subprocess hung past its timeout"}
    res = {"ok": out.returncode == 0, "elapsed_s": round(time.monotonic() - t0, 1),
           "timeout_s": timeout}
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    if lines:
        try:
            payload = json.loads(lines[-1])
            if isinstance(payload, dict):
                res.update(payload)
        except json.JSONDecodeError:
            res["stdout_tail"] = out.stdout[-400:]
    if out.returncode != 0:
        res["detail"] = f"exit {out.returncode}"
        res["no_device"] = out.returncode == NO_DEVICE_RC
        res["stderr_tail"] = out.stderr[-600:] or None
    return res


def run(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m rbg_tpu_torch.cli.gpucheck")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated subset to run, in order")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    stages: dict = {}
    no_device = probe_failed = False
    for name in [s.strip() for s in args.stages.split(",") if s.strip()]:
        if probe_failed:
            stages[name] = {"ok": False, "skipped": True,
                            "detail": "skipped: the probe failed"}
            continue
        stages[name] = _run_stage(name, PAYLOADS[name])
        if name == "probe" and not stages[name]["ok"]:
            probe_failed = True
            no_device = stages[name].get("no_device", True)
    verdict = {"ok": all(s.get("ok") for s in stages.values()), "stages": stages,
               "no_device": no_device}
    doc = json.dumps(verdict)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
    if verdict["ok"]:
        return 0
    return 2 if no_device else 1


if __name__ == "__main__":
    raise SystemExit(run())
