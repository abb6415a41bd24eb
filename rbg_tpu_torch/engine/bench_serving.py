"""Serving benchmark: open-loop Poisson load against the port's engine,
measuring TTFT, inter-token latency, end-to-end latency and throughput
percentiles, and SLO goodput (``rbg_tpu/engine/bench_serving.py``).

It drives either an in-process ``EngineService`` (the default: the engine
itself, radix cache off, warmed at the input length first) or a running
server over the wire (``--addr``, streamed ``generate``). Arrivals do not
wait for completions, so the latencies include queueing at the offered
rate. Prompts (ids 1–199) and arrivals come from ``--seed``; the weights
are random from the engine's default seed. The kernels run where the
engine runs (``--device``; the card by default).

    python -m rbg_tpu_torch.engine.bench_serving --model llama3-8b \
        --requests 16 --rate 4 --input-len 512 --output-len 64 \
        --num-pages 2048 --max-seq-len 2048 --max-batch 8 --multi-step 4
    python -m rbg_tpu_torch.engine.bench_serving --device cpu --model tiny
    python -m rbg_tpu_torch.engine.bench_serving --addr 127.0.0.1:9000

Prints a table and, with ``--json``, one JSON line instead.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time
from typing import List, Optional


def _percentile(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(p / 100 * (len(ys) - 1)))))
    return ys[i]


class _Result:
    __slots__ = ("ttft_s", "itl_s", "n_tokens", "latency_s", "ok")

    def __init__(self):
        self.ttft_s: Optional[float] = None
        self.itl_s: List[float] = []
        self.n_tokens = 0
        self.latency_s = 0.0
        self.ok = False


def _open_loop(arrivals, one) -> float:
    """Start ``one(i)`` on its own thread at each arrival time; wait for
    all. Returns the wall time from the first arrival."""
    threads = []
    t_start = time.perf_counter()
    for i, at in enumerate(arrivals):
        delay = t_start + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    return time.perf_counter() - t_start


def build_service(args):
    """The in-process service a run drives: radix cache off (warmup
    prompts must not seed prefixes the measured requests hit)."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.service import EngineService

    return EngineService(EngineConfig(
        model=args.model, page_size=args.page_size, num_pages=args.num_pages,
        max_seq_len=args.max_seq_len, max_batch=args.max_batch,
        prefill_chunk=args.prefill_chunk, multi_step=args.multi_step,
        kv_dtype=args.kv_dtype, speculative=args.speculative,
        ragged=args.ragged, enable_radix_cache=False, device=args.device,
        batch_invariant=args.batch_invariant))


def _drive_inprocess(args, prompts, arrivals):
    """Submit through an EngineService; per-token timing by polling the
    pending's token list every 2 ms."""
    from rbg_tpu_torch.engine.config import SamplingParams

    svc = build_service(args)
    try:
        # Kernel builds and first launches before the measured requests.
        svc.warmup(args.input_len)
        results = [_Result() for _ in prompts]

        def one(i):
            res = results[i]
            t0 = time.perf_counter()
            p = svc.submit_async(prompts[i],
                                 SamplingParams(max_new_tokens=args.output_len))
            last = t0
            while not p.done.wait(0.002):
                now = time.perf_counter()
                n = len(p.tokens)
                if n > res.n_tokens:
                    if res.ttft_s is None:
                        res.ttft_s = now - t0
                    else:
                        res.itl_s.append((now - last) / (n - res.n_tokens))
                    res.n_tokens = n
                    last = now
            res.n_tokens = len(p.tokens)
            if res.ttft_s is None and p.t_first:
                res.ttft_s = p.t_first - p.t_submit
            res.latency_s = time.perf_counter() - t0
            res.ok = p.error is None

        wall = _open_loop(arrivals, one)
    finally:
        svc.stop()
    return results, wall


def _drive_remote(args, prompts, arrivals):
    """Streamed ``generate`` requests over the wire against ``--addr``."""
    from rbg_tpu_torch.engine.protocol import recv_obj, send_msg

    results = [_Result() for _ in prompts]
    host, port = args.addr.rsplit(":", 1)

    def one(i):
        res = results[i]
        t0 = time.perf_counter()
        req = {"op": "generate", "prompt": prompts[i],
               "max_new_tokens": args.output_len, "stream": True}
        if args.token:
            req["token"] = args.token
        try:
            with socket.create_connection((host, int(port)), timeout=300) as s:
                send_msg(s, req)
                last = t0
                while True:
                    frame = recv_obj(s)
                    if frame is None or "error" in frame:
                        break
                    toks = frame.get("tokens", [])
                    now = time.perf_counter()
                    if toks:
                        if res.ttft_s is None:
                            res.ttft_s = now - t0
                        else:
                            res.itl_s.append((now - last) / len(toks))
                        res.n_tokens += len(toks)
                        last = now
                    if frame.get("done"):
                        res.ok = True
                        break
            res.latency_s = time.perf_counter() - t0
        except OSError:
            pass

    return results, _open_loop(arrivals, one)


def run(args) -> dict:
    import numpy as np

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, 200, size=args.input_len).tolist()
               for _ in range(args.requests)]
    # Poisson process: exponential gaps at the offered rate.
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    gaps[0] = 0.0
    arrivals = np.cumsum(gaps).tolist()

    if args.addr:
        results, wall = _drive_remote(args, prompts, arrivals)
    else:
        results, wall = _drive_inprocess(args, prompts, arrivals)

    ok = [r for r in results if r.ok]
    ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
    itls = [x for r in ok for x in r.itl_s]
    lats = [r.latency_s for r in ok]
    total_tokens = sum(r.n_tokens for r in ok)

    # Goodput: completions that met both targets, judged by the serving
    # plane's own rules (SLOTargets.verdict); TPOT = (e2e - ttft) / (n - 1).
    from rbg_tpu_torch.obs.slo import SLOTargets
    ttft_target = float(args.slo_ttft_s or 0.0)
    tpot_target = float(args.slo_tpot_s or 0.0)
    targets = SLOTargets(ttft_s=ttft_target, tpot_s=tpot_target)

    def _tpot(r):
        if r.n_tokens > 1 and r.ttft_s is not None:
            return (r.latency_s - r.ttft_s) / (r.n_tokens - 1)
        return 0.0 if r.ttft_s is not None else None

    out = {
        "requests": args.requests,
        "completed": len(ok),
        "offered_rate_rps": args.rate,
        "duration_s": round(wall, 3),
        "output_tok_per_s": round(total_tokens / wall, 1) if wall else 0.0,
        "ttft_s": {"p50": round(_percentile(ttfts, 50), 4),
                   "p90": round(_percentile(ttfts, 90), 4),
                   "p99": round(_percentile(ttfts, 99), 4)},
        "itl_ms": {"p50": round(_percentile(itls, 50) * 1e3, 2),
                   "p90": round(_percentile(itls, 90) * 1e3, 2),
                   "p99": round(_percentile(itls, 99) * 1e3, 2)},
        "e2e_s": {"p50": round(_percentile(lats, 50), 3),
                  "p99": round(_percentile(lats, 99), 3)},
    }
    if ttft_target > 0 or tpot_target > 0:
        verdicts = [targets.verdict(r.ttft_s, _tpot(r)) for r in ok]
        good = sum(1 for t_ok, p_ok in verdicts if t_ok and p_ok)
        out["slo"] = {
            "ttft_target_s": ttft_target, "tpot_target_s": tpot_target,
            "ttft_attainment": round(
                sum(1 for t_ok, _ in verdicts if t_ok) / len(ok), 4)
                if ok else None,
            "tpot_attainment": round(
                sum(1 for _, p_ok in verdicts if p_ok) / len(ok), 4)
                if ok else None,
            "goodput_fraction": round(good / len(ok), 4) if ok else None,
        }
        out["goodput_rps"] = round(good / wall, 3) if wall else 0.0
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("rbg-tpu-torch serving benchmark")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="offered request rate (Poisson), req/s")
    ap.add_argument("--input-len", type=int, default=32)
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--device", default=None,
                    help="torch device of the in-process engine (default: "
                         "cuda; fails without a card)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--kv-dtype", default="model", choices=("model", "int8"))
    ap.add_argument("--multi-step", type=int, default=1)
    ap.add_argument("--speculative", default="off", choices=("off", "ngram"),
                    help="prompt-lookup speculative decoding (needs "
                         "--multi-step 1)")
    ap.add_argument("--ragged", default="auto", choices=("auto", "off"),
                    help="'off' serves through the split prefill and decode "
                         "paths")
    ap.add_argument("--batch-invariant", action="store_true",
                    help="serve batch-invariant (EngineConfig.batch_invariant: "
                         "a request's tokens do not depend on its batch)")
    ap.add_argument("--addr", default="",
                    help="benchmark a running server instead of in-process "
                         "(host:port)")
    ap.add_argument("--token", default=os.environ.get("RBG_DATA_TOKEN", ""),
                    help="auth token for --addr (default: $RBG_DATA_TOKEN)")
    ap.add_argument("--slo-ttft-s", type=float, default=0.0,
                    help="TTFT target: report goodput_rps and attainment "
                         "(0 = no TTFT judgment)")
    ap.add_argument("--slo-tpot-s", type=float, default=0.0,
                    help="per-output-token target for goodput (0 = none)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts and the arrivals")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of the table")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"completed {out['completed']}/{out['requests']} requests "
          f"in {out['duration_s']}s @ offered {out['offered_rate_rps']} rps")
    print(f"throughput  {out['output_tok_per_s']} output tok/s")
    print(f"ttft        p50 {out['ttft_s']['p50']}s   p90 "
          f"{out['ttft_s']['p90']}s   p99 {out['ttft_s']['p99']}s")
    print(f"itl         p50 {out['itl_ms']['p50']}ms  p90 "
          f"{out['itl_ms']['p90']}ms  p99 {out['itl_ms']['p99']}ms")
    print(f"e2e         p50 {out['e2e_s']['p50']}s   p99 "
          f"{out['e2e_s']['p99']}s")
    if "goodput_rps" in out:
        slo = out["slo"]
        print(f"goodput     {out['goodput_rps']} req/s meeting ttft<="
              f"{slo['ttft_target_s']}s tpot<={slo['tpot_target_s']}s "
              f"(fraction {slo['goodput_fraction']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
