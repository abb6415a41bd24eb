"""SLO rate sweep against a spawned engine server
(``rbg_tpu/engine/bench_slo.py``, its ``unified`` setup).

``unified`` spawns ``python -m rbg_tpu_torch.engine.server``, warms it
through its ``warmup`` op and a full-batch wave of requests, then offers
each rate the same Poisson schedule through ``bench_serving --addr``. The
``pd`` setup (router + prefill + decode) needs the disaggregated roles,
which are not ported, and is refused.

    python -m rbg_tpu_torch.engine.bench_slo --setups unified --rates 4,8 \
        --model tiny --requests 32
    python -m rbg_tpu_torch.engine.bench_slo --device cpu --model tiny

Prints a markdown table and, with ``--json-out``, a JSON artifact with each
run's command and the load average before it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

from rbg_tpu_torch.engine import bench_serving
from rbg_tpu_torch.engine.protocol import request_once

_ROOT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class UnifiedServer:
    """One spawned engine server; ``stop()`` terminates it."""

    def __init__(self, engine_args: List[str], env: dict,
                 ready_timeout: float = 300.0):
        self.port = _free_port()
        self.addr = f"127.0.0.1:{self.port}"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "rbg_tpu_torch.engine.server",
             "--port", str(self.port)] + engine_args, cwd=_ROOT, env=env)
        try:
            self._wait_ready(ready_timeout)
        except BaseException:
            self.stop()
            raise

    def _wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"server exited with {self.proc.returncode}")
            try:
                h = request_once(self.addr, {"op": "health"}, timeout=5)
                if h and h.get("ok"):
                    return
            except OSError:
                pass
            time.sleep(0.5)
        raise TimeoutError(f"server on {self.addr} never became ready")

    def warmup(self, input_len: int, max_batch: int, token: str) -> None:
        """The server's ``warmup`` op, then ``max_batch`` concurrent
        requests through the front door."""
        import numpy as np

        def req(extra):
            return {**extra, "token": token} if token else extra

        resp = request_once(self.addr, req({"op": "warmup",
                                            "input_len": input_len}), timeout=900)
        if not (resp or {}).get("ok"):
            raise RuntimeError(f"warmup failed on {self.addr}: {resp}")
        rng = np.random.default_rng(987)
        threads = []
        for _ in range(max_batch):
            prompt = rng.integers(200, 250, size=input_len).tolist()
            t = threading.Thread(target=request_once, args=(
                self.addr, req({"op": "generate", "prompt": prompt,
                                "max_new_tokens": 4}), 600.0), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=600)

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def measure(kind: str, rates: List[float], args, env) -> List[dict]:
    if kind == "pd":
        raise NotImplementedError(
            "bench_slo setup 'pd' needs the disaggregated prefill/decode "
            "roles and the router, which are not ported yet (ROADMAP: PD "
            "disaggregation)")
    if kind != "unified":
        raise ValueError(f"unknown setup {kind!r}")
    engine_args = ["--model", args.model,
                   "--page-size", str(args.page_size),
                   "--num-pages", str(args.num_pages),
                   "--max-seq-len", str(args.max_seq_len),
                   "--max-batch", str(args.max_batch),
                   "--prefill-chunk", str(args.prefill_chunk)]
    if args.device:
        engine_args += ["--device", args.device]
    token = os.environ.get("RBG_DATA_TOKEN", "")
    server = UnifiedServer(engine_args, env)
    rows = []
    try:
        server.warmup(args.input_len, args.max_batch, token)
        for rate in rates:
            bargs = bench_serving.parse_args([
                "--addr", server.addr, "--requests", str(args.requests),
                "--rate", str(rate), "--input-len", str(args.input_len),
                "--output-len", str(args.output_len), "--model", args.model,
                "--slo-ttft-s", str(args.slo_ttft_s),
                "--slo-tpot-s", str(args.slo_tpot_s),
                "--seed", str(args.seed), "--json"])
            bargs.token = token
            load1 = os.getloadavg()[0]
            out = bench_serving.run(bargs)
            out["setup"] = kind
            out["load1_before"] = round(load1, 2)
            out["command"] = (
                f"python -m rbg_tpu_torch.engine.bench_serving --addr <{kind}> "
                f"--requests {args.requests} --rate {rate} "
                f"--input-len {args.input_len} --output-len {args.output_len} "
                f"--model {args.model} --max-batch {args.max_batch}")
            rows.append(out)
    finally:
        server.stop()
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("rbg-tpu-torch SLO rate sweep")
    ap.add_argument("--rates", default="8,16,24",
                    help="comma-separated offered rates (req/s)")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--input-len", type=int, default=32)
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--device", default=None,
                    help="the server's torch device (default: cuda)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-ttft-s", type=float, default=0.2,
                    help="TTFT target for goodput (0 disables)")
    ap.add_argument("--slo-tpot-s", type=float, default=0.1,
                    help="per-output-token target for goodput (0 disables)")
    ap.add_argument("--json-out", default="",
                    help="write the JSON artifact here")
    ap.add_argument("--setups", default="unified",
                    help="comma-separated: unified (pd is not ported)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    rates = [float(r) for r in args.rates.split(",") if r]
    # A serving port from the environment would override every --port.
    env = {k: v for k, v in os.environ.items()
           if k not in ("RBG_SERVE_PORT", "RBG_PORT_SERVE")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)

    results: Dict[str, List[dict]] = {}
    for kind in args.setups.split(","):
        results[kind] = measure(kind, rates, args, env)

    print("| setup | rate rps | done | tok/s | ttft p50/p99 s | "
          "itl p50/p99 ms | e2e p50/p99 s | load1 |")
    print("|" + "---|" * 8)
    for kind, rows in results.items():
        for r in rows:
            print(f"| {kind} | {r['offered_rate_rps']} "
                  f"| {r['completed']}/{r['requests']} "
                  f"| {r['output_tok_per_s']} "
                  f"| {r['ttft_s']['p50']}/{r['ttft_s']['p99']} "
                  f"| {r['itl_ms']['p50']}/{r['itl_ms']['p99']} "
                  f"| {r['e2e_s']['p50']}/{r['e2e_s']['p99']} "
                  f"| {r['load1_before']} |")
    if args.json_out:
        artifact = {
            "suite": "unified_slo",
            "model": args.model,
            "device": args.device or "cuda",
            "input_len": args.input_len, "output_len": args.output_len,
            "slo_targets": {"ttft_s": args.slo_ttft_s,
                            "tpot_s": args.slo_tpot_s},
            "results": results,
        }
        with open(args.json_out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
