"""SLO rate sweep of PD-disaggregated against unified serving, on spawned
processes over the real wire (``rbg_tpu/engine/bench_slo.py``).

Setups (all subprocesses; the port's modules):

* ``unified`` — one ``python -m rbg_tpu_torch.engine.server``; requests
  hit it directly.
* ``pd``      — a kv pool (``engine.kvpool``), a prefill server wired to
  it, ``--pd-decode-replicas`` decode servers and the router in front;
  requests hit the router, KV crosses the wire (pushed chunk streams by
  default).

Each setup is warmed (every engine's ``warmup`` op, then a full-batch
wave through the front door) and offered the same Poisson schedule at
each rate through ``bench_serving --addr``.

    python -m rbg_tpu_torch.engine.bench_slo --setups unified,pd --rates 4,8 \
        --model tiny --requests 32
    python -m rbg_tpu_torch.engine.bench_slo --device cpu --model tiny

Prints a markdown table (and, with both setups, the PD/unified throughput
ratio at each rate) and, with ``--json-out``, a JSON artifact with each
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
from rbg_tpu_torch.engine.protocol import request_obj

_ROOT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(addr: str, proc: subprocess.Popen, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server on {addr} exited with {proc.returncode}")
        try:
            h = request_obj(addr, {"op": "health"}, timeout=5)
            if h and h.get("ok"):
                return
        except OSError:
            pass
        time.sleep(0.5)
    raise TimeoutError(f"server on {addr} never became ready")


class Topology:
    """One spawned serving setup (``unified`` or ``pd``); ``addr`` is its
    front door, ``stop()`` terminates every process it started."""

    def __init__(self, kind: str, engine_args: List[str], env: dict,
                 decode_replicas: int = 1, ready_timeout: float = 300.0):
        self.kind = kind
        self.procs: List[subprocess.Popen] = []
        self.engines: List[str] = []
        try:
            if kind == "unified":
                self.addr = self._server([], engine_args, env, ready_timeout)
                self.engines = [self.addr]
            elif kind == "pd":
                pool = f"127.0.0.1:{_free_port()}"
                page = _flag(engine_args, "--page-size", "16")
                self._spawn(["-m", "rbg_tpu_torch.engine.kvpool", "--port",
                             pool.rsplit(":", 1)[1], "--page-size", page], env)
                prefill = self._server(["--mode", "prefill", "--kv-pool", pool],
                                       engine_args, env, ready_timeout)
                decode = [self._server(["--mode", "decode"], engine_args, env,
                                       ready_timeout)
                          for _ in range(decode_replicas)]
                self.engines = [prefill] + decode
                self.addr = f"127.0.0.1:{_free_port()}"
                backends = {"prefill": [prefill], "decode": decode}
                proc = self._spawn(["-m", "rbg_tpu_torch.engine.router",
                                    "--port", self.addr.rsplit(":", 1)[1],
                                    "--backends", json.dumps(backends)], env)
                _wait_ready(self.addr, proc, ready_timeout)
            else:
                raise ValueError(f"unknown setup {kind!r}")
        except BaseException:
            self.stop()
            raise

    def _spawn(self, argv: List[str], env: dict) -> subprocess.Popen:
        proc = subprocess.Popen([sys.executable] + argv, cwd=_ROOT, env=env)
        self.procs.append(proc)
        return proc

    def _server(self, role: List[str], engine_args: List[str], env: dict,
                timeout: float) -> str:
        port = _free_port()
        proc = self._spawn(["-m", "rbg_tpu_torch.engine.server", "--port",
                            str(port)] + role + engine_args, env)
        addr = f"127.0.0.1:{port}"
        _wait_ready(addr, proc, timeout)
        return addr

    def warmup(self, input_len: int, max_batch: int, token: str) -> None:
        """Every engine's ``warmup`` op, then ``max_batch`` concurrent
        requests through the front door (the router and the KV transfer
        paths of a pd setup included)."""
        import numpy as np

        def req(obj):
            return {**obj, "token": token} if token else obj

        for addr in self.engines:
            resp = request_obj(addr, req({"op": "warmup",
                                          "input_len": input_len}), timeout=900)
            if not (resp or {}).get("ok"):
                raise RuntimeError(f"warmup failed on {addr}: {resp}")
        rng = np.random.default_rng(987)
        threads = []
        for _ in range(max_batch):
            prompt = rng.integers(200, 250, size=input_len).tolist()
            t = threading.Thread(target=request_obj, args=(
                self.addr, req({"op": "generate", "prompt": prompt,
                                "max_new_tokens": 4}), 600.0), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=600)

    def stop(self) -> None:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _flag(args: List[str], name: str, default: str) -> str:
    return args[args.index(name) + 1] if name in args else default


def measure(kind: str, rates: List[float], args, env) -> List[dict]:
    engine_args = ["--model", args.model,
                   "--page-size", str(args.page_size),
                   "--num-pages", str(args.num_pages),
                   "--max-seq-len", str(args.max_seq_len),
                   "--max-batch", str(args.max_batch),
                   "--prefill-chunk", str(args.prefill_chunk)]
    if args.device:
        engine_args += ["--device", args.device]
    token = os.environ.get("RBG_DATA_TOKEN", "")
    server = Topology(kind, engine_args, env,
                      decode_replicas=args.pd_decode_replicas)
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
            replicas = (f" [pd topology: --pd-decode-replicas "
                        f"{args.pd_decode_replicas}]" if kind == "pd" else "")
            out["command"] = (
                f"python -m rbg_tpu_torch.engine.bench_serving --addr <{kind}> "
                f"--requests {args.requests} --rate {rate} "
                f"--input-len {args.input_len} --output-len {args.output_len} "
                f"--model {args.model} --max-batch {args.max_batch}{replicas}")
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
    ap.add_argument("--setups", default="unified,pd",
                    help="comma-separated: unified, pd")

    def _positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    ap.add_argument("--pd-decode-replicas", type=_positive, default=1,
                    help="decode replicas in the pd setup (the router "
                         "least-loads across them)")
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
    # PD against unified at each matched rate.
    ratios = []
    if "unified" in results and "pd" in results:
        for u, p in zip(results["unified"], results["pd"]):
            ratios.append({
                "rate_rps": u["offered_rate_rps"],
                "pd_over_unified_throughput": round(
                    p["output_tok_per_s"] / u["output_tok_per_s"], 3)
                if u["output_tok_per_s"] else None,
                "pd_ttft_p50_s": p["ttft_s"]["p50"],
                "unified_ttft_p50_s": u["ttft_s"]["p50"],
                "pd_goodput_rps": p.get("goodput_rps"),
                "unified_goodput_rps": u.get("goodput_rps"),
            })

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
    for rt in ratios:
        print(f"ratio @ {rt['rate_rps']} rps: PD/unified throughput = "
              f"{rt['pd_over_unified_throughput']}  "
              f"(PD ttft p50 {rt['pd_ttft_p50_s']}s, PD goodput "
              f"{rt['pd_goodput_rps']} rps vs unified "
              f"{rt['unified_goodput_rps']} rps)")
    if args.json_out:
        artifact = {
            "suite": "pd_vs_unified_slo",
            "model": args.model,
            "device": args.device or "cuda",
            "input_len": args.input_len, "output_len": args.output_len,
            "slo_targets": {"ttft_s": args.slo_ttft_s,
                            "tpot_s": args.slo_tpot_s},
            "pd_decode_replicas": args.pd_decode_replicas,
            "results": results, "pd_over_unified": ratios,
        }
        with open(args.json_out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
