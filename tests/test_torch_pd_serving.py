"""A PD group of the port on the CPU: a kv pool, a prefill server
(``--mode prefill``), a decode server (``--mode decode``) and the port's
router in PD mode, in process, with ``--kv-stream`` auto (KV pushed
prefill→decode as chunk streams) and off (whole bundles over the wire).
Greedy and seeded sampled tokens, blocking and streamed, equal
``rbg_tpu``'s ``Engine.generate`` on the same weights; a push to a dead
decode peer falls back to the bundle path; the servers answer the PD ops
and report their mode. Then the same group as subprocesses through the
servers' command line."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine import router as t_router
from rbg_tpu_torch.engine.config import EngineConfig
from rbg_tpu_torch.engine.kvpool import KVPoolServer, KVPoolStore
from rbg_tpu_torch.engine.pd import PrefillWorker
from rbg_tpu_torch.engine.protocol import recv_obj, request_obj, send_msg
from rbg_tpu_torch.engine.server import parse_args, build_config, start_server
from rbg_tpu_torch.engine.service import DecodeService
from rbg_tpu_torch.kvtransfer.directory import DirectoryClient, PrefixDirectory
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model="tiny", page_size=8, num_pages=128, max_batch=4,
            max_seq_len=128, prefill_chunk=16)
SAMPLINGS = [dict(max_new_tokens=6), dict(max_new_tokens=6, temperature=0.8,
                                          top_k=30, seed=77)]


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 get_config("tiny"), "cpu")


def _prompts():
    rng = np.random.RandomState(21)
    return [rng.randint(1, 250, size=n).tolist() for n in (12, 33, 20)]


@pytest.fixture(scope="module")
def expect(weights):
    jp, _ = weights
    eng = JEngine(JConfig(use_pallas="never", enable_radix_cache=False,
                          **BASE), params=jp)
    return {i: eng.generate(_prompts(), JSampling(**sp))
            for i, sp in enumerate(SAMPLINGS)}


class _Group:
    """Pool + prefill server + decode server + router, in this process."""

    def __init__(self, tp, kv_stream="auto", decode_addrs=()):
        self.closers = []
        self.pool = KVPoolServer(("127.0.0.1", 0),
                                 KVPoolStore(8, directory=PrefixDirectory(page_size=8)))
        self._serve(self.pool)
        pool_addr = f"127.0.0.1:{self.pool.server_address[1]}"
        from rbg_tpu_torch.engine.kvpool import KVPoolClient
        self.prefill = PrefillWorker(
            EngineConfig(**BASE, device="cpu"), params=tp,
            pool=KVPoolClient(pool_addr),
            directory=DirectoryClient(pool_addr, page_size=8))
        self.decode = DecodeService(EngineConfig(**BASE, device="cpu"), params=tp)
        self.psrv = start_server(prefill=self.prefill, kv_stream=kv_stream)
        self.prefill.advertise_addr = self.psrv.addr
        self.dsrv = start_server(decode=self.decode)
        self.closers += [self.psrv, self.dsrv]
        self.router = t_router.RouterServer(("127.0.0.1", 0), t_router.Handler)
        self.router.state = t_router.RouterState(
            t_router.Registry(None), None,
            {"prefill": [self.psrv.addr],
             "decode": list(decode_addrs) + [self.dsrv.addr]},
            kv_stream=kv_stream != "off",
            directory=DirectoryClient(pool_addr))
        self._serve(self.router)
        self.addr = f"127.0.0.1:{self.router.server_address[1]}"

    def _serve(self, srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self.closers.append(srv)

    def close(self):
        for s in self.closers:
            s.shutdown()
            s.server_close()
        self.decode.stop()


def _stream(addr, req):
    host, port = addr.rsplit(":", 1)
    toks = []
    with socket.create_connection((host, int(port)), timeout=60) as s:
        send_msg(s, {**req, "stream": True})
        while True:
            f = recv_obj(s)
            assert f is not None and "error" not in f, f
            toks += f.get("tokens") or []
            if f.get("done"):
                return toks


@pytest.mark.parametrize("kv_stream", ["auto", "off"])
def test_pd_group_tokens_equal_reference(weights, expect, kv_stream):
    _, tp = weights
    g = _Group(tp, kv_stream)
    try:
        for i, sp in enumerate(SAMPLINGS):
            got = [request_obj(g.addr, {"op": "generate", "prompt": p, **sp},
                               timeout=60)["tokens"] for p in _prompts()]
            assert got == expect[i], (kv_stream, sp)
        # Streamed through the router: the prefill-sampled token first.
        assert _stream(g.addr, {"op": "generate", "prompt": _prompts()[1],
                                **SAMPLINGS[1]}) == expect[1][1]
        m = g.router.state.metrics
        if kv_stream == "auto":
            assert m["kv_stream_routed"] == 7 and m["kv_stream_fallbacks"] == 0
        else:
            assert m["kv_stream_routed"] == 0 and m["kv_bytes_routed"] > 0
        assert m["pd_requests"] == 7
        # The servers report their modes; the pool took the prefixes and
        # the directory knows the prefill replica holds them.
        assert request_obj(g.psrv.addr, {"op": "health"})["mode"] == "prefill"
        dm = request_obj(g.dsrv.addr, {"op": "metrics"})
        assert dm["mode"] == "decode" and dm["metrics"]["running"] == 0
        assert dm["metrics"]["free_pages"] == 127
        pm = request_obj(g.psrv.addr, {"op": "metrics"})["metrics"]
        assert pm["pool_exports"] >= 1 and pm["dir_registers"] >= 1
        assert g.prefill.engine.allocator.free_pages == 127
        held, holders = DirectoryClient(
            f"127.0.0.1:{g.pool.server_address[1]}").lookup(_prompts()[1])
        assert held == 32 and holders == [g.psrv.addr]
        # A unified op on a PD role: the reference's reply.
        assert request_obj(g.dsrv.addr, {"op": "prefill", "prompt": [1]}) == \
            {"error": "unsupported op 'prefill' in mode decode"}
    finally:
        g.close()


def test_push_to_a_dead_decode_peer_falls_back_to_bundles(weights, expect):
    """The router picks the decode replica first; when the pushed stream
    cannot reach it (nothing listens there), the request re-routes in
    bundle mode to the live replica, token-exactly."""
    _, tp = weights
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    g = _Group(tp, "auto", decode_addrs=[dead])
    try:
        got = [request_obj(g.addr, {"op": "generate", "prompt": p,
                                    **SAMPLINGS[0]}, timeout=60)["tokens"]
               for p in _prompts()]
        assert got == expect[0]
        assert g.router.state.metrics["kv_stream_fallbacks"] >= 1
    finally:
        g.close()


def test_prefill_op_answers_a_bundle_and_decode_bundle_decodes(weights, expect):
    """The raw ops without the router: ``prefill`` replies the bundle
    header and lanes, ``decode_bundle`` takes them back; a deadline already
    spent is refused before compute."""
    from rbg_tpu_torch.engine.protocol import request_once

    _, tp = weights
    g = _Group(tp, "off")
    try:
        p = _prompts()[0]
        hdr, kb, vb = request_once(g.psrv.addr, {"op": "prefill", "prompt": p,
                                                 **SAMPLINGS[0]})
        assert hdr["dtype"] == "float32" and len(kb) == len(vb) > 0
        fwd = {**hdr, "op": "decode_bundle", **SAMPLINGS[0]}
        for key in ("bin_k", "bin_v"):
            fwd.pop(key)
        r, _, _ = request_once(g.dsrv.addr, fwd, kb, vb)
        assert r["tokens"] == expect[0][0]
        late = request_obj(g.psrv.addr, {"op": "prefill", "prompt": p,
                                         "timeout_s": 1e-9})
        assert late.get("code") == "deadline_exceeded"
    finally:
        g.close()


def test_server_flags_name_the_pd_role():
    args = parse_args(["--mode", "prefill", "--device", "cpu", "--kv-pool",
                       "127.0.0.1:1", "--kv-stream", "off",
                       "--advertise-addr", "10.0.0.1:9001"])
    cfg = build_config(args)
    assert cfg.mode == "prefill" and args.kv_pool == "127.0.0.1:1"
    assert args.kv_stream == "off" and args.advertise_addr == "10.0.0.1:9001"
    assert parse_args([]).mode == "unified"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pd_group_as_processes():
    """The command line: a pool, ``--mode prefill`` (with ``--kv-pool``),
    ``--mode decode`` and the router as subprocesses on the CPU give the
    tokens of a unified engine on the servers' weights (the port's random
    init from ``--seed 0``)."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.llama import init_params

    want = Engine(EngineConfig(**BASE, device="cpu", enable_radix_cache=False),
                  params=init_params(get_config("tiny"), 0, "cpu")).generate(
        _prompts(), SamplingParams(**SAMPLINGS[1]))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RBG_SERVE_PORT", "RBG_PORT_SERVE", "PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    pool, pp, dp, rp = (_free_port() for _ in range(4))
    flags = ["--device", "cpu", "--model", "tiny", "--page-size", "8",
             "--num-pages", "128", "--max-seq-len", "128", "--max-batch", "4",
             "--prefill-chunk", "16"]
    argvs = [["-m", "rbg_tpu_torch.engine.kvpool", "--port", str(pool),
              "--page-size", "8"],
             ["-m", "rbg_tpu_torch.engine.server", "--mode", "prefill", "--port",
              str(pp), "--kv-pool", f"127.0.0.1:{pool}"] + flags,
             ["-m", "rbg_tpu_torch.engine.server", "--mode", "decode", "--port",
              str(dp)] + flags,
             ["-m", "rbg_tpu_torch.engine.router", "--port", str(rp),
              "--directory", f"127.0.0.1:{pool}", "--backends",
              json.dumps({"prefill": [f"127.0.0.1:{pp}"],
                          "decode": [f"127.0.0.1:{dp}"]})]]
    procs = [subprocess.Popen([sys.executable] + a, cwd=ROOT, env=env,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL) for a in argvs]
    try:
        for port in (pool, pp, dp, rp):
            deadline = time.monotonic() + 120
            while True:
                try:
                    if request_obj(f"127.0.0.1:{port}", {"op": "health"},
                                   timeout=2).get("ok"):
                        break
                except OSError:
                    pass
                assert time.monotonic() < deadline, f"port {port} never ready"
                time.sleep(0.2)
        got = [request_obj(f"127.0.0.1:{rp}", {"op": "generate", "prompt": p,
                                               **SAMPLINGS[1]},
                           timeout=120)["tokens"] for p in _prompts()]
        assert got == want
        h = request_obj(f"127.0.0.1:{rp}", {"op": "health"})
        assert h["metrics"]["kv_stream_routed"] == 3
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
