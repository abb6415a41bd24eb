"""The port's router (``rbg_tpu_torch/engine/router.py``) against
``rbg_tpu``'s on the same scripted scenarios over echo backends — pool
order, eviction and backoff, probes, failover, draining frames, stream
failover without duplicates, ``_pin_seed``, deadlines, auth, prefix
affinity and the directory's tier-priced prefix cost: both routers must
make the same choices (by backend index) and end with equal ``metrics``.
Then end to end on the CPU: the port's router in front of two port
servers on ``tiny`` gives ``rbg_tpu``'s ``Engine.generate`` tokens,
greedy and seeded, also across a stream cut mid-way, and the OpenAI
front end answers through it."""

import http.client
import json
import re
import socket
import socketserver
import struct
import threading
import time

import jax
import numpy as np
import pytest

from rbg_tpu.engine import router as j_router
from rbg_tpu_torch.engine import protocol as t_protocol
from rbg_tpu_torch.engine import router as t_router
from rbg_tpu_torch.engine.protocol import recv_obj
from rbg_tpu_torch.engine.protocol import request_obj
from rbg_tpu_torch.engine.protocol import send_msg

ROUTERS = {"ref": j_router, "port": t_router}
TIMEOUT = 30


# ---- backends and harness --------------------------------------------------


class _Backend(socketserver.ThreadingTCPServer):
    """Engine stand-in on the newline-JSON wire. ``reply``: the blocking
    answer; ``stream_n``: a streamed request gets tokens 0..n-1, one per
    frame; ``die_after``: close after that many frames (``rst``: with a
    reset, ``partial``: after half a frame); ``garbage``: answer with a
    non-JSON line."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, reply=None, stream_n=10, die_after=None, rst=False,
                 partial=False, garbage=False, delay=0.0):
        self.seen = []
        backend = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        obj = recv_obj(self.request)
                    except (ConnectionError, json.JSONDecodeError):
                        return
                    if obj is None:
                        return
                    backend.seen.append(obj)
                    if garbage:
                        self.request.sendall(b"not json at all\n")
                        return
                    if obj.get("op") == "health":
                        send_msg(self.request, {"ok": True})
                        continue
                    if reply is not None or not obj.get("stream"):
                        if delay:
                            time.sleep(delay)
                        send_msg(self.request,
                                 {"tokens": [1, 2, 3], **(reply or {})})
                        continue
                    for i in range(stream_n):
                        if die_after is not None and i >= die_after:
                            if partial:
                                self.request.sendall(b'{"tokens": [99')
                            if rst:
                                self.request.setsockopt(
                                    socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                            return
                        send_msg(self.request, {"tokens": [i], "done": False})
                        time.sleep(0.005)
                    send_msg(self.request, {"tokens": [], "done": True,
                                            "ttft_s": 0.0})
                    return

        super().__init__(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server_address[1]}"
        threading.Thread(target=self.serve_forever, args=(0.02,),
                         daemon=True).start()

    def stop(self):
        self.shutdown()
        self.server_close()


def _dead_addr():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    assert cond()


class _Run:
    """One scenario's backends and router, with every address replaced by
    its backend index in what the scenario records."""

    def __init__(self, R, *specs, **state_kw):
        self.R = R
        self.backends, self.addrs = [], []
        for spec in specs:
            if spec is None:
                self.addrs.append(_dead_addr())
            else:
                be = _Backend(**spec)
                self.backends.append(be)
                self.addrs.append(be.addr)
        self.state_kw = state_kw
        self.state = None
        self.server = None
        self.out = {}

    def router(self, role="worker", serve=False, **kw):
        self.state = self.R.RouterState(self.R.Registry(None), None,
                                        {role: list(self.addrs)},
                                        **{**self.state_kw, **kw})
        if serve:
            self.server = self.R.RouterServer(("127.0.0.1", 0),
                                              self.R.Handler)
            self.server.state = self.state
            threading.Thread(target=self.server.serve_forever, args=(0.02,),
                             daemon=True).start()
        return self.state

    @property
    def port(self):
        return self.server.server_address[1]

    def record(self, key, value):
        self.out[key] = value

    def stream(self, req):
        """Frames of one streamed request through the router."""
        frames = []
        with socket.create_connection(("127.0.0.1", self.port),
                                      timeout=TIMEOUT) as s:
            send_msg(s, req)
            while True:
                f = recv_obj(s)
                if f is None:
                    frames.append(None)
                    return frames
                frames.append(f)
                if f.get("done") or "error" in f:
                    return frames

    def _sub(self, text):
        for i, a in enumerate(self.addrs):
            text = re.sub(re.escape(a) + r"(?!\d)", f"<backend {i}>", text)
        return text

    def names(self, addrs):
        """Addresses as backend indices, sorted."""
        return sorted(self._sub(a) for a in addrs)

    def result(self):
        if self.state is not None:
            self.out["metrics"] = dict(self.state.metrics)
        return json.loads(self._sub(json.dumps(self.out, sort_keys=True,
                                               default=str)))

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        for be in self.backends:
            be.stop()


# ---- scenarios: each returns what it recorded ------------------------------


def sc_pool_order(run):
    p = run.R.BackendPool()
    a, b, c = "h:1", "h:2", "h:3"
    seq = []
    for op, addr in [("acquire", a), ("acquire", a), ("acquire", b),
                     ("order", None), ("acquire", c), ("acquire", c),
                     ("acquire", c), ("order", None), ("release", a),
                     ("release", a), ("order", None), ("fail", b),
                     ("order", None), ("ok", b), ("order", None)]:
        if op == "order":
            seq.append(p.order([a, b, c]))
        else:
            getattr(p, op)(addr)
    run.record("orders", seq)
    run.record("outstanding", [p.outstanding(x) for x in (a, b, c)])


def sc_pool_backoff(run):
    p = run.R.BackendPool()
    a, b = "h:1", "h:2"
    p.fail(a)
    run.record("evicted", p.evicted())
    run.record("order", p.order([a, b]))
    p.ok(a)
    run.record("evicted_after_ok", p.evicted())
    for _ in range(10):
        p.fail(b)
    snap = p.snapshot()[b]
    run.record("fails", snap["fails"])
    run.record("capped", snap["down_for_s"] <= p.EVICT_MAX_S + 0.1)
    time.sleep(0.01)
    p.fail(a)
    run.record("all_down_order", p.order([a, b]))
    p.set_draining(a, True)
    p.ok(a)
    run.record("draining_order", p.order([a, b, "h:3"]))


def sc_probe(run):
    p = run.R.BackendPool()
    for a in run.addrs:
        p.fail(a)
    run.record("readmitted", p.probe(timeout=1.0))
    run.record("evicted", p.evicted())


def sc_failover(run):
    st = run.router()
    addr, resp, _, _ = st.call("worker", {"op": "generate", "prompt": [1]})
    run.record("first", [addr, resp["tokens"], st.pool.evicted()])
    st.call("worker", {"op": "generate", "prompt": [1]})
    run.record("seen", [len(be.seen) for be in run.backends])


def sc_app_error(run):
    st = run.router()
    _, resp, _, _ = st.call("worker", {"op": "generate", "prompt": [1]})
    run.record("resp", [resp["error"], st.pool.evicted()])


def sc_all_dead(run):
    st = run.router()
    try:
        st.call("worker", {"op": "generate", "prompt": [1]})
    except Exception as e:  # noqa: BLE001 — recorded and compared
        run.record("raised", [type(e).__name__,
                              str(e).split(":")[0]])


def _draining(retry_after_s):
    return {"reply": {"error": "server is draining", "code": "draining",
                      "retry_after_s": retry_after_s, "done": True}}


def sc_all_draining(run):
    st = run.router()
    try:
        st.call("worker", {"op": "generate", "prompt": [1]})
    except Exception as e:  # noqa: BLE001
        run.record("frame", [type(e).__name__, e.frame])
    run.record("pool", [st.pool.evicted(), run.names(st.pool.draining())])


def sc_stream_draining(run):
    run.router(serve=True)
    frames = run.stream({"op": "generate", "prompt": [1], "stream": True,
                         "timeout_s": 30})
    run.record("frames", frames)


def sc_stream_failover(run):
    run.router(serve=True)
    frames = run.stream({"op": "generate", "prompt": [1], "stream": True,
                         "max_new_tokens": 10})
    tokens = [t for f in frames if f for t in f.get("tokens") or []]
    run.record("tokens", tokens)
    run.record("last", frames[-1])
    _wait_for(lambda: run.state.metrics["failovers"] >= 1
              or run.state.metrics["errors"] >= 1)
    run.record("evicted", run.state.pool.evicted())


def sc_client_gone(run):
    run.router(serve=True)
    s = socket.create_connection(("127.0.0.1", run.port), timeout=TIMEOUT)
    send_msg(s, {"op": "generate", "prompt": [1], "stream": True})
    run.record("first", recv_obj(s))
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()
    a = run.addrs[0]
    _wait_for(lambda: run.state.pool.snapshot()[a]["outstanding"] == 0)
    snap = run.state.pool.snapshot()[a]
    run.record("snap", [snap["fails"], snap["down_for_s"],
                        run.state.pool.evicted()])


def sc_blocking_client_gone(run):
    run.router(serve=True)
    s = socket.create_connection(("127.0.0.1", run.port), timeout=TIMEOUT)
    send_msg(s, {"op": "generate", "prompt": [1]})
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()
    _wait_for(lambda: len(run.backends[0].seen) >= 1)
    time.sleep(0.1)
    run.record("evicted", run.state.pool.evicted())


def sc_garbage(run):
    st = run.router()
    addr, resp, _, _ = st.call("worker", {"op": "generate", "prompt": [1]})
    run.record("call", [addr, resp["tokens"], st.pool.evicted()])


def sc_pin_seed(run):
    pin = run.R.Handler._pin_seed
    run.record("unsampled", ["seed" in pin({"temperature": 0.0}),
                             "seed" in pin({})])
    run.record("client_seed", pin({"temperature": 0.7, "seed": 42})["seed"])
    run.record("pinned", isinstance(pin({"temperature": 0.7})["seed"], int))


def sc_deadline(run):
    st = run.router()
    try:
        st.call("worker", {"op": "generate", "prompt": [1]},
                deadline=time.monotonic() - 1.0)
    except Exception as e:  # noqa: BLE001
        run.record("spent", [type(e).__name__, e.frame["code"]])
    _, resp, _, _ = st.call("worker", {"op": "generate", "prompt": [1]},
                            deadline=time.monotonic() + 30)
    resp.pop("_router_t_dispatch", None)
    run.record("budget", [resp, "timeout_s" in run.backends[0].seen[-1]])


def sc_wire_ops(run):
    run.router(serve=True, token="sesame")
    a = f"127.0.0.1:{run.port}"
    h = request_obj(a, {"op": "health"}, timeout=TIMEOUT)
    run.record("health_open", sorted(h))
    h = request_obj(a, {"op": "health", "token": "sesame"}, timeout=TIMEOUT)
    run.record("health_auth", {k: run.names(v) if isinstance(v, dict) else v
                               for k, v in h.items()
                               if k not in ("slo", "retry_budget")})
    run.record("unauthorized", request_obj(
        a, {"op": "generate", "prompt": [1]}, timeout=TIMEOUT))
    gen = request_obj(a, {"op": "generate", "prompt": [1], "token": "sesame"},
                       timeout=TIMEOUT)
    run.record("generate", sorted(gen))
    run.record("embed", request_obj(
        a, {"op": "embed", "prompts": [[1]], "token": "sesame"},
        timeout=TIMEOUT))
    run.record("unsupported", request_obj(
        a, {"op": "prefill", "prompt": [1], "token": "sesame"},
        timeout=TIMEOUT))
    run.record("bad_timeout", request_obj(
        a, {"op": "generate", "prompt": [1], "token": "sesame",
            "timeout_s": -1}, timeout=TIMEOUT))
    run.record("forwarded", [be.seen[-1].get("token") for be in run.backends])


def sc_retry_budget_off(run):
    st = run.router(retry_budget=run.R.RetryBudget(rate=0))
    try:
        st.call("worker", {"op": "generate", "prompt": [1]})
    except Exception as e:  # noqa: BLE001
        run.record("raised", type(e).__name__)
    run.record("budget", st.retry_budget.snapshot())


def sc_affinity(run):
    st = run.router()
    p1, p2 = list(range(40)), list(range(100, 140))
    picks = []
    for p in [p1] * 5 + [p2, p2]:
        addr, _, _, _ = st.call("worker", {"op": "generate", "prompt": p},
                                prompt=p)
        picks.append(addr)
    run.record("picks", picks)


def sc_affinity_yields(run):
    st = run.router()
    p = list(range(40))
    pinned, _, _, _ = st.call("worker", {"op": "generate", "prompt": p},
                              prompt=p)
    for _ in range(6):
        st.pool.acquire(pinned)
    run.record("loaded", st.candidates_for("worker", p))
    for _ in range(6):
        st.pool.release(pinned)
    run.record("balanced", st.candidates_for("worker", p))
    st.pool.fail(pinned)
    run.record("evicted", st.candidates_for("worker", p))
    st.pool.ok(pinned)
    st.pool.set_draining(pinned, True)
    run.record("draining", st.candidates_for("worker", p))


class _StubDirectory:
    def __init__(self, matched_tokens, detail):
        self.matched_tokens = matched_tokens
        self.detail = detail

    def lookup_detail(self, _tokens):
        return self.matched_tokens, [dict(e) for e in self.detail]


def sc_prefix_cost(run):
    prompt = list(range(1, 65))
    st = run.R.RouterState(
        run.R.Registry(None), None, {"worker": ["dev:1", "host:2", "none:3"]},
        directory=_StubDirectory(48, [
            {"backend": "dev:1", "tier": "device", "hotness": 1},
            {"backend": "host:2", "tier": "host", "hotness": 1}]))
    run.state = st
    run.record("cold", st.candidates_for("worker", prompt))
    st.note_kv_observed(64, 64 * 4096)
    st.linkstats.observe("host:2", 1 << 20, 1.0)
    run.record("priced", st.candidates_for("worker", prompt))
    cost, rep, holders = st._prefix_cost_fn(
        prompt, 48, st.directory.detail)
    run.record("costs", [round(cost(a), 9) for a in ("dev:1", "host:2",
                                                     "none:3")]
               + [rep, sorted(holders)])
    for _ in range(4):
        st.pool.acquire("dev:1")
        st.pool.acquire("host:2")
    run.record("swamped", st.candidates_for("worker", prompt))


def sc_replicate(run):
    prompt = list(range(1, 65))
    st = run.R.RouterState(
        run.R.Registry(None), None, {"worker": ["only:1", "other:2"]},
        directory=_StubDirectory(64, [
            {"backend": "only:1", "tier": "device", "hotness": 50}]))
    run.state = st
    run.record("picks", [st.candidates_for("worker", prompt)[0]
                         for _ in range(10 * run.R.REPLICATE_EVERY)])


def sc_registry_prune(run, tmp_path):
    reg = tmp_path / f"registry-{run.R.__name__}.json"
    reg.write_text(json.dumps({
        "pod-a": {"addr": "127.0.0.1:1001", "role": "worker"},
        "pod-b": {"addr": "127.0.0.1:1002", "role": "worker"}}))
    st = run.R.RouterState(run.R.Registry(str(reg)), None)
    run.state = st
    run.record("before", [st.candidates("worker"),
                          sorted(st.pool.snapshot())])
    time.sleep(0.01)
    reg.write_text(json.dumps({
        "pod-c": {"addr": "127.0.0.1:1003", "role": "worker"}}))
    run.record("after", [st.candidates("worker"),
                         sorted(st.pool.snapshot()), st.worker_role()])


def sc_pd_roles(run):
    st = run.R.RouterState(run.R.Registry(None), None,
                           {"prefill": ["p:1"], "decode": ["d:1"]})
    run.state = st
    run.record("pd_mode", st.pd_mode())
    st.set_role_candidacy("prefill", False)
    run.record("pd_after_withdraw", st.pd_mode())


SCENARIOS = {
    "pool_order": (sc_pool_order, ()),
    "pool_backoff": (sc_pool_backoff, ()),
    "probe": (sc_probe, ({}, None)),
    "failover": (sc_failover, (None, {})),
    "app_error": (sc_app_error, ({"reply": {"error": "bad params"}},)),
    "all_dead": (sc_all_dead, (None, None)),
    "all_draining": (sc_all_draining, (_draining(3.0), _draining(1.5))),
    "stream_draining": (sc_stream_draining, (_draining(4.0), _draining(2.0))),
    "stream_failover": (sc_stream_failover, ({"die_after": 4}, {})),
    "stream_failover_rst": (sc_stream_failover,
                            ({"die_after": 4, "rst": True}, {})),
    "stream_failover_partial": (sc_stream_failover,
                                ({"die_after": 4, "partial": True}, {})),
    "stream_all_dead": (sc_stream_failover,
                        ({"die_after": 2}, {"die_after": 0})),
    "client_gone": (sc_client_gone, ({"stream_n": 400},)),
    "blocking_client_gone": (sc_blocking_client_gone, ({"delay": 0.05},)),
    "garbage": (sc_garbage, ({"garbage": True}, {})),
    "pin_seed": (sc_pin_seed, ()),
    "deadline": (sc_deadline, ({},)),
    "wire_ops": (sc_wire_ops, ({}, {})),
    "retry_budget_off": (sc_retry_budget_off, (None, {})),
    "affinity": (sc_affinity, ({}, {})),
    "affinity_yields": (sc_affinity_yields, ({}, {})),
    "prefix_cost": (sc_prefix_cost, ()),
    "replicate": (sc_replicate, ()),
    "registry_prune": (sc_registry_prune, ()),
    "pd_roles": (sc_pd_roles, ()),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_reference(name, tmp_path):
    fn, specs = SCENARIOS[name]
    results = {}
    for label, R in ROUTERS.items():
        run = _Run(R, *specs)
        try:
            if fn is sc_registry_prune:
                fn(run, tmp_path)
            else:
                fn(run)
            results[label] = run.result()
        finally:
            run.close()
    assert results["port"] == results["ref"]
    assert results["port"], "scenario recorded nothing"


def test_pd_routes_and_directory_flag_refuse():
    """The PD legs are ported and refuse nothing: on a PD group whose
    backends are down, both routers' ``_route`` fail alike on the prefill
    leg (no NotImplementedError), the stream switch reaches the state, and
    KV lanes ride ``request_once`` to a backend and back."""
    with socket.socket() as s0:
        s0.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s0.getsockname()[1]}"
    errs = []
    for R in (j_router, t_router):
        st = R.RouterState(R.Registry(None), None,
                           {"prefill": [dead], "decode": [dead]},
                           kv_stream=False)
        assert st.kv_stream is False
        with pytest.raises(Exception) as ei:
            R.Handler._route(R.Handler, st, {"prompt": [1]},
                             time.monotonic() + 10)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0] and errs[1][0] != "NotImplementedError"

    class Echo(socketserver.BaseRequestHandler):
        def handle(self):
            obj, k, v = t_protocol.recv_msg(self.request)
            t_protocol.send_msg(self.request, {"got": obj["op"]}, v, k)

    srv = socketserver.TCPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        hdr, k, v = t_router.request_once(
            f"127.0.0.1:{srv.server_address[1]}", {"op": "x"}, b"k" * 9, b"v")
        assert (hdr["got"], k, v) == ("x", b"v", b"k" * 9)
    finally:
        srv.shutdown()
        srv.server_close()


def test_prefix_cost_scores_like_reference_test():
    """``tests/test_kvtier.py``'s router scoring cases on the port: the
    device-tier holder wins over the host-tier one and both beat the
    non-holder; the balance guard is the scoring; hot single-holder
    prefixes replicate a bounded number of times."""
    R = t_router
    prompt = list(range(1, 65))
    st = R.RouterState(R.Registry(None), None,
                       {"worker": ["dev:1", "host:2", "none:3"]},
                       directory=_StubDirectory(48, [
                           {"backend": "dev:1", "tier": "device", "hotness": 1},
                           {"backend": "host:2", "tier": "host",
                            "hotness": 1}]))
    st.note_kv_observed(64, 64 * 4096)
    assert st.candidates_for("worker", prompt)[:2] == ["dev:1", "host:2"]
    assert st.metrics["directory_hits"] == 1
    for _ in range(4):
        st.pool.acquire("dev:1")
        st.pool.acquire("host:2")
    assert st.candidates_for("worker", prompt)[0] == "none:3"
    st = R.RouterState(R.Registry(None), None,
                       {"worker": ["only:1", "other:2"]},
                       directory=_StubDirectory(64, [
                           {"backend": "only:1", "tier": "device",
                            "hotness": 50}]))
    picks = [st.candidates_for("worker", prompt)[0]
             for _ in range(2 * R.REPLICATE_EVERY)]
    assert "only:1" in picks and "other:2" in picks
    assert st.metrics["dir_replications"] == 2
    for _ in range(10 * R.REPLICATE_EVERY):
        st.candidates_for("worker", prompt)
    assert st.metrics["dir_replications"] == R.REPLICATE_MAX_PER_PREFIX


# ---- end to end: the port's router before two port servers (CPU) ----------


class _CutProxy(socketserver.ThreadingTCPServer):
    """Relays one backend; a streamed request is cut (connection reset)
    after ``cut_after`` token frames, once."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, upstream, cut_after):
        proxy = self
        self.cuts = 0

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                obj = recv_obj(self.request)
                if obj is None:
                    return
                host, port = upstream.rsplit(":", 1)
                with socket.create_connection((host, int(port)),
                                              timeout=TIMEOUT) as up:
                    send_msg(up, obj)
                    frames = 0
                    while True:
                        f = recv_obj(up)
                        if f is None:
                            return
                        if (obj.get("stream") and f.get("tokens")
                                and frames >= cut_after and not proxy.cuts):
                            proxy.cuts += 1
                            self.request.setsockopt(
                                socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
                            return
                        send_msg(self.request, f)
                        frames += bool(f.get("tokens"))
                        if not obj.get("stream") or f.get("done") \
                                or "error" in f:
                            return

        super().__init__(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server_address[1]}"
        threading.Thread(target=self.serve_forever, args=(0.02,),
                         daemon=True).start()


E2E = dict(model="tiny", vocab_size=512, page_size=8, num_pages=96,
           max_seq_len=256, prefill_chunk=16, max_batch=4)


@pytest.fixture(scope="module")
def fleet():
    """Two port servers on ``tiny`` (vocab 512, the reference's weights
    converted), one behind a cutting proxy, and the reference engine."""
    from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.server import start_server
    from rbg_tpu_torch.engine.service import EngineService
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.convert import params_from_numpy

    jref = JEngine(JConfig(use_pallas="never", **E2E))
    tp = params_from_numpy(jax.tree.map(np.asarray, jref.params),
                           get_config("tiny", vocab_size=512), "cpu")
    svcs = [EngineService(EngineConfig(device="cpu", **E2E), params=tp)
            for _ in range(2)]
    srvs = [start_server(s) for s in svcs]
    proxy = _CutProxy(srvs[0].addr, cut_after=1)
    yield jref, svcs, srvs, proxy
    for s in [proxy] + srvs:
        s.shutdown()
        s.server_close()
    for s in svcs:
        s.stop()


def _router(backends):
    rs = t_router.RouterServer(("127.0.0.1", 0), t_router.Handler)
    rs.state = t_router.RouterState(t_router.Registry(None), None,
                                    {"worker": list(backends)})
    threading.Thread(target=rs.serve_forever, args=(0.02,),
                     daemon=True).start()
    return rs, f"127.0.0.1:{rs.server_address[1]}"


def _ref_tokens(jref, prompt, **sp):
    from rbg_tpu.engine import SamplingParams as JSampling
    return jref.generate([prompt], JSampling(**sp))[0]


def _stream_tokens(addr, req):
    tokens = []
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=TIMEOUT) as s:
        send_msg(s, {**req, "stream": True})
        while True:
            f = recv_obj(s)
            assert f is not None, "router closed mid-stream"
            assert "error" not in f, f
            tokens.extend(f.get("tokens") or [])
            if f.get("done"):
                return tokens


SAMPLINGS = [dict(max_new_tokens=12),
             dict(max_new_tokens=12, temperature=0.9, top_k=40, seed=11)]


def test_router_before_port_servers_gives_reference_tokens(fleet):
    """Blocking requests through the port's router: greedy and seeded
    tokens equal ``rbg_tpu``'s ``Engine.generate``, both servers serve,
    and a repeated prefix sticks to one server and hits its radix cache."""
    jref, svcs, srvs, _ = fleet
    rs, addr = _router([s.addr for s in srvs])
    try:
        rng = np.random.RandomState(5)
        prompts = [rng.randint(1, 500, size=n).tolist() for n in (9, 30, 17)]
        joins = [s.engine.metrics["joins"] for s in svcs]
        for p in prompts:
            for sp in SAMPLINGS:
                r = request_obj(addr, {"op": "generate", "prompt": p, **sp},
                                 timeout=TIMEOUT)
                assert r["tokens"] == _ref_tokens(jref, p, **sp), (p, sp)
        assert all(s.engine.metrics["joins"] > j for s, j in zip(svcs, joins))
        shared = rng.randint(1, 500, size=48).tolist()
        hits = [s.engine.metrics["radix_hit_tokens"] for s in svcs]
        for tail in range(3):
            request_obj(addr, {"op": "generate", "prompt": shared + [tail + 1],
                                "max_new_tokens": 2}, timeout=TIMEOUT)
        gained = [s.engine.metrics["radix_hit_tokens"] - h
                  for s, h in zip(svcs, hits)]
        assert sorted(g > 0 for g in gained) == [False, True], gained
        assert rs.state.metrics["affinity_hits"] >= 2
        assert rs.state.metrics["errors"] == 0
    finally:
        rs.shutdown()
        rs.server_close()


@pytest.mark.parametrize("sp", SAMPLINGS, ids=["greedy", "seeded"])
def test_cut_stream_resumes_on_the_sibling(fleet, sp):
    """A stream cut after its first token frame (connection reset) is
    replayed on the other server: the client's tokens equal the
    uninterrupted reference stream, none duplicated. 24 tokens at one a
    step outlast the server's 5 ms frame polling, so a second frame comes."""
    jref, _, srvs, proxy = fleet
    proxy.cuts = 0
    sp = {**sp, "max_new_tokens": 24}
    rs, addr = _router([proxy.addr, srvs[1].addr])
    try:
        p = np.random.RandomState(9).randint(1, 500, size=21).tolist()
        got = _stream_tokens(addr, {"op": "generate", "prompt": p, **sp})
        assert proxy.cuts == 1
        assert got == _ref_tokens(jref, p, **sp)
        _wait_for(lambda: rs.state.metrics["failovers"] == 1)
        assert rs.state.metrics["errors"] == 0
    finally:
        rs.shutdown()
        rs.server_close()


def test_frontend_answers_through_the_router(fleet):
    """The OpenAI front end with the router as its backend: health, a
    completion equal to the one it gets from the server directly, a
    streamed chat, and embeddings."""
    from rbg_tpu_torch.engine import http_frontend as t_hf

    _, svcs, srvs, _ = fleet
    rs, addr = _router([s.addr for s in srvs])

    def frontend(backend):
        ns = type("A", (), {})()
        ns.host, ns.port, ns.backend = "127.0.0.1", 0, backend
        ns.model, ns.tokenizer_path, ns.default_max_tokens = "tiny", "", 16
        server = t_hf.serve(ns)
        threading.Thread(target=server.serve_forever, args=(0.02,),
                         daemon=True).start()
        return server, server.server_address[1]

    via, via_port = frontend(addr)
    direct, direct_port = frontend(srvs[1].addr)
    try:
        assert _http(via_port, "GET", "/healthz")[2]["ok"]
        body = {"prompt": "hello", "max_tokens": 8}
        st, _, out = _http(via_port, "POST", "/v1/completions", body)
        assert st == 200
        want = _http(direct_port, "POST", "/v1/completions", body)[2]
        assert out["choices"][0]["text"] == want["choices"][0]["text"]
        st, _, events = _http(via_port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "stream": True})
        assert st == 200 and events[-1] == "[DONE]"
        st, _, out = _http(via_port, "POST", "/v1/embeddings",
                           {"input": ["ab"]})
        assert st == 200
        assert len(out["data"][0]["embedding"]) == \
            svcs[0].engine.mcfg.hidden_size
        assert rs.state.metrics["requests"] >= 2
    finally:
        for s in (via, direct, rs):
            s.shutdown()
            s.server_close()


def _http(port, method, path, body=None):
    """(status, headers, JSON body or list of SSE payloads)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        if r.getheader("Content-Type") == "text/event-stream":
            events = [e[len(b"data: "):] for e in payload.split(b"\n\n")
                      if e.startswith(b"data: ")]
            out = [e.decode() if e == b"[DONE]" else json.loads(e)
                   for e in events]
        else:
            out = json.loads(payload)
        return r.status, dict(r.getheaders()), out
    finally:
        conn.close()
