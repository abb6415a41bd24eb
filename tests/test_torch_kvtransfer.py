"""The port's KV transfer plane (``rbg_tpu_torch/kvtransfer``, the wire of
``engine/protocol.py`` and the kv-pool server of ``engine/kvpool.py``)
against ``rbg_tpu``'s: every frame's wire header and lanes equal the
reference's in float32 and bfloat16 (bf16 held as int16 bits here, as
JAX's bf16 numpy there), the socket bytes of ``send_msg`` too; the chunk
assembler on one seeded script of reordered, duplicated, truncated,
out-of-bounds and wrong-size chunks gives the reference's slabs, counters
and error types; the transports (in process, paced, seeded lossy, TCP)
deliver; a receiver with no sender times out with a structured error; the
prefix directory on one script and over the pool's wire; the pool client
against the port's pool server, bf16 pages included, with the page-size
handshake refusal. Engine-free but for the handshake's prefill worker."""

import json
import socket
import socketserver
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.engine import kvpool as j_kvpool
from rbg_tpu.engine import protocol as j_protocol
from rbg_tpu.kvtransfer import chunks as j_chunks
from rbg_tpu.kvtransfer import directory as j_directory
from rbg_tpu.kvtransfer import transport as j_transport
from rbg_tpu_torch.engine import kvpool as t_kvpool
from rbg_tpu_torch.engine import protocol as t_protocol
from rbg_tpu_torch.engine.kvtier import _to_host
from rbg_tpu_torch.kvtransfer import (ChunkAssembler, DirectoryClient,
                                      FakeICITransport, InProcTransport,
                                      KVStreamReceiver, PrefixDirectory,
                                      SlowLossyTransport, StreamError,
                                      StreamFin, StreamFirstToken, StreamMeta,
                                      TCPTransport, bundle_to_frames,
                                      frame_from_wire, frame_to_wire)
from rbg_tpu_torch.kvtransfer import chunks as t_chunks

DTYPES = ["float32", "bfloat16"]


def _meta(mod, sid="s1", n_pages=4, layers=3, page=8, kv=2, hd=4,
          dtype="float32", v_hd=None):
    return mod.StreamMeta(stream_id=sid, prompt=list(range(1, n_pages * page + 1)),
                          n_pages=n_pages, k_page_shape=(page, kv, hd),
                          v_page_shape=(page, kv, v_hd or hd), dtype=dtype,
                          layers=layers, page_size=page)


def _payload(meta, seed=0):
    """(reference k, v), (port k, v): float32 as it is; bfloat16 as JAX's
    bf16 numpy for the reference and as int16 bits for the port."""
    rng = np.random.RandomState(seed)
    x = [rng.randn(*meta.k_shape()).astype(np.float32),
         rng.randn(*meta.v_shape()).astype(np.float32)]
    if meta.dtype == "float32":
        return tuple(x), tuple(x)
    ref = tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in x)
    port = tuple(_to_host(torch.from_numpy(a).to(torch.bfloat16)) for a in x)
    return ref, port


def _socket_bytes(send_msg, *args) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send_msg(a, *args)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk


# ---- frames and the wire ---------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_on_the_wire_equal_reference(dtype):
    """Meta, every chunk (layer_split 1 and 0), first token and FIN: equal
    headers and lanes, equal socket bytes through ``send_msg``, and the
    port's ``frame_from_wire`` reads the reference's frames back."""
    for split in (1, 0):
        jm, tm = _meta(j_chunks, dtype=dtype), _meta(t_chunks, dtype=dtype)
        (jk, jv), (tk, tv) = _payload(tm, seed=split)
        jf = j_chunks.bundle_to_frames(jm, jk, jv, 42, layer_split=split)
        tf = bundle_to_frames(tm, tk, tv, 42, layer_split=split)
        assert [type(f).__name__ for f in tf] == [type(f).__name__ for f in jf]
        for a, b in zip(jf, tf):
            ja, ta = j_transport.frame_to_wire(a), frame_to_wire(b)
            assert json.dumps(ja[0]) == json.dumps(ta[0])
            assert ja[1:] == ta[1:]
            assert _socket_bytes(j_protocol.send_msg, *ja) == \
                _socket_bytes(t_protocol.send_msg, *ta)
            back = frame_from_wire(*ja)
            assert type(back).__name__ == type(b).__name__
            assert frame_to_wire(back) == ta
        assert tf[-1].n_chunks == (tm.layers if split else 1) * tm.n_pages
        assert tm.nbytes() == jm.nbytes()


def test_send_and_recv_msg_lanes_equal_reference():
    """``send_msg`` with and without lanes writes the reference's bytes;
    the port's ``recv_msg`` returns the reference's (header, k, v) and
    ``recv_obj`` the header alone, for messages back to back."""
    msgs = [({"op": "health"},), ({"op": "x", "n": 3}, b"k" * 70000, b"v" * 5),
            ({"op": "y"}, b"kk", b""), ({"op": "z", "tokens": [1, 2]},)]
    for m in msgs:
        assert _socket_bytes(j_protocol.send_msg, *m) == \
            _socket_bytes(t_protocol.send_msg, *m)
    a, b = socket.socketpair()
    with a, b:
        for m in msgs:
            j_protocol.send_msg(a, *m)
        a.shutdown(socket.SHUT_WR)
        got = [t_protocol.recv_msg(b) for _ in range(3)]
        last = t_protocol.recv_obj(b)
        assert t_protocol.recv_msg(b) == (None, None, None)
    assert got[0] == ({"op": "health"}, None, None)
    assert got[1] == ({"op": "x", "n": 3, "bin_k": 70000, "bin_v": 5},
                      b"k" * 70000, b"v" * 5)
    assert got[2] == ({"op": "y", "bin_k": 2, "bin_v": 0}, b"kk", b"")
    assert last == {"op": "z", "tokens": [1, 2]}
    assert t_protocol.CODE_KV_INTEGRITY == "kv_integrity_failed"
    from rbg_tpu.api import errors as j_errors
    assert t_protocol.CODE_KV_INTEGRITY == j_errors.CODE_KV_INTEGRITY
    assert t_protocol.CODE_KV_STREAM == j_errors.CODE_KV_STREAM


# ---- the chunk assembler ---------------------------------------------------


def _script(rng, frames, meta):
    """A seeded delivery: data chunks shuffled, some twice, one out of
    bounds, one short, the first token, then (a truncation) half the data
    withheld from a second assembler."""
    data = [f for f in frames if type(f).__name__ == "KVChunk"]
    order = rng.permutation(len(data)).tolist()
    dups = rng.choice(len(data), size=4, replace=False).tolist()
    return data, order, dups


def _run_script(mod, meta, frames, data_idx, dups, bad):
    """Feed one assembler; returns (events, assembler). ``bad``: indices of
    chunks to corrupt (out of bounds, short payload, bad checksum)."""
    a = mod.ChunkAssembler(meta)
    events = []
    data = [f for f in frames if type(f).__name__ == "KVChunk"]
    for step, i in enumerate(data_idx + dups):
        ch = data[i]
        if step in bad:
            kind = bad[step]
            ch = type(ch)(**{**ch.__dict__})
            if kind == "oob":
                ch.page_hi = meta.n_pages + 2
            elif kind == "short":
                ch.k_bytes = ch.k_bytes[:-2]
            else:
                ch.v_bytes = bytes(len(ch.v_bytes))
        try:
            a.feed(ch)
            events.append(("ok", a.layer_coverage(), a.ready_layers(1),
                           sorted(a.drain_uncommitted())))
        except mod.StreamError as e:
            events.append((type(e).__name__, str(e)))
        if step == len(data_idx) // 2:
            a.feed(mod.StreamFirstToken(meta.stream_id, 7))
    return events, a


@pytest.mark.parametrize("dtype", DTYPES)
def test_assembler_script_matches_reference(dtype):
    """Reordered, duplicated, out-of-bounds, wrong-size and corrupted chunks
    on one seeded script: the same events (coverage, readiness, drained
    cells, error types and messages), slabs with equal bytes, equal
    counters; a truncated stream closes with the same structured error."""
    jm, tm = (_meta(m, dtype=dtype, v_hd=6) for m in (j_chunks, t_chunks))
    (jk, jv), (tk, tv) = _payload(tm, seed=3)
    jf = j_chunks.bundle_to_frames(jm, jk, jv, 7, layer_split=1)
    tf = bundle_to_frames(tm, tk, tv, 7, layer_split=1)
    rng = np.random.RandomState(11)
    _, order, dups = _script(rng, tf, tm)
    bad = {2: "oob", 5: "short", 8: "crc"}
    j_ev, ja = _run_script(j_chunks, jm, jf, order, dups, bad)
    t_ev, ta = _run_script(t_chunks, tm, tf, order, dups, bad)
    assert t_ev == j_ev
    assert {e[0] for e in t_ev} >= {"ok", "StreamError", "KVIntegrityError"}
    for name in ("dup_chunks", "reordered_chunks", "chunks_seen", "bytes_seen",
                 "first_token"):
        assert getattr(ta, name) == getattr(ja, name), name
    assert ta.k.tobytes() == ja.k.tobytes() and ta.v.tobytes() == ja.v.tobytes()
    assert ta.k.dtype.itemsize == ja.k.dtype.itemsize
    assert ta.coverage_complete() == ja.coverage_complete()
    # Truncation: half the data, then FIN.
    results = []
    for mod, meta, frames in ((j_chunks, jm, jf), (t_chunks, tm, tf)):
        a = mod.ChunkAssembler(meta)
        data = [f for f in frames if type(f).__name__ == "KVChunk"]
        for ch in data[:len(data) // 2]:
            a.feed(ch)
        a.feed(mod.StreamFin(meta.stream_id, n_chunks=len(data)))
        with pytest.raises(mod.StreamError) as ei:
            a.check_closed()
        results.append((str(ei.value), a.layer_coverage()))
    assert results[0] == results[1]


# ---- transports --------------------------------------------------------------


def _pump(transport, sid, timeout=10.0):
    rx = KVStreamReceiver(sid)
    t = threading.Thread(target=rx.pump, args=(transport,),
                         kwargs={"timeout": timeout}, daemon=True)
    t.start()
    return rx, t


def test_inproc_and_fake_ici_round_trip_and_pace():
    meta = _meta(t_chunks, sid="ici")
    _, (k, v) = _payload(meta)
    tr = InProcTransport()
    rx, t = _pump(tr, "ici")
    tr.send_chunks("", bundle_to_frames(meta, k, v, first_token=9))
    a = rx.wait_ready(5.0)
    t.join(5.0)
    assert a.first_token == 9 and rx.error() is None and rx.t_fin is not None
    np.testing.assert_array_equal(a.k, k)
    nbytes = k.nbytes + v.nbytes
    meta2 = _meta(t_chunks, sid="ici2")
    tr = FakeICITransport(bytes_per_s=nbytes / 0.2, latency_s=0.0)
    rx, t = _pump(tr, "ici2")
    t0 = time.monotonic()
    tr.send_chunks("", bundle_to_frames(meta2, k, v, first_token=1))
    elapsed = time.monotonic() - t0
    rx.wait_ready(5.0)
    t.join(5.0)
    assert elapsed >= 0.15
    assert tr.stats.rate("") == pytest.approx(nbytes / elapsed, rel=0.5)


def test_slow_lossy_seeded_delivery_equals_reference():
    """The same seed reorders and duplicates the same frames as the
    reference's link, and the port's receiver still assembles the
    payload; a truncated stream surfaces a structured error."""
    orders = []
    for mod, tmod, cmod in ((j_transport, j_transport, j_chunks),
                            (None, None, t_chunks)):
        meta = _meta(cmod, sid="sl")
        (jk, jv), (tk, tv) = _payload(meta)
        k, v = (jk, jv) if mod is not None else (tk, tv)
        inner = (j_transport.InProcTransport() if mod is not None
                 else InProcTransport())
        link = (j_transport.SlowLossyTransport if mod is not None
                else SlowLossyTransport)(inner, delay_s=0.0, reorder_window=4,
                                         dup_rate=0.5, seed=5)
        link.send_chunks("", cmod.bundle_to_frames(meta, k, v, 3, layer_split=1))
        q = inner._q("sl")
        seen = []
        while not q.empty():
            f = q.get()
            seen.append((type(f).__name__, getattr(f, "seq", None)))
        orders.append(seen)
    assert orders[0] == orders[1]
    meta = _meta(t_chunks, sid="sl2")
    _, (k, v) = _payload(meta)
    link = SlowLossyTransport(InProcTransport(), delay_s=0.0, reorder_window=4,
                              dup_rate=0.5, seed=5)
    rx, t = _pump(link, "sl2")
    link.send_chunks("", bundle_to_frames(meta, k, v, 3, layer_split=1))
    a = rx.wait_ready(5.0)
    t.join(5.0)
    np.testing.assert_array_equal(a.v, v)
    cut = SlowLossyTransport(InProcTransport(), delay_s=0.0,
                             truncate_stream="cut", truncate_after_bytes=k.nbytes // 4)
    meta = _meta(t_chunks, sid="cut")
    rx, t = _pump(cut, "cut")
    cut.send_chunks("", bundle_to_frames(meta, k, v, 3))
    t.join(5.0)
    with pytest.raises(StreamError):
        rx.wait_ready(2.0)
    assert rx.error() is not None


class _KVListener(socketserver.ThreadingTCPServer):
    """The accepting half of a TCP chunk stream (what the decode server's
    ``kv_stream`` op does): frames into a receiver, an ack after FIN."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        self.receivers = {}
        srv = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                hello, _, _ = t_protocol.recv_msg(self.request)
                rx = srv.receivers.setdefault(hello["stream_id"],
                                              KVStreamReceiver(hello["stream_id"]))
                srv.hellos.append(hello)
                while True:
                    obj, k, v = t_protocol.recv_msg(self.request)
                    frame = frame_from_wire(obj, k, v)
                    rx.feed(frame)
                    if isinstance(frame, StreamFin):
                        t_protocol.send_msg(self.request, {"ok": True})
                        return

        self.hellos = []
        super().__init__(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server_address[1]}"
        threading.Thread(target=self.serve_forever, daemon=True).start()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tcp_transport_round_trip(dtype):
    meta = _meta(t_chunks, sid=f"tcp-{dtype}", dtype=dtype, n_pages=8)
    _, (k, v) = _payload(meta, seed=4)
    lst = _KVListener()
    try:
        tr = TCPTransport(token="sesame")
        n = tr.send_chunks(lst.addr, bundle_to_frames(meta, k, v, 5, layer_split=1))
        rx = lst.receivers[meta.stream_id]
        a = rx.wait_ready(5.0)
        assert n == k.nbytes + v.nbytes and a.first_token == 5
        assert a.k.tobytes() == k.tobytes() and a.v.tobytes() == v.tobytes()
        assert lst.hellos == [{"op": "kv_stream", "stream_id": meta.stream_id,
                               "token": "sesame"}]
        assert tr.stats.rate(lst.addr) is not None
    finally:
        lst.shutdown()
        lst.server_close()


def test_receiver_times_out_with_a_structured_error():
    rx = KVStreamReceiver("never")
    t = threading.Thread(target=rx.pump, args=(InProcTransport(),),
                         kwargs={"timeout": 0.1}, daemon=True)
    t.start()
    t.join(5.0)
    assert not t.is_alive()
    assert "no frame within" in rx.error()
    with pytest.raises(StreamError):
        rx.wait_ready(0.5)


# ---- the prefix directory ----------------------------------------------------


def _directory_script(d, sleep):
    toks = list(range(40))
    out = [d.register(toks, "b1", slice_id="s1"),
           d.register(toks[:16], "b2", slice_id="s2", tier="host"),
           d.lookup(toks), d.lookup(toks[:17]), d.lookup([99] * 8),
           d.lookup_detail(toks[:17])]
    keys = t_chunks.prefix_keys(toks, 8)
    out += [d.invalidate_keys(keys[3:], "eviction", backend="b1"),
            d.lookup(toks), d.invalidate_backend("b2", "drain"),
            d.lookup(toks[:17]), d.register(toks, "b3", slice_id="s3"),
            d.invalidate_slice("s1", "preemption"), d.lookup(toks)]
    stats = d.stats()
    out.append({k: stats[k] for k in ("keys",)})
    sleep()
    out.append(d.lookup(toks))
    return out


def test_directory_script_matches_reference():
    """register, lookup (longest prefix, holders, tier detail), key /
    backend / slice invalidation and TTL expiry: equal answers."""
    got = []
    for mod in (j_directory, None):
        cls = j_directory.PrefixDirectory if mod else PrefixDirectory
        d = cls(page_size=8, ttl_s=0.3)
        got.append(_directory_script(d, lambda: time.sleep(0.35)))
    # lookup_detail's hotness rides equal; compare the whole record.
    assert got[1] == got[0]
    assert got[1][-1] == (0, [])


def _pool_server(store):
    srv = t_kvpool.KVPoolServer(("127.0.0.1", 0), store)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def test_directory_wire_ops_against_the_port_pool_server():
    """The port's and the reference's DirectoryClient against a live port
    pool server: equal answers op for op; a page_size-less client (the
    router) looks up by prompt and the server computes the key chain."""
    out = []
    for cls in (j_directory.DirectoryClient, DirectoryClient):
        d = PrefixDirectory(page_size=8)
        srv, addr = _pool_server(t_kvpool.KVPoolStore(8, directory=d))
        try:
            c = cls(addr, page_size=8, token="")
            rc = cls(addr, token="")
            toks = list(range(24))
            out.append([c.register(toks, "10.0.0.5:9000", slice_id="sl-a"),
                        c.lookup(toks), rc.lookup(toks), rc.lookup_detail(toks)[0],
                        c.invalidate_slice("sl-a"), rc.lookup(toks),
                        "lookups" in c.stats()])
        finally:
            srv.shutdown()
            srv.server_close()
    assert out[1] == out[0]
    assert out[1][:3] == [3, (24, ["10.0.0.5:9000"]), (24, ["10.0.0.5:9000"])]


# ---- the kv pool's wire ------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_client_against_the_port_server(dtype):
    """put / match / stats through the port's client and server; bf16 pages
    ride as "bfloat16" and come back bit for bit, to the port's client as
    int16 bits and to the reference's client as JAX bf16 with the same
    bytes; a mismatched page size is refused with the reference's
    message."""
    srv, addr = _pool_server(t_kvpool.KVPoolStore(8))
    try:
        rng = np.random.RandomState(2)
        x = rng.randn(2, 3, 8, 2, 4).astype(np.float32)
        if dtype == "bfloat16":
            k = _to_host(torch.from_numpy(x).to(torch.bfloat16))
            v = _to_host(torch.from_numpy(-x).to(torch.bfloat16))
        else:
            k, v = x, -x
        prompt = list(range(1, 30))
        c = t_kvpool.KVPoolClient(addr, page_size=8)
        assert c.put(prompt, k, v, dtype=dtype) == 3
        matched, km, vm = c.match(prompt)
        assert matched == 24 and km.tobytes() == k.tobytes()
        assert vm.tobytes() == v.tobytes()
        jm, jk, jv = j_kvpool.KVPoolClient(addr, page_size=8).match(prompt)
        assert jm == 24 and str(jk.dtype) == dtype
        assert jk.tobytes() == k.tobytes() and jv.tobytes() == v.tobytes()
        assert c.match([7, 7, 7, 7, 7, 7, 7, 7, 7]) == (0, None, None)
        assert c.stats()["pages"] == 3
        bad = t_kvpool.KVPoolClient(addr, page_size=16)
        with pytest.raises(RuntimeError) as ei:
            bad.match(prompt)
        assert str(ei.value) == "page_size mismatch: pool=8 client=16"
    finally:
        srv.shutdown()
        srv.server_close()


def test_page_size_handshake_refusal_degrades_to_cold_prefill():
    """A prefill worker whose page size differs from the pool's is refused
    and prefills cold, as the reference's does."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.pd import PrefillWorker

    srv, addr = _pool_server(t_kvpool.KVPoolStore(16))
    try:
        w = PrefillWorker(EngineConfig(model="tiny", page_size=8, num_pages=64,
                                       max_seq_len=128, prefill_chunk=16,
                                       device="cpu"),
                          pool=t_kvpool.KVPoolClient(addr))
        prompt = np.random.RandomState(3).randint(1, 250, size=64).tolist()
        b = w.prefill(prompt)
        assert b.first_token is not None
        assert w.engine.metrics["prefill_tokens"] == 64
        assert w.metrics["pool_errors"] >= 1 and w.metrics["pool_hits"] == 0
        assert w.engine.allocator.free_pages == 63
    finally:
        srv.shutdown()
        srv.server_close()


def test_pool_server_auth_and_health():
    store = t_kvpool.KVPoolStore(8)
    srv = t_kvpool.KVPoolServer(("127.0.0.1", 0), store, auth_token="tok")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        assert t_protocol.request_obj(addr, {"op": "health"}) == \
            {"ok": True, "mode": "kvpool"}
        assert t_protocol.request_obj(addr, {"op": "pool_stats"}) == \
            {"error": "unauthorized"}
        c = t_kvpool.KVPoolClient(addr, page_size=8, token="tok")
        assert c.stats()["pages"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
