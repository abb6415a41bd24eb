"""Shared cross-request KV pool — the Mooncake-store analog
(``rbg_tpu/engine/kvpool.py``): the page store, the ``kv-pool`` TCP
server and the prefill workers' client.

``KVPoolStore`` is a host-memory page store: a token-trie over
page-aligned prefixes (one node per page), LRU-evicted against a byte
budget. Values are numpy ``[L, page, KV, hd]`` page pairs — host RAM is
the pool's medium (Mooncake's DRAM/SSD tier analog); the device pool
stays private to each engine. The host KV tier (``engine/kvtier.py``)
keeps its spilled pages here. A page whose dtype numpy lacks (bfloat16)
is stored as a view of its raw bits, so ``nbytes`` and the payload CRC
are those of the device page. Recency is a logical clock (one tick per
match, extend or put), where the reference reads ``time.monotonic()``: the
same eviction order wherever that clock advances between calls, and the
same on every rank of a mesh whose host tiers see the same calls.

* ``KVPoolServer`` — the ``kv-pool`` role's process
  (``python -m rbg_tpu_torch.engine.kvpool``): ops ``pool_match`` /
  ``pool_put`` / ``pool_stats`` and the cluster prefix directory's
  ``dir_*`` ops over the engine wire's binary lanes. It imports no torch
  and needs no card.
* ``KVPoolClient`` — used by prefill workers: consult before computing,
  export after.

Wire security (flag-gated): ``--auth-token`` (env ``RBG_DATA_TOKEN``)
requires a shared bearer token on every data op (``health`` stays open),
and ``--cert-dir`` serves TLS, wrapped per connection on the handler's
thread. Clients pass ``token=`` / ``ca_path=``.

    python -m rbg_tpu_torch.engine.kvpool --port 9200 --page-size 16
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import itertools
import ssl
from typing import Dict, List, Optional, Tuple

import numpy as np

from rbg_tpu_torch.engine.protocol import recv_msg, send_msg, token_ok
from rbg_tpu_torch.kvtransfer.chunks import host_dtype, payload_checksum
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

_ticks = itertools.count()


class _Node:
    __slots__ = ("key", "k", "v", "children", "parent", "last_used",
                 "nbytes", "dirkey", "hits", "crc")

    def __init__(self, key: Tuple[int, ...], parent):
        self.key = key                    # page_size tokens
        self.k: Optional[np.ndarray] = None   # [L, page, KV, hd]
        self.v: Optional[np.ndarray] = None
        # Payload checksum minted when the page payload was stored (None
        # until then) — verified on every match/extend so bytes that
        # rotted while resident (or were poisoned over the wire) are
        # dropped as a miss instead of served (spill→promote rides this).
        self.crc: Optional[int] = None
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_used = next(_ticks)
        self.nbytes = 0
        # Directory hash-chain key of the prefix ending at this node
        # (chunks.prefix_keys convention) — eviction invalidates it.
        self.dirkey: str = ""
        # Hotness: payload matches through this node. Eviction is
        # LRU-by-hotness — coldest (fewest hits) pages go first.
        self.hits = 0

    @property
    def placeholder(self) -> bool:
        """Path-only node: a deeper tier (the device radix cache) still
        holds this page, so the trie keeps the route to payload pages
        below it without holding data itself (the host tier receives
        DEEP pages first — radix eviction is leaf-first)."""
        return self.k is None


class KVPoolStore:
    """Page-granular prefix trie with LRU byte-budget eviction."""

    def __init__(self, page_size: int, max_bytes: int = 1 << 30,
                 directory=None):
        self.page_size = page_size
        self.max_bytes = max_bytes
        self.root = _Node((), None)  # guarded_by[engine.kvpool]
        self.bytes = 0  # guarded_by[engine.kvpool]
        self._lock = named_lock("engine.kvpool")
        # Cluster prefix directory living NEXT to the pool (the kv-pool
        # server hosts both): evicting a prefix here invalidates its
        # directory keys, so a lookup can never return an evicted prefix.
        self.directory = directory
        # Backend whose claims this store's evictions invalidate. Empty
        # = key-wide (the shared cluster pool, sole holder registry);
        # a per-replica host tier (kvtier.wire_directory) sets its own
        # address so its byte-budget eviction cannot wipe a sibling
        # replica's claim for the same content-hashed key.
        self.owner_backend = ""
        # guarded_by[engine.kvpool]
        self.metrics = {"hits": 0, "misses": 0, "hit_tokens": 0,
                        "put_pages": 0, "evicted_pages": 0, "pages": 0}

    # ---- lookup ----

    def match(self, tokens: List[int]) -> Tuple[int, Optional[np.ndarray],
                                                Optional[np.ndarray]]:
        """Longest page-aligned stored prefix of ``tokens``. Returns
        (matched_tokens, k [L, n_pages, page, KV, hd], v) — None arrays on
        a miss."""
        ps = self.page_size
        with self._lock:
            node = self.root
            ks, vs, run = [], [], []
            i, n = 0, (len(tokens) // ps) * ps
            now = next(_ticks)
            while i < n:
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None or child.placeholder:
                    break   # payload run ends (missing or path-only node)
                child.last_used = now
                child.hits += 1
                ks.append(child.k)
                vs.append(child.v)
                run.append(child)
                i += ps
                node = child
            if not ks:
                self.metrics["misses"] += 1
                return 0, None, None
            self.metrics["hits"] += 1
            self.metrics["hit_tokens"] += i
        # The payload copy happens OUTSIDE the lock: stored arrays are
        # immutable (eviction only drops references; our refs keep them
        # alive), and a multi-MB np.stack under the global lock would
        # serialize every other replica's match/put behind it. Checksum
        # verification rides the same rationale.
        good = self._verify_run(run, ks, vs)
        if good == 0:
            return 0, None, None
        return (good * ps, np.stack(ks[:good], axis=1),
                np.stack(vs[:good], axis=1))

    def extend(self, tokens: List[int], start_tokens: int,
               take: bool = False,
               max_tokens: Optional[int] = None
               ) -> Tuple[int, Optional[np.ndarray],
                          Optional[np.ndarray]]:
        """Contiguous payload run BELOW ``start_tokens`` — the page-
        aligned depth a faster tier (the device radix cache) already
        covers. The walk to ``start_tokens`` may cross placeholder
        nodes; the returned run is payload pages only. With ``take``
        the matched pages leave this store (the caller moves them to
        the faster tier — every cached page lives in exactly one tier),
        their nodes staying as placeholders so deeper payloads remain
        reachable. ``max_tokens`` caps the run (a caller that allocated
        destination room from a peek must not receive more than it can
        place). Returns ``(extra_tokens, k, v)``."""
        ps = self.page_size
        n = (len(tokens) // ps) * ps
        start_tokens = (start_tokens // ps) * ps
        if max_tokens is not None:
            n = min(n, start_tokens + (max_tokens // ps) * ps)
        with self._lock:
            node = self.root
            i = 0
            now = next(_ticks)
            while i < start_tokens:
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None:
                    self.metrics["misses"] += 1
                    return 0, None, None
                node = child
                i += ps
            ks, vs, run = [], [], []
            while i < n:
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None or child.placeholder:
                    break
                child.last_used = now
                child.hits += 1
                ks.append(child.k)
                vs.append(child.v)
                run.append(child)
                i += ps
                node = child
            if not ks:
                self.metrics["misses"] += 1
                return 0, None, None
            self.metrics["hits"] += 1
            self.metrics["hit_tokens"] += i - start_tokens
        # Verify OUTSIDE the lock (match() rationale) and only then take:
        # a corrupt page must not be promoted to the device tier, and the
        # pages behind it must stay resident here for the next hit.
        good = self._verify_run(run, ks, vs)
        if good == 0:
            return 0, None, None
        if take:
            with self._lock:
                for nd in run[:good]:
                    if nd.placeholder:
                        continue   # a racing take already moved it
                    self.bytes -= nd.nbytes
                    self.metrics["pages"] -= 1
                    nd.k = nd.v = None
                    nd.crc = None
                    nd.nbytes = 0
                    nd.dirkey = ""   # caller re-registers as device tier
        # Stack outside the lock (match() rationale); the local ks/vs
        # refs keep taken arrays alive past the placeholder conversion.
        return (good * ps, np.stack(ks[:good], axis=1),
                np.stack(vs[:good], axis=1))

    def peek(self, tokens: List[int], start_tokens: int = 0) -> int:
        """Advisory payload-run depth below ``start_tokens`` — no LRU or
        hotness mutation (the admission TTFT predictor's read)."""
        ps = self.page_size
        n = (len(tokens) // ps) * ps
        start_tokens = (start_tokens // ps) * ps
        with self._lock:
            node = self.root
            i = 0
            while i < start_tokens:
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None:
                    return 0
                node = child
                i += ps
            while i < n:
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None or child.placeholder:
                    break
                i += ps
                node = child
        return i - start_tokens

    # ---- integrity ----

    def _verify_run(self, run: List[_Node], ks: List[np.ndarray],
                    vs: List[np.ndarray]) -> int:
        """Checksum-verify a matched payload run OUTSIDE the lock (the
        arrays are immutable once stored). Returns the count of leading
        good pages. The first corrupt page is dropped from the store and
        its directory claim invalidated — a rotted page must neither be
        served nor stay resident to poison the next lookup; the caller's
        hit simply ends one page earlier (graceful, never wrong)."""
        for j, nd in enumerate(run):
            crc = nd.crc
            if crc is None or payload_checksum(ks[j], vs[j]) == crc:
                continue
            REGISTRY.inc(obs_names.KVT_INTEGRITY_FAILURES_TOTAL,
                         surface="pool")
            dirkey = ""
            with self._lock:
                if not nd.placeholder:
                    self.bytes -= nd.nbytes
                    self.metrics["pages"] -= 1
                    self.metrics["evicted_pages"] += 1
                    nd.k = nd.v = None
                    nd.crc = None
                    nd.nbytes = 0
                    dirkey, nd.dirkey = nd.dirkey, ""
            if dirkey and self.directory is not None:
                self.directory.invalidate_keys(
                    [dirkey], reason="integrity",
                    backend=self.owner_backend)
            return j
        return len(run)

    # ---- insert ----

    def put(self, tokens: List[int], k: np.ndarray, v: np.ndarray,
            data_from_page: int = 0, dtype: Optional[str] = None) -> int:
        """Store the page-aligned prefix of ``tokens``; ``k``/``v`` are
        ``[L, n_pages, page, KV, hd]`` covering the pages from
        ``data_from_page`` on (pages before it — held by a faster tier —
        become path-only placeholder nodes so later spills of deeper
        suffixes stay reachable). Existing pages are refreshed (LRU), not
        duplicated; a placeholder reached with payload is filled in.
        Returns pages newly stored. ``dtype`` (``KVPoolClient.put``'s wire
        dtype name) is accepted so a prefill worker can publish to a store
        in its own process; the store keeps the host arrays as given and
        ``match`` returns them so."""
        ps = self.page_size
        n = min((len(tokens) // ps) * ps,
                (data_from_page + k.shape[1]) * ps if k is not None
                else data_from_page * ps)
        # Copy the page payloads BEFORE taking the lock (see match());
        # directory keys (the cross-process hash chain) likewise.
        from rbg_tpu_torch.kvtransfer.chunks import prefix_keys
        dirkeys = prefix_keys(tokens[:n], ps)
        staged = []
        for pi in range(n // ps):
            if pi < data_from_page:
                staged.append((tuple(tokens[pi * ps:(pi + 1) * ps]),
                               None, None, "", None))
            else:
                ci = pi - data_from_page
                kp = np.ascontiguousarray(k[:, ci])
                vp = np.ascontiguousarray(v[:, ci])
                # Checksum minted at store time, outside the lock like
                # the payload copy — the match/extend verify leg reads it.
                staged.append((tuple(tokens[pi * ps:(pi + 1) * ps]),
                               kp, vp, dirkeys[pi],
                               payload_checksum(kp, vp)))
        new_pages = 0
        with self._lock:
            node = self.root
            now = next(_ticks)
            for key, kp, vp, dk, crc in staged:
                child = node.children.get(key)
                if child is not None:
                    child.last_used = now
                    if kp is not None and child.placeholder:
                        # A shallower page arrived after its deeper
                        # suffix (leaf-first radix eviction) — fill it.
                        child.k, child.v = kp, vp
                        child.nbytes = kp.nbytes + vp.nbytes
                        child.dirkey = dk
                        child.crc = crc
                        self.bytes += child.nbytes
                        new_pages += 1
                    node = child
                    continue
                # Children are keyed by the FULL page's tokens: prompts
                # sharing a first token but diverging inside a page coexist
                # as siblings instead of clobbering each other.
                child = _Node(key, node)
                child.last_used = now
                if kp is not None:
                    child.k, child.v = kp, vp
                    child.nbytes = kp.nbytes + vp.nbytes
                    child.dirkey = dk
                    child.crc = crc
                    self.bytes += child.nbytes
                    new_pages += 1
                node.children[key] = child
                node = child
            self.metrics["put_pages"] += new_pages
            self.metrics["pages"] += new_pages
            evicted_keys = self._evict_locked()
        if evicted_keys and self.directory is not None:
            # Outside the pool lock: a lookup racing this sees the prefix
            # a moment longer, but never AFTER invalidation completes —
            # the directory_consistent drill checks post-eviction lookups.
            self.directory.invalidate_keys(evicted_keys, reason="eviction",
                                           backend=self.owner_backend)
        return new_pages

    # ---- eviction ----

    def _evict_locked(self) -> List[str]:
        """Evict LRU leaves until under budget. Each pass walks the trie
        ONCE and evicts all current leaves in LRU order (a per-page
        full-trie scan would be O(pages²) under sustained pressure); a node
        whose children were all evicted becomes a leaf for the next pass.
        Returns the directory keys of evicted pages (the caller
        invalidates them outside this lock)."""
        evicted: List[str] = []
        while self.bytes > self.max_bytes:
            leaves = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                if node is not self.root and not node.children:
                    leaves.append(node)
                stack.extend(node.children.values())
            if not leaves:
                return evicted
            # LRU-by-hotness WITH aging: coldest (fewest payload
            # matches) go first, recency breaks ties — and every
            # eviction pass halves the survivors' heat, so a prefix
            # that was hot months ago cannot hold the budget against
            # current traffic forever (hits only ever incremented
            # would otherwise turn the store into no-aging LFU).
            # Placeholder leaves (payload taken or never arrived) sort
            # first and cost nothing to drop. No pressure = no decay.
            for nd in leaves:
                nd.hits >>= 1
            leaves.sort(key=lambda nd: (nd.hits, nd.last_used))
            for leaf in leaves:
                if self.bytes <= self.max_bytes:
                    return evicted
                leaf.parent.children.pop(leaf.key, None)
                if not leaf.placeholder:
                    self.bytes -= leaf.nbytes
                    self.metrics["evicted_pages"] += 1
                    self.metrics["pages"] -= 1
                if leaf.dirkey:
                    evicted.append(leaf.dirkey)
        return evicted

    def stats(self) -> dict:
        with self._lock:
            return {**self.metrics, "bytes": self.bytes,
                    "max_bytes": self.max_bytes}


# ---- wire service ----


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        # TLS wraps PER CONNECTION on the worker thread, never on the
        # accept loop — a wrapped listener would run the handshake inside
        # serve_forever, letting one silent peer (port scanner, half-open
        # flow) freeze every prefill replica's pool access (same pattern
        # as the admin wire, runtime/admin.py).
        ctx = self.server.ssl_context
        self._tls_failed = False
        if ctx is not None:
            self.request.settimeout(10.0)  # bound the handshake
            try:
                self.request = ctx.wrap_socket(self.request, server_side=True)
            except OSError:  # ssl.SSLError / timeout / reset — drop peer
                self._tls_failed = True
                return
            self.request.settimeout(None)

    def handle(self):
        if self._tls_failed:
            return
        store: KVPoolStore = self.server.store
        while True:
            try:
                obj, k, v = recv_msg(self.request)
            except (ConnectionError, json.JSONDecodeError):
                return
            if obj is None:
                return
            try:
                self._dispatch(store, obj, k, v)
            except Exception as e:  # noqa: BLE001 — reply, don't die:
                # a malformed frame (bad shape/dtype, truncated payload)
                # must produce an error REPLY, not a dead handler thread
                # and an EOF on the client.
                try:
                    send_msg(self.request, {"error": f"{type(e).__name__}: {e}"})
                except OSError:
                    return

    def _dispatch(self, store, obj, k, v):
        op = obj.get("op")
        token = self.server.auth_token
        if token and op != "health":
            # Shared-token gate on every data op: an unauthenticated peer
            # must neither read KV (match leaks computed activations) nor
            # poison the store (put). Constant-time compare.
            if not token_ok(obj.get("token"), token):
                send_msg(self.request, {"error": "unauthorized"})
                return
        ps = obj.get("page_size")
        if (op in ("pool_match", "pool_put") and ps is not None
                and ps != store.page_size):
            # Page-size handshake: a mismatched client would interpret
            # the page arrays wrong (silently corrupt KV) — refuse.
            send_msg(self.request, {"error": (
                f"page_size mismatch: pool={store.page_size} "
                f"client={ps}")})
            return
        if op == "pool_match":
            matched, km, vm = store.match(obj["prompt"])
            if matched == 0:
                send_msg(self.request, {"matched": 0})
            else:
                kb, vb = km.tobytes(), vm.tobytes()
                # End-to-end: the checksum covers the stacked payload as
                # sent, so a peer fetch is verified at the RECEIVER —
                # corruption on this hop degrades to a miss, never KV.
                send_msg(self.request, {
                    "matched": matched,
                    "k_shape": list(km.shape), "v_shape": list(vm.shape),
                    "dtype": self.server.wire_dtype.get(str(km.dtype),
                                                        str(km.dtype)),
                    "checksum": payload_checksum(kb, vb),
                }, kb, vb)
        elif op == "pool_put":
            # bfloat16 pages are held as int16 bits; the wire name they
            # arrived under is what a match answers with.
            dt = host_dtype(obj["dtype"])
            self.server.wire_dtype[str(dt)] = obj["dtype"]
            ks = np.frombuffer(k, dtype=dt).reshape(obj["k_shape"])
            vs = np.frombuffer(v, dtype=dt).reshape(obj["v_shape"])
            stored = store.put(obj["prompt"], ks, vs)
            send_msg(self.request, {"stored_pages": stored})
        elif op in ("dir_register", "dir_lookup", "dir_invalidate",
                    "dir_stats"):
            d = store.directory
            if d is None:
                send_msg(self.request, {"error": "no directory configured"})
                return
            if op == "dir_register":
                n = d.register_keys(list(obj.get("keys") or ()),
                                    obj.get("backend") or "",
                                    slice_id=obj.get("slice_id") or "",
                                    tier=obj.get("tier") or "device")
                send_msg(self.request, {"registered": n})
            elif op == "dir_lookup":
                if "prompt" in obj:
                    # Key chain computed HERE with the pool's page size —
                    # routers hold no engine config.
                    from rbg_tpu_torch.kvtransfer.chunks import prefix_keys
                    keys = prefix_keys(list(obj["prompt"]),
                                       store.page_size)
                else:
                    keys = list(obj.get("keys") or ())
                matched, detail = d.lookup_entries(keys)
                reply = {
                    "matched": matched,
                    "matched_tokens": matched * store.page_size,
                    "holders": [e["backend"] for e in detail]}
                if obj.get("detail"):
                    # Tier + hotness per holder — the router's tier-
                    # fetch-cost scoring input.
                    reply["detail"] = detail
                send_msg(self.request, reply)
            elif op == "dir_invalidate":
                reason = obj.get("reason") or "explicit"
                n = 0
                if obj.get("keys"):
                    # keys + backend = that replica's claims for those
                    # keys only (per-replica host-tier eviction must not
                    # wipe siblings' claims for a shared prefix hash).
                    n += d.invalidate_keys(list(obj["keys"]), reason,
                                           backend=obj.get("backend")
                                           or "")
                elif obj.get("backend"):
                    n += d.invalidate_backend(obj["backend"], reason)
                if obj.get("slice_id"):
                    n += d.invalidate_slice(obj["slice_id"], reason)
                send_msg(self.request, {"invalidated": n})
            else:
                send_msg(self.request, {"directory": d.stats(),
                                        "mode": "kvpool"})
        elif op == "pool_stats" or op == "metrics":
            stats = {"metrics": store.stats(), "mode": "kvpool"}
            if store.directory is not None:
                stats["directory"] = store.directory.stats()
            send_msg(self.request, stats)
        elif op == "health":
            send_msg(self.request, {"ok": True, "mode": "kvpool"})
        else:
            send_msg(self.request, {"error": f"unsupported op {op!r}"})


class KVPoolServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, store: KVPoolStore,
                 auth_token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None):
        super().__init__(addr, _Handler)
        self.store = store
        self.auth_token = auth_token
        self.ssl_context = ssl_context
        # host numpy dtype name → wire dtype name of the pages put here.
        self.wire_dtype: Dict[str, str] = {}


class KVPoolClient:
    """Prefill-side client. One short-lived connection per op (the ops are
    rare relative to decode steps: once per admitted prompt)."""

    def __init__(self, addr: str, timeout: float = 30.0,
                 page_size: Optional[int] = None,
                 token: Optional[str] = None,
                 ca_path: Optional[str] = None):
        host, port = addr.rsplit(":", 1)
        self.host = host
        self.addr = (host, int(port))
        self.timeout = timeout
        self.page_size = page_size   # engine's page size; server verifies
        self.token = (token if token is not None
                      else os.environ.get("RBG_DATA_TOKEN") or None)
        self._ssl = None
        if ca_path:
            from rbg_tpu_torch.runtime.tlsutil import client_context
            self._ssl = client_context(ca_path)

    def _roundtrip(self, obj, k=None, v=None):
        if self.page_size is not None:
            obj["page_size"] = self.page_size
        if self.token:
            obj["token"] = self.token
        with socket.create_connection(self.addr, timeout=self.timeout) as raw:
            if self._ssl is not None:
                with self._ssl.wrap_socket(raw,
                                           server_hostname=self.host) as s:
                    send_msg(s, obj, k, v)
                    resp = recv_msg(s)
            else:
                send_msg(raw, obj, k, v)
                resp = recv_msg(raw)
        if resp[0] is None:
            # EOF without a reply (pool restarting / handler died):
            # RuntimeError keeps this inside the callers' degrade path.
            raise RuntimeError("kv pool closed the connection mid-request")
        return resp

    def match(self, prompt: List[int]):
        obj, k, v = self._roundtrip({"op": "pool_match", "prompt": list(prompt)})
        if obj.get("error"):
            raise RuntimeError(obj["error"])
        if obj["matched"] == 0:
            return 0, None, None
        cs = obj.get("checksum")
        if cs is not None \
                and payload_checksum(k or b"", v or b"") != int(cs):
            # Bytes rotted on the peer-fetch hop: a miss (the caller
            # recomputes — correct and cheap), never corrupt KV.
            REGISTRY.inc(obs_names.KVT_INTEGRITY_FAILURES_TOTAL,
                         surface="peer_fetch")
            return 0, None, None
        dt = host_dtype(obj["dtype"])
        km = np.frombuffer(k, dtype=dt).reshape(obj["k_shape"])
        vm = np.frombuffer(v, dtype=dt).reshape(obj["v_shape"])
        return obj["matched"], km, vm

    def put(self, prompt: List[int], k: np.ndarray, v: np.ndarray,
            dtype: Optional[str] = None) -> int:
        """``dtype``: the pages' wire dtype name, where the host array's
        own differs (bfloat16 pages held as int16 bits)."""
        k = np.ascontiguousarray(k)
        v = np.ascontiguousarray(v)
        obj, _, _ = self._roundtrip({
            "op": "pool_put", "prompt": list(prompt),
            "k_shape": list(k.shape), "v_shape": list(v.shape),
            "dtype": dtype or str(k.dtype),
        }, k.tobytes(), v.tobytes())
        if obj.get("error"):
            raise RuntimeError(obj["error"])
        return obj["stored_pages"]

    def stats(self) -> dict:
        obj, _, _ = self._roundtrip({"op": "pool_stats"})
        return obj.get("metrics", {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("rbg-tpu-torch kv-pool server")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-bytes", type=int, default=1 << 30)
    ap.add_argument("--auth-token",
                    default=os.environ.get("RBG_DATA_TOKEN", ""),
                    help="require this bearer token on every data op "
                         "(default: $RBG_DATA_TOKEN; empty = open wire)")
    ap.add_argument("--cert-dir", default="",
                    help="serve TLS with certs from this dir (bootstrapped "
                         "via runtime.tlsutil.ensure_certs, same CA "
                         "machinery as the admin wire)")
    args = ap.parse_args(argv)
    from rbg_tpu_torch.kvtransfer.directory import PrefixDirectory
    store = KVPoolStore(args.page_size, max_bytes=args.max_bytes,
                        directory=PrefixDirectory(
                            page_size=args.page_size))
    ctx = None
    if args.cert_dir:
        from rbg_tpu_torch.runtime.tlsutil import ensure_certs, server_context
        _ca, cert, key = ensure_certs(args.cert_dir)
        ctx = server_context(cert, key)
    srv = KVPoolServer(("0.0.0.0", args.port), store,
                       auth_token=args.auth_token or None, ssl_context=ctx)
    print(f"kv-pool serving on :{args.port}"
          f"{' [tls]' if ctx else ''}{' [auth]' if args.auth_token else ''}",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
