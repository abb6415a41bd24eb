"""Cluster-wide prefix directory — which replica holds which KV prefix.

The router's prefix affinity used to be a last-serving-backend LRU: it
could only re-find a prefix on the ONE replica that most recently served
it. Mooncake's KVCache-centric design keeps a cluster-wide index instead:
any replica that published a page-aligned prefix (to its radix cache and
the shared pool) registers it here, and the router can route a request to
ANY holder.

* ``PrefixDirectory``  — the authoritative in-memory map: page-aligned
  prefix key (``chunks.prefix_keys`` hash chain — stable across
  processes) → {backend addr → entry}. Entries carry a ``slice_id`` tag
  so the disruption controller can invalidate a whole slice on
  preemption, and a TTL backstop against anything the explicit
  invalidation paths miss.
* ``DirectoryClient``  — wire client for the directory ops the kv-pool
  server hosts (``dir_register`` / ``dir_lookup`` / ``dir_invalidate`` /
  ``dir_stats``): the pool is already the cluster's shared KV service, so
  the index lives next to the data.

Lifecycle contract (the staleness satellite): entries are registered by
the prefill publish path, and invalidated on (a) pool/radix eviction of
the prefix, (b) backend drain (SIGTERM), (c) slice preemption or
maintenance (DisruptionController), (d) TTL expiry. A lookup must never
return an evicted prefix — the ``directory_consistent`` stress invariant.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.kvtransfer.chunks import prefix_keys
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock


class _Entry:
    __slots__ = ("backend", "slice_id", "t_registered", "tier", "hits")

    def __init__(self, backend: str, slice_id: str, tier: str = "device"):
        self.backend = backend
        self.slice_id = slice_id
        self.t_registered = time.monotonic()
        # Cache tier the holder keeps this prefix in: "device" (radix /
        # HBM pool — a hit is ~free) or "host" (spill tier — a hit costs
        # the promote fetch). The router's tier-fetch-cost scoring reads
        # it; re-registration refreshes it (promotion flips host→device).
        self.tier = tier
        # Lookup hotness: times this entry fronted a deepest-key lookup.
        # The router replicates hot single-holder prefixes off it.
        self.hits = 0


class PrefixDirectory:
    def __init__(self, page_size: Optional[int] = None,
                 ttl_s: float = 600.0, max_keys: int = 65536):
        self.page_size = page_size
        self.ttl_s = ttl_s
        self.max_keys = max_keys
        self._lock = named_lock("kvtransfer.directory")
        # key → {backend: _Entry}
        self._m: Dict[str, Dict[str, _Entry]] = {}  # guarded_by[kvtransfer.directory]
        # guarded_by[kvtransfer.directory]
        self.metrics = {"registers": 0, "lookups": 0, "hits": 0,
                        "invalidated": 0}

    # -- write paths --

    def register_keys(self, keys: List[str], backend: str,
                      slice_id: str = "", tier: str = "device") -> int:
        """Register a hash-chain of page keys for ``backend``. Returns the
        number of keys registered. Keys are refreshed, not duplicated;
        re-registration updates the tier tag (spill demotes to "host",
        promotion restores "device")."""
        if not keys or not backend:
            return 0
        now = time.monotonic()
        with self._lock:
            for key in keys:
                holders = self._m.get(key)
                if holders is None:
                    holders = self._m[key] = {}
                e = holders.get(backend)
                if e is None:
                    holders[backend] = _Entry(backend, slice_id, tier=tier)
                else:
                    e.t_registered = now
                    e.slice_id = slice_id or e.slice_id
                    e.tier = tier
            self.metrics["registers"] += 1
            self._cap_locked()
            n = len(self._m)
        REGISTRY.set_gauge(obs_names.KVT_DIR_ENTRIES, float(n))
        return len(keys)

    def register(self, tokens: List[int], backend: str,
                 slice_id: str = "", tier: str = "device") -> int:
        if self.page_size is None:
            raise ValueError("directory has no page_size; use register_keys")
        return self.register_keys(prefix_keys(tokens, self.page_size),
                                  backend, slice_id, tier=tier)

    def _invalidate_where(self, pred, reason: str) -> int:
        """Drop entries matching ``pred(key, entry)``; empty keys die."""
        dropped = 0
        with self._lock:
            for key in list(self._m):
                holders = self._m[key]
                for b in [b for b, e in holders.items() if pred(key, e)]:
                    del holders[b]
                    dropped += 1
                if not holders:
                    del self._m[key]
            self.metrics["invalidated"] += dropped
            n = len(self._m)
        if dropped:
            REGISTRY.inc(obs_names.KVT_DIR_INVALIDATIONS_TOTAL,
                         float(dropped), reason=reason)
            REGISTRY.set_gauge(obs_names.KVT_DIR_ENTRIES, float(n))
        return dropped

    def invalidate_backend(self, backend: str, reason: str = "drain") -> int:
        return self._invalidate_where(
            lambda _k, e: e.backend == backend, reason)

    def invalidate_slice(self, slice_id: str,
                         reason: str = "preemption") -> int:
        if not slice_id:
            return 0
        return self._invalidate_where(
            lambda _k, e: e.slice_id == slice_id, reason)

    def invalidate_keys(self, keys: List[str],
                        reason: str = "eviction",
                        backend: str = "") -> int:
        """Drop entries for these keys — scoped to ``backend`` when
        given. Scoping matters once host tiers are per-replica: replica
        A's byte-budget eviction of a shared (content-hashed) prefix
        key must not wipe replica B's still-valid claim for the same
        key. Empty backend keeps the key-wide semantics the single
        shared cluster pool relies on (the pool IS its only holder)."""
        ks = set(keys)
        if backend:
            return self._invalidate_where(
                lambda k, e: k in ks and e.backend == backend, reason)
        return self._invalidate_where(lambda k, _e: k in ks, reason)

    def _cap_locked(self) -> None:
        """Bound the index: evict oldest-registered keys past max_keys
        (caller holds the lock)."""
        over = len(self._m) - self.max_keys
        if over <= 0:
            return
        oldest = sorted(
            self._m,
            key=lambda k: max(e.t_registered
                              for e in self._m[k].values()))[:over]
        for k in oldest:
            del self._m[k]
        self.metrics["invalidated"] += over

    # -- read path --

    def lookup_entries(self, keys: List[str]) -> Tuple[int, List[dict]]:
        """Longest registered prefix of the key chain, with per-holder
        detail. Returns (matched_pages, [{backend, tier, hotness}] of the
        deepest matched key). TTL-expired entries are dropped on the way;
        each hit bumps the deepest entries' hotness (the replication
        signal)."""
        cutoff = time.monotonic() - self.ttl_s
        with self._lock:
            self.metrics["lookups"] += 1
            matched, deepest = 0, None
            for key in keys:
                hs = self._m.get(key)
                if hs:
                    for b in [b for b, e in hs.items()
                              if e.t_registered < cutoff]:
                        del hs[b]
                    if not hs:
                        del self._m[key]
                        hs = None
                if not hs:
                    break
                matched += 1
                deepest = hs
            detail = []
            if deepest is not None:
                for e in deepest.values():
                    e.hits += 1
                    detail.append({"backend": e.backend, "tier": e.tier,
                                   "hotness": e.hits})
            if matched:
                self.metrics["hits"] += 1
        REGISTRY.inc(obs_names.KVT_DIR_LOOKUPS_TOTAL,
                     result="hit" if matched else "miss")
        return matched, detail

    def lookup_keys(self, keys: List[str]) -> Tuple[int, List[str]]:
        """Longest registered prefix of the key chain. Returns
        (matched_pages, holders-of-the-deepest-matched-key)."""
        matched, detail = self.lookup_entries(keys)
        return matched, [d["backend"] for d in detail]

    def lookup(self, tokens: List[int]) -> Tuple[int, List[str]]:
        """Longest registered page-aligned prefix of ``tokens`` →
        (matched_tokens, holder backends)."""
        if self.page_size is None:
            raise ValueError("directory has no page_size; use lookup_keys")
        pages, holders = self.lookup_keys(
            prefix_keys(tokens, self.page_size))
        return pages * self.page_size, holders

    def lookup_detail(self, tokens: List[int]) -> Tuple[int, List[dict]]:
        """Longest registered page-aligned prefix of ``tokens`` →
        (matched_tokens, [{backend, tier, hotness}]) — the router's
        tier-fetch-cost scoring input."""
        if self.page_size is None:
            raise ValueError("directory has no page_size; use lookup_entries")
        pages, detail = self.lookup_entries(
            prefix_keys(tokens, self.page_size))
        return pages * self.page_size, detail

    def stats(self) -> dict:
        with self._lock:
            return {**self.metrics, "keys": len(self._m)}


class ExponentialBackoff:
    """Per-item failure backoff (``rbg_tpu/runtime/queue.py``'s): min(base
    * 2^(n-1), max), or with ``jitter=True`` decorrelated jitter
    (``min(max, uniform(base, prev*3))``), so clients failing together do
    not retry in lockstep."""

    def __init__(self, base: float = 0.005, max_delay: float = 30.0,
                 jitter: bool = False):
        self.base = base
        self.max_delay = max_delay
        self.jitter = jitter
        self._failures: dict = {}  # guarded_by[runtime.backoff]
        # item -> previous jittered delay  # guarded_by[runtime.backoff]
        self._prev: dict = {}
        self._lock = named_lock("runtime.backoff")

    def next_delay(self, item) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            if not self.jitter:
                return min(self.base * (2 ** n), self.max_delay)
            import random
            prev = self._prev.get(item) or self.base
            d = min(self.max_delay, random.uniform(self.base, prev * 3))
            self._prev[item] = d
            return d

    def forget(self, item) -> None:
        with self._lock:
            self._failures.pop(item, None)
            self._prev.pop(item, None)


class DirectoryClient:
    """Wire client for the directory ops hosted on the kv-pool server.
    Failures degrade (return misses / 0) — the directory is an
    optimization, never a request dependency. A failed call opens a
    circuit-breaker whose window GROWS with consecutive failures
    (``ExponentialBackoff``, decorrelated jitter): a flapping pool host
    is neither hammered at a fixed half-open cadence (N routers with the
    same 5 s window would reconnect in lockstep) nor allowed to
    blackhole affinity for a long fixed wall-clock window after one
    blip. A successful call snaps the window back to the base."""

    def __init__(self, addr: str, timeout: float = 2.0,
                 token: Optional[str] = None,
                 page_size: Optional[int] = None,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 chaos=None):
        import os
        self.addr = addr
        self.timeout = timeout
        self.page_size = page_size
        self.backoff_s = backoff_s
        # Fault-injection hook (chaos.inject.directory_fault): called
        # inside the request try-block so an injected OSError rides the
        # REAL failure path (breaker, degraded gauge). None in production.
        self._chaos = chaos
        self._backoff = ExponentialBackoff(base=backoff_s,
                                           max_delay=backoff_max_s,
                                           jitter=True)
        self.token = (token if token is not None
                      else os.environ.get("RBG_DATA_TOKEN") or None)
        self._lock = named_lock("kvtransfer.dirclient")
        self._down_until = 0.0   # guarded_by[kvtransfer.dirclient]
        # True while ONE caller owns the half-open probe (see _call).
        self._probing = False    # guarded_by[kvtransfer.dirclient]

    def _call(self, obj: dict) -> Optional[dict]:
        from rbg_tpu_torch.engine.protocol import request_once
        # Half-open single-flight: while the breaker window is open every
        # caller degrades instantly (local-affinity fast path). When the
        # window closes, exactly ONE caller becomes the probe; concurrent
        # callers keep degrading until the probe's verdict lands — N
        # routers recovering must not thundering-herd the pool host.
        probe = False
        with self._lock:
            if time.monotonic() < self._down_until:
                return None
            if self._down_until > 0.0:
                if self._probing:
                    return None
                self._probing = probe = True
        if self.token:
            obj = dict(obj, token=self.token)
        try:
            if self._chaos is not None:
                self._chaos()
            resp, _, _ = request_once(self.addr, obj, timeout=self.timeout)
        except (OSError, ValueError):
            with self._lock:
                delay = self._backoff.next_delay(self.addr)
                self._down_until = time.monotonic() + delay
                self._probing = False
            REGISTRY.inc(obs_names.KVT_DIR_BREAKER_OPEN_TOTAL)
            # Ladder rung engaged: the router serves on, affinity-only.
            REGISTRY.set_gauge(obs_names.DEGRADED_MODE, 1.0,
                               ladder="directory")
            return None
        if not isinstance(resp, dict) or resp.get("error"):
            if probe:
                with self._lock:
                    self._probing = False
            return None
        with self._lock:
            self._backoff.forget(self.addr)
            self._down_until = 0.0
            self._probing = False
        REGISTRY.set_gauge(obs_names.DEGRADED_MODE, 0.0,
                           ladder="directory")
        return resp

    def register_keys(self, keys: List[str], backend: str,
                      slice_id: str = "", tier: str = "device") -> int:
        resp = self._call({"op": "dir_register", "keys": list(keys),
                           "backend": backend, "slice_id": slice_id,
                           "tier": tier})
        return int(resp.get("registered", 0)) if resp else 0

    def register(self, tokens: List[int], backend: str,
                 slice_id: str = "", tier: str = "device") -> int:
        if self.page_size is None:
            return 0
        return self.register_keys(prefix_keys(tokens, self.page_size),
                                  backend, slice_id, tier=tier)

    def lookup_keys(self, keys: List[str]) -> Tuple[int, List[str]]:
        resp = self._call({"op": "dir_lookup", "keys": list(keys)})
        if not resp:
            return 0, []
        return int(resp.get("matched", 0)), list(resp.get("holders") or ())

    def lookup_detail(self, tokens: List[int]) -> Tuple[int, List[dict]]:
        """(matched_tokens, [{backend, tier, hotness}]) — like
        ``PrefixDirectory.lookup_detail`` but over the wire; the server
        computes the key chain with ITS page size when this client holds
        none. Degrades to (0, []) like every directory op."""
        if self.page_size is not None:
            obj = {"op": "dir_lookup", "detail": True,
                   "keys": prefix_keys(tokens, self.page_size)}
            resp = self._call(obj)
            if not resp:
                return 0, []
            return (int(resp.get("matched", 0)) * self.page_size,
                    list(resp.get("detail") or ()))
        resp = self._call({"op": "dir_lookup", "detail": True,
                           "prompt": list(tokens)})
        if not resp:
            return 0, []
        return (int(resp.get("matched_tokens", 0)),
                list(resp.get("detail") or ()))

    def lookup(self, tokens: List[int]) -> Tuple[int, List[str]]:
        """Longest registered prefix of ``tokens``. Without a local
        page_size the prompt goes to the server, which computes the key
        chain with ITS page size (the router has no engine config)."""
        if self.page_size is not None:
            pages, holders = self.lookup_keys(
                prefix_keys(tokens, self.page_size))
            return pages * self.page_size, holders
        resp = self._call({"op": "dir_lookup", "prompt": list(tokens)})
        if not resp:
            return 0, []
        return (int(resp.get("matched_tokens", 0)),
                list(resp.get("holders") or ()))

    def invalidate_backend(self, backend: str, reason: str = "drain") -> int:
        resp = self._call({"op": "dir_invalidate", "backend": backend,
                           "reason": reason})
        return int(resp.get("invalidated", 0)) if resp else 0

    def invalidate_slice(self, slice_id: str,
                         reason: str = "preemption") -> int:
        resp = self._call({"op": "dir_invalidate", "slice_id": slice_id,
                           "reason": reason})
        return int(resp.get("invalidated", 0)) if resp else 0

    def invalidate_keys(self, keys: List[str],
                        reason: str = "eviction",
                        backend: str = "") -> int:
        """Key-level invalidation (the KVPoolStore eviction path calls
        this on whatever directory handle it was built with — the wire
        client must honor the same contract as the in-proc directory).
        ``backend`` scopes the drop to one replica's claims."""
        obj = {"op": "dir_invalidate", "keys": list(keys),
               "reason": reason}
        if backend:
            obj["backend"] = backend
        resp = self._call(obj)
        return int(resp.get("invalidated", 0)) if resp else 0

    def stats(self) -> dict:
        resp = self._call({"op": "dir_stats"})
        return (resp or {}).get("directory", {})
