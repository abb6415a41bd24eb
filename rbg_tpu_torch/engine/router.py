"""Router process — the front role of a PD-disagg group
(``rbg_tpu/engine/router.py``, in front of the port's servers).

Reference analog: the sglang-router role in ``examples/inference/
pd-disagg-*.yaml`` (router → prefill → decode with startup dependencies;
the deployed router is cache-aware and fault-tolerant). Discovers its
backends from the address registry the executor maintains (or static
``--backends``):

* registry entries carry the role name, so PD mode switches on automatically
  when ``prefill`` and ``decode`` roles exist: prefill op → KV bundle over
  the wire → decode_bundle op on a decode peer (Mooncake-style transfer).
* otherwise routes ``generate`` over unified workers.

Resilience (reference parity with the deployed sglang-router):

* **least-outstanding-requests** backend choice per role (ties broken
  least-recently-picked), not blind round-robin;
* **health eviction**: a connect/transport failure evicts the backend with
  exponential backoff (1 s → 15 s); a background prober health-checks
  evicted backends every 500 ms and re-admits on first success;
* **failover retries**: every leg is idempotent here — prefill re-runs on a
  sibling, decode_bundle re-sends the held KV bundle, unified generate
  re-submits — so a dead backend never surfaces as a client error while a
  sibling lives;
* **deterministic replay**: sampled requests without a client seed get a
  router-assigned one, so a mid-stream failover re-runs the identical
  token stream on the sibling (position-keyed PRNG: randomness is
  f(seed, position)) and the router resumes the client stream exactly
  where it broke — already-delivered tokens are skipped, never replayed.

In a PD group the router runs the prefill leg (KV bundle back over the
wire, or a KV stream pushed straight to a decode replica chosen first,
transfer-cost-aware) and then the decode leg; a pushed stream that fails
re-routes in bundle mode, token-exact. ``--directory`` consults the
cluster prefix directory the kv-pool server hosts.

    python -m rbg_tpu_torch.engine.router --port 9100 \\
        --backends '{"worker": ["127.0.0.1:9000", "127.0.0.1:9001"]}'
    python -m rbg_tpu_torch.engine.router --port 9100 --directory 127.0.0.1:9200 \\
        --backends '{"prefill": ["127.0.0.1:9001"], "decode": ["127.0.0.1:9002"]}'
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import socketserver
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, CODE_DRAINING,
                                           CODE_KV_STREAM,
                                           RETRYABLE_REJECT_CODES, recv_msg,
                                           request_once, send_msg)
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs import trace
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.obs.slo import SLOTargets, SLOTracker

MAX_ATTEMPTS = 3          # distinct backends tried per leg
CONNECT_TIMEOUT_S = 5.0   # fast failure detection on the connect
STREAM_TIMEOUT_S = 300.0  # per-recv budget once streaming
LEG_TIMEOUT_S = 120.0     # per-attempt blocking-call cap (deadline trims it)
DEFAULT_TIMEOUT_S = 120.0 # whole-request budget when the client sends none
AFFINITY_PREFIX = 32      # prompt tokens hashed for cache affinity
AFFINITY_SLACK = 4        # max extra outstanding before affinity yields
# Cache-aware scoring (Mooncake): a FULL prefill weighs this many
# outstanding-request equivalents in the candidate order; a prefix hit
# scales it down by the hit fraction, and a host-tier hit adds the
# promote-fetch time over the measured link (KV_COST_WEIGHT currency).
PREFIX_MISS_WEIGHT = 2.0
REPLICATE_HOTNESS = 8     # deepest-key lookups before a prefix is "hot"
REPLICATE_EVERY = 4       # every Nth hot single-holder lookup goes off-holder
# Off-holder routes attempted per prefix before giving up: a replica
# with no directory publish path never registers the second copy, and
# an unbounded tick would tax the hottest traffic with deliberate full
# prefills forever. A second holder appearing resets the count.
REPLICATE_MAX_PER_PREFIX = 3
# Transfer-cost-aware decode selection (NetKV, PAPERS.md): estimated
# KV-move seconds (bytes / measured link rate) are weighed against queue
# depth at this exchange rate — 1/WEIGHT seconds of transfer costs as much
# as one outstanding request. Rates come from rbg_kvtransfer link
# observations; with no measurement yet the default keeps the cost term
# small so least-outstanding still dominates.
KV_COST_WEIGHT = 4.0
DEFAULT_KV_LINK_RATE = 1e9   # bytes/s assumed before any real transfer

class _Rejected(Exception):
    """A structured upstream rejection (overloaded / draining / deadline)
    that must reach the client VERBATIM — wrapping it in a generic error
    string would strip the code and retry_after_s the edge maps to
    429/503/504 + Retry-After."""

    def __init__(self, frame: dict):
        super().__init__(frame.get("error", "rejected"))
        self.frame = dict(frame)


def _deadline_frame(msg: str) -> dict:
    return {"error": msg, "code": CODE_DEADLINE}


class RetryBudget:
    """Token bucket capping cross-backend retries router-wide. Under a shed
    storm every request retrying on every sibling MULTIPLIES load exactly
    when the fleet can least afford it — once the bucket is empty, failures
    surface immediately instead of amplifying. First attempts are never
    charged; rate=0 disables retries outright; rate=None disables the
    budget (unbounded legacy behavior)."""

    def __init__(self, rate: Optional[float] = 8.0, burst: float = 32.0):
        self.rate = rate
        # rate=0 means retries DISABLED — the bucket must start empty too,
        # or the initial burst would still allow `burst` retries.
        self.burst = 0.0 if rate == 0 else float(burst)
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> bool:
        if self.rate is None:
            return True
        now = time.monotonic()
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            ok = self._tokens >= 1.0
            if ok:
                self._tokens -= 1.0
            tokens = self._tokens
        # Published so operators can SEE the per-process bucket drain:
        # the budget is per-router-process, so a tier of N routers has an
        # N x fleet-wide effective budget (docs/operations.md).
        REGISTRY.set_gauge(obs_names.SERVING_RETRY_BUDGET_TOKENS, tokens)
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate_per_s": self.rate, "burst": self.burst,
                    "tokens": round(self._tokens, 2)}


class Registry:
    """Pod address registry: {fqdn: {addr, role, group}} JSON file, written
    atomically by the executor; re-read (mtime-cached) per lookup."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._cache: Dict[str, dict] = {}
        self._mtime = 0.0

    def entries(self) -> Dict[str, dict]:
        if not self.path or not os.path.exists(self.path):
            return self._cache
        mtime = os.path.getmtime(self.path)
        if mtime != self._mtime:
            try:
                with open(self.path) as f:
                    self._cache = json.load(f)
                self._mtime = mtime
            except (OSError, json.JSONDecodeError):
                pass
        return self._cache

    def backends(self, role: str, group: Optional[str] = None) -> List[str]:
        """Addresses for a role. When the role's service declares LeaderOnly
        (KEP-260 sharedServiceSelection, carried into registry entries), only
        instance leaders are addressed — one endpoint per multi-host
        instance; the default (All) addresses every pod."""
        all_, leaders, leader_only = [], [], False
        for fqdn, e in sorted(self.entries().items()):
            if e.get("role") == role and (group is None or e.get("group") == group):
                all_.append(e["addr"])
                leader_only = leader_only or bool(e.get("leaderOnly"))
                if e.get("leader", True):
                    leaders.append(e["addr"])
        return (leaders or all_) if leader_only else all_


# Every registry family carrying a per-backend `backend=` label — the
# staleness sweep in BackendPool.retain prunes these for dead addresses.
_BACKEND_SERIES = (obs_names.ROUTER_BACKEND_OUTSTANDING,
                   obs_names.ROUTER_BACKEND_DRAINING,
                   obs_names.SLO_JUDGED_TOTAL,
                   obs_names.SLO_TTFT_MET_TOTAL,
                   obs_names.SLO_TPOT_MET_TOTAL,
                   obs_names.SLO_GOODPUT_TOTAL,
                   obs_names.SLO_TTFT_SECONDS,
                   obs_names.SLO_TPOT_SECONDS)


class _BackendState:
    __slots__ = ("outstanding", "fails", "down_until", "last_pick",
                 "draining")

    def __init__(self):
        self.outstanding = 0
        self.fails = 0
        self.down_until = 0.0
        self.last_pick = 0
        self.draining = False


class BackendPool:
    """Health + load bookkeeping for backend addresses.

    Selection is least-outstanding-requests over healthy backends (ties:
    least recently picked). A transport failure evicts the address with
    exponential backoff; recovery re-admits it (via the prober, or lazily
    when the backoff expires). When EVERY candidate is evicted the
    soonest-to-recover one is still returned — total eviction must degrade
    to "keep trying", not a hard outage."""

    EVICT_BASE_S = 1.0
    EVICT_MAX_S = 15.0

    def __init__(self, on_unavailable=None):
        self._lock = threading.Lock()
        self._st: Dict[str, _BackendState] = {}
        self._seq = 0
        # Fired (outside the lock) when an address stops being a routing
        # candidate — drain mark or eviction. The router wires it to
        # prefix-affinity demotion: a draining/preempted backend must fall
        # out of the front-of-LRU IMMEDIATELY, not when it gets evicted.
        self._on_unavailable = on_unavailable

    def _state(self, addr: str) -> _BackendState:
        st = self._st.get(addr)
        if st is None:
            st = self._st[addr] = _BackendState()
        return st

    def order(self, addrs: List[str], cost=None) -> List[str]:
        """Candidates in try-order: healthy by (outstanding + transfer
        cost, last_pick), then DRAINING by the same key (not-a-candidate
        while any healthy sibling exists, but still reachable so a
        fleet-wide rollout degrades to 'draining' replies rather than a
        hard outage), then evicted by soonest recovery.

        ``cost`` (optional ``addr -> float``) is the transfer-cost term of
        the NetKV-style decode selection: estimated KV-move seconds scaled
        into outstanding-equivalents. Healthy candidates only — a cheap
        link never un-drains or un-evicts anything."""
        now = time.monotonic()
        costs = {a: cost(a) for a in addrs} if cost is not None else {}
        with self._lock:
            healthy, draining, down = [], [], []
            for i, a in enumerate(addrs):
                st = self._state(a)
                if st.down_until > now:
                    down.append((st.down_until, i, a))
                elif st.draining:
                    draining.append((st.outstanding, st.last_pick, i, a))
                else:
                    healthy.append((st.outstanding + costs.get(a, 0.0),
                                    st.last_pick, i, a))
            healthy.sort()
            draining.sort()
            down.sort()
            return ([t[-1] for t in healthy] + [t[-1] for t in draining]
                    + [t[-1] for t in down])

    def acquire(self, addr: str) -> None:
        # last_pick is charged HERE — to the address actually served —
        # not in order(): affinity reordering can choose a different head
        # than order() computed, and crediting the unserved sibling would
        # invert the least-recently-picked tie-break.
        with self._lock:
            st = self._state(addr)
            st.outstanding += 1
            self._seq += 1
            st.last_pick = self._seq
            # Published INSIDE the lock: concurrent acquires on one addr
            # would otherwise commit their gauge writes out of order and
            # park a stale value (the Registry lock is a plain leaf lock
            # — no ordering hazard nesting it here).
            REGISTRY.set_gauge(obs_names.ROUTER_BACKEND_OUTSTANDING,
                               float(st.outstanding), backend=addr)

    def release(self, addr: str) -> None:
        with self._lock:
            st = self._state(addr)
            st.outstanding = max(0, st.outstanding - 1)
            REGISTRY.set_gauge(obs_names.ROUTER_BACKEND_OUTSTANDING,
                               float(st.outstanding), backend=addr)

    def ok(self, addr: str) -> None:
        with self._lock:
            st = self._state(addr)
            st.fails = 0
            st.down_until = 0.0

    def fail(self, addr: str) -> None:
        with self._lock:
            st = self._state(addr)
            st.fails += 1
            backoff = min(self.EVICT_BASE_S * (2 ** (st.fails - 1)),
                          self.EVICT_MAX_S)
            st.down_until = time.monotonic() + backoff
        # Outside the lock: an evicted (dead / preempted) backend must
        # lose its prefix-affinity front-of-LRU spot immediately.
        if self._on_unavailable is not None:
            self._on_unavailable(addr)

    def set_draining(self, addr: str, draining: bool) -> None:
        """Mark an address as draining (SIGTERM rollout): it stops being a
        candidate while siblings live but is NOT evicted — its in-flight
        streams finish, and probes clear the flag if the pod un-drains
        (or the address never returns and ordinary eviction takes over)."""
        with self._lock:
            self._state(addr).draining = draining
            REGISTRY.set_gauge(obs_names.ROUTER_BACKEND_DRAINING,
                               1.0 if draining else 0.0, backend=addr)
        if draining and self._on_unavailable is not None:
            self._on_unavailable(addr)

    def is_draining(self, addr: str) -> bool:
        with self._lock:
            return self._state(addr).draining

    def draining(self) -> List[str]:
        with self._lock:
            return [a for a, st in self._st.items() if st.draining]

    def evicted(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [a for a, st in self._st.items() if st.down_until > now]

    def outstanding(self, addr: str) -> int:
        with self._lock:
            return self._state(addr).outstanding

    def is_down(self, addr: str) -> bool:
        with self._lock:
            return self._state(addr).down_until > time.monotonic()

    def probe(self, timeout: float = 1.0) -> List[str]:
        """Health-check every evicted backend (re-admit responders) and
        every draining backend (clear the flag if it un-drained; a drained
        process that already exited fails its next dispatch and moves to
        ordinary eviction). Returns the re-admitted addresses."""
        readmitted = []
        for addr in self.evicted():
            try:
                resp, _, _ = request_once(addr, {"op": "health"},
                                          timeout=timeout)
            except (OSError, ConnectionError, json.JSONDecodeError):
                continue
            if resp and resp.get("ok"):
                self.ok(addr)
                self.set_draining(addr, bool(resp.get("draining")))
                readmitted.append(addr)
        for addr in self.draining():
            try:
                resp, _, _ = request_once(addr, {"op": "health"},
                                          timeout=timeout)
            except (OSError, ConnectionError, json.JSONDecodeError):
                continue
            if resp and resp.get("ok") and not resp.get("draining"):
                self.set_draining(addr, False)
        return readmitted

    def retain(self, live) -> None:
        """Drop state for addresses no longer in the registry (pod churn
        mints a new address per replacement — without pruning, a long-lived
        router's state and health payload grow monotonically). In-flight
        entries are kept until their requests drain."""
        with self._lock:
            for a in [a for a in self._st
                      if a not in live and self._st[a].outstanding == 0]:
                del self._st[a]
            keep = set(self._st) | set(live)
        # Series staleness: an evicted address must leave the exposition
        # too, or a long-lived router on a churning fleet renders every
        # dead pod's series forever — the pool gauges AND the backend-
        # labeled rbg_slo_* verdicts the router's judgment minted. Swept
        # against the registry's ACTUAL label values (not a drop list):
        # a judgment that lands after its request's release — and so
        # re-mints series for an address already pruned from _st — is
        # caught by the next sweep instead of leaking permanently.
        for name in _BACKEND_SERIES:
            for a in REGISTRY.label_values(name, "backend") - keep:
                REGISTRY.remove_series(name, backend=a)

    def snapshot(self) -> Dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            return {a: {"outstanding": st.outstanding, "fails": st.fails,
                        "down_for_s": round(max(0.0, st.down_until - now), 3),
                        "draining": st.draining}
                    for a, st in self._st.items()}


class PrefixAffinity:
    """Cache-aware routing memory (a property of the deployed
    sglang-router): requests sharing a prompt prefix go to the backend
    whose radix / prefix cache already holds it. Approximation: an LRU map from
    hash(first AFFINITY_PREFIX tokens) → the backend that last served
    that prefix. The *balance guard* lives in the caller — affinity only
    wins while the remembered backend isn't meaningfully busier than the
    least-loaded one, so a hot prefix cannot melt a single replica."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._m: "OrderedDict[int, str]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def key(prompt) -> Optional[int]:
        if not prompt:
            return None
        return hash(tuple(prompt[:AFFINITY_PREFIX]))

    def get(self, key: Optional[int]) -> Optional[str]:
        if key is None:
            return None
        with self._lock:
            addr = self._m.get(key)
            if addr is not None:
                self._m.move_to_end(key)
            return addr

    def put(self, key: Optional[int], addr: str) -> None:
        if key is None:
            return
        with self._lock:
            self._m[key] = addr
            self._m.move_to_end(key)
            if len(self._m) > self.cap:
                self._m.popitem(last=False)

    def drop_backend(self, addr: str) -> int:
        """Demote every prefix remembered for ``addr`` — the drain /
        disruption staleness fix: a draining or preempted backend used to
        stay front-of-LRU until eviction aged it out, steering prefix
        traffic at a pod that refuses (or dropped) it."""
        with self._lock:
            dead = [k for k, a in self._m.items() if a == addr]
            for k in dead:
                del self._m[k]
            return len(dead)


class RouterState:
    def __init__(self, registry: Registry, group: Optional[str],
                 static_backends: Optional[dict] = None,
                 token: Optional[str] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 slo_targets: Optional[SLOTargets] = None,
                 directory=None, kv_stream: bool = True,
                 router_id: Optional[str] = None, tier=None):
        from rbg_tpu_torch.kvtransfer.transport import LinkStats

        self.registry = registry
        self.group = group
        # Router-tier membership (engine/routertier.py): this router's
        # stable identity on the hash ring plus the peer event feed it
        # publishes health/draining/link-rate/ingress transitions to.
        # None = standalone single-router deployment, nothing changes.
        self.router_id = router_id or "router-0"
        self.tier = tier
        # Drain protocol, router edition: a draining router finishes
        # in-flight streams (tracked below) while refusing NEW requests
        # with a structured CODE_DRAINING frame — tier peers take its
        # hash ranges the moment the drain transition hits the feed.
        self.draining = False
        self._active_requests = 0
        self._drain_lock = threading.Lock()
        if tier is not None:
            tier.register(self.router_id, state=self)
        self.static = static_backends or {}
        # Drain/eviction notifications demote prefix affinity immediately
        # (the staleness fix) — wired before any traffic.
        self.pool = BackendPool(on_unavailable=self._backend_unavailable)
        # Cluster prefix directory (kvtransfer.directory): lets prefix
        # affinity route to ANY replica holding the prefix, not just the
        # last-serving one. Optional — lookups degrade to the local LRU.
        self.directory = directory
        # Chunked prefill→decode KV streaming (push_to): on by default;
        # backends that don't support it reply with a bundle and nothing
        # changes.
        self.kv_stream = kv_stream
        # Measured prefill→decode link rates (merged from prefill replies'
        # observed push rates) feeding transfer-cost-aware decode choice.
        self.linkstats = LinkStats("router")
        # Observed KV bytes per prompt token (EWMA) — the pre-prefill
        # estimate the stream-mode decode choice scores with.
        self._kv_bpt: Optional[float] = None
        # Router-level SLO judgment (obs/slo.py): TTFT/TPOT measured from
        # the INGRESS arrival stamp — a retried or failed-over request is
        # charged its full wait — aggregated per role and per backend
        # into the health snapshot.
        self.slo = SLOTracker(slo_targets or SLOTargets(),
                              component="router")
        # Shared data-plane bearer token: when set, clients
        # must present it and the router forwards it on every backend leg
        # (one trust domain edge-to-engine; health stays open for probes).
        self.token = token if token is not None \
            else (os.environ.get("RBG_DATA_TOKEN") or None)
        self.affinity = PrefixAffinity()
        self.retry_budget = retry_budget or RetryBudget()
        # Topology candidacy: roles withdrawn from NEW-traffic routing by
        # the adaptive agg↔disagg controller (in-flight work on their
        # backends finishes untouched; set membership is GIL-atomic).
        self._inactive_roles: set = set()
        # Hot-prefix replication cadence (single counter; GIL-atomic
        # increments — an off-by-one under a race only shifts WHICH
        # lookup replicates, never whether replication happens) plus a
        # bounded per-prefix attempt ledger (akey -> off-holder routes)
        # so a fleet that never registers the second copy stops paying
        # the deliberate-miss tax after REPLICATE_MAX_PER_PREFIX tries.
        self._replicate_seq = 0
        self._replicated: "OrderedDict[int, int]" = OrderedDict()
        self.metrics = {"requests": 0, "pd_requests": 0, "errors": 0,
                        "retries": 0, "failovers": 0, "affinity_hits": 0,
                        "kv_bytes_routed": 0,
                        # KV transfer plane (kvtransfer): streamed PD
                        # requests, bundle fallbacks after a stream
                        # failure, cluster prefix-directory hits, and
                        # affinity entries demoted on drain/eviction.
                        "kv_stream_routed": 0, "kv_stream_fallbacks": 0,
                        "directory_hits": 0, "affinity_demotions": 0,
                        "dir_replications": 0,
                        # Overload / lifecycle robustness counters.
                        "sheds_routed_around": 0, "sheds_returned": 0,
                        "draining_routed_around": 0,
                        "deadline_refusals": 0,
                        "retry_budget_exhausted": 0}

    def _backend_unavailable(self, addr: str) -> None:
        dropped = self.affinity.drop_backend(addr)
        if dropped:
            self.metrics["affinity_demotions"] += dropped
        self._tier_publish("health", {"backend": addr, "available": False})

    # -- router tier seam (engine/routertier.py) --

    def _tier_publish(self, kind: str, payload: dict) -> None:
        if self.tier is None:
            return
        try:
            self.tier.publish(self.router_id, kind, payload)
        except Exception:
            pass

    def note_ingress(self, kind: str, n: float) -> None:
        """One ingress token observation (prefill prompt tokens at
        dispatch / decode tokens at delivery) — counted in THIS process's
        registry AND in the tier aggregate, because the topology ratio
        must see the whole tier's mix, not one router's shard of it."""
        if n <= 0:
            return
        REGISTRY.inc(obs_names.ROUTER_INGRESS_TOKENS_TOTAL, float(n),
                     kind=kind)
        if self.tier is not None:
            try:
                self.tier.note_ingress(self.router_id, kind, float(n))
            except Exception:
                pass

    def publish_ingress(self) -> None:
        """Publish this process's CUMULATIVE ingress token counters on
        the tier feed (the wire-form twin of ``note_ingress`` for members
        whose tier object is remote). Cumulative on purpose: the tier
        folds watermark deltas, and a restart that zeroes these counters
        reads as a counter restart (full-value fold), never a negative
        delta — the counter-restart convention, load-bearing for the ratio."""
        totals = {k: REGISTRY.counter(obs_names.ROUTER_INGRESS_TOKENS_TOTAL,
                                      kind=k)
                  for k in ("prefill", "decode")}
        self._tier_publish("ingress", {"totals": totals})

    def on_peer_event(self, ev: dict) -> None:
        """Receive one router-to-router feed event: peers' backend
        health/draining transitions and measured link rates fold into
        THIS router's pool and link view, so N routers converge on one
        picture of the fleet instead of each rediscovering it."""
        kind, payload = ev.get("kind"), ev.get("payload") or {}
        addr = payload.get("backend")
        if kind == "link_rates":
            self.merge_link_rates(payload.get("rates"), _from_peer=True)
        elif kind == "draining" and addr:
            self.pool.set_draining(addr, bool(payload.get("draining")))
        elif kind == "health" and addr:
            if payload.get("available"):
                self.pool.ok(addr)
            else:
                self.pool.fail(addr)

    # -- drain protocol (SIGTERM → finish in-flight, refuse new) --

    def enter_request(self) -> bool:
        """Admission gate for one request: False when draining (caller
        replies with the structured CODE_DRAINING frame)."""
        with self._drain_lock:
            if self.draining:
                return False
            self._active_requests += 1
            return True

    def exit_request(self) -> None:
        with self._drain_lock:
            if self._active_requests > 0:
                self._active_requests -= 1

    def begin_drain(self, wait_s: float = 30.0) -> bool:
        """Flip to draining, announce it on the tier feed (peers take
        this router's hash ranges), then wait for in-flight streams to
        finish. Returns True when the router drained clean inside
        ``wait_s``."""
        with self._drain_lock:
            self.draining = True
        if self.tier is not None:
            try:
                self.tier.set_draining(self.router_id, True)
            except Exception:
                pass
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._drain_lock:
                if self._active_requests == 0:
                    return True
            time.sleep(0.02)
        with self._drain_lock:
            return self._active_requests == 0

    def charge_retry(self) -> bool:
        """Take one retry token; on exhaustion count it and refuse."""
        if self.retry_budget.take():
            return True
        self.metrics["retry_budget_exhausted"] += 1
        return False

    def note_shed(self, addr: str, frame: dict,
                  best: Optional[dict]) -> dict:
        """Record a structured route-around shed (overloaded / draining)
        from a HEALTHY backend — the one shed policy both the blocking and
        streaming paths apply: no eviction, draining marks the pool, and
        the frame with the smallest retry_after_s becomes the reply should
        every candidate shed."""
        self.pool.ok(addr)
        if frame.get("code") == CODE_DRAINING:
            self.pool.set_draining(addr, True)
            self.metrics["draining_routed_around"] += 1
            # Tier peers learn the drain NOW instead of each waiting to
            # be shed by the same backend themselves.
            self._tier_publish("draining", {"backend": addr,
                                            "draining": True})
        else:
            self.metrics["sheds_routed_around"] += 1
        if best is None or (frame.get("retry_after_s") or 1e9) < \
                (best.get("retry_after_s") or 1e9):
            return frame
        return best

    def authorized(self, obj: dict) -> bool:
        if not self.token:
            return True
        from rbg_tpu_torch.engine.protocol import token_ok
        return token_ok(obj.get("token"), self.token)

    def set_role_candidacy(self, role: str, active: bool) -> None:
        """Topology cutover seam: an inactive role's backends take no NEW
        requests, while streams they already hold run to completion."""
        if active:
            self._inactive_roles.discard(role)
        else:
            self._inactive_roles.add(role)

    def role_active(self, role: str) -> bool:
        return role not in self._inactive_roles

    def candidates(self, role: str, cost=None) -> List[str]:
        if role in self._inactive_roles:
            return []
        backends = self.static.get(role) or self.registry.backends(role, self.group)
        live = {a for addrs in self.static.values() for a in addrs}
        live.update(e["addr"] for e in self.registry.entries().values()
                    if "addr" in e)
        self.pool.retain(live)
        return self.pool.order(list(backends), cost=cost)

    # -- transfer-cost-aware decode selection (NetKV) --

    def kv_cost_fn(self, kv_bytes: int):
        """``addr -> outstanding-equivalents`` for moving ``kv_bytes`` to
        that backend, from MEASURED link rates (None when there is
        nothing to weigh)."""
        if not kv_bytes:
            return None

        def cost(addr: str) -> float:
            rate = self.linkstats.rate(addr) or DEFAULT_KV_LINK_RATE
            return (kv_bytes / rate) * KV_COST_WEIGHT
        return cost

    def est_kv_bytes(self, prompt_tokens: int) -> int:
        """Pre-prefill KV size estimate from observed bytes/token."""
        if self._kv_bpt is None:
            return 0
        return int(self._kv_bpt * prompt_tokens)

    def note_kv_observed(self, prompt_tokens: int, kv_bytes: int) -> None:
        if not prompt_tokens or not kv_bytes:
            return
        bpt = kv_bytes / prompt_tokens
        self._kv_bpt = bpt if self._kv_bpt is None \
            else 0.7 * self._kv_bpt + 0.3 * bpt

    def merge_link_rates(self, rates: Optional[dict],
                         _from_peer: bool = False) -> None:
        """Fold prefill-reported push rates (prefill→decode, observed on
        real transfers) into this router's link view. Locally-observed
        rates (not peer echoes) are re-published on the tier feed so
        every router's NetKV decode choice prices the same links."""
        if not rates:
            return
        for addr, rate in rates.items():
            try:
                self.linkstats.observe(addr, int(float(rate)), 1.0)
            except (TypeError, ValueError):
                continue
        if not _from_peer:
            self._tier_publish("link_rates", {"rates": dict(rates)})

    def pd_mode(self) -> bool:
        return bool(
            self.role_active("prefill") and self.role_active("decode")
            and (self.static.get("prefill") or self.registry.backends("prefill", self.group))
            and (self.static.get("decode") or self.registry.backends("decode", self.group))
        )

    def worker_role(self) -> str:
        """The unified-engine role (embed / non-PD generate)."""
        for role in ("worker", "server"):
            if self.role_active(role) and (
                    self.static.get(role)
                    or self.registry.backends(role, self.group)):
                return role
        roles = {e.get("role") for e in self.registry.entries().values()}
        roles |= set(self.static)
        roles.discard("router")
        roles.discard(None)
        for r in sorted(roles):
            if self.role_active(r) and (
                    self.static.get(r)
                    or self.registry.backends(r, self.group)):
                return r
        raise RuntimeError("no backends available")

    def _affinity_viable(self, addr: Optional[str],
                         cands: List[str]) -> bool:
        """A cache-affinity candidate wins only while it is a live,
        non-draining candidate that is not meaningfully busier than the
        least-loaded choice — a hot prefix cannot melt one replica, and a
        draining/preempted backend is never fronted."""
        return bool(addr and addr in cands and addr != cands[0]
                    and not self.pool.is_down(addr)
                    and not self.pool.is_draining(addr)
                    and self.pool.outstanding(addr)
                    <= self.pool.outstanding(cands[0]) + AFFINITY_SLACK)

    def _prefix_cost_fn(self, prompt, matched_tokens: int,
                        detail: List[dict], akey=None):
        """``addr -> outstanding-equivalents`` of serving this prompt's
        prefill there, from the cluster directory's tier-tagged holder
        detail: a device-tier holder's hit is ~free (only the unmatched
        tail costs), a host-tier holder adds the promote fetch (estimated
        bytes over its measured link rate — the KV-move currency),
        and a non-holder pays the full prefill. Hot single-holder
        prefixes are deliberately scored as misses every
        ``REPLICATE_EVERY``-th lookup, so the least-loaded non-holder
        computes AND registers the prefix — a second replica appears
        without any explicit copy protocol. Returns ``(cost_fn,
        replicate_tick, holder_addrs)`` — the caller counts a
        replication only when the tick actually routed off-holder."""
        entries = {e["backend"]: e for e in detail if e.get("backend")}
        replicate = False
        if len(entries) == 1 and any(
                e.get("hotness", 0) >= REPLICATE_HOTNESS
                for e in entries.values()):
            if (akey is None or self._replicated.get(akey, 0)
                    < REPLICATE_MAX_PER_PREFIX):
                self._replicate_seq += 1
                replicate = self._replicate_seq % REPLICATE_EVERY == 0
        elif akey is not None and len(entries) > 1:
            # A second holder appeared: replication CONVERGED for this
            # prefix — forget the attempt count so a later holder loss
            # can re-replicate.
            self._replicated.pop(akey, None)
        hit_fraction = min(1.0, matched_tokens / max(1, len(prompt)))

        def cost(addr: str) -> float:
            e = entries.get(addr)
            if replicate:
                # Replication tick: the holder scores as a miss and the
                # non-holders as hits, so the least-loaded NON-holder
                # wins (unless it is much busier), computes the prefix,
                # and registers the second copy.
                return PREFIX_MISS_WEIGHT if e is not None else 0.0
            if e is None:
                return PREFIX_MISS_WEIGHT
            c = PREFIX_MISS_WEIGHT * (1.0 - hit_fraction)
            if e.get("tier") == "host":
                bytes_ = self.est_kv_bytes(matched_tokens)
                rate = self.linkstats.rate(addr) or DEFAULT_KV_LINK_RATE
                c += (bytes_ / rate) * KV_COST_WEIGHT
            return c
        return cost, replicate, frozenset(entries)

    # hot_path
    def candidates_for(self, role: str, prompt) -> List[str]:
        """Candidates ordered CACHE-AWARE. The local last-serving LRU
        stays the FAST PATH: a viable affinity hit answers with zero I/O
        — against a wire directory (``DirectoryClient``) the scored path
        costs a blocking RPC per request, which must only be paid when
        the LRU has nothing (the pre-hierarchy contract). On an LRU
        miss, the cluster directory scores every candidate prefix-hit
        depth × tier-fetch cost AGAINST its queue depth
        (``_prefix_cost_fn`` — the balance guard is the scoring itself:
        a deep hit on a swamped replica loses to a shallow miss on an
        idle one). Without a directory the LRU is all there is, under
        the legacy AFFINITY_SLACK balance guard."""
        cands = self.candidates(role)
        akey = PrefixAffinity.key(prompt)
        if akey is None or len(cands) < 2:
            return cands
        addr = self.affinity.get(akey)
        if self._affinity_viable(addr, cands):
            self.metrics["affinity_hits"] += 1
            return [addr] + [a for a in cands if a != addr]
        if addr == cands[0] and addr is not None:
            self.metrics["affinity_hits"] += 1
            return cands
        if self.directory is not None and prompt:
            try:
                matched, detail = self.directory.lookup_detail(list(prompt))
            except (OSError, RuntimeError, ValueError):
                matched, detail = 0, []
            if matched and detail:
                cost, replicate, holders = self._prefix_cost_fn(
                    prompt, matched, detail, akey=akey)
                # Reorder the list already built above — rebuilding via
                # candidates() would repeat the registry read + pool
                # retain on a hot path that just paid a directory RPC.
                scored = self.pool.order(list(cands), cost=cost)
                if scored and scored[0] in holders:
                    self.metrics["directory_hits"] += 1
                elif scored and replicate:
                    # Counted only when the inverted scoring ACTUALLY
                    # routed off-holder (a single-backend role, or a
                    # much-less-loaded holder, replicates nothing) —
                    # and the per-prefix ledger bounds the attempts.
                    self.metrics["dir_replications"] += 1
                    REGISTRY.inc(obs_names.KVT_DIR_REPLICATIONS_TOTAL)
                    self._replicated[akey] = \
                        self._replicated.get(akey, 0) + 1
                    self._replicated.move_to_end(akey)
                    while len(self._replicated) > 1024:
                        self._replicated.popitem(last=False)
                if scored:
                    return scored
        return cands

    def call(self, role: str, obj: dict, k_bytes=None, v_bytes=None,
             timeout: float = LEG_TIMEOUT_S, prompt=None,
             deadline: Optional[float] = None,
             pinned: Optional[str] = None,
             kv_bytes: int = 0) -> Tuple[str, dict, bytes, bytes]:
        """One blocking request with failover across the role's backends.
        Transport failures (connect refused, peer closed) evict + retry on
        a sibling; application errors pass through untouched. ``prompt``
        (when given) engages cache-affinity candidate ordering.

        ``deadline`` (absolute monotonic) is the REQUEST's end-to-end
        budget: every attempt — first dispatch or failover — derives its
        transport timeout from what remains instead of the fixed leg cap,
        the remaining budget is forwarded to the backend as ``timeout_s``
        (so ITS queue/abort enforcement composes), and a spent budget
        refuses the dispatch outright (``_Rejected`` with
        deadline_exceeded) — never a doomed retry.

        Structured sheds (code overloaded/draining) are NOT backend
        failures: the backend is healthy and answered. The router tries a
        sibling (retry-budget permitting) and, when every candidate shed,
        raises ``_Rejected`` carrying the frame with the smallest
        retry_after_s — the edge maps it to 429/503 + Retry-After.

        ``pinned`` restricts the leg to ONE address (a decode_stream leg —
        the KV lives only there; failover is the caller's re-route).
        ``kv_bytes`` engages transfer-cost-aware candidate ordering: the
        estimated move time over each backend's MEASURED link rate is
        weighed against its queue depth."""
        if pinned is not None:
            cands = [pinned]
        elif kv_bytes:
            cands = self.candidates(role, cost=self.kv_cost_fn(kv_bytes))
        else:
            cands = self.candidates_for(role, prompt)
        if not cands:
            raise RuntimeError(f"no {role} backends available")
        akey = PrefixAffinity.key(prompt)
        rspan = trace.current()     # ambient request span (NULL when off)
        last: Optional[Exception] = None
        shed: Optional[dict] = None
        for i, addr in enumerate(cands[:MAX_ATTEMPTS]):
            aspan = rspan.child(obs_names.SPAN_ROUTER_ATTEMPT,
                                backend=addr, attempt=i, role=role)
            if aspan and k_bytes is not None:
                aspan.attrs["kv_bytes"] = len(k_bytes) + len(v_bytes or b"")
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.metrics["deadline_refusals"] += 1
                    aspan.end(outcome="deadline")
                    raise _Rejected(_deadline_frame(
                        f"deadline spent before dispatch to {role} "
                        f"(attempt {i + 1})"))
                timeout = min(LEG_TIMEOUT_S, remaining)
                obj = dict(obj)
                obj["timeout_s"] = round(remaining, 3)
            if aspan:
                # Per-attempt child context: the backend's engine.op span
                # parents under THIS attempt, so sibling retries stay
                # distinguishable in the waterfall.
                obj = dict(obj)
                obj["trace"] = aspan.wire()
            if i:
                if not self.charge_retry():
                    aspan.end(outcome="retry_budget_exhausted")
                    break
                self.metrics["retries"] += 1
            self.pool.acquire(addr)
            t_dispatch = time.monotonic()
            try:
                resp, rk, rv = request_once(addr, obj, k_bytes, v_bytes,
                                            timeout=timeout)
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                self.pool.fail(addr)
                aspan.end(outcome="transport_error")
                last = e
                continue
            finally:
                self.pool.release(addr)
            if resp is None:
                self.pool.fail(addr)
                aspan.end(outcome="transport_error")
                last = RuntimeError(f"{addr} closed connection")
                continue
            code = resp.get("code")
            if code == CODE_DEADLINE:
                # The backend spent the client's budget (queue drop or
                # mid-run abort): structured passthrough — a sibling retry
                # would dispatch work that is already out of time.
                self.pool.ok(addr)
                aspan.end(outcome="deadline")
                raise _Rejected(resp)
            if code in RETRYABLE_REJECT_CODES:
                shed = self.note_shed(addr, resp, shed)
                aspan.end(outcome=code)
                continue
            self.pool.ok(addr)
            self.affinity.put(akey, addr)
            if i:
                self.metrics["failovers"] += 1
            aspan.end(outcome="ok")
            # Private timing stamp: when the SUCCESSFUL attempt was
            # dispatched (monotonic). Callers pop it to anchor TTFT at
            # ingress arrival — a backend-reported ttft_s alone restarts
            # the clock on every failover attempt and under-reports.
            if isinstance(resp, dict):
                resp["_router_t_dispatch"] = t_dispatch
            return addr, resp, rk, rv
        if shed is not None:
            self.metrics["sheds_returned"] += 1
            raise _Rejected(shed)
        raise RuntimeError(
            f"all {role} backends failed (tried {min(len(cands), MAX_ATTEMPTS)}): {last}")


class _ClientGone(Exception):
    """The CLIENT socket failed mid-relay. Deliberately NOT an OSError
    subclass: the failover loop catches transport errors and charges them
    to the backend — a vanished client must neither evict a healthy
    backend nor trigger a pointless replay on a sibling."""


class Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            self._serve_connection()
        except _ClientGone:
            # Routine client disconnect — not a router error, no traceback.
            return

    def _serve_connection(self):
        state: RouterState = self.server.state
        while True:
            try:
                obj, _, _ = recv_msg(self.request)
            except (ConnectionError, json.JSONDecodeError):
                return
            if obj is None:
                return
            op = obj.get("op")
            if op == "health":
                # Liveness itself stays unauthenticated, but on a
                # token-gated router the metrics and the backend pool
                # snapshot (internal topology addresses) are only for
                # authenticated peers — health must not map the very
                # fleet the token protects.
                resp = {"ok": True, "pd": state.pd_mode(),
                        "draining": state.draining,
                        "router_id": state.router_id}
                if state.authorized(obj):
                    # Candidacy is fleet topology — authenticated peers
                    # only, like the backend snapshot below.
                    if state._inactive_roles:
                        resp["inactive_roles"] = sorted(
                            state._inactive_roles)
                    resp["metrics"] = state.metrics
                    resp["backends"] = state.pool.snapshot()
                    resp["draining_backends"] = state.pool.draining()
                    resp["retry_budget"] = state.retry_budget.snapshot()
                    # KV transfer plane posture: streaming mode, measured
                    # per-backend link rates, observed KV bytes/token.
                    resp["kv"] = {
                        "stream": state.kv_stream,
                        "directory": state.directory is not None,
                        "link_rates": {
                            a: round(r, 1) for a, r in
                            state.linkstats.snapshot().items()},
                        "kv_bytes_per_token": (
                            round(state._kv_bpt, 1)
                            if state._kv_bpt is not None else None),
                    }
                    # Measured SLO attainment from THIS router's vantage
                    # (ingress-anchored TTFT): per role and per backend,
                    # 60 s window — the agg↔disagg switcher's decision
                    # input.
                    resp["slo"] = {
                        "targets": state.slo.targets.as_dict(),
                        "judged_total": state.slo.judged_total(),
                        "per_role": state.slo.attainment(
                            60.0, group_by=("role",)),
                        "per_backend": state.slo.attainment(
                            60.0, group_by=("backend",)),
                    }
                self._send_client(resp)
                continue
            if op in ("embed", "generate") and not state.authorized(obj):
                self._send_client({"error": "unauthorized", "done": True})
                continue
            try:
                deadline = self._stamp_deadline(obj)
            except (TypeError, ValueError) as e:
                self._send_client({"error": f"bad timeout_s: {e}",
                                   "done": True})
                continue
            if not state.enter_request():
                # SIGTERM drain: in-flight streams run to completion
                # (they passed this gate already); NEW work gets the
                # structured draining frame — the same shed contract the
                # backends use, so clients/peers route around.
                self._send_client({"error": "router draining",
                                   "code": CODE_DRAINING,
                                   "retry_after_s": 1.0, "done": True})
                continue
            try:
                self._dispatch_op(state, op, obj, deadline)
            finally:
                state.exit_request()

    def _dispatch_op(self, state: "RouterState", op: str, obj: dict,
                     deadline: float) -> None:
        # Ingress arrival stamp (the deadline's sibling): TTFT is
        # measured from HERE — spanning queueing, the prefill leg, and
        # every failover attempt — never restarted per attempt.
        t_arrival = time.monotonic()
        # The router continues the edge's trace context — or IS the
        # ingress (head sampling) when clients hit it directly. The
        # incoming context is consumed here; every downstream leg gets
        # a fresh per-attempt child context instead.
        rspan = trace.from_wire(obj.pop("trace", None),
                                obs_names.SPAN_ROUTER_REQUEST, op=op)
        if op == "embed":
            state.metrics["requests"] += 1
            try:
                with trace.use_span(rspan):
                    _, resp, _, _ = state.call(state.worker_role(), obj,
                                               deadline=deadline)
            except _Rejected as e:
                resp = e.frame
            except Exception as e:
                state.metrics["errors"] += 1
                resp = {"error": f"embed: {e}"}
            resp.pop("_router_t_dispatch", None)
            rspan.end(outcome=resp.get("code") or
                      ("error" if "error" in resp else "ok"))
            self._send_client(resp)
            return
        if op != "generate":
            rspan.end(outcome="unsupported_op")
            self._send_client({"error": f"router: unsupported op {op!r}"})
            return
        try:
            with trace.use_span(rspan):
                if obj.get("stream"):
                    self._generate_stream(state, obj, deadline,
                                          t_arrival)
                else:
                    resp = self._generate(state, obj, deadline,
                                          t_arrival)
                    self._send_client(resp)
        except _ClientGone:
            rspan.end(outcome="client_gone")
            raise
        except _Rejected as e:
            # Structured shed/deadline: NOT a router error — the
            # contract under overload is exactly this reply.
            rspan.end(outcome=e.frame.get("code") or "rejected")
            self._send_client({**e.frame, "done": True})
        except Exception as e:
            state.metrics["errors"] += 1
            rspan.end(outcome="error")
            self._send_client({"error": str(e), "done": True})
        else:
            rspan.end(outcome="ok")

    @staticmethod
    def _stamp_deadline(obj: dict) -> float:
        """Absolute monotonic deadline for this request: the client's
        ``timeout_s`` budget (or the router default), stamped ONCE at
        ingress — every hop, failover attempt, and backend admission below
        derives its remaining budget from this single number."""
        t = obj.get("timeout_s")
        t = DEFAULT_TIMEOUT_S if t is None else float(t)
        if t <= 0:
            raise ValueError(f"timeout_s must be > 0, got {t}")
        return time.monotonic() + t

    @staticmethod
    def _pin_seed(obj: dict) -> dict:
        """Sampled requests without a client seed get a router-assigned one
        BEFORE any backend sees the request, so a failover re-run produces
        the identical stream (position-keyed PRNG: tokens are f(seed,
        position), independent of which replica computes them)."""
        if float(obj.get("temperature", 0.0) or 0.0) > 0.0 \
                and obj.get("seed") is None:
            obj = dict(obj)
            obj["seed"] = random.getrandbits(31)
        return obj

    _FWD_DECODE_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p",
                        "min_p", "repetition_penalty", "presence_penalty",
                        "frequency_penalty", "seed", "logprobs", "json_mode",
                        "regex", "json_schema", "lora", "stop_token",
                        "stream", "token")

    def _route(self, state: RouterState, obj: dict, deadline: float,
               force_bundle: bool = False):
        """Resolve the final leg shared by blocking and streaming paths.
        PD mode runs the (always blocking, failover-wrapped) prefill hop
        here; returns (role, (header, k_bytes, v_bytes), affinity_prompt,
        t_first, pinned) for the leg the caller owns — the caller can
        re-send that payload to any sibling of ``role`` (decode failover;
        ``pinned`` non-None means the payload only works on THAT address
        — a pushed KV stream — and failover is a bundle re-route), the
        affinity prompt (None on cache-less legs) steers cache-aware
        ordering, and ``t_first`` (PD only, else None) is the monotonic
        instant the prefill hop returned: the FIRST TOKEN exists from
        then on, so PD TTFT ends here, not when decode completes.

        KVCache-centric path (default): the decode replica is chosen
        FIRST — transfer-cost-aware: queue depth + estimated KV bytes
        over its measured link rate — and the prefill request carries
        ``push_to``, so KV chunks stream prefill→decode as they compute.
        A prefill that can't push (older build, no transport, early
        connect failure) replies with the bundle and nothing changes."""
        if not force_bundle:    # a fallback re-route is the SAME request
            state.metrics["requests"] += 1
        obj = self._pin_seed(obj)
        if state.pd_mode():
            if not force_bundle:
                state.metrics["pd_requests"] += 1
            # Forward sampling fields: the FIRST token is sampled by the
            # prefill engine — without them it would always be greedy,
            # diverging from unified mode for the identical request.
            pf_req = {"op": "prefill", "prompt": obj["prompt"]}
            for key in ("temperature", "top_k", "top_p", "min_p",
                        "repetition_penalty", "presence_penalty",
                        "frequency_penalty", "seed", "json_mode", "regex",
                        "json_schema", "lora", "stop_token", "token"):
                if key in obj:
                    pf_req[key] = obj[key]
            decode_addr = None
            if state.kv_stream and not force_bundle:
                est = state.est_kv_bytes(len(obj.get("prompt") or ()))
                dcands = state.candidates("decode",
                                          cost=state.kv_cost_fn(est))
                if dcands and not state.pool.is_down(dcands[0]):
                    decode_addr = dcands[0]
                    pf_req["push_to"] = decode_addr
                    pf_req["stream_id"] = f"rtr-{random.getrandbits(48):x}"
            # Cache affinity on the prefill leg: the replica that served
            # this prefix before has it in its radix cache / pool hot set.
            # The prefill leg spends from the SAME deadline the decode leg
            # inherits — a slow prefill shrinks the decode budget.
            _, hdr, kb, vb = state.call("prefill", pf_req,
                                        prompt=obj.get("prompt"),
                                        deadline=deadline)
            hdr.pop("_router_t_dispatch", None)
            t_first = time.monotonic()
            if "error" in hdr:
                raise RuntimeError(f"prefill failed: {hdr}")
            if hdr.get("pushed"):
                # KV already streamed (or streaming) prefill→decode; the
                # router never touched the payload bytes.
                state.metrics["kv_stream_routed"] += 1
                state.note_kv_observed(len(obj.get("prompt") or ()),
                                       int(hdr.get("kv_bytes") or 0))
                state.merge_link_rates(hdr.get("link_rates"))
                fwd = {"op": "decode_stream",
                       "stream_id": hdr["stream_id"]}
                for key in self._FWD_DECODE_KEYS:
                    if key in obj:
                        fwd[key] = obj[key]
                return "decode", (fwd, None, None), None, t_first, \
                    decode_addr
            if hdr.get("pushed") is False:
                # Push failed before the reply (decode peer unreachable):
                # the prefill ran but holds no bundle — re-run it in
                # bundle mode (its radix/pool hot set makes the re-prefill
                # cheap) instead of failing the request.
                state.metrics["kv_stream_fallbacks"] += 1
                pf_req.pop("push_to", None)
                pf_req.pop("stream_id", None)
                _, hdr, kb, vb = state.call("prefill", pf_req,
                                            prompt=obj.get("prompt"),
                                            deadline=deadline)
                hdr.pop("_router_t_dispatch", None)
                t_first = time.monotonic()
                if "error" in hdr:
                    raise RuntimeError(f"prefill failed: {hdr}")
            state.metrics["kv_bytes_routed"] += len(kb or b"") + len(vb or b"")
            state.note_kv_observed(len(obj.get("prompt") or ()),
                                   len(kb or b"") + len(vb or b""))
            fwd = dict(hdr)
            fwd["op"] = "decode_bundle"
            for key in self._FWD_DECODE_KEYS:
                if key in obj:
                    fwd[key] = obj[key]
            # Decode replicas hold no prefix cache — no affinity prompt.
            return "decode", (fwd, kb, vb), None, t_first, None
        return (state.worker_role(), (obj, None, None), obj.get("prompt"),
                None, None)

    def _generate(self, state: RouterState, obj: dict, deadline: float,
                  t_arrival: float) -> dict:
        """Blocking generate. TTFT is anchored at the INGRESS arrival
        stamp: PD requests end it when the prefill hop returns (the first
        token exists then — decode time is NOT first-token time), unified
        requests add the backend-reported ttft to the successful
        attempt's dispatch offset (a failed-over request is charged the
        attempts that preceded it, not just the winner's clock)."""
        pd = state.pd_mode()
        role, payload, aff, t_first, pinned = self._route(state, obj,
                                                          deadline)
        kvb = len(payload[1] or b"") + len(payload[2] or b"")
        fall_back = False
        try:
            addr, resp, _, _ = state.call(role, *payload, prompt=aff,
                                          deadline=deadline, pinned=pinned,
                                          kv_bytes=kvb)
            if pinned is not None and isinstance(resp, dict) \
                    and "error" in resp:
                # The pushed stream's decode leg failed (stream truncated,
                # replica died holding the KV) — recoverable below.
                raise RuntimeError(f"decode_stream failed: {resp}")
        except _Rejected as e:
            # A pinned leg that SHED (overloaded/draining — the replica is
            # healthy, just unwilling) must not surface a 429/503 that a
            # sibling would have absorbed: bundle mode retries the fleet.
            # Deadline rejections stay terminal on any path.
            if pinned is None \
                    or e.frame.get("code") not in RETRYABLE_REJECT_CODES:
                raise
            fall_back = True
        except Exception:
            if pinned is None:
                raise
            fall_back = True
        if fall_back:
            # KVCache-centric leg is gone; the request is not: re-route
            # in bundle mode (pinned seed ⇒ token-exact) and try the
            # decode fleet normally. TTFT honestly re-anchors on the
            # fallback prefill's return.
            state.metrics["kv_stream_fallbacks"] += 1
            role, payload, aff, t_first, _ = self._route(
                state, obj, deadline, force_bundle=True)
            kvb = len(payload[1] or b"") + len(payload[2] or b"")
            addr, resp, _, _ = state.call(role, *payload, prompt=aff,
                                          deadline=deadline, kv_bytes=kvb)
        t_dispatch = resp.pop("_router_t_dispatch", None) \
            if isinstance(resp, dict) else None
        t_done = time.monotonic()
        if pd:
            if "error" in resp:
                raise RuntimeError(f"decode failed: {resp}")
            resp["ttft_s"] = round(t_first - t_arrival, 6)
        elif "error" not in resp and resp.get("ttft_s") is not None \
                and t_dispatch is not None:
            t_first = t_dispatch + float(resp["ttft_s"])
            resp["ttft_s"] = round(t_first - t_arrival, 6)
        else:
            t_first = None
        if "error" not in resp:
            # Ingress-vantage token counters — the production
            # prefill:decode ratio signal the topology policy steers on
            # (topology.router_ingress_signals_fn). Counted on SUCCESS
            # only, both kinds symmetrically: shed/failed requests did
            # no prefill work, and counting them would inflate the
            # ratio toward prefill-heavy exactly when the fleet is
            # failing.
            n_prompt = len(obj.get("prompt") or ())
            state.note_ingress("prefill", float(n_prompt))
            n = len(resp.get("tokens") or ())
            state.note_ingress("decode", float(n))
            if t_first is not None:
                tpot = ((t_done - t_first) / (n - 1)) if n > 1 else 0.0
                state.slo.judge(t_first - t_arrival, tpot,
                                role=role, backend=addr)
        return resp

    def _generate_stream(self, state: RouterState, obj: dict,
                         deadline: float, t_arrival: float) -> None:
        """Streaming generate with mid-stream failover: relay incremental
        token frames from the backend to the client (feeds the SSE front
        end). PD mode streams the decode leg; the prefill leg is one
        blocking hop (its product is the first token + KV).

        If the backend dies mid-stream, the SAME payload is re-sent to a
        sibling (the router still holds the KV bundle / the request), and
        the replayed stream — identical because the seed is pinned — is
        relayed with the already-delivered token prefix skipped. The
        client never sees the failure. A backend that SHEDS the attempt
        (overloaded / draining — always before any token) is routed
        around without eviction; a spent deadline ends the request with a
        structured frame instead of another doomed attempt."""
        role, payload, aff, t_first, pinned = self._route(state, obj,
                                                          deadline)
        akey = PrefixAffinity.key(aff)
        rspan = trace.current()
        kv_bytes = len(payload[1] or b"") + len(payload[2] or b"")
        delivered = 0                  # tokens already relayed to the client
        # SLO timing across attempts: t_first (PD: set by the prefill hop
        # above; unified: the first relayed token frame) survives
        # failover — the replay skips already-delivered tokens, so the
        # client's first token stays the one the clock stopped on.
        timing = {"t_first": t_first}
        last: Optional[Exception] = None
        shed: Optional[dict] = None
        for attempt in range(MAX_ATTEMPTS):
            if deadline - time.monotonic() <= 0:
                state.metrics["deadline_refusals"] += 1
                self._send_client({**_deadline_frame(
                    "deadline spent mid-stream"), "done": True})
                return
            if pinned is not None:
                # The payload is a pushed KV stream — it only exists on
                # ONE decode replica. A failed attempt re-routes in
                # bundle mode below instead of trying siblings.
                cands = [pinned]
            else:
                # Affinity only steers the FIRST attempt: a failover must
                # not re-pin to the remembered (possibly just-dead)
                # backend. KV-carrying legs weigh measured transfer cost.
                cands = (state.candidates_for(role, aff) if attempt == 0
                         else state.candidates(
                             role, cost=state.kv_cost_fn(kv_bytes)))
            if not cands:
                break
            addr = cands[0]
            aspan = rspan.child(obs_names.SPAN_ROUTER_ATTEMPT,
                                backend=addr, attempt=attempt, role=role,
                                stream=True)
            if aspan and kv_bytes:
                aspan.attrs["kv_bytes"] = kv_bytes
            if attempt:
                if not state.charge_retry():
                    aspan.end(outcome="retry_budget_exhausted")
                    break
                state.metrics["retries"] += 1
            attempt_payload = payload
            if aspan:
                attempt_payload = (dict(payload[0], trace=aspan.wire()),
                                   payload[1], payload[2])
            state.pool.acquire(addr)
            try:
                delivered, status, frame = self._relay_attempt(
                    addr, attempt_payload, delivered, deadline,
                    timing=timing)
            finally:
                state.pool.release(addr)
            if status == "done":
                state.pool.ok(addr)
                state.affinity.put(akey, addr)
                if attempt:
                    state.metrics["failovers"] += 1
                aspan.end(outcome="ok", delivered=delivered)
                if frame is None:
                    # Ingress tokens on SUCCESS only, both kinds
                    # symmetrically (the blocking path's rule): a
                    # stream that ultimately fails counts NEITHER side,
                    # so failure storms cannot skew the topology ratio.
                    # ``delivered`` already nets out failover replays.
                    n_prompt = len(obj.get("prompt") or ())
                    state.note_ingress("prefill", float(n_prompt))
                    state.note_ingress("decode", float(delivered))
                # frame is None on a CLEAN stream completion; an
                # application-error passthrough carries its frame and is
                # not a finished request — never judged.
                if timing["t_first"] is not None and frame is None:
                    t_done = time.monotonic()
                    tpot = ((t_done - timing["t_first"]) / (delivered - 1)
                            if delivered > 1 else 0.0)
                    state.slo.judge(timing["t_first"] - t_arrival, tpot,
                                    role=role, backend=addr)
                return
            if status == "rejected":
                # Healthy backend refused the attempt (shed before any
                # token): no eviction; deadline ends the request.
                if frame.get("code") == CODE_DEADLINE:
                    state.pool.ok(addr)
                    aspan.end(outcome=CODE_DEADLINE)
                    self._send_client({**frame, "done": True})
                    return
                if pinned is not None:
                    # The pushed stream is unusable — whether it never
                    # became decodable (kv_stream_failed) or the only
                    # replica holding it SHED the attempt. Retrying the
                    # same pinned address cannot help: re-route in bundle
                    # mode, token-exact (seed pinned, delivered prefix
                    # skipped), and let the fleet absorb it. Sheds still
                    # feed the shed bookkeeping (drain marks, best
                    # retry_after_s should the fallback shed everywhere).
                    code = frame.get("code")
                    if code == CODE_KV_STREAM:
                        state.pool.ok(addr)
                    else:
                        shed = state.note_shed(addr, frame, shed)
                    aspan.end(outcome=code or "rejected")
                    state.metrics["kv_stream_fallbacks"] += 1
                    try:
                        role, payload, aff, _, pinned = self._route(
                            state, obj, deadline, force_bundle=True)
                    except Exception as e:  # noqa: BLE001
                        last = e
                        break
                    kv_bytes = len(payload[1] or b"") \
                        + len(payload[2] or b"")
                    continue
                shed = state.note_shed(addr, frame, shed)
                aspan.end(outcome=frame.get("code") or "rejected")
                continue
            # Backend closed mid-stream without a done frame.
            state.pool.fail(addr)
            aspan.end(outcome="died_mid_stream", delivered=delivered)
            last = RuntimeError(f"{addr} closed mid-stream")
            if pinned is not None:
                # The replica holding the pushed KV died (possibly with
                # tokens already delivered): bundle re-route + replay —
                # the client stream never breaks.
                state.metrics["kv_stream_fallbacks"] += 1
                try:
                    role, payload, aff, _, pinned = self._route(
                        state, obj, deadline, force_bundle=True)
                except Exception as e:  # noqa: BLE001
                    last = e
                    break
                kv_bytes = len(payload[1] or b"") + len(payload[2] or b"")
        if shed is not None:
            state.metrics["sheds_returned"] += 1
            self._send_client({**shed, "done": True})
            return
        state.metrics["errors"] += 1
        self._send_client({
            "error": f"all {role} backends failed mid-stream: {last}",
            "done": True})

    def _send_client(self, frame: dict) -> None:
        try:
            send_msg(self.request, frame)
        except OSError as e:
            raise _ClientGone(str(e)) from e

    def _relay_attempt(self, addr: str, payload, delivered: int,
                       deadline: Optional[float] = None,
                       timing: Optional[dict] = None):
        """One streaming attempt against ``addr``. Relays frames to the
        client, skipping the first ``delivered`` tokens (already sent by a
        previous attempt — deterministic replay makes them identical).
        Returns (new_delivered, status, frame): status "done" with a None
        frame (stream completed cleanly), "done" with the error frame (an
        application error passed through — not a finished request),
        "died" (transport failure — the tokens relayed before it are
        never lost from the count, so the retry skips them instead of
        duplicating), or "rejected" (a structured shed frame, returned
        for the caller's route-around logic instead of being surfaced).
        Client-side send failures raise _ClientGone, which aborts the
        request without charging the backend. ``deadline`` re-arms the
        per-recv timeout from the remaining budget and forwards it to the
        backend. ``timing`` (when given) gets ``t_first`` stamped the
        instant the first NEW token reaches the client — SLO TTFT input."""
        host, port = addr.rsplit(":", 1)
        skip = delivered
        try:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return delivered, "rejected", _deadline_frame(
                        "deadline spent before stream dispatch")
                payload = (dict(payload[0], timeout_s=round(remaining, 3)),
                           payload[1], payload[2])
            with socket.create_connection(
                    (host, int(port)),
                    timeout=min(CONNECT_TIMEOUT_S, remaining)
                    if remaining is not None else CONNECT_TIMEOUT_S) as s:
                # Widen to the stream budget BEFORE sending: the payload
                # can carry a multi-MB KV bundle whose transmission must
                # not be cut by the 5 s connect timeout (that would read
                # as 'died' and evict a healthy backend).
                s.settimeout(min(STREAM_TIMEOUT_S, remaining)
                             if remaining is not None else STREAM_TIMEOUT_S)
                send_msg(s, *payload)
                while True:
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return delivered, "rejected", _deadline_frame(
                                "deadline spent mid-stream")
                        s.settimeout(min(STREAM_TIMEOUT_S, remaining))
                    else:
                        s.settimeout(STREAM_TIMEOUT_S)
                    frame, _, _ = recv_msg(s)
                    if frame is None:
                        return delivered, "died", None
                    if frame.get("keepalive"):
                        # SSE liveness pass-through: forwarded verbatim so
                        # the edge can emit its comment frame, but never
                        # counted as tokens and never re-arming the
                        # deadline — liveness is not progress.
                        self._send_client(frame)
                        continue
                    if "error" in frame:
                        if frame.get("code") in RETRYABLE_REJECT_CODES \
                                or frame.get("code") in (CODE_DEADLINE,
                                                         CODE_KV_STREAM):
                            # Shed at admission (always before any token):
                            # the caller routes around / ends the request
                            # (kv_stream_failed → bundle re-route).
                            return delivered, "rejected", frame
                        # Application error — not a transport failure; the
                        # engine is healthy and answered. Pass through
                        # (frame returned so the caller skips SLO judgment).
                        self._send_client(frame)
                        return delivered, "done", frame
                    tokens = frame.get("tokens") or []
                    drop = min(skip, len(tokens))
                    if drop:
                        skip -= drop
                        frame = dict(frame)
                        frame["tokens"] = tokens[drop:]
                        if "logprobs" in frame:
                            frame["logprobs"] = frame["logprobs"][drop:]
                        tokens = frame["tokens"]
                    if tokens or frame.get("done"):
                        self._send_client(frame)
                        if (tokens and timing is not None
                                and timing.get("t_first") is None):
                            timing["t_first"] = time.monotonic()
                        delivered += len(tokens)
                    if frame.get("done"):
                        return delivered, "done", None
        except (OSError, ConnectionError, json.JSONDecodeError):
            # JSONDecodeError = garbage frame from a version-mismatched or
            # corrupt backend — same class as a transport failure (probe()
            # classifies it identically): fail over, don't surface it.
            return delivered, "died", None


class RouterServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def start_prober(state: RouterState, interval_s: float = 0.5) -> threading.Thread:
    """Background re-admission: health-check evicted backends so recovery
    is noticed in ~interval_s instead of waiting out the backoff."""
    def loop():
        while True:
            time.sleep(interval_s)
            try:
                state.pool.probe()
            except Exception:
                pass
    t = threading.Thread(target=loop, daemon=True, name="router-prober")
    t.start()
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rbg-tpu-torch-router")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--registry", default=os.environ.get("RBG_REGISTRY_PATH"))
    ap.add_argument("--group", default=os.environ.get("RBG_GROUP_NAME"))
    ap.add_argument("--backends", default="",
                    help='static JSON {"prefill": ["host:port"], ...}')
    ap.add_argument("--auth-token", default="",
                    help="require this bearer token on generate/embed and "
                         "forward it on every backend leg (default: "
                         "$RBG_DATA_TOKEN; empty = open wire)")
    ap.add_argument("--retry-rate", type=float, default=8.0,
                    help="router-wide retry budget: sustained failover "
                         "retries per second (token bucket; shed storms "
                         "must not amplify). 0 disables retries; "
                         "negative = unbounded")
    ap.add_argument("--retry-burst", type=float, default=32.0,
                    help="retry budget burst size (bucket capacity)")
    ap.add_argument("--slo-ttft-s", type=float, default=2.0,
                    help="TTFT target for router-side SLO judgment "
                         "(ingress-anchored; health carries per-role and "
                         "per-backend attainment; 0 disables)")
    ap.add_argument("--slo-tpot-s", type=float, default=0.5,
                    help="per-output-token latency target for router-side "
                         "SLO judgment (0 disables)")
    ap.add_argument("--kv-stream", choices=("auto", "off"), default="auto",
                    help="KVCache-centric PD routing: pick the decode "
                         "replica first (transfer-cost-aware) and have "
                         "prefill push KV chunks to it as they compute; "
                         "'off' keeps the whole-bundle relay path")
    ap.add_argument("--directory",
                    default=os.environ.get("RBG_KV_POOL_ADDR", ""),
                    help="host:port of the cluster prefix directory (the "
                         "kv-pool server hosts it) — prefix affinity can "
                         "then route to ANY replica holding a prefix "
                         "(default: $RBG_KV_POOL_ADDR; empty = local LRU "
                         "only)")
    ap.add_argument("--router-id",
                    default=os.environ.get("RBG_ROUTER_ID", ""),
                    help="stable identity on the router-tier hash ring "
                         "(default: $RBG_ROUTER_ID or router-<port>)")
    ap.add_argument("--drain-wait-s", type=float, default=30.0,
                    help="SIGTERM drain: max seconds to wait for in-flight "
                         "streams to finish before exiting")
    args = ap.parse_args(argv)
    port = int(os.environ.get("RBG_SERVE_PORT")
               or os.environ.get("RBG_PORT_SERVE") or args.port)
    static = json.loads(args.backends) if args.backends else None
    server = RouterServer(("127.0.0.1", port), Handler)
    budget = RetryBudget(rate=None if args.retry_rate < 0 else args.retry_rate,
                         burst=args.retry_burst)
    directory = None
    if args.directory:
        from rbg_tpu_torch.kvtransfer.directory import DirectoryClient
        directory = DirectoryClient(args.directory,
                                    token=args.auth_token or None)
    server.state = RouterState(Registry(args.registry), args.group, static,
                               token=args.auth_token or None,
                               retry_budget=budget,
                               slo_targets=SLOTargets(
                                   ttft_s=args.slo_ttft_s,
                                   tpot_s=args.slo_tpot_s),
                               directory=directory,
                               kv_stream=args.kv_stream != "off",
                               router_id=args.router_id or f"router-{port}")
    from rbg_tpu_torch.obs import timeseries
    timeseries.ensure_started()
    start_prober(server.state)

    # Drain protocol: SIGTERM flips the admission gate (new requests
    # get the structured draining frame; tier peers take the hash range),
    # in-flight streams finish, then the listener exits cleanly.
    import signal

    def _on_sigterm(signum, frame):
        def drain():
            server.state.begin_drain(wait_s=args.drain_wait_s)
            server.shutdown()
        threading.Thread(target=drain, daemon=True,
                         name="router-drain").start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # non-main thread (embedded use) — drain via begin_drain()
    print(f"router listening on 127.0.0.1:{port} group={args.group}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
