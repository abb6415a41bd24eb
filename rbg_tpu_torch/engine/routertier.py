"""Router tier: N routers behind consistent-hash affinity — SPOF #1 killed.

One ``engine/router.py`` process was a single point of failure AND a
signal silo: its prefix-affinity LRU, measured KV link rates, and the
ingress token counters the topology policy steers on all lived in one
process. This module makes a TIER out of N routers:

* :class:`HashRing` — consistent hashing with virtual nodes. The same
  session/prefix key always lands on the replica whose affinity LRU is
  warm; removing a member moves ONLY that member's ranges (its keys
  re-hash to ring successors, everyone else's stay put).
* :class:`RouterTier` — membership + the router-to-router event feed.
  Peers learn backend health/draining transitions and measured
  ``rbg_kvtransfer_link_bytes_per_s`` rates from each other instead of
  rediscovering them per-process, and ingress token counts AGGREGATE
  across members so ``TopologyPolicy`` sees the whole mix, not one
  router's partial view (``topology.signals.tier_ingress_ratio``).
  Routing is consistent-hash first with bounded-load fallback: an
  overloaded or draining owner spills its key to the next ring
  successor instead of hot-spotting.
* :class:`TierClient` — the kill-a-router drill's session driver:
  sessions pin their sampling seed CLIENT-SIDE on the first attempt, so
  when a member dies mid-stream the re-hashed replay is token-exact
  (position-keyed PRNG) and the already-delivered prefix is skipped —
  the router's bundle-fallback replay contract, one hop up.

The tier object is process-local coordination (the drill and embedded
multi-router deployments); the wire form of the same feed is the
``peer_event`` admin op each router serves.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs import trace
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

__all__ = ["HashRing", "RouterTier", "TierClient", "MemberDown"]

# Virtual nodes per member: enough that a 3-member tier splits the key
# space within a few percent of even, small enough that ring rebuilds
# (member join/leave) stay trivially cheap.
VNODES = 64

# Bounded-load factor (the "power of consistent-hash with bounded loads"
# bound): an owner carrying more than factor x the tier-mean outstanding
# load spills NEW keys to its ring successor. 1.25 is the classic choice.
BOUNDED_LOAD_FACTOR = 1.25

# Peer-feed event kinds.
EV_HEALTH = "health"            # backend up/down transition
EV_DRAINING = "draining"        # backend OR router draining transition
EV_LINK_RATES = "link_rates"    # measured kvtransfer link rates
EV_INGRESS = "ingress"          # ingress token counts (prefill/decode)


def _digest(key: str) -> int:
    """Deterministic 64-bit ring position (NOT ``hash()``: that is
    per-process salted and would shred affinity across restarts)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes over member names."""

    def __init__(self, vnodes: int = VNODES):
        self.vnodes = vnodes
        self._members: set = set()
        self._ring: List[Tuple[int, str]] = []   # sorted (digest, member)
        self._keys: List[int] = []               # digests only, for bisect

    def members(self) -> List[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def add(self, name: str) -> None:
        if name in self._members:
            return
        self._members.add(name)
        for i in range(self.vnodes):
            self._ring.append((_digest(f"{name}#{i}"), name))
        self._ring.sort()
        self._keys = [d for d, _ in self._ring]

    def remove(self, name: str) -> None:
        if name not in self._members:
            return
        self._members.discard(name)
        self._ring = [(d, m) for d, m in self._ring if m != name]
        self._keys = [d for d, _ in self._ring]

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key`` (first vnode clockwise)."""
        if not self._ring:
            return None
        i = bisect.bisect(self._keys, _digest(key)) % len(self._ring)
        return self._ring[i][1]

    def owners(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct members in clockwise fallback order from ``key`` —
        ``owners(k)[0] == owner(k)``; a dead/draining owner's traffic
        spills to ``[1]``, which is exactly who inherits the range when
        the owner leaves the ring (minimal-movement fallback)."""
        if not self._ring:
            return []
        want = len(self._members) if n is None else min(n, len(self._members))
        out: List[str] = []
        start = bisect.bisect(self._keys, _digest(key))
        for j in range(len(self._ring)):
            m = self._ring[(start + j) % len(self._ring)][1]
            if m not in out:
                out.append(m)
                if len(out) >= want:
                    break
        return out


class _Member:
    __slots__ = ("name", "state", "draining", "outstanding", "ingress",
                 "link_rates", "peer_events", "last_seen", "ingress_last")

    def __init__(self, name: str, state=None, now: float = 0.0):
        self.name = name
        self.state = state           # optional RouterState back-reference
        self.draining = False
        self.outstanding = 0
        self.ingress = {"prefill": 0.0, "decode": 0.0}
        self.link_rates: Dict[str, float] = {}
        self.peer_events = 0
        # Last instant this member showed life on the feed (registration,
        # any published event, its own ingress notes) — the per-peer
        # staleness TTL ages routing eligibility off it.
        self.last_seen = now
        # Per-kind last CUMULATIVE ingress totals seen from this member's
        # EV_INGRESS events — the counter-restart fold's watermark.
        self.ingress_last: Dict[str, float] = {}


class MemberDown(Exception):
    """A routed member died mid-stream (drill injection / dead peer)."""


class RouterTier:
    """Membership, routing, and the peer event feed for N routers.

    Everything here is guarded by one lock (``named_lock("engine.tier")``)
    except peer delivery callbacks, which run OUTSIDE it — a member's
    ``on_peer_event`` may call back into the tier (e.g. merge link rates
    then publish its own transition) without deadlocking.
    """

    def __init__(self, name: str = "tier", vnodes: int = VNODES,
                 bounded_load: float = BOUNDED_LOAD_FACTOR,
                 clock: Optional[Callable[[], float]] = None,
                 peer_stale_after_s: Optional[float] = None):
        self.name = name
        self.ring = HashRing(vnodes)
        self.bounded_load = float(bounded_load)
        # Per-peer staleness TTL: a member silent on the feed for longer
        # than this is EXCLUDED from routing (a router must not steer at
        # backends whose health it can no longer observe) until it speaks
        # again. None (default) = off — single-process tiers with no
        # heartbeat traffic must not age themselves out.
        self.peer_stale_after_s = peer_stale_after_s
        self._clock = clock or time.monotonic
        self._lock = named_lock("engine.tier")
        self._members: Dict[str, _Member] = {}   # guarded_by[engine.tier]
        # Ingress sample log for windowed cross-router rates:
        # (t, member, kind, n) appended by note_ingress.
        self._ingress_log: deque = deque(maxlen=65536)  # guarded_by[engine.tier]
        self.events_published = 0                # guarded_by[engine.tier]

    # -- membership --

    def register(self, name: str, state=None) -> None:
        """Add a router to the ring. ``state`` (a ``RouterState``) makes
        the member an in-process peer: events fan in through its
        ``on_peer_event``."""
        with self._lock:
            now = self._clock()
            if name not in self._members:
                self._members[name] = _Member(name, state, now=now)
                self.ring.add(name)
            else:
                m = self._members[name]
                m.last_seen = now
                if state is not None:
                    m.state = state
            n = len(self.ring)
        REGISTRY.set_gauge(obs_names.ROUTER_RING_MEMBERS, float(n),
                           tier=self.name)

    def remove(self, name: str) -> None:
        """Member leaves (crash or drained-out): its hash ranges move to
        ring successors — a reshard event."""
        with self._lock:
            existed = self._members.pop(name, None) is not None
            self.ring.remove(name)
            n = len(self.ring)
        if existed:
            span = trace.start_trace(obs_names.SPAN_ROUTER_RESHARD,
                                     tier=self.name, left=name)
            REGISTRY.inc(obs_names.ROUTER_RING_RESHARDS_TOTAL,
                         tier=self.name)
            REGISTRY.set_gauge(obs_names.ROUTER_RING_MEMBERS, float(n),
                               tier=self.name)
            span.end(outcome="resharded", members=n)

    def members(self) -> List[str]:
        with self._lock:
            return self.ring.members()

    # -- routing --

    def route(self, key: str) -> Optional[str]:
        """Pick the serving router for ``key``: ring owner unless it is
        draining, gone, or over the bounded-load limit — then the first
        eligible ring successor (consistent spill: the same overloaded
        key always spills to the same peer). Returns None on an empty
        tier."""
        stale_cut = None
        n_stale = 0
        with self._lock:
            if self.peer_stale_after_s is not None:
                stale_cut = self._clock() - self.peer_stale_after_s
                n_stale = sum(1 for m in self._members.values()
                              if m.last_seen < stale_cut)
            order = self.ring.owners(key)
            if not order:
                return None
            loads = {m.name: m.outstanding for m in self._members.values()}
            mean = (sum(loads.values()) / len(loads)) if loads else 0.0
            limit = max(self.bounded_load * mean, 1.0)
            pick = None
            for cand in order:
                m = self._members.get(cand)
                if m is None or m.draining:
                    continue
                if stale_cut is not None and m.last_seen < stale_cut:
                    # Silent past the TTL: maybe partitioned, maybe dead —
                    # either way its health view is fiction. Its ranges
                    # spill to ring successors until it speaks again.
                    continue
                if pick is None:
                    pick = cand      # first non-draining = fallback floor
                if m.outstanding <= limit:
                    pick = cand
                    break
        if stale_cut is not None:
            # Tier-level, not per-decision: ANY stale member means the
            # ladder rung is engaged (its ranges are spilling), whether
            # or not this particular key's walk touched it.
            REGISTRY.set_gauge(obs_names.DEGRADED_MODE,
                               1.0 if n_stale else 0.0,
                               ladder="peer_feed")
        if pick is not None:
            REGISTRY.inc(obs_names.ROUTER_RING_ROUTES_TOTAL,
                         tier=self.name, member=pick)
        return pick

    def acquire(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.outstanding += 1

    def release(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is not None and m.outstanding > 0:
                m.outstanding -= 1

    # -- peer event feed --

    def publish(self, origin: str, kind: str, payload: dict) -> int:
        """Fan an event from ``origin`` out to every OTHER member's
        ``on_peer_event`` (delivery outside the tier lock). Returns the
        number of peers reached."""
        ev = {"tier": self.name, "origin": origin, "kind": kind,
              "payload": payload, "t": self._clock()}
        with self._lock:
            self.events_published += 1
            m = self._members.get(origin)
            if m is not None:
                # Any event is proof of life — the staleness TTL feeds
                # off this watermark.
                m.last_seen = ev["t"]
            if kind == EV_DRAINING and "router" in payload:
                if m is not None:
                    m.draining = bool(payload.get("draining"))
            if kind == EV_LINK_RATES:
                if m is not None:
                    for a, r in (payload.get("rates") or {}).items():
                        try:
                            m.link_rates[a] = float(r)
                        except (TypeError, ValueError):
                            continue
            if kind == EV_INGRESS and m is not None:
                # Payload carries CUMULATIVE per-kind totals. Fold the
                # delta against this member's watermark; a total BELOW
                # the watermark is a counter restart (the member came
                # back under the same --router-id with zeroed counters,
                # counter-restart convention) — fold the full new value, never a
                # negative delta that would poison the topology ratio.
                for k, tot in (payload.get("totals") or {}).items():
                    try:
                        tot = float(tot)
                    except (TypeError, ValueError):
                        continue
                    last = m.ingress_last.get(k)
                    delta = tot if (last is None or tot < last) \
                        else tot - last
                    m.ingress_last[k] = tot
                    if delta > 0:
                        m.ingress[k] = m.ingress.get(k, 0.0) + delta
                        self._ingress_log.append((ev["t"], origin, k,
                                                  delta))
            targets = [mm for n, mm in self._members.items() if n != origin]
        delivered = 0
        for m in targets:
            st = m.state
            handler = getattr(st, "on_peer_event", None)
            if handler is None:
                continue
            try:
                handler(ev)
                delivered += 1
                with self._lock:
                    m.peer_events += 1
            except Exception:
                continue
        REGISTRY.inc(obs_names.ROUTER_PEER_EVENTS_TOTAL,
                     tier=self.name, kind=kind)
        return delivered

    def set_draining(self, name: str, draining: bool = True) -> None:
        """Router-level drain transition (the SIGTERM drain protocol's
        tier half): the member stops taking NEW keys — ``route`` spills
        its ranges to ring successors — while its in-flight streams run
        to completion; peers learn via the feed."""
        with self._lock:
            m = self._members.get(name)
            if m is None or m.draining == draining:
                return
            m.draining = draining
        self.publish(name, EV_DRAINING,
                     {"router": name, "draining": draining})

    def draining(self, name: str) -> bool:
        with self._lock:
            m = self._members.get(name)
            return bool(m is not None and m.draining)

    # -- cross-router ingress aggregation --

    def note_ingress(self, name: str, kind: str, n: float,
                     now: Optional[float] = None) -> None:
        """Record ``n`` ingress tokens of ``kind`` observed by member
        ``name`` — the per-router counter's tier-shared twin. The
        topology ratio MUST read the tier sum: N routers each see 1/N of
        the mix, and any single router's ratio is noise."""
        if n <= 0:
            return
        t = self._clock() if now is None else now
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.ingress[kind] = m.ingress.get(kind, 0.0) + float(n)
                m.last_seen = max(m.last_seen, t)  # its own heartbeat
            self._ingress_log.append((t, name, kind, float(n)))

    def ingress_totals(self) -> Dict[str, float]:
        """Cumulative tokens per kind summed across ALL members."""
        out: Dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        with self._lock:
            for m in self._members.values():
                for k, v in m.ingress.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def ingress_rates(self, window_s: float = 60.0,
                      now: Optional[float] = None) -> Dict[str, Optional[float]]:
        """Windowed tokens/s per kind, summed across members; a kind with
        NO samples in the window is ``None`` (absence of signal), never
        0.0 — the SignalReader discipline."""
        t = self._clock() if now is None else now
        lo = t - window_s
        sums: Dict[str, float] = {}
        seen: set = set()
        with self._lock:
            for ts, _name, kind, n in self._ingress_log:
                if ts < lo or ts > t:
                    continue
                seen.add(kind)
                sums[kind] = sums.get(kind, 0.0) + n
        return {k: (sums.get(k, 0.0) / window_s if k in seen else None)
                for k in ("prefill", "decode")}

    # -- introspection --

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            members = {
                n: {"draining": m.draining, "outstanding": m.outstanding,
                    "ingress": dict(m.ingress), "peer_events": m.peer_events,
                    "silent_s": round(max(0.0, now - m.last_seen), 3),
                    "stale": bool(self.peer_stale_after_s is not None
                                  and now - m.last_seen
                                  > self.peer_stale_after_s),
                    "link_rates": {a: round(r, 1)
                                   for a, r in m.link_rates.items()}}
                for n, m in self._members.items()}
            return {"tier": self.name, "members": members,
                    "ring": self.ring.members(),
                    "events_published": self.events_published,
                    "peer_stale_after_s": self.peer_stale_after_s,
                    "bounded_load": self.bounded_load}


class TierClient:
    """Session driver for the kill-a-router drill (and tier tests).

    ``token_fn(seed, pos)`` is the position-keyed PRNG stand-in: token at
    ``pos`` is a pure function of (seed, pos), matching the engine's
    replay-deterministic sampling — which is exactly why a re-hashed
    replay is token-exact. The seed is pinned CLIENT-SIDE on session
    open (the router's ``_pin_seed`` one hop up), so no router holds
    irreplaceable session state.

    ``deliver_fn(member, session_key, seed, start_pos, n)`` produces the
    next ``n`` tokens from ``member`` starting at ``start_pos``; it
    raises :class:`MemberDown` when the member has been killed — the
    client then re-routes via the ring (the dead member is gone from it)
    and resumes from ``len(delivered)``, skipping nothing and repeating
    nothing."""

    def __init__(self, tier: RouterTier, token_fn: Callable[[int, int], int],
                 deliver_fn=None):
        self.tier = tier
        self.token_fn = token_fn
        self.deliver_fn = deliver_fn or self._default_deliver
        self.rehashes = 0
        self.failed = 0

    def _default_deliver(self, member: str, key: str, seed: int,
                         start: int, n: int) -> List[int]:
        if member not in self.tier.ring:
            raise MemberDown(member)
        return [self.token_fn(seed, p) for p in range(start, start + n)]

    def run_session(self, key: str, seed: int, total: int,
                    chunk: int = 8) -> dict:
        """Stream ``total`` tokens for session ``key``; survive member
        loss by re-routing + replaying. Returns {tokens, members, rehashes,
        delivered}."""
        delivered: List[int] = []
        members_used: List[str] = []
        rehashes = 0
        while len(delivered) < total:
            member = self.tier.route(key)
            if member is None:
                self.failed += 1
                raise RuntimeError(f"tier empty mid-session {key!r}")
            if not members_used or members_used[-1] != member:
                members_used.append(member)
            self.tier.acquire(member)
            try:
                while len(delivered) < total:
                    n = min(chunk, total - len(delivered))
                    toks = self.deliver_fn(member, key, seed,
                                           len(delivered), n)
                    delivered.extend(toks)
            except MemberDown:
                rehashes += 1
                self.rehashes += 1
                continue
            finally:
                self.tier.release(member)
        return {"tokens": delivered, "members": members_used,
                "rehashes": rehashes, "delivered": len(delivered)}
