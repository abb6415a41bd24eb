"""The port's router tier (``rbg_tpu_torch/engine/routertier.py``) against
``rbg_tpu``'s: ring owners and fallback orders equal for the same members
and keys, the same bounded-load spill and drain re-routes, the peer event
feed folding into ``RouterState`` pools, cross-router ingress rates, and
``TierClient``'s token-exact replay across a member loss."""

import threading
import time

import pytest

from rbg_tpu.engine import router as j_router
from rbg_tpu.engine import routertier as j_tier
from rbg_tpu_torch.engine import router as t_router
from rbg_tpu_torch.engine import routertier as t_tier
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY

PAIRS = [(j_tier, j_router), (t_tier, t_router)]
KEYS = [f"sess-{i}" for i in range(600)]


# ---- hash ring -------------------------------------------------------------


@pytest.mark.parametrize("members", [("a",), ("a", "b", "c"),
                                     ("r0", "r1", "r2", "r3", "r4")])
def test_ring_owners_match_reference(members):
    rings = [T.HashRing() for T, _ in PAIRS]
    for r in rings:
        for m in members:
            r.add(m)
    ref, port = rings
    assert [port.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    assert [port.owners(k) for k in KEYS[:100]] == \
        [ref.owners(k) for k in KEYS[:100]]
    assert [port.owners(k, 2) for k in KEYS[:50]] == \
        [ref.owners(k, 2) for k in KEYS[:50]]
    assert set(port.owner(k) for k in KEYS) == set(members)


def test_ring_removal_moves_only_the_removed_members_keys():
    rings = [T.HashRing() for T, _ in PAIRS]
    for r in rings:
        for m in ("a", "b", "c", "d"):
            r.add(m)
    before = {k: rings[1].owner(k) for k in KEYS}
    for r in rings:
        r.remove("b")
    moved = [k for k in KEYS if rings[1].owner(k) != before[k]]
    assert moved and all(before[k] == "b" for k in moved)
    assert [rings[1].owner(k) for k in KEYS] == [rings[0].owner(k) for k in KEYS]
    empty = t_tier.HashRing()
    assert empty.owner("k") is None and empty.owners("k") == []


# ---- bounded-load routing and drain ----------------------------------------


def _tier_script(T):
    tier = T.RouterTier(name=f"t-script-{T.__name__}")
    for m in ("a", "b", "c"):
        tier.register(m)
    picks = []
    key = "sess-42"
    owner = tier.ring.owner(key)
    picks.append(tier.route(key))
    for _ in range(10):
        tier.acquire(owner)
    picks += [tier.route(key), tier.route(key)]
    for _ in range(10):
        tier.release(owner)
    picks.append(tier.route(key))
    tier.set_draining(owner, True)
    picks += [tier.route(k) for k in KEYS[:40]]
    for m in ("a", "b", "c"):
        for _ in range(5):
            tier.acquire(m)
    picks.append(tier.route(key))
    tier.set_draining(owner, False)
    tier.remove("b")
    picks += [tier.route(k) for k in KEYS[:40]]
    snap = tier.snapshot()
    return picks, {n: (m["draining"], m["outstanding"])
                   for n, m in snap["members"].items()}, snap["ring"]


def test_route_spill_drain_and_removal_match_reference():
    ref, port = (_tier_script(T) for T, _ in PAIRS)
    assert port == ref
    picks = port[0]
    assert picks[1] == picks[2] != picks[0] == picks[3]   # consistent spill


def test_routes_counter_and_members_gauge():
    tier = t_tier.RouterTier(name="t-metrics")
    tier.register("a")
    before = REGISTRY.counter(obs_names.ROUTER_RING_ROUTES_TOTAL,
                              tier="t-metrics", member="a")
    tier.route("k1")
    tier.route("k2")
    assert REGISTRY.counter(obs_names.ROUTER_RING_ROUTES_TOTAL,
                            tier="t-metrics", member="a") == before + 2
    assert REGISTRY.gauge(obs_names.ROUTER_RING_MEMBERS,
                          tier="t-metrics") == 1.0
    tier.remove("a")
    assert REGISTRY.counter(obs_names.ROUTER_RING_RESHARDS_TOTAL,
                            tier="t-metrics") >= 1
    assert REGISTRY.gauge(obs_names.ROUTER_RING_MEMBERS,
                          tier="t-metrics") == 0.0


def test_stale_peer_spills_its_ranges():
    t = {"t": 0.0}
    tier = t_tier.RouterTier(name="t-stale", clock=lambda: t["t"],
                             peer_stale_after_s=5.0)
    for m in ("a", "b"):
        tier.register(m)
    key = next(k for k in KEYS if tier.ring.owner(k) == "a")
    assert tier.route(key) == "a"
    t["t"] = 10.0
    tier.note_ingress("b", "prefill", 1.0)      # b speaks, a stays silent
    assert tier.route(key) == "b"
    assert REGISTRY.gauge(obs_names.DEGRADED_MODE, ladder="peer_feed") == 1.0
    assert tier.snapshot()["members"]["a"]["stale"]


# ---- peer event feed into RouterState pools --------------------------------


def _states(T, R, n=2):
    tier = T.RouterTier(name="t-feed")
    states = [R.RouterState(R.Registry(None), None,
                            {"worker": [f"10.0.0.{i}:9000"]},
                            router_id=f"r{i}", tier=tier) for i in range(n)]
    return tier, states


def _feed_script(T, R):
    tier, (s0, s1) = _states(T, R)
    out = []
    addr = "10.9.9.9:7000"
    out.append(tier.publish(s0.router_id, "draining",
                            {"backend": addr, "draining": True}))
    out.append(s1.pool.is_draining(addr))
    tier.publish(s0.router_id, "draining", {"backend": addr,
                                            "draining": False})
    out.append(s1.pool.is_draining(addr))
    tier.publish(s0.router_id, "health", {"backend": addr,
                                          "available": False})
    out.append(s1.pool.evicted())
    tier.publish(s0.router_id, "health", {"backend": addr,
                                          "available": True})
    out.append(s1.pool.evicted())
    before = tier.events_published
    s0.merge_link_rates({"10.0.0.1:9000": 2.5e9})
    out.append(tier.events_published - before)
    out.append(s1.linkstats.rate("10.0.0.1:9000"))
    # A shed with CODE_DRAINING marks the backend and tells the peers.
    s0.note_shed("10.0.0.0:9000", {"code": "draining"}, None)
    out.append(s1.pool.is_draining("10.0.0.0:9000"))
    s0.note_ingress("prefill", 100.0)
    s1.note_ingress("prefill", 50.0)
    s1.note_ingress("decode", 10.0)
    out.append(tier.ingress_totals())
    s0.publish_ingress()
    out.append({n: m["peer_events"]
                for n, m in tier.snapshot()["members"].items()})
    out.append(dict(s0.metrics))
    return out


def test_peer_feed_folds_like_reference():
    ref, port = (_feed_script(T, R) for T, R in PAIRS)
    assert port == ref
    assert port[1] is True and port[3] == ["10.9.9.9:7000"]


def test_router_drain_protocol_announces_and_waits():
    tier, (s0, s1) = _states(t_tier, t_router)
    assert s0.enter_request()
    done = []
    t = threading.Thread(
        target=lambda: done.append(s0.begin_drain(wait_s=5.0)), daemon=True)
    t.start()
    deadline = time.monotonic() + 2.0
    while not s0.draining and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not s0.enter_request()
    assert tier.draining(s0.router_id)
    key = next(k for k in KEYS if tier.ring.owner(k) == s0.router_id)
    assert tier.route(key) == s1.router_id
    s0.exit_request()
    t.join(timeout=5.0)
    assert done == [True]


# ---- cross-router ingress ---------------------------------------------------


def _ingress_script(T):
    t = {"t": 100.0}
    tier = T.RouterTier(name="t-ing", clock=lambda: t["t"])
    tier.register("a")
    tier.register("b")
    out = []
    tier.note_ingress("a", "prefill", 600.0)
    tier.note_ingress("b", "prefill", 600.0)
    tier.note_ingress("a", "decode", 60.0)
    out.append(tier.ingress_rates(window_s=60.0))
    # Cumulative totals on the feed fold as deltas; a drop is a restart.
    tier.publish("a", "ingress", {"totals": {"prefill": 50.0}})
    tier.publish("a", "ingress", {"totals": {"prefill": 80.0}})
    tier.publish("a", "ingress", {"totals": {"prefill": 10.0}})
    out.append(tier.ingress_totals())
    t["t"] = 200.0
    out.append(tier.ingress_rates(window_s=60.0))
    return out


def test_ingress_rates_match_reference():
    ref, port = (_ingress_script(T) for T, _ in PAIRS)
    assert port == ref
    assert port[0]["prefill"] == pytest.approx(20.0)
    assert port[0]["decode"] == pytest.approx(1.0)
    assert port[2] == {"prefill": None, "decode": None}
    assert port[1]["prefill"] == pytest.approx(1200.0 + 80.0 + 10.0)


# ---- session replay across a member loss -----------------------------------


def _replay_script(T):
    tier = T.RouterTier(name="t-replay")
    for m in ("a", "b", "c"):
        tier.register(m)

    def token_fn(seed, pos):
        return (seed * 31 + pos * 7) & 0xFFFF

    killed = set()

    def deliver(member, key, seed, start, n):
        if member in killed or member not in tier.ring:
            raise T.MemberDown(member)
        return [token_fn(seed, p) for p in range(start, start + n)]

    client = T.TierClient(tier, token_fn, deliver_fn=deliver)
    key = "sess-replay"
    victim = tier.ring.owner(key)
    first = client.run_session(key, seed=5, total=32, chunk=8)

    def deliver_then_kill(member, key_, seed, start, n):
        if member == victim and start >= 16:
            killed.add(victim)
            tier.remove(victim)
        return deliver(member, key_, seed, start, n)

    client.deliver_fn = deliver_then_kill
    second = client.run_session(key, seed=9, total=32, chunk=8)
    want = [token_fn(9, p) for p in range(32)]
    return first, second, want, client.rehashes, victim


def test_tier_client_replays_token_exact_after_member_loss():
    ref, port = (_replay_script(T) for T, _ in PAIRS)
    assert port == ref
    first, second, want, rehashes, victim = port
    assert first["rehashes"] == 0 and first["members"] == [victim]
    assert second["tokens"] == want and second["rehashes"] == 1 == rehashes
    assert second["members"][0] == victim != second["members"][-1]
    with pytest.raises(RuntimeError, match="tier empty"):
        t_tier.TierClient(t_tier.RouterTier(name="t-empty"),
                          lambda s, p: 0).run_session("k", 1, 4)


def test_retry_budget_publishes_tokens_gauge():
    rb = t_router.RetryBudget(rate=8.0, burst=4.0)
    assert rb.take()
    g = REGISTRY.gauge(obs_names.SERVING_RETRY_BUDGET_TOKENS)
    assert g is not None and g <= 3.0 + 0.1
    off = t_router.RetryBudget(rate=0)
    assert not off.take() and off.snapshot()["burst"] == 0.0
