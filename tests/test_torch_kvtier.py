"""The port's host-DRAM KV tier (``rbg_tpu_torch/engine/kvtier.py`` on the
trie of ``engine/kvpool.py``) against ``rbg_tpu``'s: the store on one
shared script (returns, stats, bytes and page CRCs equal, bf16 pages
included), the spill → promote lifecycle on ``tiny`` and ``tiny-mla``
with the reference engine's greedy tokens and page counts, the pinned
pages that must not spill, the host hits counted once, the config's
refusals with the reference's messages, the server's flag and stats,
and the ``slo`` cache panel. CPU, float32 models; Pallas never runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.kvpool import KVPoolStore as JStore
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.kvcache import PagedKVCache
from rbg_tpu_torch.engine.kvpool import KVPoolStore
from rbg_tpu_torch.engine.kvtier import HostKVTier, _to_host
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy

PS = 8
BASE = dict(page_size=PS, max_batch=2, max_seq_len=256, prefill_chunk=16)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for model in ("tiny", "tiny-mla"):
        jp = j_init(j_get_config(model), jax.random.key(0))
        out[model] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            get_config(model), "cpu"))
    return out


def _prompts(n, length, seed=0, vocab=250):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=length).tolist() for _ in range(n)]


def _engines(weights, model, **cfg):
    jp, tp = weights[model]
    cfg = {**BASE, "model": model, **cfg}
    return (JEngine(JConfig(use_pallas="never", **cfg), params=jp),
            Engine(EngineConfig(**cfg), params=tp, device="cpu"))


# ---- KVPoolStore: one script on both stores --------------------------------


def _crcs(store):
    """(depth, page tokens, crc, nbytes, hits) of every trie node."""
    out, stack = [], [(store.root, 0)]
    while stack:
        node, d = stack.pop()
        if node is not store.root:
            out.append((d, node.key, node.crc, node.nbytes, node.hits))
        stack.extend((c, d + 1) for c in node.children.values())
    return sorted(out, key=lambda e: (e[0], e[1]))


def _same(a, b):
    """Equal returns: (tokens, k, v) triples or plain values."""
    if isinstance(a, tuple):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype.itemsize == y.dtype.itemsize
                assert x.tobytes() == y.tobytes()
    else:
        assert a == b


def _page_pairs(n, seed, bf16):
    """[L, n, page, KV, hd] K and V as the reference keeps them (float32,
    or JAX bf16 numpy) and as the port keeps them (float32, or bf16 bits
    through the tier's ``_to_host``)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        x = rng.randn(2, n, PS, 2, 4).astype(np.float32)
        if bf16:
            ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
            port = _to_host(torch.from_numpy(x).to(torch.bfloat16))
        else:
            ref = port = x
        out.append((ref, port))
    (kr, kp), (vr, vp) = out
    return (kr, vr), (kp, vp)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_store_script_matches_reference(bf16):
    """Placeholders filled deep-first, a take that moves pages, hotness,
    and byte-budget eviction of the coldest page: every return, the
    stats, the byte count and each node's CRC equal the reference's."""
    one_page = _page_pairs(1, 0, bf16)[1][0][:, 0].nbytes * 2
    stores = (JStore(PS, max_bytes=7 * one_page),
              KVPoolStore(PS, max_bytes=7 * one_page))
    toks = list(range(1, 4 * PS + 1))
    hot = list(range(200, 200 + 2 * PS))
    script = [
        ("put", toks, 2, 2, 1),          # deep pages 2..3 first
        ("match", toks), ("peek", toks, 0), ("peek", toks, 2 * PS),
        ("extend", toks, 2 * PS, False, None),
        ("put", toks, 0, 2, 2),          # shallow pages fill placeholders
        ("match", toks),
        ("put", hot, 0, 2, 3),
        ("match", hot), ("match", hot), ("match", hot[:PS] + [0] * PS),
        ("extend", toks, PS, True, 2 * PS),   # take pages 1..2
        ("peek", toks, 0), ("match", toks), ("extend", toks, PS, False, None),
        ("put", list(range(300, 300 + 2 * PS)), 0, 2, 4),
        ("put", list(range(400, 400 + 2 * PS)), 0, 2, 5),   # over budget
        ("put", list(range(500, 500 + PS)), 0, 1, 6),
        ("match", hot), ("match", toks), ("peek", toks, PS),
        ("extend", toks, 3 * PS, True, None),
        ("match", list(range(300, 300 + 2 * PS))),
    ]
    for step in script:
        op = step[0]
        if op == "put":
            _, tk, frm, n, seed = step
            ref, port = _page_pairs(n, seed, bf16)
            got = [s.put(tk, *pages, data_from_page=frm)
                   for s, pages in zip(stores, (ref, port))]
        elif op == "match":
            got = [s.match(step[1]) for s in stores]
        elif op == "peek":
            got = [s.peek(step[1], step[2]) for s in stores]
        else:
            _, tk, start, take, cap = step
            got = [s.extend(tk, start, take=take, max_tokens=cap)
                   for s in stores]
        _same(*got)
        assert stores[0].stats() == stores[1].stats(), step
        crc = [[e[:4] for e in _crcs(s)] for s in stores]
        assert crc[0] == crc[1], step
        assert [e[4] for e in _crcs(stores[0])] == \
            [e[4] for e in _crcs(stores[1])]
    s = stores[1].stats()
    assert s["evicted_pages"] > 0 and s["bytes"] <= 7 * one_page


def test_bf16_pages_round_trip_bit_exact():
    """A bf16 pool's pages spill as their bits and promote back into other
    device pages unchanged (the tier's copies on the CPU)."""
    cfg = get_config("tiny")
    cache = PagedKVCache.create(cfg, 12, PS)
    cache.k_pages = torch.randn(cache.k_pages.shape).to(torch.bfloat16)
    cache.v_pages = torch.randn(cache.v_pages.shape).to(torch.bfloat16)
    tier = HostKVTier(PS, 1 << 24)
    toks = list(range(1, 3 * PS + 1))
    before = (cache.k_pages[:, [3, 5, 7]].clone(),
              cache.v_pages[:, [3, 5, 7]].clone())
    assert tier.spill_from_device(toks, [3, 5, 7], cache) == 3
    assert tier.stats()["bytes"] == 3 * 2 * before[0][:, 0].nbytes
    free = iter([[9, 10, 11]])
    extra, pages, out = tier.promote_to_device(toks + [1], 0,
                                               lambda n: next(free), cache)
    assert (extra, pages, out) == (3 * PS, [9, 10, 11], cache)
    for pool, want in zip((cache.k_pages, cache.v_pages), before):
        got = pool[:, [9, 10, 11]]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert tier.accounting_closes() and tier.stats()["pages"] == 0


# ---- the lifecycle against the reference engine ----------------------------


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_spill_then_promote_matches_reference(weights, model):
    """An undersized pool evicts between prompts (spill); the second pass
    promotes from the host tier. Both passes give the reference engine's
    greedy tokens, the tiers move the same page counts, and every page
    stays in exactly one tier."""
    prompts = _prompts(5, 40, seed=7)
    je, te = _engines(weights, model, num_pages=24, host_tier_bytes=1 << 26)
    for n in range(2):
        want = [je.generate([p], JSampling(max_new_tokens=6))[0]
                for p in prompts]
        got = [te.generate([p], SamplingParams(max_new_tokens=6))[0]
               for p in prompts]
        assert got == want, f"pass {n + 1}"
        assert te.host_tier.stats() == je.host_tier.stats(), f"pass {n + 1}"
    s = te.host_tier.stats()
    assert s["spilled_pages"] > 0 and s["promoted_pages"] > 0
    assert te.metrics["host_hit_tokens"] == je.metrics["host_hit_tokens"] > 0
    assert te.metrics["radix_hit_tokens"] == je.metrics["radix_hit_tokens"]
    assert te.host_tier.accounting_closes()
    for p in prompts:
        d = te.radix.peek(p)
        assert not (d > 0 and te.host_tier.peek(p, 0) > 0)
        assert te.prefix_peek(p) == je.prefix_peek(p)


def test_byte_budget_under_churn_matches_reference(weights):
    """A host budget of ~4 pages: churn evicts host pages, the counts
    equal the reference's, and the accounting still closes."""
    one_page = 2 * 2 * PS * 2 * 32 * 4      # [L=2, page, KV=2, hd=32] f32 x2
    je, te = _engines(weights, "tiny", num_pages=24,
                      host_tier_bytes=4 * one_page)
    for _ in range(2):
        for p in _prompts(8, 48, seed=11):
            want = je.generate([p], JSampling(max_new_tokens=4))
            assert te.generate([p], SamplingParams(max_new_tokens=4)) == want
    s = te.host_tier.stats()
    assert s == je.host_tier.stats()
    assert s["bytes"] <= 4 * one_page and s["evicted_pages"] > 0
    assert te.host_tier.accounting_closes()


def test_spill_skips_pages_pinned_by_running_requests(weights):
    """A radix-evicted page a running request still pins (refcount > 1)
    stays on the device: only the unpinned tail spills."""
    _, tp = weights["tiny"]
    eng = Engine(EngineConfig(model="tiny", num_pages=32,
                              host_tier_bytes=1 << 26, **BASE),
                 params=tp, device="cpu")
    calls = []

    class _FakeTier:
        def spill_from_device(self, toks, ids, cache):
            calls.append(list(ids))
            return len(ids)

    eng.host_tier = _FakeTier()
    pages = eng.allocator.alloc(3)
    eng.allocator.share(pages[:2])
    eng._spill_evicted(list(range(1, 3 * PS + 1)), pages)
    assert calls == [pages[2:]]
    calls.clear()
    eng.allocator.share([pages[2]])
    eng._spill_evicted(list(range(1, 3 * PS + 1)), pages)
    assert calls == []
    assert [eng.allocator.refcount(p) for p in pages] == [2, 2, 2]


def test_host_hits_not_double_counted_when_admission_blocks(weights):
    """Two passes over six prompts with a pool that blocks admissions: the
    hit counters equal the reference's and never exceed the tokens
    submitted."""
    prompts = _prompts(6, 40, seed=41)
    je, te = _engines(weights, "tiny", num_pages=24, host_tier_bytes=1 << 26)
    for _ in range(2):
        for p in prompts:
            want = je.generate([p], JSampling(max_new_tokens=6))
            assert te.generate([p], SamplingParams(max_new_tokens=6)) == want
    for key in ("radix_hit_tokens", "host_hit_tokens", "prefill_tokens"):
        assert te.metrics[key] == je.metrics[key], key
    hits = te.metrics["radix_hit_tokens"] + te.metrics["host_hit_tokens"]
    assert hits <= 2 * sum(len(p) for p in prompts)
    assert te.metrics["host_hit_tokens"] > 0


def test_adapter_rows_skip_the_host_tier(weights):
    """A LoRA row neither promotes nor counts a tier hit."""
    _, tp = weights["tiny"]
    eng = Engine(EngineConfig(model="tiny", num_pages=24,
                              host_tier_bytes=1 << 26, **BASE),
                 params=tp, device="cpu")
    cfg = get_config("tiny")
    rng = np.random.RandomState(3)
    ad = {"wq": (rng.randn(cfg.num_layers, cfg.hidden_size, 4) * 0.01,
                 rng.randn(cfg.num_layers, 4,
                           cfg.num_heads * cfg.head_dim_) * 0.01)}
    eng.load_lora("a", {k: tuple(np.float32(x) for x in v)
                        for k, v in ad.items()})
    prompts = _prompts(5, 40, seed=7)
    for p in prompts:
        eng.generate([p], SamplingParams(max_new_tokens=6))
    assert eng.host_tier.stats()["spilled_pages"] > 0
    before = dict(eng.host_tier.stats())
    eng.generate([prompts[0]], SamplingParams(max_new_tokens=6, lora="a"))
    assert eng.host_tier.stats()["promoted_pages"] == before["promoted_pages"]
    assert eng.metrics["host_hit_tokens"] == 0


# ---- configuration, server, operator panel ---------------------------------


@pytest.mark.parametrize("over", [
    dict(host_tier_bytes=-1),
    dict(host_tier_bytes=1 << 20, kv_dtype="int8"),
    dict(host_tier_bytes=1 << 20, enable_radix_cache=False),
], ids=["negative", "int8", "no-radix"])
def test_config_refusals_match_reference(over):
    cfg = dict(model="tiny", num_pages=32, **BASE, **over)
    with pytest.raises(ValueError) as want:
        JConfig(use_pallas="never", **cfg).validate()
    with pytest.raises(ValueError) as got:
        EngineConfig(**cfg).validate()
    assert str(got.value) == str(want.value)


def test_mla_pools_take_the_tier_int8_does_not(weights):
    _, tp = weights["tiny-mla"]
    eng = Engine(EngineConfig(model="tiny-mla", num_pages=24,
                              host_tier_bytes=1 << 20, **BASE),
                 params=tp, device="cpu")
    assert eng.host_tier is not None


def test_server_flag_and_metrics_carry_the_tier(weights):
    from rbg_tpu_torch.engine.protocol import request_obj
    from rbg_tpu_torch.engine.server import (build_config, parse_args,
                                             start_server)
    from rbg_tpu_torch.engine.service import EngineService

    args = parse_args(["--device", "cpu", "--host-tier-bytes", "4096"])
    assert build_config(args).host_tier_bytes == 4096
    assert parse_args(["--device", "cpu"]).host_tier_bytes == 0
    svc = EngineService(EngineConfig(model="tiny", num_pages=24,
                                     host_tier_bytes=1 << 26, device="cpu",
                                     **BASE))
    srv = start_server(svc)
    try:
        for p in _prompts(6, 40, seed=37):
            r = request_obj(srv.addr, {"op": "generate", "prompt": p,
                                        "max_new_tokens": 4}, timeout=60)
            assert len(r["tokens"]) == 4
        m = request_obj(srv.addr, {"op": "metrics"}, timeout=10)["metrics"]
        assert m["host_tier"] == svc.engine.host_tier.stats()
        assert m["host_tier"]["spilled_pages"] > 0
        assert m["device_tier_pages"] == svc.engine.radix.cached_pages
        assert request_obj(srv.addr, {"op": "health"}, timeout=10)["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.stop()


def test_slo_cache_panel_has_the_reference_keys(weights):
    from rbg_tpu.obs.slo import slo_response as j_slo
    from rbg_tpu_torch.obs.slo import slo_response

    je, te = _engines(weights, "tiny", num_pages=24, host_tier_bytes=1 << 26)
    for p in _prompts(6, 40, seed=37):
        je.generate([p], JSampling(max_new_tokens=4))
        te.generate([p], SamplingParams(max_new_tokens=4))
    want, got = j_slo(60)["cache"], slo_response(60)["cache"]

    def shape(d):
        return {k: shape(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert got and shape(got) == shape(want)
    assert set(got["tiers"]) == {"device", "host"}
    assert got["tiers"]["host"]["pages"] == float(
        te.host_tier.stats()["pages"])
