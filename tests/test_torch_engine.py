"""rbg_tpu_torch's Engine against rbg_tpu's Engine on the same converted
weights (tiny preset, float32, CPU): greedy tokens must be identical under
staggered joins, preemption, a radix-cache hit and a multi-step decode
window, and sampled streams identical too. A differing greedy token is
reported with the top-2 logit gap at that step; the comparison itself is
exact."""

import itertools

import jax
import numpy as np
import pytest
import torch

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.engine import Request as JRequest
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine, Request
from rbg_tpu_torch.engine.kvcache import PagedKVCache
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import forward_ragged

BASE = dict(model="tiny", page_size=8, max_batch=4, max_seq_len=128,
            prefill_chunk=16)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"), "cpu")
    return jp, tp


def _drive(engine, sampling_cls, schedule):
    """schedule: [(step index at which to add, prompt, max_new_tokens)].
    Steps until idle; returns tokens per schedule entry."""
    ids, out, step = {}, {}, 0
    pending = sorted(enumerate(schedule), key=lambda e: e[1][0])
    while pending or engine.has_work():
        while pending and pending[0][1][0] <= step:
            i, (_, prompt, n) = pending.pop(0)
            ids[engine.add_request(prompt, sampling_cls(max_new_tokens=n))] = i
            out[i] = []
        for ev in engine.step():
            out[ids[ev.request_id]].append(ev.token)
        step += 1
    return [out[i] for i in range(len(schedule))]


def _top2_gap(tp, cfg, seq):
    """Top-2 logit gap of the next token after ``seq`` (port, one pack on
    a model-dtype pool)."""
    n = len(seq)
    P = -(-n // 8)
    cache = PagedKVCache.create(cfg, P + 1, 8)
    logits = forward_ragged(
        tp, cfg, torch.tensor([seq]), torch.arange(n, dtype=torch.int32)[None],
        torch.ones(1, n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32),
        torch.arange(1, P + 1, dtype=torch.int32)[None], cache.k_pages,
        cache.v_pages)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _compare(weights, schedule, **cfg):
    jp, tp = weights
    cfg = {**BASE, **cfg}
    je = JEngine(JConfig(use_pallas="never", **cfg), params=jp)
    te = Engine(EngineConfig(**cfg), params=tp, device="cpu")
    want = _drive(je, JSampling, schedule)
    got = _drive(te, SamplingParams, schedule)
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            j = next(k for k in range(len(w)) if k >= len(g) or w[k] != g[k])
            gap = _top2_gap(tp, te.mcfg, schedule[i][1] + w[:j])
            pytest.fail(f"request {i}: token {j} differs (jax {w[j]}, torch "
                        f"{g[j:j + 1]}); top-2 logit gap there {gap:.3g}")
    return je, te


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=n).tolist() for n in lens]


@pytest.mark.parametrize("multi_step", [1, 4])
def test_staggered_joins_match_jax(weights, multi_step):
    """Requests join a running batch at later steps (unified steps mixing
    decode rows with prefill chunks, then pure-decode windows)."""
    p = _prompts(0, (5, 40, 17, 3, 30))
    schedule = [(0, p[0], 12), (0, p[1], 6), (2, p[2], 9), (3, p[3], 5),
                (7, p[4], 8)]
    je, te = _compare(weights, schedule, num_pages=64, multi_step=multi_step)
    assert te.metrics["unified_steps"] == je.metrics["unified_steps"]


def test_preemption_matches_jax(weights):
    """A pool too small for the batch: the youngest is preempted and
    resumes where it left off, in both engines alike."""
    p = _prompts(1, (20, 22, 18))
    schedule = [(0, p[0], 30), (0, p[1], 30), (1, p[2], 30)]
    je, te = _compare(weights, schedule, num_pages=12, enable_radix_cache=False)
    assert te.metrics["preemptions"] == je.metrics["preemptions"] > 0


def test_radix_hit_matches_jax(weights):
    """The same prompt again after the first finished: the second prefill
    starts from cached pages."""
    p = _prompts(2, (35,))[0]
    schedule = [(0, p, 6), (12, p, 6), (12, p[:20] + [7, 8, 9], 4)]
    je, te = _compare(weights, schedule, num_pages=64)
    assert te.metrics["radix_hit_tokens"] == je.metrics["radix_hit_tokens"] > 0


def test_sampled_streams_are_reproducible(weights):
    """Seeded sampling is a pure function of (seed, position): the same
    request twice gives the same tokens, in one batch or alone."""
    _, tp = weights
    te = Engine(EngineConfig(**BASE, num_pages=64, multi_step=2), params=tp,
                device="cpu")
    p = _prompts(3, (9, 14))
    sp = SamplingParams(max_new_tokens=10, temperature=0.9, top_k=40, seed=5)
    both = te.generate(p, sp)
    alone = te.generate([p[1]], sp)
    assert both[1] == alone[0] and len(both[0]) == 10


@pytest.mark.parametrize("multi_step", [1, 4])
def test_sampled_streams_match_jax(weights, monkeypatch, multi_step):
    """Sampled requests, seeded and unseeded (keyed by request id), with
    top-k and top-p: token for token the reference's streams, because the
    port's keys and Gumbel noise are JAX's threefry bit for bit."""
    jp, tp = weights
    cfg = dict(BASE, num_pages=64, multi_step=multi_step, seed=3)
    engines = (JEngine(JConfig(use_pallas="never", **cfg), params=jp),
               Engine(EngineConfig(**cfg), params=tp, device="cpu"))
    p = _prompts(3, (9, 14, 30, 5))
    streams = []
    for eng, req_cls, sampling_cls in zip(engines, (JRequest, Request),
                                          (JSampling, SamplingParams)):
        # The same request ids in both engines: unseeded rows fold them in.
        monkeypatch.setattr(req_cls, "_ids", itertools.count(100))
        ids = [eng.add_request(pr, sampling_cls(
            max_new_tokens=12, temperature=0.9, top_k=40,
            top_p=0.95 if i == 2 else 1.0, seed=5 if i % 2 == 0 else None))
            for i, pr in enumerate(p)]
        out = {i: [] for i in ids}
        while eng.has_work():
            for ev in eng.step():
                out[ev.request_id].append(ev.token)
        streams.append([out[i] for i in ids])
    assert streams[0] == streams[1]
    assert streams[1][0] != streams[1][2]       # seeded alike, other prompts


@pytest.mark.parametrize("bad,exc", [
    # The PD modes are ported; with int8 KV they are refused as the
    # reference refuses them (bundles carry unquantized pages).
    (dict(mode="prefill", kv_dtype="int8"), ValueError),
    # The host tier is ported; with int8 KV it is refused as the
    # reference refuses it.
    (dict(host_tier_bytes=1 << 20, kv_dtype="int8"), ValueError),
    (dict(mode="decode", kv_dtype="int8"), ValueError)], ids=["bad0", "bad1", "bad2"])
def test_unsupported_configs_raise(bad, exc):
    with pytest.raises(exc):
        Engine(EngineConfig(**{**BASE, **bad}), device="cpu")


@pytest.mark.parametrize("page_size,device", [
    (128, None), (24, "cuda"), (48, "cuda:0"), (128, "cpu"), (32, "cuda"), (8, None),
    (96, "cpu")])
def test_page_size_checked_at_start_up_for_the_card(page_size, device):
    """Every page size is accepted at start-up, on the card's device
    strings (None means the card) as on the CPU: kernels A-H look up each
    slot's page, so their KV blocks may span pages of any size.
    EngineConfig.validate reads no device; the CPU serves the page size."""
    cfg = EngineConfig(**{**BASE, "page_size": page_size}, num_pages=64, device=device)
    cfg.validate()
    if device == "cpu":     # the plain versions serve it
        out = Engine(cfg).generate(_prompts(5, (7, 30)), SamplingParams(max_new_tokens=4))
        assert [len(o) for o in out] == [4, 4]


def test_mla_int8_latent_pools_serve():
    """tiny-mla with kv_dtype='int8' builds int8 latent pools with f32
    scales [L, NP, page, 1, 1] and serves a request."""
    te = Engine(EngineConfig(**{**BASE, "model": "tiny-mla"}, kv_dtype="int8",
                             num_pages=32), device="cpu")
    cfg = te.mcfg
    c = te.cache
    assert c.quantized and c.k_pages.dtype == c.v_pages.dtype == torch.int8
    assert tuple(c.k_pages.shape) == (cfg.num_layers, 32, 8, 1, cfg.kv_lora_rank)
    assert tuple(c.v_pages.shape) == (cfg.num_layers, 32, 8, 1, cfg.qk_rope_head_dim)
    assert tuple(c.k_scales.shape) == tuple(c.v_scales.shape) == (cfg.num_layers, 32, 8, 1, 1)
    out = te.generate(_prompts(4, (11, 20)), SamplingParams(max_new_tokens=5))
    assert [len(o) for o in out] == [5, 5]
    assert bool(c.k_scales.abs().sum() > 0)


@pytest.mark.parametrize("field", [dict(json_mode=True), dict(regex="a+"),
                                   dict(json_schema={})])
def test_unsupported_sampling_raises(weights, field):
    """A constrained request on an engine whose grammar was never wired
    (enable_json_grammar) is refused at admission, as the reference
    refuses it."""
    te = Engine(EngineConfig(**BASE), params=weights[1], device="cpu")
    je = JEngine(JConfig(use_pallas="never", **BASE), params=weights[0])
    with pytest.raises(ValueError) as want:
        je.add_request([1, 2, 3], JSampling(**field))
    with pytest.raises(ValueError, match="require a grammar table") as got:
        te.add_request([1, 2, 3], SamplingParams(**field))
    assert str(got.value) == str(want.value)
    assert not te.waiting


@pytest.mark.parametrize("make", [
    lambda m: m.EngineConfig(model="nope").validate(),
    lambda m: m.EngineConfig(model="tiny", grammar_table="maybe").validate(),
    lambda m: m.EngineConfig(model="tiny", grammar_state_budget=1).validate(),
    lambda m: m.SamplingParams(json_mode=True, regex="a").validate(),
    lambda m: m.SamplingParams(regex="a", json_schema={}).validate(),
], ids=["unknown_preset", "grammar_table", "state_budget", "json_and_regex",
        "regex_and_schema"])
def test_validate_matches_reference(make):
    """validate refuses what the reference's refuses, with its exception
    type and message: an unknown preset (KeyError, before a server binds
    its port), two grammar constraints, a bad grammar_table, a budget
    below 2."""
    import rbg_tpu.engine.config as jcfg
    import rbg_tpu_torch.engine.config as tcfg

    with pytest.raises((KeyError, ValueError)) as want:
        make(jcfg)
    with pytest.raises((KeyError, ValueError)) as got:
        make(tcfg)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_server_with_unknown_preset_exits_before_listening():
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "rbg_tpu_torch.engine.server", "--model", "nope",
         "--device", "cpu", "--port", "0"], cwd=root, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": root})
    assert r.returncode != 0
    assert "engine listening" not in r.stdout
    assert "unknown model preset 'nope'" in r.stderr
