"""rbg_tpu_torch's Engine against rbg_tpu's Engine on the same converted
weights (tiny preset, float32, CPU): greedy tokens must be identical under
staggered joins, preemption, a radix-cache hit and a multi-step decode
window. A differing token is reported with the top-2 logit gap at that
step; the comparison itself is exact."""

import jax
import numpy as np
import pytest
import torch

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
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


def _top2_gap(tp, seq):
    """Top-2 logit gap of the next token after ``seq`` (port, one pack)."""
    cfg = get_config("tiny")
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
    je = JEngine(JConfig(use_pallas="never", **BASE, **cfg), params=jp)
    te = Engine(EngineConfig(**BASE, **cfg), params=tp, device="cpu")
    want = _drive(je, JSampling, schedule)
    got = _drive(te, SamplingParams, schedule)
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            j = next(k for k in range(len(w)) if k >= len(g) or w[k] != g[k])
            gap = _top2_gap(tp, schedule[i][1] + w[:j])
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


@pytest.mark.parametrize("bad", [
    dict(kv_dtype="int8"), dict(speculative="ngram"), dict(mode="prefill"),
    dict(ragged="off"), dict(host_tier_bytes=1 << 20), dict(model="tiny-mla"),
    dict(model="tiny-moe")])
def test_unsupported_configs_raise(bad):
    with pytest.raises(NotImplementedError):
        Engine(EngineConfig(**{**BASE, **bad}), device="cpu")


@pytest.mark.parametrize("field", [dict(json_mode=True), dict(regex="a+"),
                                   dict(json_schema={}), dict(lora="x")])
def test_unsupported_sampling_raises(weights, field):
    te = Engine(EngineConfig(**BASE), params=weights[1], device="cpu")
    with pytest.raises(NotImplementedError):
        te.add_request([1, 2, 3], SamplingParams(**field))
