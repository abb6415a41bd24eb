"""Speculative decoding in rbg_tpu_torch against rbg_tpu's on the CPU
(mirroring tests/test_speculative.py): the port's ``NGramIndex`` drafts
what the reference's drafts on seeded sequences, and the port's
speculative engine streams, token for token, what the reference's
speculative engine and the port's own non-speculative engine stream,
greedy and seeded-sampled, with penalties, logprobs, a stop token and a
forced preemption. Weights are the reference's tiny init, converted."""

import itertools

import jax
import numpy as np
import pytest

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.engine import Request as JRequest
from rbg_tpu.engine.spec import NGramIndex as JNGramIndex
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine, Request
from rbg_tpu_torch.engine.spec import NGramIndex
from test_torch_engine import weights  # noqa: F401 — the module fixture

BASE = dict(model="tiny", page_size=8, num_pages=128, max_seq_len=256,
            enable_radix_cache=False)
REP_PROMPT = [1, 2, 3, 4] * 8


# ---- NGramIndex ----


def test_ngram_reference_cases():
    idx = NGramIndex(2)
    idx.extend([1, 2, 3, 1, 2])
    assert idx.draft(2) == [3, 1]
    idx.append(3)
    assert idx.draft(3) == [1, 2, 3]
    idx = NGramIndex(3)
    idx.extend([5, 6, 7])
    assert idx.draft(4) == []
    idx = NGramIndex(1)
    idx.extend([4, 4, 4])
    assert idx.draft(2) == [4]
    idx = NGramIndex(2)
    idx.extend([1, 2, 9, 5, 1, 2, 7, 3, 1, 2])
    assert idx.draft(1) == [7]
    with pytest.raises(ValueError):
        NGramIndex(0)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_drafts_match_jax_on_seeded_sequences(seed):
    """After every appended token of a seeded low-alphabet sequence, both
    indexes draft the same tokens for every k."""
    rng = np.random.RandomState(seed)
    n = 1 + seed % 3
    seq = rng.randint(0, 4 + seed, size=200).tolist()
    ours, ref = NGramIndex(n), JNGramIndex(n)
    for tok in seq:
        ours.append(tok)
        ref.append(tok)
        for k in (1, 3, 5):
            assert ours.draft(k) == ref.draft(k)


# ---- engines ----


def _engines(weights, **kw):
    """(reference speculative, port speculative, port non-speculative)."""
    jp, tp = weights
    cfg = {**BASE, **kw}
    small = cfg.pop("spec_num_pages", None)
    spec = dict(cfg, speculative="ngram")
    if small:
        spec["num_pages"] = small
    return (JEngine(JConfig(use_pallas="never", **spec), params=jp),
            Engine(EngineConfig(**spec), params=tp, device="cpu"),
            Engine(EngineConfig(**cfg), params=tp, device="cpu"))


def _streams(monkeypatch, engines, prompts, sp):
    """Each engine's tokens and logprobs per prompt, the same request ids in
    every engine (unseeded rows fold them into their keys)."""
    out = []
    for eng in engines:
        is_ref = isinstance(eng, JEngine)
        monkeypatch.setattr(JRequest if is_ref else Request, "_ids",
                            itertools.count(100))
        sampling = (JSampling if is_ref else SamplingParams)(**sp)
        ids = [eng.add_request(p, sampling) for p in prompts]
        toks = {i: [] for i in ids}
        lps = {i: [] for i in ids}
        while eng.has_work():
            for ev in eng.step():
                toks[ev.request_id].append(ev.token)
                lps[ev.request_id].append(ev.logprob)
        out.append(([toks[i] for i in ids], [lps[i] for i in ids]))
    return out


SAMPLINGS = {
    "greedy": dict(max_new_tokens=24),
    "sampled": dict(max_new_tokens=24, temperature=1.0, top_p=0.9, seed=3),
    "sampled_unseeded_topk": dict(max_new_tokens=16, temperature=0.7, top_k=5),
}


@pytest.mark.parametrize("kind", sorted(SAMPLINGS))
def test_spec_streams_match_jax_and_non_spec(weights, monkeypatch, kind):
    """A batch of a repetitive prompt and two others: the port's
    speculative streams equal the reference's speculative streams and the
    port's non-speculative ones, and drafts were accepted (greedy)."""
    engines = _engines(weights)
    prompts = [REP_PROMPT, [9, 8, 7, 6, 5], [4] * 8]
    (ref, _), (got, _), (plain, _) = _streams(monkeypatch, engines, prompts,
                                              SAMPLINGS[kind])
    assert got == ref
    assert got == plain
    je, te, _ = engines
    for k in ("spec_drafted", "spec_accepted", "spec_steps"):
        assert te.metrics[k] == je.metrics[k], k
    assert te.metrics["spec_accepted"] <= te.metrics["spec_drafted"]
    if kind == "greedy":
        assert te.metrics["spec_accepted"] > 0


def test_spec_penalties_never_draft_but_match(weights, monkeypatch):
    """Penalized rows never draft and ride the verify one token a step,
    equal to the sequential streams."""
    engines = _engines(weights)
    sp = dict(max_new_tokens=12, presence_penalty=1e9, frequency_penalty=0.5,
              repetition_penalty=1.3)
    (ref, _), (got, _), (plain, _) = _streams(monkeypatch, engines, [REP_PROMPT], sp)
    assert got == ref == plain
    te = engines[1]
    assert te.metrics["spec_drafted"] == 0 and te.metrics["spec_steps"] > 0
    assert len(set(got[0])) == len(got[0])


def test_spec_logprobs_match(weights, monkeypatch):
    engines = _engines(weights)
    sp = dict(max_new_tokens=10, logprobs=True)
    (ref, rlp), (got, glp), (plain, plp) = _streams(monkeypatch, engines,
                                                    [REP_PROMPT], sp)
    assert got == ref == plain
    assert all(lp is not None and lp <= 0 for lp in glp[0])
    np.testing.assert_allclose(glp[0], rlp[0], atol=1e-4)
    np.testing.assert_allclose(glp[0], plp[0], atol=1e-4)


def test_spec_stop_token(weights, monkeypatch):
    """Stop on the 3rd greedy token: the speculative streams cut where the
    sequential one does, though the verify accepted tokens past it."""
    _, tp = weights
    base = Engine(EngineConfig(**BASE), params=tp, device="cpu").generate(
        [REP_PROMPT], SamplingParams(max_new_tokens=10))[0]
    sp = dict(max_new_tokens=10, stop_token=base[2])
    (ref, _), (got, _), (plain, _) = _streams(monkeypatch, _engines(weights),
                                              [REP_PROMPT], sp)
    assert got == ref == plain
    assert got[0][-1] == base[2] and len(got[0]) <= 3


def test_spec_preemption_matches(weights, monkeypatch):
    """A pool of 10 pages forces preemption mid-speculation (drafts shed
    first); the streams still equal an unconstrained sequential engine's."""
    engines = _engines(weights, spec_num_pages=10)
    sp = dict(max_new_tokens=16, seed=5, temperature=1.0)
    prompts = [[1, 2, 3, 4] * 4, [5, 6, 7, 8] * 4, [2, 4, 6, 8] * 4]
    (ref, _), (got, _), (plain, _) = _streams(monkeypatch, engines, prompts, sp)
    assert got == ref == plain
    je, te, _ = engines
    assert te.metrics["preemptions"] == je.metrics["preemptions"] > 0


def test_spec_config_validation():
    for cfg_cls in (JConfig, EngineConfig):
        with pytest.raises(ValueError, match="mutually exclusive"):
            cfg_cls(model="tiny", speculative="ngram", multi_step=4).validate()
        with pytest.raises(ValueError, match="speculative"):
            cfg_cls(model="tiny", speculative="eagle").validate()
        for bad in (dict(spec_k=0), dict(spec_ngram=0)):
            with pytest.raises(ValueError, match="spec_k and spec_ngram"):
                cfg_cls(model="tiny", speculative="ngram", **bad).validate()
