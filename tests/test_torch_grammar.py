"""The port's grammar-constrained decoding against rbg_tpu's: the grammar
module (masks, transitions and compiled token tables on every reachable
state, the same ValueErrors), and the engines token for token on the
same converted weights (tiny, vocab 512, float32, CPU) with regex,
json_schema and json_mode rows mixed with free rows, greedy and seeded,
through the fused window, the K = 0 verify, the unified step, the split
prefill step, the n-gram verify and a preemption."""

import itertools
import json
import re

import jax
import numpy as np
import pytest

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine import grammar as jg
from rbg_tpu.engine.engine import Request as JRequest
from rbg_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine import grammar as tg
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine, Request
from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy

TOK = ByteTokenizer()
EOS = TOK.eos_id
SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"},
    "state": {"enum": ["on", "off"]},
}}
NESTED = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 2},
    "n": {"type": "number"},
}}
GRAMMARS = {
    "phone": lambda m: m.RegexGrammar(r"\d{3}-\d{4}"),
    "http": lambda m: m.RegexGrammar(r"(GET|POST) /[a-z/]{0,6} HTTP"),
    "ab": lambda m: m.RegexGrammar(r"[ab]{1,4}c"),
    "words": lambda m: m.RegexGrammar(r"(alpha|beta|gamma)"),
    "empty": lambda m: m.RegexGrammar(""),
    "schema": lambda m: m.JsonSchemaGrammar(SCHEMA),
    "nested": lambda m: m.JsonSchemaGrammar(NESTED),
}


def _token_grammars(name):
    jt = jg.TokenGrammar(GRAMMARS[name](jg), jg.token_bytes_for(JByteTokenizer()),
                         EOS)
    pt = tg.TokenGrammar(GRAMMARS[name](tg), tg.token_bytes_for(TOK), EOS)
    return jt, pt


def test_token_bytes_equal_reference():
    assert tg.token_bytes_for(TOK) == jg.token_bytes_for(JByteTokenizer())


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_grammar_tables_match_reference(name):
    """compile_token_table at vocab 512, and on every state it reaches the
    port's mask and advance_token equal the reference's; budgets just
    below and at the state count give the same None / table."""
    jt, pt = _token_grammars(name)
    a = jg.compile_token_table(jt, 512, vocab_size=512)
    b = tg.compile_token_table(pt, 512, vocab_size=512)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a.next_state, b.next_state)
    np.testing.assert_array_equal(a.legal, b.legal)
    assert a.state_ids == b.state_ids
    for state, sid in b.state_ids.items():
        m = pt.mask(state)
        np.testing.assert_array_equal(m, jt.mask(state))
        np.testing.assert_array_equal(b.legal[sid, :len(m)], m)
        for v in np.nonzero(m)[0]:
            assert pt.advance_token(state, int(v)) == jt.advance_token(state, int(v))
    assert pt.advance_token(pt.initial(), EOS) == jt.advance_token(jt.initial(), EOS)
    n = b.num_states
    for budget in (max(2, n - 1), n):
        ra = jg.compile_token_table(jt, budget, vocab_size=512)
        rb = tg.compile_token_table(pt, budget, vocab_size=512)
        assert (ra is None) == (rb is None)
        if rb is not None:
            np.testing.assert_array_equal(ra.next_state, rb.next_state)


def test_pushdown_json_masks_match_reference():
    """The json_mode grammar has no finite table: its masks and
    transitions equal the reference's along a walk through a document."""
    jt = jg.TokenGrammar(jg.JsonGrammar(), jg.token_bytes_for(JByteTokenizer()), EOS)
    pt = tg.TokenGrammar(tg.JsonGrammar(), tg.token_bytes_for(TOK), EOS)
    sj, sp = jt.initial(), pt.initial()
    for ch in b'{"a": [1, -2.5e3, true, null], "b": {"c": "x\\n"}}':
        np.testing.assert_array_equal(pt.mask(sp), jt.mask(sj))
        sj, sp = jt.advance_token(sj, ch), pt.advance_token(sp, ch)
        assert sp == sj and sp is not None
    assert pt.grammar.is_complete(sp) and pt.mask(sp)[EOS]


@pytest.mark.parametrize("ctor,bad", [
    *[("RegexGrammar", b) for b in ("(open", "a{3,1}", "[z-a]", "*lead",
                                    "x{bad}", "[unterm", "trail\\", r"\bfoo")],
    *[("JsonSchemaGrammar", b) for b in (
        {"$ref": "#/x"}, {"allOf": []}, {"type": "frob"}, {"enum": []},
        {"type": "array"}, {"type": "array", "minItems": 3, "maxItems": 1},
        {"anyOf": []}, {"type": "object", "properties": {"a": True}},
        "not a dict")],
])
def test_unsupported_constructs_raise_alike(ctor, bad):
    with pytest.raises(ValueError) as want:
        getattr(jg, ctor)(bad)
    with pytest.raises(ValueError) as got:
        getattr(tg, ctor)(bad)
    assert str(got.value) == str(want.value)


# ---- the engines ----


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny", vocab_size=512), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           get_config("tiny", vocab_size=512), "cpu")
    return jp, tp


BASE = dict(model="tiny", vocab_size=512, page_size=8, num_pages=128,
            max_seq_len=256, prefill_chunk=16)


def _engines(weights, **kw):
    jp, tp = weights
    cfg = {**BASE, **kw}
    je = JEngine(JConfig(use_pallas="never", **cfg), params=jp)
    je.enable_json_grammar(JByteTokenizer())
    te = Engine(EngineConfig(**cfg), params=tp, device="cpu")
    te.enable_json_grammar(TOK)
    return je, te


def _mixed(cls):
    """Regex, json_schema and json_mode rows beside free rows, greedy and
    seeded."""
    enc = lambda s: TOK.encode(s, add_bos=False)  # noqa: E731
    return [
        (enc("e:"), cls(max_new_tokens=40, temperature=0.9, seed=1,
                        json_schema=SCHEMA, stop_token=EOS)),
        (enc("v:"), cls(max_new_tokens=12, regex=r"\d{3}-\d{4}", stop_token=EOS)),
        ([1, 2, 3], cls(max_new_tokens=10)),
        (enc("j:"), cls(max_new_tokens=16, temperature=0.7, seed=3,
                        json_mode=True, stop_token=EOS)),
        (enc("w:"), cls(max_new_tokens=10, temperature=0.9, seed=7,
                        regex=r"(alpha|beta|gamma)", stop_token=EOS)),
        (enc("s:"), cls(max_new_tokens=30, json_schema=SCHEMA, stop_token=EOS)),
        ([9, 8, 7, 6], cls(max_new_tokens=8, temperature=0.8, seed=5)),
    ]


def _run(eng, req_cls, reqs, monkeypatch):
    monkeypatch.setattr(req_cls, "_ids", itertools.count(100))
    ids = [eng.add_request(p, sp) for p, sp in reqs]
    out = {i: [] for i in ids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append(ev.token)
    return [out[i] for i in ids]


def _check_legal(reqs, streams):
    """Every constrained token is accepted by the port's grammar; regex
    rows that ended on EOS fullmatch, schema rows parse and conform."""
    eng = Engine(EngineConfig(**{**BASE, "num_pages": 8}), device="cpu")
    eng.enable_json_grammar(TOK)
    for (_, sp), out in zip(reqs, streams):
        g = eng._grammar_for(sp)
        if g is None:
            continue
        s = g.initial()
        for t in out:
            s2 = g.advance_token(s, t)
            assert s2 is not None or t == EOS, (sp, out)
            s = s2 if s2 is not None else s
        if out and out[-1] == EOS:
            text = TOK.decode(out[:-1])
            if sp.regex is not None:
                assert re.fullmatch(sp.regex, text)
            elif sp.json_schema:
                doc = json.loads(text)
                assert set(doc) == {"id", "state"} and doc["state"] in ("on", "off")
            else:
                json.loads(text)


@pytest.mark.parametrize("kw", [
    dict(multi_step=4),
    dict(multi_step=1),
    dict(multi_step=4, ragged="off"),
    dict(multi_step=4, grammar_table="off"),
    # The schema (28 states) over the budget, the regexes (9, 15) within.
    dict(multi_step=4, grammar_state_budget=20),
    dict(speculative="ngram"),
], ids=["window4", "window1", "split", "tables_off", "budget_fallback", "ngram"])
def test_engine_tokens_match_reference(weights, monkeypatch, kw):
    je, te = _engines(weights, **kw)
    reqs = _mixed(SamplingParams)
    want = _run(je, JRequest, _mixed(JSampling), monkeypatch)
    got = _run(te, Request, reqs, monkeypatch)
    assert got == want
    _check_legal(reqs, got)
    for k in ("spec_steps", "preemptions"):
        assert te.metrics[k] == je.metrics[k], k
    # json_mode (and every grammar row with tables off or over the budget)
    # took the K = 0 verify, tabled rows the window; under ngram the verify
    # owns every row, and speculative mode and ragged="off" take the split
    # prefill step instead of the unified one.
    assert te.metrics["spec_steps"] > 0
    spec = kw.get("speculative") == "ngram"
    assert (te.metrics["decode_windows"] > 0) != spec
    split = spec or kw.get("ragged") == "off"
    assert (te.metrics["unified_steps"] > 0) != split


def test_preemption_mid_stream_matches_reference(weights, monkeypatch):
    """A pool small enough that growing grammar rows preempt each other:
    gstate survives the preemption (output folded into the prompt), the
    window state is rebuilt from it, and the streams stay the reference's."""
    def reqs(cls):
        return [
            (TOK.encode("a:", add_bos=False),
             cls(max_new_tokens=80, temperature=0.9, seed=11,
                 regex=r"[ab]{60,}c", stop_token=EOS)),
            (TOK.encode("b:", add_bos=False),
             cls(max_new_tokens=80, temperature=0.9, seed=12,
                 regex=r"[cd]{60,}e", stop_token=EOS)),
            ([4, 5, 6], cls(max_new_tokens=60)),
        ]
    je, te = _engines(weights, multi_step=4, num_pages=24, enable_radix_cache=False)
    want = _run(je, JRequest, reqs(JSampling), monkeypatch)
    got = _run(te, Request, reqs(SamplingParams), monkeypatch)
    assert got == want
    assert te.metrics["preemptions"] == je.metrics["preemptions"] > 0
    assert re.fullmatch(r"[ab]{60,}c?", TOK.decode([t for t in got[0] if t != EOS]))


def test_device_tables_cached_and_counted(weights):
    """One grammar's block is used as it is (pow-2 states); two grammars
    concatenate once per combination, order-insensitive; the bytes held
    count both; a grammar over the budget has no table."""
    _, te = _engines(weights, grammar_state_budget=64)
    g1 = te._grammar_for(SamplingParams(regex=r"\d+"))
    g2 = te._grammar_for(SamplingParams(regex=r"[a-f]+"))
    n1, l1, off1 = te._device_grammar_tables([g1, g2])
    n2, l2, off2 = te._device_grammar_tables([g2, g1])
    assert n1 is n2 and l1 is l2 and off1 is off2 and set(off1) == {id(g1), id(g2)}
    s1 = te._grammar_dev_block(g1)[0].shape[0]
    assert s1 & (s1 - 1) == 0 and n1.shape[0] >= s1
    ns, _, offs = te._device_grammar_tables([g1])
    assert ns is te._grammar_dev_block(g1)[0] and offs == {id(g1): 0}
    blocks = sum(t.numel() * t.element_size()
                 for g in (g1, g2) for t in te._grammar_dev_block(g))
    assert te.grammar_table_bytes() == 2 * blocks
    big = te._grammar_for(SamplingParams(regex=r"[ab]{1,100}c"))
    assert te._grammar_table(big) is None and te._grammar_table(te.grammar) is None
