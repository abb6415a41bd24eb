"""The port's serving surface against rbg_tpu's on the CPU (tiny, float32):
bench_serving's percentiles and the SLO verdicts, the metric and span
names, the admission gates (estimated wait, early rejection, the queue
bound) on scripted histories, deadline drops and aborts, the join
accounting and prefix peek, the tokenizers, gqa_attention and the
embeddings path, SLO judging and tracing in the service, and the
bench_serving / bench_slo entry points."""

import json
import math
import time

import jax
import numpy as np
import pytest
import torch

from rbg_tpu.engine import bench_serving as j_bench
from rbg_tpu.engine import tokenizer as j_tok
from rbg_tpu.engine.config import EngineConfig as JConfig
from rbg_tpu.engine.config import SamplingParams as JSampling
from rbg_tpu.engine.engine import Engine as JEngine
from rbg_tpu.engine.protocol import Overloaded as JOverloaded
from rbg_tpu.engine.service import EngineService as JService
from rbg_tpu.engine.service import embed_prompts as j_embed_prompts
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import encode_hidden as j_encode_hidden
from rbg_tpu.obs import names as j_names
from rbg_tpu.obs.slo import SLOTargets as JTargets
from rbg_tpu.ops.attention import gqa_attention as j_gqa
from rbg_tpu_torch.engine import bench_serving, bench_slo, tokenizer
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.protocol import (CODE_DEADLINE, CODE_OVERLOADED,
                                           DeadlineExceeded, Overloaded)
from rbg_tpu_torch.engine import service as service_mod
from rbg_tpu_torch.engine.service import (EMBED_MAX_BATCH, EMBED_SCORE_BYTES,
                                          EngineService, _chunk_bucket,
                                          _embed_spans, embed_prompts)
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import encode_hidden
from rbg_tpu_torch.obs import names, trace
from rbg_tpu_torch.obs.slo import SLOTargets
from rbg_tpu_torch.ops.attention import gqa_attention

EMBED_ATOL = 1e-4


def _weights(model):
    jp = j_init(j_get_config(model), jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(model),
                                 "cpu")


@pytest.fixture(scope="module")
def tiny_weights():
    return _weights("tiny")


# ---- percentiles, verdicts, names ----


def test_percentile_and_slo_verdicts_match_reference():
    rng = np.random.default_rng(0)
    for xs in ([], [1.0], [1.0, 2.0, 3.0], rng.random(17).tolist()):
        for p in (0, 1, 50, 90, 99, 100):
            a, b = bench_serving._percentile(xs, p), j_bench._percentile(xs, p)
            assert (math.isnan(a) and math.isnan(b)) or a == b
    values = (None, 0.0, 0.05, 0.2, 0.5, 2.0, 3.0)
    for tt in (0.0, 0.2, 2.0):
        for tp in (0.0, 0.1, 0.5):
            port, ref = SLOTargets(tt, tp), JTargets(tt, tp)
            for a in values:
                for b in values:
                    assert port.verdict(a, b) == ref.verdict(a, b)


def test_obs_names_equal_reference():
    mine = {k: v for k, v in vars(names).items()
            if k.isupper() and isinstance(v, str)}
    assert set(mine.values()) == names.ALL_NAMES | names.SPANS
    for k, v in mine.items():
        assert getattr(j_names, k) == v, k
    assert names.SPANS <= j_names.SPANS
    assert names.COUNTERS <= j_names.COUNTERS
    assert names.GAUGES <= j_names.GAUGES
    assert names.HISTOGRAMS <= j_names.HISTOGRAMS


def test_sampler_reads_counter_rates_and_histogram_means():
    """The process-wide sampler at its fixed 2 s interval and 330 s ring:
    growth between two snapshots reads as a positive rate and a mean, and
    an uncataloged ``rbg_*`` name raises instead of reading 0."""
    from rbg_tpu_torch.obs import timeseries
    from rbg_tpu_torch.obs.metrics import REGISTRY

    s = timeseries.SAMPLER
    s.sample_now()
    REGISTRY.inc(names.SERVING_TOKENS_TOTAL, 30.0, service="sampler-test")
    REGISTRY.observe(names.SLO_TTFT_SECONDS, 0.25, component="sampler-test")
    time.sleep(0.01)
    s.sample_now()
    assert s.rate(names.SERVING_TOKENS_TOTAL, 300.0) > 0
    assert s.mean_observed(names.SLO_TTFT_SECONDS, 300.0) > 0
    stats = s.stats()
    assert (stats["interval_s"], stats["retention_s"]) == (2.0, 330.0)
    assert stats["samples"] >= 2
    with pytest.raises(ValueError, match="not cataloged"):
        s.rate("rbg_not_a_metric_total", 60.0)


# ---- admission gates on scripted histories ----


GATE_CFG = dict(model="tiny", page_size=8, num_pages=64, max_batch=4,
                max_seq_len=128, prefill_chunk=16, slo_ttft_s=0.1,
                early_reject="auto", early_reject_factor=1.5)


def _script(svc, done_times, prefill_rate, rate_age, waiting, prefix):
    """Same history on either package's service (its loop stopped): the
    completion times, the prefill-rate EMA and its age, requests waiting
    in the engine and a cached prefix."""
    now = time.monotonic()
    svc._done_times.clear()
    svc._done_times.extend(now - d for d in done_times)
    svc._prefill_rate = prefill_rate
    svc._pf_rate_t = now - rate_age
    eng = svc.engine
    for p in waiting:
        eng.add_request(p, _sampling(svc)(max_new_tokens=4))
    if prefix:
        pages = eng.allocator.alloc(len(prefix) // eng.cfg.page_size)
        eng.radix.insert(prefix, pages)


def _sampling(svc):
    return SamplingParams if isinstance(svc, EngineService) else JSampling


def _outcomes(svc, submissions):
    out = []
    for prompt, deadline_in in submissions:
        deadline = None if deadline_in is None else time.monotonic() + deadline_in
        est = svc.estimated_wait_s()
        pred = svc.predicted_ttft_s(prompt)
        try:
            svc.submit_async(prompt, _sampling(svc)(max_new_tokens=4),
                             deadline=deadline)
            out.append(("admitted", None, est, pred))
        except (Overloaded, JOverloaded) as e:
            out.append((e.code, e.retry_after_s, est, pred))
    return out


PROMPT = list(range(1, 65))
HISTORIES = {
    # No history: every gate abstains.
    "cold": dict(done_times=[], prefill_rate=None, rate_age=0.0, waiting=[],
                 prefix=None, max_queue=None,
                 subs=[(PROMPT, 0.5), (PROMPT, None)]),
    # 1 completion/s with a backlog: the deadline gate alone sheds.
    "backlog": dict(done_times=[10 - i for i in range(11)], prefill_rate=None,
                    rate_age=0.0, waiting=[[3, 4, 5], [6, 7, 8]], prefix=None,
                    max_queue=None, cfg=dict(early_reject="off"),
                    subs=[(PROMPT, 0.5), (PROMPT, 30.0), (PROMPT, 2.5)]),
    # A measured prefill rate: early rejection unless the prefix hits.
    "early": dict(done_times=[], prefill_rate=100.0, rate_age=1.0, waiting=[],
                  prefix=PROMPT, max_queue=None,
                  subs=[(list(range(100, 164)), None), (PROMPT, None),
                        (list(range(100, 110)), None)]),
    # The prefill rate expired: the prediction falls back to queue wait.
    "expired": dict(done_times=[4, 3, 2, 1], prefill_rate=1.0, rate_age=31.0,
                    waiting=[], prefix=None, max_queue=None,
                    subs=[(list(range(100, 164)), None)] * 2),
    # The queue bound with a history: the hint is the estimated wait.
    "bound": dict(done_times=[2.0, 1.5, 1.0, 0.5], prefill_rate=None,
                  rate_age=0.0, waiting=[], prefix=None, max_queue=2,
                  cfg=dict(early_reject="off"), subs=[(PROMPT, None)] * 4),
}


@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_admission_gates_decide_as_reference(history):
    h = HISTORIES[history]
    cfg = {**GATE_CFG, **h.get("cfg", {})}
    port = EngineService(EngineConfig(**cfg), device="cpu",
                         max_queue=h["max_queue"])
    ref = JService(JConfig(use_pallas="never", **cfg), max_queue=h["max_queue"])
    for svc in (port, ref):
        svc.stop()      # scripted: nothing is admitted while the gates run
        _script(svc, h["done_times"], h["prefill_rate"], h["rate_age"],
                h["waiting"], h["prefix"])
    assert port.engine.prefix_peek(PROMPT) == ref.engine.prefix_peek(PROMPT)
    got, want = _outcomes(port, h["subs"]), _outcomes(ref, h["subs"])
    assert [o[0] for o in got] == [o[0] for o in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            assert (a is None) == (b is None) and (a is None
                                                  or abs(a - b) <= 1e-9), (g, w)
    assert port.counters["shed_total"] == ref.counters["shed_total"]
    assert port.counters["early_rejects"] == ref.counters["early_rejects"]
    if history == "early":
        assert [o[0] for o in got] == [CODE_OVERLOADED, "admitted", "admitted"]
    if history == "backlog":
        assert [o[0] for o in got] == [CODE_OVERLOADED, "admitted",
                                       CODE_OVERLOADED]
    if history == "bound":
        assert [o[0] for o in got] == ["admitted"] * 2 + [CODE_OVERLOADED] * 2
    if history == "expired":
        assert [o[0] for o in got] == ["admitted", CODE_OVERLOADED]
        assert got[1][3] == got[1][2] == 1.0     # queue wait only


# ---- deadlines and aborts through the running service ----


@pytest.fixture(scope="module")
def svc():
    s = EngineService(EngineConfig(model="tiny", page_size=8, num_pages=128,
                                   max_batch=2, max_seq_len=256, prefill_chunk=16,
                                   decode_buckets=(1, 2)), device="cpu")
    s.submit_wait([1, 2, 3], SamplingParams(max_new_tokens=4))
    yield s
    s.stop()


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


def _drain(svc):
    def empty():
        with svc._lock:
            return not svc._queue and not svc.engine.has_work()
    _wait_for(empty, 30)


def test_queue_bound_sheds_with_retry_hint(svc):
    svc.max_queue = 2
    shed_before = svc.counters["shed_total"]
    pendings, shed = [], None
    try:
        for _ in range(12):
            try:
                pendings.append(svc.submit_async(
                    [5, 6, 7], SamplingParams(max_new_tokens=64)))
            except Overloaded as e:
                shed = e
                break
        assert shed is not None and shed.retry_after_s > 0
        assert shed.to_wire()["code"] == CODE_OVERLOADED
        assert svc.counters["shed_total"] == shed_before + 1
        with svc._lock:
            assert len(svc._queue) <= 2
    finally:
        svc.max_queue = None
        for p in pendings:
            svc.cancel(p)
        _drain(svc)


def test_expired_deadline_rejected_synchronously(svc):
    before = svc.engine.metrics["prefill_tokens"]
    with pytest.raises(DeadlineExceeded):
        svc.submit_async([1, 2, 3], SamplingParams(max_new_tokens=4),
                         deadline=time.monotonic() - 0.1)
    assert svc.engine.metrics["prefill_tokens"] == before


def test_queued_expiry_dropped_before_admission(svc):
    drops = svc.counters["deadline_queue_drops"]
    blockers = [svc.submit_async([9, 9, 9 + i], SamplingParams(max_new_tokens=200))
                for i in range(2)]
    try:
        doomed = svc.submit_async([4, 4, 4], SamplingParams(max_new_tokens=4),
                                  deadline=time.monotonic() + 0.2)
        assert doomed.done.wait(10)
        assert doomed.code == CODE_DEADLINE and doomed.tokens == []
        assert svc.counters["deadline_queue_drops"] > drops
    finally:
        for p in blockers:
            svc.cancel(p)
        _drain(svc)


def test_running_abort_recycles_slot_and_pages(svc):
    _drain(svc)
    free_before = svc.engine.allocator.free_pages
    aborts = svc.counters["deadline_running_aborts"]
    judged = svc.slo.judged_total()
    orig_step = svc.engine.step

    def slow_step():
        time.sleep(0.05)        # 240 tokens cannot finish inside 1 s
        return orig_step()

    svc.engine.step = slow_step
    try:
        p = svc.submit_async([11, 12, 13], SamplingParams(max_new_tokens=240),
                             deadline=time.monotonic() + 1.0)
        assert p.done.wait(30)
        assert p.code == CODE_DEADLINE
        assert svc.counters["deadline_running_aborts"] == aborts + 1
        assert 0 < len(p.tokens) < 240
    finally:
        svc.engine.step = orig_step
    _wait_for(lambda: svc.engine.allocator.free_pages == free_before)
    assert not svc.engine.running and not svc.engine.waiting
    assert svc.slo.judged_total() == judged    # an abort is not judged


def test_estimated_wait_gate_sheds_doomed_request(svc):
    _drain(svc)
    now = time.monotonic()
    svc._done_times.clear()
    svc._done_times.extend([now - 10 + i for i in range(11)])
    blockers = [svc.submit_async([7, 7, 7 + i], SamplingParams(max_new_tokens=200))
                for i in range(4)]
    try:
        est = svc.estimated_wait_s()
        assert est is not None and est > 1.0
        with pytest.raises(Overloaded) as ei:
            svc.submit_async([8, 8, 8], SamplingParams(max_new_tokens=4),
                             deadline=time.monotonic() + 0.5)
        assert ei.value.retry_after_s >= 0.5
    finally:
        svc._done_times.clear()
        for p in blockers:
            svc.cancel(p)
        _drain(svc)


def test_service_judges_each_finished_request_once(svc):
    _drain(svc)
    before = svc.slo.judged_total()
    ps = [svc.submit_async([20 + i, 21, 22], SamplingParams(max_new_tokens=3))
          for i in range(3)]
    for p in ps:
        assert p.done.wait(30) and p.error is None
    _wait_for(lambda: svc.slo.judged_total() == before + 3)
    stats = svc.stats()
    for key in ("estimated_wait_s", "slo_judged_total", "prefill_tokens_per_s",
                "early_reject_armed", "early_rejects", "join_wait_steps_max",
                "join_excess_steps_max"):
        assert key in stats, key


def test_trace_spans_complete_for_served_and_shed_requests(svc):
    trace.configure(enabled=True, sample=1.0)
    trace.SINK.reset()
    try:
        root = trace.start_trace(names.SPAN_ENGINE_OP, sample=True)
        p = svc.submit_async([30, 31, 32], SamplingParams(max_new_tokens=3),
                             span=root)
        assert p.done.wait(30)
        _wait_for(lambda: p.span_scan.duration_s is not None)
        root.end()
        shed_root = trace.start_trace(names.SPAN_ENGINE_OP, sample=True)
        with pytest.raises(DeadlineExceeded):
            svc.submit_async([1, 2], SamplingParams(), span=shed_root,
                             deadline=time.monotonic() - 1)
        shed_root.end()
        recs = trace.SINK.recent(2)
        assert [r["complete"] for r in recs] == [True, True]
        assert [s["name"] for s in recs[0]["spans"]] == [
            names.SPAN_ENGINE_OP, names.SPAN_SERVICE_QUEUE_WAIT,
            names.SPAN_SERVICE_SCAN]
        assert recs[1]["spans"][1]["attrs"]["outcome"] == "deadline"
    finally:
        trace.configure(enabled=False)
        trace.SINK.reset()
    assert not trace.start_trace(names.SPAN_ENGINE_OP)   # off: NULL_SPAN


# ---- engine: join accounting and prefix peek ----


def test_join_accounting_and_prefix_peek_match_reference(tiny_weights):
    jp, tp = tiny_weights
    kw = dict(model="tiny", page_size=8, max_batch=2, max_seq_len=128,
              prefill_chunk=16, num_pages=64)
    port = Engine(EngineConfig(**kw), params=tp, device="cpu")
    ref = JEngine(JConfig(use_pallas="never", **kw), params=jp)
    rng = np.random.RandomState(0)
    schedule = [(0, 20, 6), (0, 5, 9), (1, 33, 4), (2, 7, 5), (6, 12, 3)]
    prompts = [rng.randint(1, 256, n).tolist() for _, n, _ in schedule]
    for eng, sp in ((port, SamplingParams), (ref, JSampling)):
        step, pending = 0, list(zip(schedule, prompts))
        while pending or eng.has_work():
            while pending and pending[0][0][0] <= step:
                (_, _, n_new), prompt = pending.pop(0)
                eng.add_request(prompt, sp(max_new_tokens=n_new))
            eng.step()
            step += 1
    for key in ("steps", "joins", "join_wait_steps_max", "join_excess_steps_max"):
        assert port.metrics[key] == ref.metrics[key], key
    assert port.metrics["join_wait_steps_max"] > 0
    assert len(port.last_join_waits) == len(ref.last_join_waits) == 5
    for p in prompts + [prompts[0][:9] + [1, 2, 3], [5]]:
        assert port.prefix_peek(p) == ref.prefix_peek(p)
    assert port.prefix_peek(prompts[0]) > 0


# ---- tokenizers ----


TEXTS = ["hello", "", "naïve café — 東京 🚀", "a\nb\tc", "x" * 50 + "é" * 20]


def test_tokenizers_match_reference():
    port, ref = tokenizer.ByteTokenizer(), j_tok.ByteTokenizer()
    for text in TEXTS:
        for bos in (True, False):
            assert port.encode(text, add_bos=bos) == ref.encode(text, add_bos=bos)
        ids = ref.encode(text) + [ref.eos_id, ref.pad_id]
        assert port.decode(ids) == ref.decode(ids)
        pd, rd = (tokenizer.IncrementalDetokenizer(port),
                  j_tok.IncrementalDetokenizer(ref))
        got = [pd.feed(i) for i in ids] + [pd.flush()]
        want = [rd.feed(i) for i in ids] + [rd.flush()]
        assert got == want and "".join(got) == port.decode(ids)
    assert isinstance(tokenizer.load_tokenizer(""), tokenizer.ByteTokenizer)
    with pytest.raises(ValueError, match="not a directory"):
        tokenizer.load_tokenizer("/nonexistent/tokenizer")


# ---- gqa_attention, encode_hidden and embeddings ----


def test_gqa_attention_matches_reference():
    rng = np.random.default_rng(1)
    B, T, S, H, KV, hd = 2, 5, 7, 4, 2, 8
    q = rng.standard_normal((B, T, H, hd), np.float32)
    k = rng.standard_normal((B, S, KV, hd), np.float32)
    v = rng.standard_normal((B, S, KV, hd), np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [2, 3, 4, 5, 6]], np.int32)
    valid = np.ones((B, S), bool)
    valid[1, :3] = False         # row 1's first query sees no valid slot
    got = gqa_attention(*map(torch.from_numpy, (q, k, v, pos, valid)))
    want = np.asarray(j_gqa(q, k, v, pos, valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_encode_hidden_and_embed_match_reference(model):
    jp, tp = _weights(model)
    kw = dict(model=model, page_size=8, num_pages=64, max_seq_len=128,
              prefill_chunk=16)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 256, n).tolist() for n in (5, 16, 37, 2)]
    toks = np.zeros((4, 48), np.int32)
    mask = np.zeros((4, 48), bool)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], mask[i, :len(p)] = p, True
    h = encode_hidden(tp, get_config(model), torch.from_numpy(toks),
                      torch.from_numpy(mask))
    hj = np.asarray(j_encode_hidden(jp, j_get_config(model), toks, mask))
    np.testing.assert_allclose(h.numpy()[mask], hj[mask], atol=EMBED_ATOL, rtol=0)
    port = Engine(EngineConfig(**kw), params=tp, device="cpu")
    ref = JEngine(JConfig(use_pallas="never", **kw), params=jp)
    got = np.asarray(embed_prompts(port, prompts))
    want = np.asarray(j_embed_prompts(ref, prompts))
    assert got.shape == (4, 128)
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)


@pytest.fixture(scope="module")
def embed_svc(tiny_weights):
    s = EngineService(EngineConfig(model="tiny", page_size=8, num_pages=64,
                                   max_seq_len=128), params=tiny_weights[1],
                      device="cpu")
    yield s
    s.stop()


def test_embed_padding_invariant_and_deterministic(tiny_weights, embed_svc):
    v1 = embed_svc.embed([1, 2, 3, 4, 5])
    assert len(v1) == 128 and v1 == embed_svc.embed([1, 2, 3, 4, 5])
    assert v1 != embed_svc.embed([9, 8, 7])
    other = Engine(EngineConfig(model="tiny", page_size=8, num_pages=64,
                                max_seq_len=128, prefill_chunk=16),
                   params=tiny_weights[1], device="cpu")
    vb = embed_prompts(other, [[1, 2, 3, 4, 5]])[0]
    assert np.max(np.abs(np.asarray(v1) - np.asarray(vb))) < EMBED_ATOL


def test_embed_batched_matches_singles_and_chunks(embed_svc):
    prompts = [[i + 1, i + 2, i + 3] for i in range(EMBED_MAX_BATCH + 3)]
    batch = embed_prompts(embed_svc.engine, prompts)
    assert len(batch) == len(prompts)
    for i in (0, EMBED_MAX_BATCH - 1, EMBED_MAX_BATCH + 2):
        solo = embed_prompts(embed_svc.engine, [prompts[i]])[0]
        assert np.max(np.abs(np.asarray(solo) - np.asarray(batch[i]))) < EMBED_ATOL


def test_embed_rejects_bad_prompts(embed_svc):
    with pytest.raises(ValueError, match="vocab"):
        embed_svc.embed([99999])
    with pytest.raises(ValueError, match="empty"):
        embed_svc.embed([])
    with pytest.raises(ValueError, match="max_seq_len"):
        embed_svc.embed(list(range(1, 200)))


def test_embed_shapes_are_bucketed(embed_svc, monkeypatch):
    import rbg_tpu_torch.models.llama as llama

    shapes, real = [], llama.encode_hidden

    def spy(params, cfg, tokens, mask=None):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, mask)

    monkeypatch.setattr(llama, "encode_hidden", spy)
    eng = embed_svc.engine
    for prompts in ([[1, 2, 3]], [[1, 2, 3, 4], [5, 6, 7]],
                    [[1, 2], [3, 4], [5, 6]], [[1]] * 4, [list(range(1, 70))]):
        embed_prompts(eng, prompts)
    chunk = eng.cfg.prefill_chunk
    assert shapes == [(1, chunk), (2, chunk), (4, chunk), (4, chunk),
                      (1, 2 * chunk)]
    assert [_chunk_bucket(n) for n in (1, 2, 3, 4, 5, 9)] == [1, 2, 4, 4, 8, 16]
    assert _chunk_bucket(1, 16) == 16


def test_embed_spans_bound_score_memory_at_llama3_8b():
    """llama3-8b's 32 heads, prefill_chunk 64: 32 prompts of 2048 tokens
    (17 GB of scores in one forward) run two rows at a time; the smoke's
    4 prompts of 100-500 tokens and 32 of 512 run in one forward; one
    prompt over the budget still runs alone."""
    heads, chunk = get_config("llama3-8b").num_heads, 64
    spans = _embed_spans([2048] * 32, heads, chunk)
    assert spans == [(i, i + 2) for i in range(0, 32, 2)]
    assert _embed_spans([100, 230, 377, 500], heads, chunk) == [(0, 4)]
    assert _embed_spans([512] * 32, heads, chunk) == [(0, 32)]
    assert _embed_spans([512] * 33, heads, chunk) == [(0, 32), (32, 33)]
    assert _embed_spans([10, 2048, 10, 10], heads, chunk) == [(0, 2), (2, 4)]
    assert _embed_spans([8192, 8192], heads, chunk) == [(0, 1), (1, 2)]
    assert _embed_spans([], heads, chunk) == []
    for lens in ([2048] * 32, [10, 2048, 10, 10], [300, 1500, 40, 900, 2000]):
        for lo, hi in _embed_spans(lens, heads, chunk):
            rows = _chunk_bucket(hi - lo)
            T = _chunk_bucket(max(lens[lo:hi]), chunk)
            assert hi - lo == 1 or rows * heads * T * T * 4 <= EMBED_SCORE_BYTES


def test_embed_large_request_chunked_by_memory(embed_svc, monkeypatch):
    """With the score budget at two rows of T 128 (tiny: 4 heads), a
    request of six prompts runs in forwards within that budget and gives
    the vectors of the single unchunked forward."""
    import rbg_tpu_torch.models.llama as llama

    eng = embed_svc.engine
    prompts = [list(range(1, n + 1)) for n in (100, 10, 100, 30, 70, 5)]
    whole = np.asarray(embed_prompts(eng, prompts))
    budget = 2 * eng.mcfg.num_heads * 128 * 128 * 4
    monkeypatch.setattr(service_mod, "EMBED_SCORE_BYTES", budget)
    shapes, real = [], llama.encode_hidden

    def spy(params, cfg, tokens, mask=None):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, mask)

    monkeypatch.setattr(llama, "encode_hidden", spy)
    got = np.asarray(embed_prompts(eng, prompts))
    assert shapes == [(2, 128), (2, 128), (2, 128)]
    assert all(b * eng.mcfg.num_heads * t * t * 4 <= budget for b, t in shapes)
    assert np.max(np.abs(got - whole)) < EMBED_ATOL


# ---- bench_serving and bench_slo ----


# The keys of rbg_tpu.engine.bench_serving.run's result with SLO targets.
REF_BENCH_KEYS = {"requests", "completed", "offered_rate_rps", "duration_s",
                  "output_tok_per_s", "ttft_s", "itl_ms", "e2e_s", "slo",
                  "goodput_rps"}


def test_bench_serving_inprocess_completes_every_request():
    args = bench_serving.parse_args([
        "--device", "cpu", "--model", "tiny", "--requests", "8", "--rate", "64",
        "--input-len", "8", "--output-len", "8", "--page-size", "8",
        "--num-pages", "128", "--max-seq-len", "128", "--max-batch", "8",
        "--slo-ttft-s", "1000", "--slo-tpot-s", "1000"])
    out = bench_serving.run(args)
    assert set(out) == REF_BENCH_KEYS
    assert set(out["ttft_s"]) == {"p50", "p90", "p99"}
    assert set(out["slo"]) == {"ttft_target_s", "tpot_target_s", "ttft_attainment",
                               "tpot_attainment", "goodput_fraction"}
    assert out["completed"] == 8 and out["output_tok_per_s"] > 0
    assert out["slo"]["goodput_fraction"] == 1.0
    args.slo_ttft_s = 1e-9
    out2 = bench_serving.run(args)
    assert out2["completed"] == 8 and out2["goodput_rps"] == 0.0


def test_bench_serving_json_line(capsys):
    rc = bench_serving.main(["--device", "cpu", "--model", "tiny", "--requests",
                             "4", "--rate", "64", "--input-len", "8",
                             "--output-len", "4", "--num-pages", "128",
                             "--max-seq-len", "128", "--max-batch", "4", "--json"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert parsed["completed"] == 4 and "slo" not in parsed


@pytest.mark.parametrize("flags", [["--speculative", "ngram"], ["--ragged", "off"],
                                   ["--ragged", "off", "--multi-step", "4"]],
                         ids=["speculative", "ragged_off", "ragged_off_ms4"])
def test_bench_serving_serves_split_paths(flags, monkeypatch):
    """bench_serving in process through the split paths: every request
    completes, through the speculative verify or the split prefill."""
    args = bench_serving.parse_args(["--device", "cpu", "--model", "tiny",
                                     "--requests", "4", "--rate", "64",
                                     "--input-len", "16", "--output-len", "6",
                                     "--num-pages", "128", "--max-seq-len", "128",
                                     "--max-batch", "4", *flags])
    seen = {}
    real = bench_serving.build_service
    monkeypatch.setattr(bench_serving, "build_service",
                        lambda a: seen.setdefault("svc", real(a)))
    out = bench_serving.run(args)
    assert out["completed"] == 4 and out["output_tok_per_s"] > 0
    m = seen["svc"].engine.metrics
    assert m["unified_steps"] == 0
    if flags[1] == "ngram":
        assert m["spec_steps"] > 0
    with pytest.raises(SystemExit):
        bench_serving.parse_args(["--speculative", "eagle"])


def test_bench_slo_pd_setup_not_ported(tmp_path, capsys):
    """The pd setup is ported: a spawned kv pool, prefill and decode
    servers and the router on the CPU serve every request of each rate."""
    out = tmp_path / "slo.json"
    rc = bench_slo.main(["--setups", "pd", "--device", "cpu", "--model", "tiny",
                         "--rates", "8", "--requests", "4", "--input-len", "8",
                         "--output-len", "4", "--num-pages", "128",
                         "--max-seq-len", "128", "--max-batch", "4",
                         "--json-out", str(out)])
    assert rc == 0
    art = json.loads(out.read_text())
    rows = art["results"]["pd"]
    assert [r["completed"] for r in rows] == [4] and rows[0]["setup"] == "pd"
    assert art["pd_decode_replicas"] == 1
    assert "| pd | 8.0 | 4/4 |" in capsys.readouterr().out


def test_bench_slo_unified_sweeps_a_spawned_server(tmp_path, capsys):
    out = tmp_path / "slo.json"
    rc = bench_slo.main(["--setups", "unified", "--device", "cpu", "--model",
                         "tiny", "--rates", "8,16",
                         "--requests", "4", "--input-len", "8", "--output-len",
                         "4", "--num-pages", "128", "--max-seq-len", "128",
                         "--max-batch", "4", "--json-out", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())["results"]["unified"]
    assert [r["offered_rate_rps"] for r in rows] == [8.0, 16.0]
    assert all(r["completed"] == 4 and r["setup"] == "unified" for r in rows)
    assert "| unified | 8.0 | 4/4 |" in capsys.readouterr().out
