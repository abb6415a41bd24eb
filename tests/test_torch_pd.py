"""The port's prefill/decode disaggregation (``rbg_tpu_torch/engine/pd.py``)
against ``rbg_tpu``'s on the same weights (``tiny`` and ``tiny-mla`` in
float32, converted with ``params_from_numpy``; page 8, prefill chunk 16):
``PDPair`` gives the tokens of a unified engine and of the reference's
pair, greedy and seeded; bundles carry the reference's wire bytes (GQA
headers equal; MLA adds ``v_shape``, which the reference's header cannot
say); pages recycle on both sides; ``PDStreamPair`` over clean, paced and
seeded lossy links, with and without layer-sliced admission, gives the
reference's tokens; a truncated stream retries token-exactly; the
decode service admits a pushed stream; grammar-constrained rows and the
shared pool's prefix path. CPU: kernels A and B run as their plain
versions here."""

import re
import threading

import jax
import numpy as np
import pytest
import torch

from rbg_tpu.engine import EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine import pd as j_pd
from rbg_tpu.engine import protocol as j_protocol
from rbg_tpu.kvtransfer import transport as j_transport
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.engine import protocol as t_protocol
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.pd import (DecodeWorker, KVBundle, PDPair,
                                     PDStreamPair, PrefillWorker, new_stream_id)
from rbg_tpu_torch.engine.tokenizer import ByteTokenizer
from rbg_tpu_torch.kvtransfer.transport import (FakeICITransport,
                                                InProcTransport,
                                                SlowLossyTransport)
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs.metrics import REGISTRY
from torch_pd_links import HeldTailLink, hold_tail

BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=16)
GREEDY = dict(max_new_tokens=8)
SAMPLED = dict(max_new_tokens=8, temperature=0.7, top_k=20, seed=123)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for model in ("tiny", "tiny-mla"):
        jp = j_init(j_get_config(model), jax.random.key(0))
        out[model] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            get_config(model), "cpu"))
    return out


def ecfg(model="tiny", **kw):
    return EngineConfig(**{**BASE, "model": model, "device": "cpu", **kw})


def jcfg(model="tiny", **kw):
    return JConfig(**{**BASE, "model": model, "use_pallas": "never", **kw})


def _prompts(lengths, seed=3, vocab=250):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lengths]


def _link(kind, seed=0):
    """The same link on both sides: (reference, port)."""
    if kind == "inproc":
        return j_transport.InProcTransport(), InProcTransport()
    if kind == "fake_ici":
        return (j_transport.FakeICITransport(bytes_per_s=2e6, latency_s=0.0002),
                FakeICITransport(bytes_per_s=2e6, latency_s=0.0002))
    return (j_transport.SlowLossyTransport(j_transport.InProcTransport(),
                                           delay_s=0.001, reorder_window=3,
                                           dup_rate=0.4, seed=seed),
            SlowLossyTransport(InProcTransport(), delay_s=0.001,
                               reorder_window=3, dup_rate=0.4, seed=seed))


# ---- PDPair ------------------------------------------------------------------


@pytest.mark.parametrize("sp", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_pdpair_matches_unified_and_reference(weights, sp):
    jp, tp = weights["tiny"]
    prompts = _prompts((9, 25, 14))
    unified = Engine(ecfg(enable_radix_cache=False), params=tp)
    expect = unified.generate(prompts, SamplingParams(**sp))
    pair = PDPair(ecfg(), params=tp)
    got, ttft = pair.generate(prompts, SamplingParams(**sp), collect_ttft=True)
    ref = j_pd.PDPair(jcfg(), params=jp).generate(prompts, JSampling(**sp))
    assert got == expect == ref
    assert len(ttft) == 3 and all(t > 0 for t in ttft)
    assert pair.prefill.metrics["bundles"] == 3
    assert pair.decode.metrics["bytes_in"] == pair.prefill.metrics["bytes_out"] > 0
    # Pages recycled on both sides.
    assert pair.decode.engine.allocator.free_pages == 63
    assert pair.prefill.engine.allocator.free_pages == 63


@pytest.mark.parametrize("case", ["one_token", "stop_token"])
def test_single_token_and_stop_recycle_pages(weights, case):
    jp, tp = weights["tiny"]
    prompt = [2, 4, 6, 8]
    if case == "one_token":
        sp = dict(max_new_tokens=1)
    else:
        first = Engine(ecfg(enable_radix_cache=False), params=tp).generate(
            [prompt], SamplingParams(max_new_tokens=1))[0][0]
        sp = dict(max_new_tokens=8, stop_token=first)
    expect = Engine(ecfg(enable_radix_cache=False), params=tp).generate(
        [prompt], SamplingParams(**sp))[0]
    pair = PDPair(ecfg(), params=tp)
    got = pair.generate([prompt], SamplingParams(**sp))[0]
    assert got == expect == j_pd.PDPair(jcfg(), params=jp).generate(
        [prompt], JSampling(**sp))[0]
    assert len(got) == 1
    assert pair.decode.engine.allocator.free_pages == 63
    assert pair.prefill.engine.allocator.free_pages == 63
    assert not pair.decode.engine.has_work()


def test_prefill_bundle_shape_and_values_match_reference(weights):
    """19 tokens → 3 pages of 8: the bundle's shape, the reference's KV
    within 1e-4, pages released after the export."""
    jp, tp = weights["tiny"]
    prompt = list(range(1, 20))
    w = PrefillWorker(ecfg(), params=tp)
    b = w.prefill(prompt)
    jb = j_pd.PrefillWorker(jcfg(), params=jp).prefill(prompt)
    cfg = get_config("tiny")
    assert b.k_data.shape == (cfg.num_layers, 3, 8, cfg.num_kv_heads, cfg.head_dim_)
    assert b.k_data.shape == jb.k_data.shape and b.dtype == "float32"
    assert b.first_token == jb.first_token
    np.testing.assert_allclose(b.k_data, jb.k_data, atol=1e-4)
    np.testing.assert_allclose(b.v_data, jb.v_data, atol=1e-4)
    assert w.engine.allocator.free_pages == 63


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_bundle_wire_equals_reference(dtype):
    """The same pages as a port bundle and a reference bundle: equal
    headers and lanes; each side reads the other's wire back to the same
    bytes."""
    import jax.numpy as jnp

    from rbg_tpu_torch.engine.kvtier import _to_host

    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 2, 4).astype(np.float32)
    if dtype == "bfloat16":
        jk, jv = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, -x))
        tk, tv = (_to_host(torch.from_numpy(a).to(torch.bfloat16)) for a in (x, -x))
    else:
        jk, jv, tk, tv = x, -x, x, -x
    jb = j_pd.KVBundle(prompt=[1, 2, 3], first_token=7, k_data=jk, v_data=jv)
    tb = KVBundle(prompt=[1, 2, 3], first_token=7, k_data=tk, v_data=tv,
                  dtype=dtype)
    jw, tw = j_protocol.bundle_to_wire(jb), t_protocol.bundle_to_wire(tb)
    assert jw[0] == tw[0] and "v_shape" not in tw[0]
    assert jw[1:] == tw[1:]
    back = t_protocol.bundle_from_wire(*jw)
    assert back.dtype == dtype and back.k_data.tobytes() == tk.tobytes()
    assert back.nbytes == tb.nbytes
    jback = j_protocol.bundle_from_wire(*tw)
    assert jback.v_data.tobytes() == tv.tobytes()


def test_mla_bundle_round_trips_the_port_wire(weights):
    """An MLA bundle (latent and RoPE key of different widths) rides the
    port's wire with ``v_shape`` and comes back equal; the reference's
    header holds one shape, so its reader fails on the same bundle — a
    fact about the reference."""
    _, tp = weights["tiny-mla"]
    b = PrefillWorker(ecfg("tiny-mla"), params=tp).prefill(list(range(1, 20)))
    assert b.k_data.shape[-1] != b.v_data.shape[-1]
    hdr, kb, vb = t_protocol.bundle_to_wire(b)
    assert hdr["v_shape"] == list(b.v_data.shape)
    back = t_protocol.bundle_from_wire(hdr, kb, vb)
    assert back.k_data.tobytes() == b.k_data.tobytes()
    assert back.v_data.tobytes() == b.v_data.tobytes()
    ref_hdr = {k: v for k, v in hdr.items() if k != "v_shape"}
    with pytest.raises(ValueError, match="cannot reshape"):
        j_protocol.bundle_from_wire(ref_hdr, kb, vb)


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_decode_worker_joins_rows_between_windows(weights, model):
    """multi_step 4 on the decode side: a bundle injected while a window is
    in flight joins the next window; both rows' tokens equal a unified
    engine's, and every page comes back."""
    _, tp = weights[model]
    prompts = _prompts((21, 13), seed=8)
    sp = SamplingParams(max_new_tokens=10)
    expect = [Engine(ecfg(model, enable_radix_cache=False), params=tp)
              .generate([p], sp)[0] for p in prompts]
    pf = PrefillWorker(ecfg(model), params=tp)
    dw = DecodeWorker(ecfg(model, multi_step=4), params=tp)
    out = {}
    a = pf.prefill(prompts[0], sp)
    ra = dw.inject(a, sp)
    out[ra] = [a.first_token]
    for ev in dw.engine.step():          # window in flight for row a
        out[ev.request_id].append(ev.token)
    assert dw.engine._dec is not None and dw.engine._dec["pending"] is not None
    b = pf.prefill(prompts[1], sp)
    rb = dw.inject(b, sp)
    out[rb] = [b.first_token]
    while dw.engine.has_work():
        for ev in dw.engine.step():
            out[ev.request_id].append(ev.token)
    assert [out[ra], out[rb]] == expect
    assert dw.engine.allocator.free_pages == 63


def test_deferred_events_come_out_first_in_order(weights):
    _, tp = weights["tiny"]
    from rbg_tpu_torch.engine.engine import StepEvent

    eng = Engine(ecfg(), params=tp)
    eng._deferred_events += [StepEvent(101, 5, False), StepEvent(102, 6, True)]
    eng.add_request([3, 4, 5], SamplingParams(max_new_tokens=2))
    evs = eng.step()
    assert [(e.request_id, e.token) for e in evs[:2]] == [(101, 5), (102, 6)]
    assert eng._deferred_events == [] and len(evs) == 3


def test_validate_messages_equal_reference():
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError) as port:
            EngineConfig(mode=mode, kv_dtype="int8").validate()
        with pytest.raises(ValueError) as ref:
            JConfig(mode=mode, kv_dtype="int8").validate()
        assert str(port.value) == str(ref.value)
    for mode in ("unified", "prefill", "decode"):
        EngineConfig(mode=mode).validate()
    with pytest.raises(ValueError, match="mode 'both'"):
        EngineConfig(mode="both").validate()


def test_pdpair_needs_a_card_unless_asked_for_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDPair(EngineConfig(**BASE))
    PDPair(ecfg(), params=weights["tiny"][1])


# ---- PDStreamPair ------------------------------------------------------------


@pytest.mark.parametrize("link,split", [("inproc", 0), ("inproc", 1),
                                        ("fake_ici", 1), ("lossy", 0),
                                        ("lossy", 1)])
def test_stream_pair_matches_reference(weights, link, split):
    jp, tp = weights["tiny"]
    prompts = _prompts((9, 25, 40), seed=4)
    jl, tl = _link(link, seed=2)
    sp = dict(SAMPLED, max_new_tokens=6)
    ref = j_pd.PDStreamPair(jcfg(num_pages=128), params=jp, transport=jl,
                            layer_split=split).generate(prompts, JSampling(**sp))
    pair = PDStreamPair(ecfg(num_pages=128), params=tp, transport=tl,
                        layer_split=split)
    got = pair.generate(prompts, SamplingParams(**sp))
    assert got == ref
    assert pair.decode.metrics["streams_in"] == 3
    # The commits' lock hold time is on record.
    _, hists = REGISTRY.snapshot_values()
    assert any(k[0] == names.PD_LOCK_HOLD_SECONDS for k in hists)
    assert pair.decode.engine.allocator.free_pages == 127
    whole = PDStreamPair(ecfg(num_pages=128), params=tp, transport=_link(link)[1],
                         layer_split=split)
    assert whole.generate(prompts, SamplingParams(**sp), stream=False) == ref


@pytest.mark.parametrize("sp", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_layer_sliced_admission_gives_the_tokens_without_it(weights, sp):
    """admit_layers=1 over a paced link admits below full layer coverage,
    runs the first decode step as a chain of layer windows under the
    transfer tail, and gives admit_layers=0's tokens (and the
    reference's); pages recycle."""
    jp, tp = weights["tiny"]
    prompt = _prompts((37,), seed=11)[0]
    paced = lambda: FakeICITransport(bytes_per_s=2e5, latency_s=0.0005)
    full = PDStreamPair(ecfg(num_pages=128), params=tp, transport=paced(),
                        layer_split=1, admit_layers=0)
    expect = full.generate_one(prompt, SamplingParams(**sp))
    assert expect["layers_at_admit"] is None
    admits0 = REGISTRY.counter(names.KVT_LAYER_ADMIT_TOTAL)
    link = HeldTailLink(admit_layers=1)
    sliced = hold_tail(PDStreamPair(ecfg(num_pages=128), params=tp, transport=link,
                                    layer_split=1, admit_layers=1), link)
    got = sliced.generate_one(prompt, SamplingParams(**sp))
    assert got["tokens"] == expect["tokens"]
    assert got["layers_at_admit"] is not None
    assert got["layers_at_admit"] < got["total_layers"]
    assert REGISTRY.counter(names.KVT_LAYER_ADMIT_TOTAL) > admits0
    ref = j_pd.PDStreamPair(jcfg(num_pages=128), params=jp,
                            transport=j_transport.InProcTransport(),
                            layer_split=1).generate_one(prompt, JSampling(**sp))
    assert got["tokens"] == ref["tokens"]
    assert sliced.decode.engine.allocator.free_pages == 127


def test_layer_sliced_admission_over_lossy_links(weights):
    """Reordered and duplicated slabs below the dispatch watermark are
    clipped (they must not overwrite the decode token's KV in place):
    tokens stay equal across fault seeds, and the sliced path engages."""
    _, tp = weights["tiny"]
    prompt = _prompts((37,), seed=13)[0]
    sp = SamplingParams(max_new_tokens=8, temperature=0.7, seed=321)
    expect = PDStreamPair(ecfg(num_pages=128), params=tp,
                          layer_split=1).generate_one(prompt, sp)["tokens"]
    engaged = 0
    for seed in range(3):
        link = HeldTailLink(admit_layers=1)
        lossy = SlowLossyTransport(link, delay_s=0.001, reorder_window=2,
                                   dup_rate=0.5, seed=seed)
        pair = hold_tail(PDStreamPair(ecfg(num_pages=128), params=tp, transport=lossy,
                                      layer_split=1, admit_layers=1), link)
        r = pair.generate_one(prompt, sp)
        assert r["tokens"] == expect, f"fault seed {seed} diverged"
        engaged += r["layers_at_admit"] is not None
    assert engaged >= 1


def test_warm_layer_sliced_leaves_the_pool_unchanged(weights):
    _, tp = weights["tiny"]
    pair = PDStreamPair(ecfg(), params=tp, layer_split=1, admit_layers=1)
    c = pair.decode.engine.cache
    c.k_pages.normal_()
    before = (c.k_pages.clone(), c.v_pages.clone())
    assert pair.decode.warm_layer_sliced(1) > 0
    assert torch.equal(c.k_pages, before[0]) and torch.equal(c.v_pages, before[1])


def test_truncated_stream_retries_token_exact(weights):
    _, tp = weights["tiny"]
    prompt = _prompts((30,), seed=5)[0]
    sp = SamplingParams(max_new_tokens=6)
    expect = PDStreamPair(ecfg(num_pages=128), params=tp).generate_one(
        prompt, sp)["tokens"]
    link = SlowLossyTransport(InProcTransport(), delay_s=0.0,
                              truncate_nth_stream=0, truncate_after_bytes=1 << 10)
    pair = PDStreamPair(ecfg(num_pages=128), params=tp, transport=link)
    r = pair.generate_one(prompt, sp, max_retries=2)
    assert r["retries"] >= 1 and r["tokens"] == expect
    assert pair.decode.engine.allocator.free_pages == 127


def test_decode_service_streaming_admission(weights):
    """DecodeService admits a pushed stream at coverage (loop-thread
    commits), decodes under continuous batching, and the first decode step
    stamps the receiver; a bundle through the same service decodes too."""
    from rbg_tpu_torch.engine.service import DecodeService

    _, tp = weights["tiny"]
    prompt = _prompts((20,), seed=9)[0]
    sp = SamplingParams(max_new_tokens=5)
    expect = Engine(ecfg(enable_radix_cache=False), params=tp).generate([prompt], sp)[0]
    pf = PrefillWorker(ecfg(), params=tp)
    svc = DecodeService(ecfg(), params=tp)
    try:
        tr = SlowLossyTransport(InProcTransport(), delay_s=0.01)
        rx = svc.kv_streams.get_or_create(new_stream_id())
        svc.watch_stream(rx)
        t = threading.Thread(target=rx.pump, args=(tr,), daemon=True)
        t.start()
        res = pf.prefill_stream(prompt, sp, transport=tr, peer="",
                                stream_id=rx.stream_id)
        rx.wait_ready(30.0)
        pending = svc.submit_stream(rx, sp)
        toks = [res.first_token] + svc.wait(pending, 60.0)
        assert toks == expect
        assert res.wait(10.0) and res.error() is None
        t.join(10.0)
        assert rx.t_first_step is not None and rx.t_fin is not None
        assert svc.submit_bundle(pf.prefill(prompt, sp), sp) == expect
        assert svc.stats()["streams_in"] == 1
    finally:
        svc.stop()


# ---- grammar, MLA and the shared pool --------------------------------------


SCHEMA = {"type": "object", "properties": {"id": {"type": "integer"},
                                           "state": {"enum": ["on", "off"]}}}


@pytest.mark.parametrize("kind,fields", [
    ("json_mode", dict(json_mode=True)), ("regex", dict(regex=r"\d{3}-\d{4}")),
    ("json_schema", dict(json_schema=SCHEMA))])
def test_grammar_constrained_pd_row_equals_unified(weights, kind, fields):
    tok = ByteTokenizer()
    jp0 = j_init(j_get_config("tiny", vocab_size=512), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp0),
                           get_config("tiny", vocab_size=512), "cpu")
    cfg = dict(vocab_size=512, num_pages=128, max_seq_len=256)
    sp = SamplingParams(max_new_tokens=40, temperature=0.8, seed=5,
                        stop_token=tok.eos_id, **fields)
    prompt = tok.encode(kind + ":", add_bos=False)
    uni = Engine(ecfg(enable_radix_cache=False, **cfg), params=tp)
    uni.enable_json_grammar(tok)
    expect = uni.generate([prompt], sp)[0]
    for pair in (PDPair(ecfg(**cfg), params=tp),
                 PDStreamPair(ecfg(**cfg), params=tp, layer_split=1,
                              admit_layers=1,
                              transport=FakeICITransport(bytes_per_s=2e5))):
        pair.prefill.engine.enable_json_grammar(tok)
        pair.decode.engine.enable_json_grammar(tok)
        assert pair.generate([prompt], sp)[0] == expect
    text = tok.decode([t for t in expect if t != tok.eos_id])
    if kind == "regex":
        assert re.fullmatch(r"\d{3}-\d{4}", text), text


@pytest.mark.parametrize("admit", [0, 1])
def test_mla_pairs_equal_reference(weights, admit):
    jp, tp = weights["tiny-mla"]
    prompts = _prompts((9, 30), seed=6)
    sp = dict(SAMPLED, max_new_tokens=6)
    ref = j_pd.PDPair(jcfg("tiny-mla"), params=jp).generate(prompts, JSampling(**sp))
    assert PDPair(ecfg("tiny-mla"), params=tp).generate(
        prompts, SamplingParams(**sp)) == ref
    pair = PDStreamPair(ecfg("tiny-mla", num_pages=128), params=tp, layer_split=1,
                        admit_layers=admit,
                        transport=FakeICITransport(bytes_per_s=2e5))
    assert pair.generate(prompts, SamplingParams(**sp)) == ref
    assert pair.decode.engine.allocator.free_pages == 127


def test_second_replica_skips_prefill_through_the_pool(weights):
    """Replica A publishes a page-aligned prefix to the pool; replica B
    fetches it (``add_request_with_prefix``), prefills only the tail, and
    gives A's tokens. Foreign pages are refused before any page is
    taken."""
    from rbg_tpu_torch.engine.kvpool import (KVPoolClient, KVPoolServer,
                                             KVPoolStore)

    _, tp = weights["tiny"]
    srv = KVPoolServer(("127.0.0.1", 0), KVPoolStore(8))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        prompt = _prompts((40,), seed=12)[0]
        sp = SamplingParams(max_new_tokens=4)
        a = PrefillWorker(ecfg(), params=tp, pool=KVPoolClient(addr))
        b = PrefillWorker(ecfg(), params=tp, pool=KVPoolClient(addr))
        ba, bb = a.prefill(prompt, sp), b.prefill(prompt, sp)
        assert a.metrics["pool_exports"] == 1 and b.metrics["pool_hits"] == 1
        assert b.engine.metrics["prefill_tokens"] == 40 - 32
        assert ba.first_token == bb.first_token
        np.testing.assert_allclose(ba.k_data, bb.k_data, atol=1e-5)
        eng = b.engine
        with pytest.raises(ValueError, match="prefix KV rejected"):
            eng.add_request_with_prefix(prompt, sp, 8, np.zeros((1, 1, 8, 2, 4),
                                                                np.float32),
                                        np.zeros((1, 1, 8, 2, 4), np.float32))
        assert eng.allocator.free_pages == 63
    finally:
        srv.shutdown()
        srv.server_close()


def test_bundle_pages_stage_into_the_pool_dtype():
    """Pages of the pool's own wire dtype land bit for bit (bf16 as int16
    bits); pages of another dtype convert by value, as the reference's
    ``jnp.asarray(.., pool dtype)`` does."""
    from rbg_tpu_torch.engine.kvtier import _to_host
    from rbg_tpu_torch.engine.pd import _stage

    x = torch.randn(2, 3, 8, 2, 4)
    pool = torch.zeros(1, dtype=torch.bfloat16)
    bits = _to_host(x.to(torch.bfloat16))
    assert torch.equal(_stage(bits, "bfloat16", pool), x.to(torch.bfloat16))
    assert torch.equal(_stage(x.numpy(), "float32", pool), x.to(torch.bfloat16))
    f32 = torch.zeros(1)
    assert torch.equal(_stage(bits, "bfloat16", f32), x.to(torch.bfloat16).float())
