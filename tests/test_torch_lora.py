"""Multi-LoRA serving in rbg_tpu_torch against rbg_tpu's on the CPU
(mirroring tests/test_lora.py, without its PD case): ``forward_paged``
with an adapter equals the merged-weights forward within 1e-4 (float32,
tiny and tiny-mla) and the reference's adapter forward; base rows are
untouched; mixed adapters in one batch give the reference engine's
tokens; alpha/r is taken per target; bad adapters and unknown names are
refused; adapter requests skip the radix cache; a runtime load keeps the
tokens in flight; ``--lora NAME=PATH`` serves over the port's wire."""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.protocol import request_once
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import forward_paged as j_forward_paged
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import forward_paged, lora_delta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(page_size=8, num_pages=96, max_seq_len=128, enable_radix_cache=False)
PROMPT = [1, 2, 3, 4]
TARGETS = {"tiny": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
           "tiny-mla": ("wq", "w_dkv", "wo", "w_gate", "w_up", "w_down")}
_WEIGHTS = {}


def _weights(preset):
    """(JAX params, port params) of the reference's init, seed 0."""
    if preset not in _WEIGHTS:
        jp = j_init(j_get_config(preset), jax.random.key(0))
        _WEIGHTS[preset] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                  get_config(preset), "cpu"))
    return _WEIGHTS[preset]


def _adapter(preset, seed, targets=None, r=4, scale=0.05):
    """{target: (A [L, d, r], B [L, r, o])} float32 from a numpy seed."""
    cfg = get_config(preset)
    blocks = _weights(preset)[1]["blocks"]
    rng = np.random.default_rng(seed)
    out = {}
    for tgt in targets or TARGETS[preset]:
        _, d_in, d_out = blocks[tgt].shape
        rt = r[tgt] if isinstance(r, dict) else r
        out[tgt] = (rng.normal(size=(cfg.num_layers, d_in, rt)).astype(np.float32) * scale,
                    rng.normal(size=(cfg.num_layers, rt, d_out)).astype(np.float32) * scale)
    return out


def _merged(params, adapter, alpha):
    """The port's params with alpha/r · A @ B added to each target."""
    blocks = dict(params["blocks"])
    for tgt, (A, B) in adapter.items():
        blocks[tgt] = blocks[tgt] + (alpha / A.shape[2]) * torch.einsum(
            "ldr,lro->ldo", torch.from_numpy(A), torch.from_numpy(B))
    return {**params, "blocks": blocks}


def _engine(preset="tiny", params=None, **kw):
    return Engine(EngineConfig(model=preset, **{**BASE, **kw}),
                  params=params if params is not None else _weights(preset)[1],
                  device="cpu")


def _j_engine(preset="tiny", **kw):
    return JEngine(JConfig(model=preset, use_pallas="never", **{**BASE, **kw}),
                   params=_weights(preset)[0])


def _step_block(cfg, rng):
    """A [2, 6] split-path block (row 1 ends in pads) over a pool of
    context."""
    page, B, P, T = 8, 2, 4, 6
    shape = ((cfg.num_layers, B * P + 1, page, 1, cfg.kv_lora_rank) if cfg.mla
             else (cfg.num_layers, B * P + 1, page, cfg.num_kv_heads, cfg.head_dim_))
    vshape = shape[:-1] + (cfg.qk_rope_head_dim,) if cfg.mla else shape
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*vshape).astype(np.float32)
    table = (np.arange(B * P) + 1).reshape(B, P).astype(np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    pos = (np.asarray([[3], [11]]) + np.arange(T)[None]).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, 4:] = False
    kvl = (pos[:, 0] + mask.sum(1)).astype(np.int32)
    return tok, pos, mask, kvl, table, kp, vp


@pytest.mark.parametrize("preset", ["tiny", "tiny-mla"])
def test_adapter_forward_matches_merged_weights_and_jax(preset):
    """Row 0 with an adapter (every target), row 1 with none: row 0's
    logits equal the merged-weights forward's, row 1's the base forward's,
    and both the reference's adapter forward, within 1e-4 (float32)."""
    cfg, jcfg = get_config(preset), j_get_config(preset)
    jp, tp = _weights(preset)
    ad = _adapter(preset, 0)
    eng = _engine(preset)
    eng.load_lora("a", ad, alpha=8.0)
    ids = torch.tensor([1, 0])
    tok, pos, mask, kvl, table, kp, vp = _step_block(cfg, np.random.RandomState(1))
    t = torch.from_numpy

    def run(params, **kw):
        k, v = t(kp.copy()), t(vp.copy())
        return forward_paged(params, cfg, t(tok), t(pos), t(mask), t(kvl), t(table),
                             k, v, **kw).numpy()

    got = run(tp, lora=eng.lora_stack, lora_ids=ids)
    merged = run(_merged(tp, ad, 8.0))
    base = run(tp)
    np.testing.assert_allclose(got[0][mask[0]], merged[0][mask[0]], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1][mask[1]], base[1][mask[1]], atol=1e-4, rtol=0)
    je = _j_engine(preset)
    je.load_lora("a", ad, alpha=8.0)
    jl, *_ = j_forward_paged(jp, jcfg, *map(jnp.asarray, (tok, pos, mask, kvl, table,
                                                          kp, vp)),
                             use_pallas="never", lora=je.lora_stack,
                             lora_ids=jnp.asarray([1, 0], jnp.int32))
    np.testing.assert_allclose(got[mask], np.asarray(jl)[mask], atol=1e-4, rtol=0)
    assert np.abs(got[0] - base[0]).max() > 1e-3        # the adapter bites


def test_lora_delta_is_per_row_and_in_x_dtype():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 2, 8).astype(np.float32)).bfloat16()
    A = torch.from_numpy(rng.randn(3, 8, 4).astype(np.float32))
    B = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    A[0], B[0] = 0, 0
    out = lora_delta(x, A, B, torch.tensor([2, 0, 1]))
    assert out.dtype == torch.bfloat16 and out.shape == (3, 2, 5)
    assert bool((out[1] == 0).all())
    want = x[0].float() @ A[2].bfloat16().float() @ B[2].bfloat16().float()
    assert float((out[0].float() - want).abs().max()) < 0.1 * float(want.abs().max())


@pytest.mark.parametrize("preset", ["tiny", "tiny-mla"])
def test_adapter_engine_matches_merged_weights(preset):
    """An adapter request's greedy tokens equal a plain engine's on the
    merged weights, for the split path and the fused window (multi_step 4)."""
    ad = _adapter(preset, 1)
    for kw in ({}, {"multi_step": 4}):
        ref = _engine(preset, params=_merged(_weights(preset)[1], ad, 8.0), **kw
                      ).generate([PROMPT * 3], SamplingParams(max_new_tokens=8))[0]
        eng = _engine(preset, **kw)
        eng.load_lora("a", ad, alpha=8.0)
        got = eng.generate([PROMPT * 3], SamplingParams(max_new_tokens=8, lora="a"))[0]
        assert got == ref, kw


def test_base_rows_unaffected_by_loaded_adapters():
    eng = _engine()
    eng.load_lora("a", _adapter("tiny", 0), alpha=8.0)
    got = eng.generate([PROMPT], SamplingParams(max_new_tokens=8))[0]
    assert got == _engine().generate([PROMPT], SamplingParams(max_new_tokens=8))[0]
    assert eng.metrics["unified_steps"] > 0     # no adapter row: the ragged step


@pytest.mark.parametrize("preset", ["tiny", "tiny-mla"])
@pytest.mark.parametrize("multi_step", [1, 4])
def test_mixed_adapters_match_jax_engine(preset, multi_step):
    """Adapter a (rank 4), adapter b (rank 8) and a base row decode
    together, joining at different steps; every stream equals the
    reference engine's."""
    ad_a = _adapter(preset, 0, r=4)
    ad_b = _adapter(preset, 1, r=8)
    streams = []
    for eng, sp_cls in ((_j_engine(preset, multi_step=multi_step), JSampling),
                        (_engine(preset, multi_step=multi_step), SamplingParams)):
        eng.load_lora("a", ad_a, alpha=8.0)
        eng.load_lora("b", ad_b, alpha=16.0)
        plan = [(0, PROMPT * 3, "a"), (0, [7, 8, 9], None), (2, PROMPT, "b")]
        out, ids, step = {}, {}, 0
        while plan or eng.has_work():
            while plan and plan[0][0] <= step:
                _, p, name = plan.pop(0)
                rid = eng.add_request(p, sp_cls(max_new_tokens=8, lora=name))
                ids[rid] = len(ids)
                out[ids[rid]] = []
            for ev in eng.step():
                out[ids[ev.request_id]].append(ev.token)
            step += 1
        streams.append([out[i] for i in range(3)])
    assert streams[0] == streams[1]
    assert streams[1][0] != streams[1][1]


def test_mixed_rank_targets_scale_per_target():
    """alpha/r with each TARGET's rank: r=2 on wq and r=8 on w_down match
    the per-target merged reference."""
    ad = _adapter("tiny", 7, targets=("wq", "w_down"), r={"wq": 2, "w_down": 8})
    ref = _engine(params=_merged(_weights("tiny")[1], ad, 16.0)).generate(
        [PROMPT], SamplingParams(max_new_tokens=8))[0]
    eng = _engine()
    eng.load_lora("m", ad, alpha=16.0)
    stack = eng.lora_stack
    assert tuple(stack["wq"][0].shape[-1:]) == (8,)         # rank-padded
    assert bool((stack["wq"][0][:, 0] == 0).all())          # slot 0 zeros
    np.testing.assert_allclose(stack["wq"][1][:, 1, :2].numpy(),
                               ad["wq"][1] * 8.0, rtol=1e-6)
    got = eng.generate([PROMPT], SamplingParams(max_new_tokens=8, lora="m"))[0]
    assert got == ref


def test_load_lora_validation():
    eng = _engine()
    L = get_config("tiny").num_layers
    z = np.zeros
    with pytest.raises(ValueError, match="empty"):
        eng.load_lora("x", {})
    with pytest.raises(ValueError, match="bad shapes"):
        eng.load_lora("x", {"wq": (z((1, 4, 2), np.float32), z((1, 3, 8), np.float32))})
    with pytest.raises(ValueError, match="unsupported target"):
        eng.load_lora("x", {"q_proj": (z((L, 128, 4)), z((L, 4, 512)))})
    with pytest.raises(ValueError, match="wrong base model"):
        eng.load_lora("ghost", {"wq": (z((L, 999, 4)), z((L, 4, 128)))})
    with pytest.raises(ValueError, match="unknown LoRA"):
        eng.add_request(PROMPT, SamplingParams(max_new_tokens=2, lora="ghost"))
    eng.load_lora("x", _adapter("tiny", 0))
    with pytest.raises(ValueError, match="already loaded"):
        eng.load_lora("x", _adapter("tiny", 1))
    mla = _engine("tiny-mla")
    with pytest.raises(ValueError, match="unsupported target"):
        mla.load_lora("x", {"wk": (z((2, 128, 4)), z((2, 4, 64)))})
    moe = Engine(EngineConfig(model="tiny-moe", **BASE), device="cpu")
    with pytest.raises(ValueError, match="unsupported target"):
        moe.load_lora("x", {"w_gate": (z((2, 128, 4)), z((2, 4, 256)))})


def test_unknown_adapter_fails_its_request_only():
    eng = _engine()
    eng.load_lora("a", _adapter("tiny", 0))
    with pytest.raises(ValueError, match="unknown LoRA"):
        eng.add_request(PROMPT, SamplingParams(max_new_tokens=4, lora="zz"))
    assert len(eng.generate([PROMPT], SamplingParams(max_new_tokens=4))[0]) == 4


def test_adapter_requests_skip_radix_cache():
    eng = _engine(enable_radix_cache=True)
    eng.load_lora("a", _adapter("tiny", 0), alpha=8.0)
    sp = SamplingParams(max_new_tokens=6, lora="a")
    first = eng.generate([PROMPT * 4], sp)
    assert eng.radix.num_nodes == 0                 # nothing inserted
    again = eng.generate([PROMPT * 4], sp)
    assert eng.metrics["radix_hit_tokens"] == 0 and first == again
    eng.generate([PROMPT * 4], SamplingParams(max_new_tokens=6))
    eng.generate([PROMPT * 4], SamplingParams(max_new_tokens=6))
    assert eng.metrics["radix_hit_tokens"] > 0      # base requests still share


def test_runtime_load_keeps_inflight_tokens():
    """An adapter loaded while a fused window is pending: the in-flight
    request loses nothing and gives the same greedy continuation."""
    ref = _engine(multi_step=4).generate([PROMPT], SamplingParams(max_new_tokens=16))[0]
    eng = _engine(multi_step=4)
    eng.add_request(PROMPT, SamplingParams(max_new_tokens=16))
    out, steps = [], 0
    while eng.has_work():
        for ev in eng.step():
            out.append(ev.token)
        steps += 1
        if steps == 3:
            assert eng._dec is not None and eng._dec["pending"] is not None
            eng.load_lora("late", _adapter("tiny", 9), alpha=8.0)
    assert out == ref


def test_lora_over_the_wire_with_npz(tmp_path):
    """``--lora style=PATH``: the adapter request bites, matches the
    in-process engine, a base request is unchanged and an unknown adapter
    gets an error reply."""
    ad = _adapter("tiny", 4)
    path = tmp_path / "style.npz"
    np.savez(path, alpha=np.float32(8.0), **{f"{k}.A": A for k, (A, _) in ad.items()},
             **{f"{k}.B": B for k, (_, B) in ad.items()})
    # The server's own seeded weights (seed 0), built the same way here.
    eng = Engine(EngineConfig(model="tiny", page_size=8, num_pages=64, max_seq_len=128,
                              prefill_chunk=16, multi_step=2), device="cpu")
    eng.load_lora("style", ad, alpha=8.0)
    want = eng.generate([PROMPT], SamplingParams(max_new_tokens=8, lora="style"))[0]
    want_base = eng.generate([PROMPT], SamplingParams(max_new_tokens=8))[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rbg_tpu_torch.engine.server", "--device", "cpu",
         "--model", "tiny", "--port", str(port), "--num-pages", "64",
         "--max-seq-len", "128", "--prefill-chunk", "16", "--multi-step", "2",
         "--page-size", "8", "--lora", f"style={path}"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    addr = f"127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                h, _, _ = request_once(addr, {"op": "health"}, timeout=2)
                if h and h.get("ok"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never healthy"
            time.sleep(0.2)
        msg = {"op": "generate", "prompt": PROMPT, "max_new_tokens": 8}
        base, _, _ = request_once(addr, msg, timeout=120)
        styled, _, _ = request_once(addr, {**msg, "lora": "style"}, timeout=120)
        assert "error" not in styled, styled
        assert styled["tokens"] == want and base["tokens"] == want_base
        assert styled["tokens"] != base["tokens"]
        bad, _, _ = request_once(addr, {**msg, "lora": "nope"}, timeout=30)
        assert "unknown LoRA" in bad.get("error", ""), bad
    finally:
        proc.terminate()
        proc.wait(timeout=30)
