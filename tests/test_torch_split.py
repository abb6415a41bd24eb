"""The split prefill path of rbg_tpu_torch against rbg_tpu's on the CPU:
``forward_paged`` over [B, T] blocks with pads (logits at real tokens
within 1e-4, the pools' written values equal, int8 bit for bit), engines
with ``ragged="off"`` (identical greedy tokens, multi_step 1 and 4, on
tiny, tiny over int8 pools, tiny-mla and tiny-moe), the contiguous-cache
``forward`` / ``prefill_and_decode_greedy`` and the config's checks.
Inputs come from numpy seeds; the reference runs with use_pallas="never"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.engine import EngineConfig as JConfig
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import (KVCache as JKVCache, forward as j_forward,
                                  forward_paged as j_forward_paged,
                                  prefill_and_decode_greedy as j_greedy)
from rbg_tpu_torch.engine.config import EngineConfig
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import (KVCache, forward, forward_paged,
                                        prefill_and_decode_greedy)
from test_torch_engine import BASE, _compare, _prompts
from test_torch_mla import LOGIT_ATOL, _assert_pools_match, _j_scales, _pools, t

# name → (preset, kv_dtype)
MODELS = {"tiny": ("tiny", "model"), "tiny-int8": ("tiny", "int8"),
          "tiny-mla": ("tiny-mla", "model"), "tiny-moe": ("tiny-moe", "model"),
          "tiny-mla-int8": ("tiny-mla", "int8")}
ENGINE_MODELS = ("tiny", "tiny-int8", "tiny-mla", "tiny-moe")

_WEIGHTS = {}


def _weights(preset):
    """(JAX config, port config, JAX params, port params), seed 0."""
    if preset not in _WEIGHTS:
        jcfg, cfg = j_get_config(preset), get_config(preset)
        jp = j_init(jcfg, jax.random.key(0))
        _WEIGHTS[preset] = (jcfg, cfg, jp,
                            params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return _WEIGHTS[preset]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("T", [5, 16])
def test_forward_paged_block_with_pads_matches_jax(name, T):
    """A [4, T] block as the split path builds it: a full prefill chunk, a
    chunk's tail (pads after it), a verify-shaped row of 2 real tokens, and
    a bucket row of pads only, over a pool holding earlier context."""
    preset, kv_dtype = MODELS[name]
    jcfg, cfg, jp, tp = _weights(preset)
    rng = np.random.RandomState(T)
    page, B, P = 8, 4, 6
    pools0 = _pools(cfg, B * P + 1, page, rng, kv_dtype)
    table = (np.arange(B * P) + 1).reshape(B, P).astype(np.int32)
    table[3] = 0                                    # the pad row's table
    start = np.asarray([0, 9, 20, 0], np.int32)
    n_real = np.asarray([T, T - 3, 2, 0])
    tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
    mask = np.arange(T)[None] < n_real[:, None]
    pos[~mask] = 0                                  # the engine's pad position
    kvl = (start + n_real).astype(np.int32)
    kvl[3] = 0
    kp, vp, ks, vs = pools0
    jl, *jpools = j_forward_paged(
        jp, jcfg, *map(jnp.asarray, (tok, pos, mask, kvl, table, kp, vp)),
        use_pallas="never", **_j_scales(ks, vs))
    pools = [None if a is None else t(a.copy()) for a in pools0]
    tl = forward_paged(tp, cfg, *map(t, (tok, pos, mask, kvl, table)), pools[0],
                       pools[1], k_scales=pools[2], v_scales=pools[3])
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=LOGIT_ATOL, rtol=0)
    _assert_pools_match(pools, jpools)


@pytest.mark.parametrize("name", ENGINE_MODELS)
@pytest.mark.parametrize("multi_step", [1, 4])
def test_ragged_off_engine_matches_jax(name, multi_step):
    """ragged="off": staggered joins go through the batched prefill step and
    the fused decode window; greedy tokens identical to the reference's,
    and no unified step is taken."""
    preset, kv_dtype = MODELS[name]
    _, _, jp, tp = _weights(preset)
    p = _prompts(0, (5, 40, 17, 3, 30))
    schedule = [(0, p[0], 12), (0, p[1], 6), (2, p[2], 9), (3, p[3], 5),
                (7, p[4], 8)]
    je, te = _compare((jp, tp), schedule, model=preset, num_pages=64,
                      multi_step=multi_step, kv_dtype=kv_dtype, ragged="off")
    assert te.metrics["unified_steps"] == je.metrics["unified_steps"] == 0
    assert te.metrics["decode_windows"] > 0
    assert te.metrics["prefill_tokens"] == je.metrics["prefill_tokens"]


def test_ragged_off_preemption_matches_jax():
    """A pool too small for the batch under ragged="off": the youngest is
    preempted and resumes, in both engines alike."""
    _, _, jp, tp = _weights("tiny")
    p = _prompts(1, (20, 22, 18))
    schedule = [(0, p[0], 30), (0, p[1], 30), (1, p[2], 30)]
    je, te = _compare((jp, tp), schedule, num_pages=12, enable_radix_cache=False,
                      ragged="off", multi_step=4)
    assert te.metrics["preemptions"] == je.metrics["preemptions"] > 0


def test_ragged_off_window_keeps_multi_step():
    """Under ragged="off" the decode window stays K while work waits; under
    "auto" it shortens to 1 so a join lands next step."""
    _, _, _, tp = _weights("tiny")
    lens = {}
    for ragged in ("auto", "off"):
        te = Engine(EngineConfig(**BASE, num_pages=64, multi_step=4, ragged=ragged),
                    params=tp, device="cpu")
        te.add_request([1, 2, 3])       # work waiting, a batch slot free
        lens[ragged] = te._decode_window()
    assert lens == {"auto": 1, "off": 4}


@pytest.mark.parametrize("preset", ["tiny", "tiny-mla"])
def test_forward_and_greedy_loop_match_jax(preset):
    """The contiguous-cache forward: a prefill with a pad row and a decode
    step (logits within 1e-4, cache lengths equal), then the plain greedy
    loop's tokens."""
    jcfg, cfg, jp, tp = _weights(preset)
    rng = np.random.RandomState(3)
    B, T, S = 2, 7, 16
    tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    jc = JKVCache.create(jcfg, B, S)
    tc = KVCache.create(cfg, B, S)
    jl, jc = j_forward(jp, jcfg, jnp.asarray(tok), jc, token_mask=jnp.asarray(mask))
    tl, tc = forward(tp, cfg, t(tok), tc, token_mask=t(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    step = rng.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc = j_forward(jp, jcfg, jnp.asarray(step), jc)
    tl, tc = forward(tp, cfg, t(step), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=LOGIT_ATOL, rtol=0)
    prompt = rng.randint(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = np.asarray(j_greedy(jp, jcfg, jnp.asarray(prompt), 8))
    got = prefill_and_decode_greedy(tp, cfg, t(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_refuses_a_block_past_capacity():
    _, cfg, _, tp = _weights("tiny")
    with pytest.raises(ValueError, match="capacity"):
        forward(tp, cfg, torch.zeros(1, 9, dtype=torch.int32), KVCache.create(cfg, 1, 8))


@pytest.mark.parametrize("bad", [dict(ragged="on"), dict(ragged="unified"),
                                 dict(ragged="")])
def test_bad_ragged_values_raise_like_the_reference(bad):
    for cfg_cls in (JConfig, EngineConfig):
        with pytest.raises(ValueError, match="ragged"):
            cfg_cls(model="tiny", **bad).validate()
