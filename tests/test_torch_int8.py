"""The port's int8 KV pools against rbg_tpu's on the CPU: quantization and
the in-place int8 writes bit for bit, the plain attention versions of
kernels C and D against the XLA functions and the Pallas kernels in
interpret mode (float32, within 1e-5: the same dequantized math summed in
another order), the llama forwards on ``tiny`` with ``kv_dtype="int8"``
(logits within 1e-4, pools bit for bit) and the engines' greedy tokens.
Inputs come from numpy seeds and go to both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import (forward_paged as j_forward_paged,
                                  forward_ragged as j_forward_ragged)
from rbg_tpu.ops.paged_attention import (paged_attention_xla, quantize_kv as j_quantize,
                                         write_kv_pages as j_write)
from rbg_tpu.ops.pallas.paged_attention_kernel import paged_attention_pallas_q
from rbg_tpu.ops.pallas.ragged_attention_kernel import ragged_paged_attention_pallas_q
from rbg_tpu.ops.ragged_paged_attention import (ragged_paged_attention_xla,
                                                write_kv_pages_ragged as j_write_ragged)
from rbg_tpu_torch.engine.kvcache import PagedKVCache
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged
from rbg_tpu_torch.ops.paged_attention import (paged_attention_plain, quantize_kv,
                                               write_kv_pages)
from rbg_tpu_torch.ops.ragged_paged_attention import (ragged_paged_attention_plain,
                                                      write_kv_pages_ragged)
from test_torch_engine import _compare, _prompts

ATOL = 1e-5         # attention: the tolerance of tests/test_torch_ops.py
LOGIT_ATOL = 1e-4   # forwards: the tolerance of tests/test_torch_model.py


def t(a):
    return torch.from_numpy(np.array(a))


def _q_pools(rng, NP, page, KV, hd):
    """An int8 pool pair with scales, quantized by JAX from random values."""
    out = []
    for _ in range(2):
        q8, s = j_quantize(jnp.asarray(rng.randn(NP, page, KV, hd).astype(np.float32)))
        out += [np.asarray(q8), np.asarray(s)]
    k8, ks, v8, vs = out
    return k8, v8, ks, vs


def test_quantize_kv_matches_jax_bit_for_bit():
    """Random values, an all-zero vector, exact halves (round half to even)
    and values at the clip limit."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 3, 32) * rng.uniform(0.01, 30, (6, 5, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 0, 0] = np.arange(32) - 15.5            # absmax 16.5: k/2 steps
    x[1, 0, 1, :] = 127.0
    x[1, 0, 1, 0] = -127.0
    got_q, got_s = quantize_kv(t(x))
    want_q, want_s = (np.asarray(a) for a in j_quantize(jnp.asarray(x)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_write_kv_pages_int8_matches_jax():
    rng = np.random.RandomState(1)
    NP, page, KV, hd, B, T, P = 9, 4, 2, 16, 2, 3, 4
    k8, v8, ks, vs = _q_pools(rng, NP, page, KV, hd)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.asarray([[3, 4, 5], [P * page, -1, 0]], np.int32)   # pads: odd positions
    mask = np.asarray([[True, True, True], [False, False, True]])
    kn = rng.randn(B, T, KV, hd).astype(np.float32)
    vn = rng.randn(B, T, KV, hd).astype(np.float32)
    want = j_write(*map(jnp.asarray, (k8, v8, kn, vn, table, pos, mask, ks, vs)))
    got = [t(a.copy()) for a in (k8, v8, ks, vs)]
    write_kv_pages(got[0], got[1], t(kn), t(vn), t(table), t(pos), t(mask),
                   got[2], got[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_kv_pages_ragged_int8_matches_jax():
    rng = np.random.RandomState(2)
    NP, page, KV, hd = 9, 4, 2, 16
    k8, v8, ks, vs = _q_pools(rng, NP, page, KV, hd)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rows = np.asarray([0, 0, 1, 0, 0], np.int32)
    pos = np.asarray([[6, 7, 2, -1, -1]], np.int32)
    mask = pos >= 0
    kn = rng.randn(1, 5, KV, hd).astype(np.float32)
    vn = rng.randn(1, 5, KV, hd).astype(np.float32)
    want = j_write_ragged(*map(jnp.asarray, (k8, v8, kn, vn, table, rows, pos,
                                             mask, ks, vs)))
    got = [t(a.copy()) for a in (k8, v8, ks, vs)]
    write_kv_pages_ragged(got[0], got[1], t(kn), t(vn), t(table), t(rows), t(pos),
                          t(mask), got[2], got[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _paged_case(seed, T=1, B=4, P=6, page=8, KV=2, G=3, hd=32):
    rng = np.random.RandomState(seed)
    NP = B * P + 1
    k8, v8, ks, vs = _q_pools(rng, NP, page, KV, hd)
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P).astype(np.int32)
    lens = np.asarray([T, page, page + 1, P * page][:B], np.int32)
    q = rng.randn(B, T, KV * G, hd).astype(np.float32)
    pos = (lens[:, None] - T + np.arange(T)[None]).astype(np.int32)
    return q, k8, v8, table, pos, lens, ks, vs


@pytest.mark.parametrize("T", [1, 3])
def test_paged_attention_plain_int8_matches_xla(T):
    q, k8, v8, table, pos, lens, ks, vs = _paged_case(3, T=T)
    got = paged_attention_plain(*map(t, (q, k8, v8, table, pos, lens, ks, vs)))
    ref = paged_attention_xla(*map(jnp.asarray, (q, k8, v8, table, pos, lens, ks, vs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_paged_attention_plain_int8_matches_pallas_q_interpret():
    """Kernel C's TPU original, with a kv_len-0 row (0 in both)."""
    q, k8, v8, table, pos, lens, ks, vs = _paged_case(4)
    lens = lens.copy()
    lens[0] = 0
    pos = np.maximum(lens - 1, 0)[:, None].astype(np.int32)
    got = paged_attention_plain(*map(t, (q, k8, v8, table, pos, lens, ks, vs))).numpy()
    ref = np.asarray(paged_attention_pallas_q(
        *map(jnp.asarray, (q, k8, v8, table, pos, lens, ks, vs)), interpret=True))
    np.testing.assert_allclose(got[1:], ref[1:], atol=ATOL, rtol=ATOL)
    assert np.all(got[0] == 0) and np.all(ref[0] == 0)


def _ragged_case(seed, specs, H=8, KV=2, hd=32, P=6, page=8, pads=0):
    rng = np.random.RandomState(seed)
    R = len(specs)
    NP = R * P + 1
    k8, v8, ks, vs = _q_pools(rng, NP, page, KV, hd)
    table = (rng.permutation(NP - 1)[:R * P] + 1).reshape(R, P).astype(np.int32)
    lens = np.asarray([kv for _, kv in specs], np.int32)
    rows, qpos = [], []
    for r, (ql, kv) in enumerate(specs):
        rows += [r] * ql
        qpos += list(range(kv - ql, kv))
    rows = np.asarray(rows + [0] * pads, np.int32)
    qpos = np.asarray([qpos + [-1] * pads], np.int32)
    q = rng.randn(1, rows.shape[0], H, hd).astype(np.float32)
    return (q, k8, v8, table, qpos, lens, rows), (ks, vs)


@pytest.mark.parametrize("specs", [[(12, 12), (1, 9)], [(7, 19), (1, 33), (2, 12)],
                                   [(1, 9), (1, 21), (1, 33), (2, 6), (3, 7)]],
                         ids=["straddle", "boundary_in_tile", "three_in_tile"])
def test_ragged_plain_int8_matches_xla_and_pallas_q(specs):
    case, (ks, vs) = _ragged_case(5, specs)
    got = ragged_paged_attention_plain(*map(t, case), k_scales=t(ks),
                                       v_scales=t(vs)).numpy()
    jc = list(map(jnp.asarray, case))
    js = (jnp.asarray(ks), jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(ragged_paged_attention_xla(*jc, *js)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_attention_pallas_q(*jc, *js, interpret=True)),
        atol=ATOL, rtol=ATOL)


def test_ragged_plain_int8_non_contiguous_rows_match_pallas_q():
    """Rows and pads interleaved. Real tokens agree; the port's pads give 0
    (the reference kernel's pads between a row's tokens do not)."""
    (q, k8, v8, table, qpos, lens, rows), (ks, vs) = _ragged_case(
        6, [(5, 15), (1, 21), (1, 4), (3, 40)], pads=3)
    perm = np.random.RandomState(6).permutation(rows.shape[0])
    case = (q[:, perm], k8, v8, table, qpos[:, perm], lens, rows[perm])
    got = ragged_paged_attention_plain(*map(t, case), k_scales=t(ks),
                                       v_scales=t(vs)).numpy()
    ref = np.asarray(ragged_paged_attention_pallas_q(
        *map(jnp.asarray, case), jnp.asarray(ks), jnp.asarray(vs), interpret=True))
    real = case[4][0] >= 0
    np.testing.assert_allclose(got[:, real], ref[:, real], atol=ATOL, rtol=ATOL)
    assert np.all(got[:, ~real] == 0)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"), "cpu")
    return jp, tp


def _int8_pools(cfg, NP, page, seed):
    """Quantized random pools (context the forward attends to)."""
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, NP, page, cfg.num_kv_heads, cfg.head_dim_)
    return _q_pools_shape(rng, shape)


def _q_pools_shape(rng, shape):
    out = []
    for _ in range(2):
        q8, s = j_quantize(jnp.asarray(rng.randn(*shape).astype(np.float32)))
        out += [np.asarray(q8), np.asarray(s)]
    return out[0], out[2], out[1], out[3]


def _assert_pools_match(pools, jpools):
    """The forwards' int8 writes: the same int8 values, and scales within
    1e-6 relative (K and V come from the two frameworks' matmuls, an ulp
    apart, so absmax/127 may differ by an ulp)."""
    for g, w in zip(pools[:2], jpools[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(pools[2:], jpools[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_forward_paged_int8_matches_jax(weights):
    """A decode step and a 4-token step with a pad over an int8 pool."""
    jp, tp = weights
    cfg = get_config("tiny")
    page, P, B = 8, 4, 2
    k8, v8, ks, vs = _int8_pools(cfg, B * P + 1, page, 7)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rng = np.random.RandomState(8)
    for T in (1, 4):
        tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
        start = np.asarray([[9], [20]], np.int32)
        pos = (start + np.arange(T)[None]).astype(np.int32)
        mask = np.ones((B, T), bool)
        mask[1, -1] = False
        kvl = (start[:, 0] + mask.sum(1)).astype(np.int32)
        jl, *jpools = j_forward_paged(
            jp, j_get_config("tiny"), *map(jnp.asarray, (tok, pos, mask, kvl, table,
                                                         k8, v8)),
            use_pallas="never", k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        pools = [t(a.copy()) for a in (k8, v8, ks, vs)]
        tl = forward_paged(tp, cfg, *map(t, (tok, pos, mask, kvl, table)),
                           pools[0], pools[1], k_scales=pools[2], v_scales=pools[3])
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=LOGIT_ATOL, rtol=0)
        _assert_pools_match(pools, jpools)


def test_forward_ragged_int8_matches_jax(weights):
    """A unified-step pack (prefill chunk, decode token, prefill chunk,
    pads) over an int8 pool."""
    jp, tp = weights
    cfg = get_config("tiny")
    page, P, R = 8, 4, 3
    k8, v8, ks, vs = _int8_pools(cfg, R * P + 1, page, 9)
    table = (np.arange(R * P) + 1).reshape(R, P).astype(np.int32)
    rows = np.asarray([0] * 5 + [1] + [2] * 6 + [0] * 4, np.int32)
    pos = np.asarray([list(range(0, 5)) + [17] + list(range(8, 14)) + [-1] * 4],
                     np.int32)
    mask = pos >= 0
    kvl = np.asarray([5, 18, 14], np.int32)
    tok = np.random.RandomState(10).randint(0, cfg.vocab_size,
                                            size=(1, rows.shape[0])).astype(np.int32)
    jl, *jpools = j_forward_ragged(
        jp, j_get_config("tiny"), *map(jnp.asarray, (tok, pos, mask, rows, kvl,
                                                     table, k8, v8)),
        use_pallas="never", k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        max_q_len=8)
    pools = [t(a.copy()) for a in (k8, v8, ks, vs)]
    tl = forward_ragged(tp, cfg, *map(t, (tok, pos, mask, rows, kvl, table)),
                        pools[0], pools[1], max_q_len=8, k_scales=pools[2],
                        v_scales=pools[3])
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=LOGIT_ATOL, rtol=0)
    _assert_pools_match(pools, jpools)


def test_int8_pool_shapes_and_bytes():
    """The four pool kinds of PagedKVCache.create, and hbm_bytes as the
    reference counts it."""
    from rbg_tpu.engine.kvcache import PagedKVCache as JCache
    for name in ("tiny", "tiny-mla"):
        cfg, jcfg = get_config(name), j_get_config(name)
        for quantize in (False, True):
            c = PagedKVCache.create(cfg, 5, 8, device="cpu", quantize=quantize)
            jc = JCache.create(jcfg, 5, 8, quantize=quantize)
            assert c.quantized == jc.quantized == quantize
            for a, b in [(c.k_pages, jc.k_pages), (c.v_pages, jc.v_pages),
                         (c.k_scales, jc.k_scales), (c.v_scales, jc.v_scales)]:
                if b is None:
                    assert a is None
                else:
                    assert tuple(a.shape) == b.shape
                    assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert (PagedKVCache.hbm_bytes(cfg, 64, 16, 1)
                == JCache.hbm_bytes(jcfg, 64, 16, 1))


@pytest.mark.parametrize("multi_step", [1, 4])
def test_int8_engine_staggered_joins_match_jax(weights, multi_step):
    """tiny with kv_dtype='int8': greedy tokens identical to rbg_tpu's
    under staggered joins."""
    p = _prompts(0, (5, 40, 17, 3, 30))
    schedule = [(0, p[0], 12), (0, p[1], 6), (2, p[2], 9), (3, p[3], 5),
                (7, p[4], 8)]
    je, te = _compare(weights, schedule, num_pages=64, multi_step=multi_step,
                      kv_dtype="int8")
    assert te.cache.quantized and te.cache.k_pages.dtype == torch.int8
    assert te.metrics["unified_steps"] == je.metrics["unified_steps"]
