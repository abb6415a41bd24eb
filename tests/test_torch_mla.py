"""The port's MLA and MoE against rbg_tpu's on the CPU: the plain versions
of kernels E and F (and the int8 latent math of G and H) against the XLA
functions and the Pallas kernels in interpret mode (float32, within 1e-5),
the MoE MLP with routing ties, the llama forwards on ``tiny-mla``,
``tiny-moe`` and the MLA + MoE config of tests/test_mla.py, and the MLA
ones again over int8 latent pools (logits within 1e-4, the pools' int8
values equal), and the engines' greedy tokens. Inputs come from numpy
seeds and go to both frameworks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rbg_tpu.models.config as j_config_mod
import rbg_tpu_torch.models.config as config_mod
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import (_moe_mlp as j_moe_mlp,
                                  forward_paged as j_forward_paged,
                                  forward_ragged as j_forward_ragged)
from rbg_tpu.ops.mla_attention import (paged_mla_attention_xla,
                                       ragged_paged_mla_attention_xla)
from rbg_tpu.ops.paged_attention import quantize_kv as j_quantize
from rbg_tpu.ops.ragged_paged_attention import (
    write_kv_pages_ragged as j_write_ragged)
from rbg_tpu.ops.pallas.paged_attention_kernel import (
    paged_mla_attention_pallas, paged_mla_attention_pallas_q)
from rbg_tpu.ops.pallas.ragged_attention_kernel import (
    ragged_paged_mla_attention_pallas, ragged_paged_mla_attention_pallas_q)
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import (_moe_mlp, forward_paged, forward_ragged,
                                        init_params)
from rbg_tpu_torch.ops.mla_attention import (paged_mla_attention,
                                             paged_mla_attention_plain,
                                             ragged_paged_mla_attention,
                                             ragged_paged_mla_attention_plain)
from rbg_tpu_torch.ops.ragged_paged_attention import write_kv_pages_ragged
from test_torch_engine import _compare, _prompts

ATOL = 1e-5         # attention: the tolerance of tests/test_torch_ops.py
LOGIT_ATOL = 1e-4   # forwards: the tolerance of tests/test_torch_model.py
SCALE = (32 + 16) ** -0.5
# The MLA + MoE config of tests/test_mla.py::test_mla_moe_combined_forward.
MLA_MOE = dict(mla=True, kv_lora_rank=64, qk_nope_head_dim=32,
               qk_rope_head_dim=16, v_head_dim=32)


def t(a):
    return torch.from_numpy(np.array(a))


def _latent_pools(rng, NP, page, dc, dr):
    return (rng.randn(NP, page, 1, dc).astype(np.float32),
            rng.randn(NP, page, 1, dr).astype(np.float32))


def _paged_case(seed, T=1, B=4, P=5, page=8, H=4, dc=64, dr=16):
    rng = np.random.RandomState(seed)
    NP = B * P + 1
    c, pe = _latent_pools(rng, NP, page, dc, dr)
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P).astype(np.int32)
    lens = np.asarray([T, page, page + 1, P * page][:B], np.int32)
    q_lat = rng.randn(B, T, H, dc).astype(np.float32)
    q_pe = rng.randn(B, T, H, dr).astype(np.float32)
    pos = (lens[:, None] - T + np.arange(T)[None]).astype(np.int32)
    return q_lat, q_pe, c, pe, table, pos, lens


@pytest.mark.parametrize("T", [1, 3])
def test_paged_mla_plain_matches_xla(T):
    case = _paged_case(0, T=T)
    got = paged_mla_attention_plain(*map(t, case), SCALE)
    ref = paged_mla_attention_xla(*map(jnp.asarray, case), SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("H,dc,dr", [(4, 64, 16), (16, 512, 64)],
                         ids=["tiny-mla", "deepseek-v2-lite"])
def test_paged_mla_plain_matches_pallas_interpret(H, dc, dr):
    """Kernel E's TPU original, with a kv_len-0 row (0 in both)."""
    q_lat, q_pe, c, pe, table, pos, lens = _paged_case(1, B=3, P=3, H=H, dc=dc,
                                                       dr=dr)
    lens = np.asarray([0, 9, 24], np.int32)
    pos = np.maximum(lens - 1, 0)[:, None].astype(np.int32)
    case = (q_lat, q_pe, c, pe, table, pos, lens)
    scale = (128 + dr) ** -0.5
    got = paged_mla_attention_plain(*map(t, case), scale).numpy()
    ref = np.asarray(paged_mla_attention_pallas(*map(jnp.asarray, case), scale,
                                                interpret=True))
    np.testing.assert_allclose(got[1:], ref[1:], atol=ATOL, rtol=ATOL)
    assert np.all(got[0] == 0) and np.all(ref[0] == 0)


@pytest.mark.parametrize("page", [1, 24, 40])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_pools", "int8_pools"])
def test_paged_mla_plain_any_page_size_matches_pallas(page, quantized):
    """Kernels E and G take any page size (their 32-slot latent blocks look
    up each slot's page): the plain version they are held to on the card
    agrees with the TPU originals at page sizes that do not divide 32."""
    q_lat, q_pe, c, pe, table, pos, lens = _paged_case(8, B=3, P=4, page=page)
    lens = np.asarray([1, 2 * page + 1, 4 * page], np.int32)
    pos = (lens - 1)[:, None].astype(np.int32)
    scales = ()
    if quantized:
        c, cs, pe, ps = _quantize(c, pe)
        scales = (cs, ps)
    case = (q_lat, q_pe, c, pe, table, pos, lens)
    got = paged_mla_attention_plain(*map(t, case), SCALE, *map(t, scales)).numpy()
    kernel = paged_mla_attention_pallas_q if quantized else paged_mla_attention_pallas
    ref = np.asarray(kernel(*map(jnp.asarray, case), SCALE, *map(jnp.asarray, scales),
                            interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_mla_decode_wrappers_refuse_other_latent_widths():
    """E and G have (dc, dr) = (512, 64) and (64, 16) instances; other
    widths are a ValueError naming them, raised before the tensors are
    looked at (so also here, on the CPU)."""
    from rbg_tpu_torch.ops.kernels.paged_mla_decode import (
        LATENT_DIMS, paged_mla_decode_attention)
    from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
    assert LATENT_DIMS == ((512, 64), (64, 16))
    for dc, dr in [(128, 32), (512, 16), (64, 64)]:
        q_lat, q_pe, c, pe, table, pos, lens = map(t, _paged_case(9, dc=dc, dr=dr))
        c8, cs, pe8, ps = map(t, _quantize(c.numpy(), pe.numpy()))
        with pytest.raises(ValueError, match=r"\(dc, dr\)"):
            paged_mla_decode_attention(q_lat, q_pe, c, pe, table, lens, SCALE)
        with pytest.raises(ValueError, match=r"\(dc, dr\)"):
            paged_mla_decode_attention_q(q_lat, q_pe, c8, pe8, cs, ps, table, lens, SCALE)


def _quantize(*arrays):
    out = []
    for a in arrays:
        q8, s = j_quantize(jnp.asarray(a))
        out += [np.asarray(q8), np.asarray(s)]
    return out


def _j_scales(ks, vs):
    """The reference forwards' scale arguments (none for model-dtype pools)."""
    if ks is None:
        return {}
    return dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))


def test_paged_mla_plain_int8_matches_xla_and_pallas_q():
    """The plain version's int8 latent math: kernel G's plain version."""
    q_lat, q_pe, c, pe, table, pos, lens = _paged_case(2)
    c8, cs, pe8, ps = _quantize(c, pe)
    case = (q_lat, q_pe, c8, pe8, table, pos, lens)
    got = paged_mla_attention_plain(*map(t, case), SCALE, t(cs), t(ps)).numpy()
    jc = list(map(jnp.asarray, case))
    js = (jnp.asarray(cs), jnp.asarray(ps))
    np.testing.assert_allclose(got, np.asarray(paged_mla_attention_xla(*jc, SCALE, *js)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(paged_mla_attention_pallas_q(*jc, SCALE, *js, interpret=True)),
        atol=ATOL, rtol=ATOL)


def _ragged_case(seed, specs, H=4, dc=64, dr=16, P=6, page=8, pads=0):
    rng = np.random.RandomState(seed)
    R = len(specs)
    NP = R * P + 1
    c, pe = _latent_pools(rng, NP, page, dc, dr)
    table = (rng.permutation(NP - 1)[:R * P] + 1).reshape(R, P).astype(np.int32)
    lens = np.asarray([kv for _, kv in specs], np.int32)
    rows, qpos = [], []
    for r, (ql, kv) in enumerate(specs):
        rows += [r] * ql
        qpos += list(range(kv - ql, kv))
    rows = np.asarray(rows + [0] * pads, np.int32)
    qpos = np.asarray([qpos + [-1] * pads], np.int32)
    T = rows.shape[0]
    return (rng.randn(1, T, H, dc).astype(np.float32),
            rng.randn(1, T, H, dr).astype(np.float32), c, pe, table, qpos, lens, rows)


LAYOUTS = {
    "straddle": [(12, 12), (1, 9)],
    "boundary_in_tile": [(7, 19), (1, 33), (2, 12)],
    "three_in_tile": [(1, 9), (1, 21), (1, 33), (2, 6), (3, 7)],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ragged_mla_plain_matches_xla_and_pallas(layout):
    case = _ragged_case(3, LAYOUTS[layout])
    got = ragged_paged_mla_attention_plain(*map(t, case), SCALE).numpy()
    jc = list(map(jnp.asarray, case))
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_mla_attention_xla(*jc, SCALE)),
        atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_mla_attention_pallas(*jc, SCALE, interpret=True)),
        atol=ATOL, rtol=ATOL)


def test_ragged_mla_plain_pads_non_contiguous_and_max_q_len():
    """Rows that are not contiguous runs, and pads: real tokens agree with
    kernel F's TPU original, pads give 0; the engine's max_q_len bound
    changes nothing real."""
    q_lat, q_pe, c, pe, table, qpos, lens, rows = _ragged_case(
        4, [(5, 15), (1, 21), (1, 4), (3, 40)], pads=6)
    perm = np.random.RandomState(6).permutation(rows.shape[0])
    case = (q_lat[:, perm], q_pe[:, perm], c, pe, table, qpos[:, perm], lens,
            rows[perm])
    got = ragged_paged_mla_attention_plain(*map(t, case), SCALE).numpy()
    bounded = ragged_paged_mla_attention_plain(*map(t, case), SCALE,
                                               max_q_len=5).numpy()
    ref = np.asarray(ragged_paged_mla_attention_pallas(*map(jnp.asarray, case),
                                                       SCALE, interpret=True))
    real = case[5][0] >= 0
    np.testing.assert_allclose(got[:, real], ref[:, real], atol=ATOL, rtol=ATOL)
    assert np.all(got[:, ~real] == 0)
    np.testing.assert_array_equal(bounded, got)


def test_ragged_mla_plain_int8_matches_pallas_q():
    """The plain version's int8 latent math: kernel H's plain version."""
    q_lat, q_pe, c, pe, table, qpos, lens, rows = _ragged_case(
        5, LAYOUTS["boundary_in_tile"])
    c8, cs, pe8, ps = _quantize(c, pe)
    case = (q_lat, q_pe, c8, pe8, table, qpos, lens, rows)
    got = ragged_paged_mla_attention_plain(*map(t, case), SCALE, t(cs),
                                           t(ps)).numpy()
    ref = np.asarray(ragged_paged_mla_attention_pallas_q(
        *map(jnp.asarray, case), SCALE, jnp.asarray(cs), jnp.asarray(ps),
        interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("page", [1, 24, 40])
@pytest.mark.parametrize("quantized", [False, True], ids=["float_pools", "int8_pools"])
def test_ragged_mla_plain_any_page_size_matches_pallas(page, quantized):
    """Kernels F and H take any page size (their 32-slot latent blocks look
    up each slot's page): the plain version they are held to on the card
    agrees with the TPU originals at page sizes that do not divide 32, on a
    pack whose rows are not contiguous runs."""
    q_lat, q_pe, c, pe, table, qpos, lens, rows = _ragged_case(
        10, [(3, 2 * page + 1), (1, 1), (2, 4 * page)], P=4, page=page)
    perm = np.random.RandomState(12).permutation(rows.shape[0])
    scales = ()
    if quantized:
        c, cs, pe, ps = _quantize(c, pe)
        scales = (cs, ps)
    case = (q_lat[:, perm], q_pe[:, perm], c, pe, table, qpos[:, perm], lens, rows[perm])
    got = ragged_paged_mla_attention_plain(*map(t, case), SCALE, *map(t, scales)).numpy()
    kernel = (ragged_paged_mla_attention_pallas_q if quantized
              else ragged_paged_mla_attention_pallas)
    ref = np.asarray(kernel(*map(jnp.asarray, case), SCALE, *map(jnp.asarray, scales),
                            interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_ragged_mla_wrappers_refuse_other_latent_widths():
    """F and H have (dc, dr) = (512, 64) and (64, 16) instances, as E and G
    do; other widths are a ValueError naming them, raised before the
    tensors are looked at (so also here, on the CPU)."""
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
        ragged_paged_mla_attention_q_cuda)
    for dc, dr in [(128, 32), (512, 16), (64, 64)]:
        case = tuple(map(t, _ragged_case(11, [(3, 9), (1, 5)], dc=dc, dr=dr)))
        c8, cs, pe8, ps = map(t, _quantize(case[2].numpy(), case[3].numpy()))
        with pytest.raises(ValueError, match=r"\(dc, dr\)"):
            ragged_paged_mla_attention_cuda(*case, SCALE)
        with pytest.raises(ValueError, match=r"\(dc, dr\)"):
            ragged_paged_mla_attention_q_cuda(case[0], case[1], c8, pe8, cs, ps, *case[4:],
                                              SCALE)


def test_latent_int8_writes_and_pads_match_jax():
    """A pack's latents into int8 latent pools (c and pe, each with
    [NP, page, 1, 1] scales), bit for bit as the reference writes them;
    pad tokens go to the null page 0 carrying its own values and scales,
    so page 0 is unchanged."""
    rng = np.random.RandomState(12)
    NP, page, dc, dr = 9, 4, 64, 16
    c8, cs, pe8, ps = _quantize(*_latent_pools(rng, NP, page, dc, dr))
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rows = np.asarray([0, 0, 1, 0, 0, 1], np.int32)
    pos = np.asarray([[6, 7, 2, -1, -1, -1]], np.int32)
    mask = pos >= 0
    cn = rng.randn(1, 6, 1, dc).astype(np.float32)
    pn = rng.randn(1, 6, 1, dr).astype(np.float32)
    want = j_write_ragged(*map(jnp.asarray, (c8, pe8, cn, pn, table, rows, pos,
                                             mask, cs, ps)))
    got = [t(a.copy()) for a in (c8, pe8, cs, ps)]
    write_kv_pages_ragged(got[0], got[1], t(cn), t(pn), t(table), t(rows), t(pos),
                          t(mask), got[2], got[3])
    for g, w, before in zip(got, want, (c8, pe8, cs, ps)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[0], before[0])


def test_mla_dispatch_on_cpu():
    """CPU tensors: auto and never run the plain version (int8 latent pools
    too); always raises instead of falling back."""
    case = list(map(t, _paged_case(6)))
    ref = paged_mla_attention_plain(*case, SCALE)
    for mode in ("auto", "never"):
        torch.testing.assert_close(
            paged_mla_attention(*case, SCALE, use_kernels=mode), ref)
    with pytest.raises(RuntimeError):
        paged_mla_attention(*case, SCALE, use_kernels="always")
    rcase = list(map(t, _ragged_case(7, [(3, 5)])))
    with pytest.raises(RuntimeError):
        ragged_paged_mla_attention(*rcase, SCALE, use_kernels="always")
    c8, cs, pe8, ps = map(t, _quantize(rcase[2].numpy(), rcase[3].numpy()))
    q = ragged_paged_mla_attention(*rcase[:2], c8, pe8, *rcase[4:], SCALE,
                                   c_scales=cs, pe_scales=ps)
    assert q.shape == rcase[0].shape and bool(torch.isfinite(q).all())


# ---- MoE ----

def _moe_block(cfg, rng, router_scale):
    d, E, mf, fs = cfg.hidden_size, cfg.num_experts, cfg.moe_f, cfg.moe_shared_f
    n = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    return {"router": n(d, E) * router_scale, "moe_gate": n(E, d, mf),
            "moe_up": n(E, d, mf), "moe_down": n(E, mf, d), "w_gate": n(d, fs),
            "w_up": n(d, fs), "w_down": n(fs, d)}


@pytest.mark.parametrize("router_scale", [1.0, 0.0], ids=["random", "all_tied"])
def test_moe_mlp_matches_jax(router_scale):
    """A zero router ties every expert: all are kept (>= the k-th largest),
    as in the reference, not the k that topk indices would pick."""
    cfg, jcfg = get_config("tiny-moe"), j_get_config("tiny-moe")
    rng = np.random.RandomState(8)
    blk = _moe_block(cfg, rng, router_scale)
    xm = rng.randn(2, 5, cfg.hidden_size).astype(np.float32)
    got = _moe_mlp(cfg, {k: t(v) for k, v in blk.items()}, t(xm)).numpy()
    ref = np.asarray(j_moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in blk.items()},
                               jnp.asarray(xm)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# ---- forwards and engines ----

CONFIGS = {"tiny-mla": {}, "tiny-moe": {}, "tiny-mla-moe": MLA_MOE}
# The MLA configs again over int8 latent pools (kernels G and H on the card).
INT8 = {"tiny-mla-int8": "tiny-mla", "tiny-mla-moe-int8": "tiny-mla-moe"}


def _configs(name):
    base = "tiny-moe" if name == "tiny-mla-moe" else name
    return (j_get_config(base, **CONFIGS[name]), get_config(base, **CONFIGS[name]))


@pytest.fixture(scope="module", params=sorted(CONFIGS) + sorted(INT8))
def model(request):
    """(config name, kv_dtype, JAX config, port config, JAX params, port
    params)."""
    name = INT8.get(request.param, request.param)
    jcfg, cfg = _configs(name)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    kv_dtype = "int8" if request.param in INT8 else "model"
    return name, kv_dtype, jcfg, cfg, jp, tp


def _pools(cfg, NP, page, rng, kv_dtype="model"):
    """Random context pools: (k, v, k_scales, v_scales), the scales None for
    model-dtype pools; int8 pools are quantized by JAX."""
    if cfg.mla:
        kshape = (cfg.num_layers, NP, page, 1, cfg.kv_lora_rank)
        vshape = kshape[:-1] + (cfg.qk_rope_head_dim,)
    else:
        kshape = vshape = (cfg.num_layers, NP, page, cfg.num_kv_heads, cfg.head_dim_)
    k, v = (rng.randn(*kshape).astype(np.float32),
            rng.randn(*vshape).astype(np.float32))
    if kv_dtype == "model":
        return k, v, None, None
    k8, ks, v8, vs = _quantize(k, v)
    return k8, v8, ks, vs


def _assert_pools_match(pools, jpools):
    """The forwards' writes: pools equal (int8 values exactly; model-dtype
    within the logits' tolerance) and int8 scales within 1e-6 relative (the
    latents come from the two frameworks' matmuls, an ulp apart)."""
    for g, w in zip(pools[:2], jpools[:2]):
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_ATOL, rtol=0)
    for g, w in zip(pools[2:], jpools[2:]):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_forward_paged_matches_jax(model):
    """A decode step (T=1) and a 4-token step with a pad token over a pool
    holding earlier context; logits and pools agree."""
    _, kv_dtype, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(9)
    page, B = 8, 2
    pools0 = _pools(cfg, 9, page, rng, kv_dtype)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for T in (1, 4):
        tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
        start = np.asarray([[9], [20]], np.int32)
        pos = (start + np.arange(T)[None]).astype(np.int32)
        mask = np.ones((B, T), bool)
        mask[1, -1] = False
        kvl = (start[:, 0] + mask.sum(1)).astype(np.int32)
        kp, vp, ks, vs = pools0
        jl, *jpools = j_forward_paged(
            jp, jcfg, *map(jnp.asarray, (tok, pos, mask, kvl, table, kp, vp)),
            use_pallas="never", **_j_scales(ks, vs))
        pools = [None if a is None else t(a.copy()) for a in pools0]
        tl = forward_paged(tp, cfg, *map(t, (tok, pos, mask, kvl, table)),
                           pools[0], pools[1], k_scales=pools[2], v_scales=pools[3])
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=LOGIT_ATOL, rtol=0)
        _assert_pools_match(pools, jpools)


def test_forward_ragged_matches_jax(model):
    """A unified-step pack: a prefill chunk of row 0, a decode token of
    row 1, a prefill chunk of row 2, then pads (row 0, position -1)."""
    _, kv_dtype, jcfg, cfg, jp, tp = model
    rng = np.random.RandomState(10)
    page, P, R = 8, 4, 3
    kp, vp, ks, vs = _pools(cfg, R * P + 1, page, rng, kv_dtype)
    table = (np.arange(R * P) + 1).reshape(R, P).astype(np.int32)
    rows = np.asarray([0] * 5 + [1] + [2] * 6 + [0] * 4, np.int32)
    pos = np.asarray([list(range(0, 5)) + [17] + list(range(8, 14)) + [-1] * 4],
                     np.int32)
    mask = pos >= 0
    kvl = np.asarray([5, 18, 14], np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(1, rows.shape[0])).astype(np.int32)
    jl, *jpools = j_forward_ragged(
        jp, jcfg, *map(jnp.asarray, (tok, pos, mask, rows, kvl, table, kp, vp)),
        use_pallas="never", max_q_len=8, **_j_scales(ks, vs))
    pools = [None if a is None else t(a.copy()) for a in (kp, vp, ks, vs)]
    tl = forward_ragged(tp, cfg, *map(t, (tok, pos, mask, rows, kvl, table)),
                        pools[0], pools[1], max_q_len=8, k_scales=pools[2],
                        v_scales=pools[3])
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=LOGIT_ATOL, rtol=0)
    _assert_pools_match(pools, jpools)


def test_init_params_layout_matches_jax(model):
    """The port's seeded init has the reference's tree, shapes and dtypes
    (the shared expert at moe_shared_f), and is a pure function of the
    seed."""
    _, _, _, cfg, jp, _ = model
    a, b = init_params(cfg, 3, "cpu"), init_params(cfg, 3, "cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "blocks"},
                      **{f"blocks.{k}": v for k, v in p["blocks"].items()}}
    fa, fj = flat(a), flat(jax.tree.map(np.asarray, jp))
    assert sorted(fa) == sorted(fj)
    for k in fa:
        assert tuple(fa[k].shape) == fj[k].shape, k
        assert torch.equal(fa[k], flat(b)[k]), k


@pytest.fixture
def presets(monkeypatch):
    """Both packages name the MLA + MoE config as a preset, so the engines
    can be built from an EngineConfig."""
    for mod, get in ((j_config_mod, j_get_config), (config_mod, get_config)):
        monkeypatch.setitem(mod._PRESETS, "tiny-mla-moe",
                            dataclasses.replace(get("tiny-moe", **MLA_MOE),
                                                name="tiny-mla-moe"))


@pytest.mark.parametrize("multi_step", [1, 4])
def test_engine_staggered_joins_match_jax(model, presets, multi_step):
    """Greedy tokens identical to rbg_tpu's under staggered joins (unified
    steps mixing decode rows with prefill chunks, then decode windows)."""
    name, kv_dtype, _, _, jp, tp = model
    p = _prompts(0, (5, 40, 17, 3, 30))
    schedule = [(0, p[0], 12), (0, p[1], 6), (2, p[2], 9), (3, p[3], 5),
                (7, p[4], 8)]
    je, te = _compare((jp, tp), schedule, model=name, num_pages=64,
                      multi_step=multi_step, kv_dtype=kv_dtype)
    assert te.metrics["unified_steps"] == je.metrics["unified_steps"]
    assert te.cache.quantized == (kv_dtype == "int8")
