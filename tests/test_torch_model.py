"""rbg_tpu_torch's llama forwards against rbg_tpu's on the same weights
(the JAX init converted by the weight bridge), tiny preset, float32, on the
CPU. Logits agree within 1e-4: the same math in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import (forward_paged as j_forward_paged,
                                  forward_ragged as j_forward_ragged)
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from rbg_tpu_torch.models.llama import forward_paged, forward_ragged, init_params

ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"), "cpu")
    return jp, tp


def _pool(cfg, NP, page, rng):
    shape = (cfg.num_layers, NP, page, cfg.num_kv_heads, cfg.head_dim_)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def test_forward_paged_matches_jax(weights):
    """A decode step (T=1) and a prefill-shaped step (T=4, with a pad
    token) over a pool holding earlier context; logits and pools agree."""
    jp, tp = weights
    cfg = get_config("tiny")
    rng = np.random.RandomState(0)
    page, P, B = 8, 4, 2
    NP = B * P + 1
    kp, vp = _pool(cfg, NP, page, rng)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for T in (1, 4):
        tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
        start = np.asarray([[9], [20]], np.int32)
        pos = (start + np.arange(T)[None]).astype(np.int32)
        mask = np.ones((B, T), bool)
        mask[1, -1] = False
        kvl = (start[:, 0] + np.where(mask, 1, 0).sum(1)).astype(np.int32)
        jl, jk, jv, _, _ = j_forward_paged(
            jp, j_get_config("tiny"), *map(jnp.asarray, (tok, pos, mask, kvl, table,
                                                         kp, vp)),
            use_pallas="never")
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        tl = forward_paged(tp, cfg, *map(torch.from_numpy, (tok, pos, mask, kvl,
                                                            table)), tk, tv)
        real = mask
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_forward_ragged_matches_jax(weights):
    """A unified-step pack: a prefill chunk of row 0, a decode token of
    row 1, a prefill chunk of row 2, then pads (row 0, position -1)."""
    jp, tp = weights
    cfg = get_config("tiny")
    rng = np.random.RandomState(1)
    page, P, R = 8, 4, 3
    NP = R * P + 1
    kp, vp = _pool(cfg, NP, page, rng)
    table = (np.arange(R * P) + 1).reshape(R, P).astype(np.int32)
    rows = np.asarray([0] * 5 + [1] + [2] * 6 + [0] * 4, np.int32)
    pos = np.asarray([list(range(0, 5)) + [17] + list(range(8, 14)) + [-1] * 4],
                     np.int32)
    mask = pos >= 0
    kvl = np.asarray([5, 18, 14], np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(1, rows.shape[0])).astype(np.int32)
    jl, jk, jv, _, _ = j_forward_ragged(
        jp, j_get_config("tiny"), *map(jnp.asarray, (tok, pos, mask, rows, kvl,
                                                     table, kp, vp)),
        use_pallas="never", max_q_len=8)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = forward_ragged(tp, cfg, *map(torch.from_numpy, (tok, pos, mask, rows, kvl,
                                                         table)), tk, tv,
                        max_q_len=8)
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_convert_bfloat16_round_trip():
    """bf16 arrays (ml_dtypes numpy) cross the bridge bit for bit."""
    cfg = j_get_config("tiny", dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init(cfg, jax.random.key(1)))
    tp = params_from_numpy(jp, get_config("tiny", dtype="bfloat16"), "cpu")
    assert tp["blocks"]["wq"].dtype == torch.bfloat16
    for name, a in [("embed", jp["embed"]), ("wq", jp["blocks"]["wq"])]:
        b = tp[name] if name == "embed" else tp["blocks"][name]
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      a.view(np.int16))
    with pytest.raises(TypeError):
        params_from_numpy(jp, get_config("tiny"), "cpu")   # float32 config
    assert tensor_from_numpy(np.ones(3, np.float32)).dtype == torch.float32


def test_init_params_layout_matches_jax(weights):
    """The port's own seeded init has the reference's tree, shapes, dtypes
    and scales, and is a pure function of the seed."""
    jp, _ = weights
    cfg = get_config("tiny")
    a = init_params(cfg, 3, "cpu")
    b = init_params(cfg, 3, "cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "blocks"},
                      **{f"blocks.{k}": v for k, v in p["blocks"].items()}}
    fa, fj = flat(a), flat(jax.tree.map(np.asarray, jp))
    assert sorted(fa) == sorted(fj)
    for k in fa:
        assert tuple(fa[k].shape) == fj[k].shape, k
        assert torch.equal(fa[k], flat(b)[k]), k
    assert abs(float(a["blocks"]["wq"].std()) - 0.02) < 2e-3
    assert torch.all(a["final_norm"] == 1)
