"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor rbg_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerances: float32 inputs compare at 1e-5 (the same math, summed in
another order). bfloat16 inputs: both sides accumulate in float32 and round
the output to bfloat16 once, so they may differ by one bfloat16 rounding
step of the output, |d| <= 2^-7 |ref| (+1e-3 for values near 0).
"""

import numpy as np
import pytest
import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from rbg_tpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_plain)
from rbg_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2 ** -7, atol=1e-3))


def _pool(rng, dev, dtype, NP, page, KV, hd):
    k = torch.from_numpy(rng.randn(NP, page, KV, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(NP, page, KV, hd).astype(np.float32))
    return k.to(dev, dtype), v.to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 128), (2, 7, 64), (2, 2, 32)])
def test_paged_decode_matches_plain(dev, dtype, KV, G, hd):
    rng = np.random.RandomState(0)
    page, P = 16, 12
    kv_lens_l = [1, 15, 16, 17, 100, P * page, 33, 0]
    B = len(kv_lens_l)
    NP = B * P + 1
    k, v = _pool(rng, dev, dtype, NP, page, KV, hd)
    table = torch.from_numpy((rng.permutation(NP - 1)[:B * P] + 1)
                             .reshape(B, P).astype(np.int32)).to(dev)
    kv_lens = torch.tensor(kv_lens_l, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(B, 1, KV * G, hd).astype(np.float32)).to(dev, dtype)
    pos = (kv_lens - 1).clamp(min=0)[:, None]
    reset_launches()
    got = paged_attention(q, k, v, table, pos, kv_lens, use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode"] == 1
    ref = paged_attention_plain(q, k, v, table, pos, kv_lens)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[-1] == 0)      # kv_len 0 gives 0


def _ragged_case(rng, dev, dtype, specs, KV, G, hd, page=16, P=8, pads=0,
                 order=None):
    """specs: (q_len, kv_len) per row; queries are each row's causal tail.
    ``order`` permutes the packed tokens (non-contiguous rows)."""
    R = len(specs)
    NP = R * P + 1
    k, v = _pool(rng, dev, dtype, NP, page, KV, hd)
    table = torch.from_numpy((rng.permutation(NP - 1)[:R * P] + 1)
                             .reshape(R, P).astype(np.int32)).to(dev)
    rows, qpos = [], []
    for r, (ql, kvl) in enumerate(specs):
        rows += [r] * ql
        qpos += list(range(kvl - ql, kvl))
    rows += [0] * pads
    qpos += [-1] * pads
    rows, qpos = np.asarray(rows, np.int32), np.asarray(qpos, np.int32)
    if order is not None:
        perm = order(len(rows))
        rows, qpos = rows[perm], qpos[perm]
    T = len(rows)
    q = torch.from_numpy(rng.randn(1, T, KV * G, hd).astype(np.float32)).to(dev, dtype)
    return (q, k, v, table, torch.from_numpy(qpos[None]).to(dev),
            torch.tensor([kv for _, kv in specs], dtype=torch.int32, device=dev),
            torch.from_numpy(rows).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 128), (2, 7, 64)])
@pytest.mark.parametrize("layout", ["straddle", "three_in_tile", "pads",
                                    "shuffled", "empty_row"])
def test_ragged_matches_plain(dev, dtype, KV, G, hd, layout):
    rng = np.random.RandomState(1)
    kw = {}
    if layout == "straddle":        # a prefill row across two tiles + decodes
        specs = [(12, 12), (1, 9), (20, 100)]
    elif layout == "three_in_tile":
        specs = [(1, 9), (1, 21), (1, 33), (2, 6), (3, 7)]
    elif layout == "pads":          # an all-pad tile after the real tokens
        specs, kw = [(2, 9), (1, 13)], dict(pads=13)
    elif layout == "shuffled":      # rows are not contiguous runs
        specs = [(5, 15), (1, 21), (1, 4), (3, 40)]
        kw = dict(order=lambda n: np.random.RandomState(7).permutation(n))
    else:                           # a row with kv_len 0 (bucket padding)
        specs = [(3, 30), (1, 5), (0, 0)]
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, dtype, specs,
                                                    KV, G, hd, **kw)
    reset_launches()
    got = ragged_paged_attention(q, k, v, table, qpos, lens, rows,
                                 use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged"] == 1
    ref = ragged_paged_attention_plain(q, k, v, table, qpos, lens, rows)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[0, qpos[0] < 0] == 0)      # pads give 0


def test_dispatch_never_and_decode_shape_check(dev):
    """'never' takes the plain version on the card and launches nothing;
    the decode kernel refuses T > 1 rather than falling back."""
    rng = np.random.RandomState(2)
    k, v = _pool(rng, dev, torch.bfloat16, 9, 16, 2, 64)
    table = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    lens = torch.tensor([20, 40], dtype=torch.int32, device=dev)
    q = torch.randn(2, 1, 4, 64, device=dev, dtype=torch.bfloat16)
    reset_launches()
    paged_attention(q, k, v, table, (lens - 1)[:, None], lens, use_kernels="never")
    assert LAUNCHES["paged_decode"] == 0
    with pytest.raises(ValueError):
        paged_attention(q.expand(2, 2, 4, 64).contiguous(), k, v, table,
                        torch.stack([lens - 2, lens - 1], 1), lens)
