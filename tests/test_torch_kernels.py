"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor rbg_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerances: float32 inputs compare at 1e-5 (the same math, summed in
another order); the MLA kernels' (E-H) scores are 576-term dot products at
deepseek-v2-lite widths, so there float32 compares at 5e-5. bfloat16
inputs: both sides accumulate in float32 and round the output to bfloat16
once, so they may differ by one bfloat16 rounding step of the output,
|d| <= 2^-7 |ref| (+1e-3 for values near 0). int8 pools hold the same
quantized values on both sides (the kernel folds the scales, the plain
version dequantizes), so they keep the tolerance of q's dtype.
"""

import numpy as np
import pytest
import torch

from rbg_tpu_torch.engine.sampler import gumbel_noise, row_keys
from rbg_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from rbg_tpu_torch.ops.kernels.ragged_paged import tile_tokens
from rbg_tpu_torch.ops.mla_attention import (
    paged_mla_attention, paged_mla_attention_plain, ragged_paged_mla_attention,
    ragged_paged_mla_attention_plain)
from rbg_tpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_plain,
                                               quantize_kv)
from rbg_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain,
    ragged_paged_attention_tokengrid)

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


# The kernels phase's decode rows (chip_smoke.DECODE_LENS).
DECODE_LENS = [2048, 1900, 1536, 1200, 1024, 700, 333, 65]


def _decode_case(case):
    """(kv_lens, table width P, page size) of a decode case of kernels A
    and C."""
    if case == "page24":    # 64-slot blocks span pages of a size not dividing 64
        return [1, 23, 24, 25, 64, 65, 500, 0], 24, 24
    if case == "page128":   # pages larger than a block
        return [1, 64, 127, 129, 700, 2000, 0], 16, 128
    return _decode_case16(case) + (16,)


def _decode_case16(case):
    """(kv_lens, table width P) of a decode case at page size 16."""
    if case == "mixed":
        return [1, 15, 16, 17, 100, 12 * 16, 33, 0], 12
    if case == "split":     # rows whose walks split, and a kv_len-0 row
        return DECODE_LENS + [0], 128
    if case == "edges":     # one slot, whole KV blocks, one slot past a block edge
        return [1, 64, 65, 128, 129, 256, 257, 0], 17
    if case == "long":      # an 8192-slot row in a 512-page table
        return [8192, 3, 4000], 512
    assert case == "bucket64"   # B = 64, every other row a bucket pad
    return [0 if i % 2 else 5 + 11 * i for i in range(64)], 43


DECODE_CASES = [(8, 4, 128, "mixed"), (2, 7, 64, "mixed"), (2, 2, 32, "mixed"),
                (8, 4, 128, "split"), (2, 7, 64, "split"), (1, 16, 128, "split"),
                (8, 4, 128, "edges"), (2, 7, 64, "edges"), (2, 2, 32, "edges"),
                (1, 16, 128, "edges"), (8, 4, 128, "long"), (2, 7, 64, "long"),
                (8, 4, 128, "bucket64"), (2, 7, 64, "bucket64"),
                (8, 4, 128, "page24"), (2, 7, 64, "page24"), (2, 2, 32, "page24"),
                (8, 4, 128, "page128"), (2, 7, 64, "page128"), (2, 2, 32, "page128")]


def _decode_inputs(rng, dev, dtype, KV, G, hd, case):
    """(q, k, v, table, pos, kv_lens) of a decode case, pools in dtype."""
    kv_lens_l, P, page = _decode_case(case)
    B = len(kv_lens_l)
    NP = B * P + 1
    k, v = _pool(rng, dev, dtype, NP, page, KV, hd)
    table = torch.from_numpy((rng.permutation(NP - 1)[:B * P] + 1)
                             .reshape(B, P).astype(np.int32)).to(dev)
    kv_lens = torch.tensor(kv_lens_l, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(B, 1, KV * G, hd).astype(np.float32)).to(dev, dtype)
    pos = (kv_lens - 1).clamp(min=0)[:, None]
    return q, k, v, table, pos, kv_lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,case", DECODE_CASES)
def test_paged_decode_matches_plain(dev, dtype, KV, G, hd, case):
    rng = np.random.RandomState(0)
    q, k, v, table, pos, kv_lens = _decode_inputs(rng, dev, dtype, KV, G, hd, case)
    reset_launches()
    got = paged_attention(q, k, v, table, pos, kv_lens, use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode"] == 1
    ref = paged_attention_plain(q, k, v, table, pos, kv_lens)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[kv_lens == 0] == 0)      # kv_len 0 gives 0


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


# Packs aimed at kernels B and D's per-row tiles (tile_tokens(G) tokens of
# one row per block) and 64-slot KV blocks; (specs, _ragged_case kwargs).
def _tile_layout(layout, G):
    tm = tile_tokens(G)
    if layout == "chunk_tiles":     # a 64-token chunk over kv 1000: several tiles
        return [(64, 1000), (1, 37)], dict(P=63)
    if layout == "limit_in_block":  # causal limits 127..150 cross slot 128
        return [(24, 150), (1, 70)], dict(P=10)
    if layout == "tile_exact":      # exactly one tile, and one tile plus a token
        return [(tm, tm + 5), (tm + 1, 40)], {}
    if layout == "many_rows":       # 64 decode rows beside one chunk
        return [(1, 5 + 3 * r) for r in range(64)] + [(30, 60)], dict(P=13)
    if layout == "split_empty":     # walks split in two; early tiles' 2nd split is empty
        return [(160, 600), (1, 20)], dict(P=38)
    if layout == "wide_table":      # a table 4096 slots wide; rows of 1000 and 37
        return [(64, 1000), (1, 37)], dict(P=256)
    if layout == "page24":          # 64-slot blocks span pages of a size not dividing 64
        return [(40, 300), (1, 50), (3, 24), (tm, 65)], dict(page=24, P=13)
    if layout == "page128":         # pages larger than a block
        return [(64, 700), (1, 129), (2, 130), (1, 1)], dict(page=128, P=6)
    assert layout == "bucket_pads"  # more pads than tokens (a power-of-two bucket)
    return [(3, 20), (1, 9)], dict(pads=28)


TILE_LAYOUTS = ["chunk_tiles", "limit_in_block", "tile_exact", "many_rows",
                "bucket_pads", "split_empty", "wide_table", "page24", "page128"]


def _split_counts_zero():
    """Kernels A-D leave their work queue and split counts at 0 after a
    launch, ready for the next one on the stream (the slots between hold
    the launch's report)."""
    from rbg_tpu_torch.ops.kernels import _SCRATCH
    from rbg_tpu_torch.ops.kernels.ragged_paged import _HEAD, _TILES
    return bool(_SCRATCH) and all(
        int(c[_HEAD]) == 0 and int(c[_TILES:].count_nonzero()) == 0
        for _, c in _SCRATCH.values())


# (KV, G, hd): llama3-8b, qwen2-0.5b, tiny and tiny-moe.
RAGGED_SHAPES = [(8, 4, 128), (2, 7, 64), (2, 2, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", RAGGED_SHAPES)
@pytest.mark.parametrize("layout", ["straddle", "three_in_tile", "pads",
                                    "shuffled", "empty_row", *TILE_LAYOUTS])
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
    elif layout == "empty_row":     # a row with kv_len 0 (bucket padding)
        specs = [(3, 30), (1, 5), (0, 0)]
    else:
        specs, kw = _tile_layout(layout, G)
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, dtype, specs,
                                                    KV, G, hd, **kw)
    reset_launches()
    got = ragged_paged_attention(q, k, v, table, qpos, lens, rows,
                                 use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged"] == 1 and _split_counts_zero()
    ref = ragged_paged_attention_plain(q, k, v, table, qpos, lens, rows)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[0, qpos[0] < 0] == 0)      # pads give 0


def test_dispatch_never_and_decode_shape_check(dev):
    """'never' takes the plain version on the card and launches nothing;
    the decode kernel refuses T > 1 rather than falling back (a T > 1
    block through ``paged_attention`` goes to kernel B instead)."""
    from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    rng = np.random.RandomState(2)
    k, v = _pool(rng, dev, torch.bfloat16, 9, 16, 2, 64)
    table = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    lens = torch.tensor([20, 40], dtype=torch.int32, device=dev)
    q = torch.randn(2, 1, 4, 64, device=dev, dtype=torch.bfloat16)
    reset_launches()
    paged_attention(q, k, v, table, (lens - 1)[:, None], lens, use_kernels="never")
    assert LAUNCHES["paged_decode"] == 0
    with pytest.raises(ValueError):
        paged_decode_attention(q.expand(2, 2, 4, 64).contiguous(), k, v, table, lens)
    assert sum(LAUNCHES.values()) == 0


def _block_case(rng, dev, dtype, KV, G, hd, T, page=16):
    """A [4, T] split-path block: a full chunk after 40 slots of context, a
    chunk's tail, a verify-shaped row of 2 real tokens after 700 slots, and
    a bucket row of pads only. Pads come at position -1, as forward_paged
    hands them to the attention. Returns (q, k, v, table, positions,
    kv_lens)."""
    start, n_real = [40, 9, 700, 0], [T, T - 3, 2, 0]
    P = -(-(max(s + n for s, n in zip(start, n_real)) + 1) // page)
    NP = 4 * P + 1
    k, v = _pool(rng, dev, dtype, NP, page, KV, hd)
    table = torch.from_numpy((rng.permutation(NP - 1) + 1).reshape(4, P)
                             .astype(np.int32)).to(dev)
    table[3] = 0
    pos = np.asarray(start)[:, None] + np.arange(T)[None]
    pos[np.arange(T)[None] >= np.asarray(n_real)[:, None]] = -1
    kvl = torch.tensor([s + n for s, n in zip(start, n_real)], dtype=torch.int32,
                       device=dev)
    q = torch.from_numpy(rng.randn(4, T, KV * G, hd).astype(np.float32)).to(dev, dtype)
    return q, k, v, table, torch.from_numpy(pos.astype(np.int32)).to(dev), kvl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", RAGGED_SHAPES)
@pytest.mark.parametrize("T", [5, 64])
@pytest.mark.parametrize("pools", ["model", "int8"])
def test_paged_attention_block_launches_ragged(dev, dtype, KV, G, hd, T, pools):
    """paged_attention at T > 1 (the split prefill's and the verify's
    block) launches kernel B (D on int8 pools) once and never A or C, and
    equals the plain version; pads give 0."""
    rng = np.random.RandomState(T + hd)
    q, k, v, table, pos, kvl = _block_case(rng, dev, dtype, KV, G, hd, T)
    kw = {}
    if pools == "int8":
        k, v, ks, vs = _quantized(k, v)
        kw = dict(k_scales=ks, v_scales=vs)
    reset_launches()
    got = paged_attention(q, k, v, table, pos, kvl, **kw)
    name = "ragged_paged_q" if pools == "int8" else "ragged_paged"
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1, LAUNCHES
    want = paged_attention_plain(q, k, v, table, pos, kvl, kw.get("k_scales"),
                                 kw.get("v_scales"))
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dc,dr", [(16, 512, 64), (4, 64, 16)])
@pytest.mark.parametrize("T", [5, 64])
@pytest.mark.parametrize("pools", ["model", "int8"])
def test_paged_mla_attention_block_launches_ragged(dev, dtype, H, dc, dr, T, pools):
    """paged_mla_attention at T > 1 launches kernel F (H on int8 latent
    pools) once and never E or G, and equals the plain version."""
    rng = np.random.RandomState(T + dc)
    q, c, _, table, pos, kvl = _block_case(rng, dev, dtype, 1, 1, 32, T)
    c, pe = _latent_pools(rng, dev, dtype, c.shape[0], 16, dc, dr)
    q_lat = torch.from_numpy(rng.randn(4, T, H, dc).astype(np.float32)).to(dev, dtype)
    q_pe = torch.from_numpy(rng.randn(4, T, H, dr).astype(np.float32)).to(dev, dtype)
    kw = {}
    if pools == "int8":
        c, pe, cs, ps = _quantized_latents(c, pe)
        kw = dict(c_scales=cs, pe_scales=ps)
    scale = 0.07
    reset_launches()
    got = paged_mla_attention(q_lat, q_pe, c, pe, table, pos, kvl, scale, **kw)
    name = "ragged_paged_mla_q" if pools == "int8" else "ragged_paged_mla"
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1, LAUNCHES
    want = paged_mla_attention_plain(q_lat, q_pe, c, pe, table, pos, kvl, scale,
                                     kw.get("c_scales"), kw.get("pe_scales"))
    assert got.shape == q_lat.shape
    torch.testing.assert_close(got.float(), want.float(), **_mla_tol(dtype))


def test_block_wrappers_refuse_before_any_launch(dev):
    """A T > 1 block past the ragged kernels' limits (more than 1024 table
    rows, hd 96, MLA widths other than theirs) raises ValueError and
    launches nothing."""
    rng = np.random.RandomState(4)
    k, v = _pool(rng, dev, torch.bfloat16, 9, 16, 2, 64)
    reset_launches()
    B = 1025
    table = torch.zeros(B, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(B, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, 2, dtype=torch.int32, device=dev)
    q = torch.randn(B, 2, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1024"):
        paged_attention(q, k, v, table, pos, lens)
    k96, v96 = _pool(rng, dev, torch.bfloat16, 9, 16, 2, 96)
    with pytest.raises(ValueError):
        paged_attention(torch.randn(2, 3, 4, 96, device=dev, dtype=torch.bfloat16),
                        k96, v96, table[:2], pos[:2, :1].expand(2, 3).contiguous(),
                        lens[:2])
    c, pe = _latent_pools(rng, dev, torch.bfloat16, 9, 16, 256, 32)
    with pytest.raises(ValueError):
        paged_mla_attention(torch.randn(2, 3, 4, 256, device=dev, dtype=torch.bfloat16),
                            torch.randn(2, 3, 4, 32, device=dev, dtype=torch.bfloat16),
                            c, pe, table[:2], pos[:2, :1].expand(2, 3).contiguous(),
                            lens[:2], 0.1)
    assert sum(LAUNCHES.values()) == 0


def _quantized(k, v):
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,case", DECODE_CASES)
def test_paged_decode_q_matches_plain(dev, dtype, KV, G, hd, case):
    """Kernel C against the plain version on the same int8 pool."""
    rng = np.random.RandomState(3)
    q, k, v, table, pos, kv_lens = _decode_inputs(rng, dev, dtype, KV, G, hd, case)
    kq, vq, ks, vs = _quantized(k, v)
    reset_launches()
    got = paged_attention(q, kq, vq, table, pos, kv_lens, use_kernels="always",
                          k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_q"] == 1 and LAUNCHES["paged_decode"] == 0
    ref = paged_attention_plain(q, kq, vq, table, pos, kv_lens, ks, vs)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[kv_lens == 0] == 0)      # kv_len 0 gives 0


# The kernels phase's decode rows in 64-slot KV blocks: 32, 30, 24, 19, 16,
# 11, 6 and 2. Each splits into min(cap, ceil(blocks / 2)) walks, cap =
# min(16, ceil(512 / (B * KV))). At B = 8, KV = 8 the cap is 8: 8 + 8 + 8 +
# 8 + 8 + 6 + 3 + 1 = 50 items per kv head on a grid of 64 x 8 blocks; at
# KV = 2 it is 16: 16 + 15 + 12 + 10 + 8 + 6 + 3 + 1 = 71 on 16 x 16 (the
# grid's rows: min(cap, ceil(ceil(P * 16 / 64) / 2)), the same at P = 128
# and 512).
@pytest.mark.parametrize("KV,G,hd,want,grid", [(8, 4, 128, 50, 64 * 8),
                                               (2, 7, 64, 71, 16 * 16)])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_paged_decode_work_items(dev, KV, G, hd, want, grid, pools):
    """The work items kernels A and C report for the kernels phase's rows,
    read back from their counts; the same output, bit for bit, in a table
    4x wider and from a second launch; the split counts back at 0."""
    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    from rbg_tpu_torch.ops.kernels.paged_decode_q import paged_decode_attention_q
    rng = np.random.RandomState(14)
    q, k, v, table, pos, kv_lens = _decode_inputs(rng, dev, torch.bfloat16, KV, G, hd,
                                                  "split")
    q, table, pos, kv_lens = q[:-1], table[:-1], pos[:-1], kv_lens[:-1]  # DECODE_LENS
    if pools == "int8":
        kq, vq, ks, vs = _quantized(k, v)
        fn = lambda t: paged_decode_attention_q(q, kq, vq, ks, vs, t, kv_lens)  # noqa: E731
        ref = paged_attention_plain(q, kq, vq, table, pos, kv_lens, ks, vs)
    else:
        fn = lambda t: paged_decode_attention(q, k, v, t, kv_lens)  # noqa: E731
        ref = paged_attention_plain(q, k, v, table, pos, kv_lens)
    got = fn(table)
    assert launch_report(q.device) == {"work_items": want * KV, "grid_blocks": grid}
    wide = torch.nn.functional.pad(table, (0, 512 - table.shape[1]))
    assert torch.equal(fn(wide), got)
    assert launch_report(q.device) == {"work_items": want * KV, "grid_blocks": grid}
    assert torch.equal(fn(table), got)
    torch.cuda.synchronize()
    assert _split_counts_zero()
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))


def test_decode_wrappers_refuse_unsupported_shapes(dev):
    """Kernels A and C take hd 32, 64 or 128 and G <= 16 (any page size);
    anything else is a ValueError before any launch, never the plain
    version."""
    from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    from rbg_tpu_torch.ops.kernels.paged_decode_q import paged_decode_attention_q
    rng = np.random.RandomState(15)
    reset_launches()
    for KV, G, hd, page in [(2, 2, 96, 16), (2, 2, 48, 12), (1, 17, 64, 16)]:
        k, v = _pool(rng, dev, torch.bfloat16, 5, page, KV, hd)
        kq, vq, ks, vs = _quantized(k, v)
        table = torch.arange(1, 5, dtype=torch.int32, device=dev).reshape(2, 2)
        lens = torch.tensor([page + 1, 3], dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.randn(2, 1, KV * G, hd).astype(np.float32)).to(
            dev, torch.bfloat16)
        with pytest.raises(ValueError):
            paged_decode_attention(q, k, v, table, lens)
        with pytest.raises(ValueError):
            paged_decode_attention_q(q, kq, vq, ks, vs, table, lens)
        with pytest.raises(ValueError):     # the dispatcher does not fall back
            paged_attention(q, k, v, table, (lens - 1)[:, None], lens)
    assert LAUNCHES["paged_decode"] == LAUNCHES["paged_decode_q"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", RAGGED_SHAPES)
@pytest.mark.parametrize("layout", ["straddle", "shuffled", "empty_row",
                                    *TILE_LAYOUTS])
def test_ragged_q_matches_plain(dev, dtype, KV, G, hd, layout):
    """Kernel D against the plain version on the same int8 pool."""
    rng = np.random.RandomState(4)
    kw = {}
    if layout == "straddle":
        specs, kw = [(12, 12), (1, 9), (20, 100)], dict(pads=5)
    elif layout == "shuffled":
        specs = [(5, 15), (1, 21), (1, 4), (3, 40)]
        kw = dict(order=lambda n: np.random.RandomState(7).permutation(n))
    elif layout == "empty_row":
        specs = [(3, 30), (1, 5), (0, 0)]
    else:
        specs, kw = _tile_layout(layout, G)
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, dtype, specs,
                                                    KV, G, hd, **kw)
    kq, vq, ks, vs = _quantized(k, v)
    reset_launches()
    got = ragged_paged_attention(q, kq, vq, table, qpos, lens, rows,
                                 use_kernels="always", k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_q"] == 1 and LAUNCHES["ragged_paged"] == 0
    assert _split_counts_zero()
    ref = ragged_paged_attention_plain(q, kq, vq, table, qpos, lens, rows,
                                       k_scales=ks, v_scales=vs)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[0, qpos[0] < 0] == 0)


# The kernels phase's mixed pack (chip_smoke.RAGGED_SPEC): rows of kv_len
# 2048, 2000, 1500, 1024 and 800 split into 4, 4, 3, 2 and 2 walks (one per
# 8 KV blocks begun), the others walk whole. Per kv head, at 16 tokens per
# tile (G = 4): 4 + 4 + 3 + 4 + 2 + 8 + 1 + 16 = 42 items; at 9 (G = 7): 74.
MIXED_SPEC = [(1, 2048), (64, 64), (1, 1500), (64, 512), (1, 800), (64, 1024),
              (1, 100), (64, 2000)]


@pytest.mark.parametrize("KV,G,hd,want", [(8, 4, 128, 42), (2, 7, 64, 74)])
@pytest.mark.parametrize("P", [128, 512])
def test_ragged_kernel_work_items(dev, KV, G, hd, want, P):
    """The work items kernel B reports for the mixed pack (252 pads), read
    back from its counts: each row's split follows its own kv_len, so a
    table 4x wider than the longest row (P = 512) gives the same items and
    the same output."""
    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
    rng = np.random.RandomState(13)
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, torch.bfloat16, MIXED_SPEC,
                                                    KV, G, hd, P=128, pads=252)
    got = ragged_paged_attention_cuda(q, k, v, table, qpos, lens, rows)
    rep = launch_report(q.device)
    assert rep["work_items"] == want * KV
    tiles = -(-q.shape[1] // (64 // G)) + len(MIXED_SPEC)     # the launch's bound
    assert 1 <= rep["grid_blocks"] <= tiles * 4 * KV
    if P > 128:
        wide = torch.nn.functional.pad(table, (0, P - 128))
        assert torch.equal(ragged_paged_attention_cuda(q, k, v, wide, qpos, lens, rows), got)
        assert launch_report(q.device)["work_items"] == want * KV
    ref = ragged_paged_attention_plain(q, k, v, table, qpos, lens, rows)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))


def test_ragged_wrappers_refuse_unsupported_shapes(dev):
    """Kernels B and D take hd 32, 64 or 128 and at most MAX_ROWS table
    rows (any page size); anything else is a ValueError before any launch,
    never the plain version."""
    from rbg_tpu_torch.ops.kernels.ragged_paged import (MAX_ROWS,
                                                        ragged_paged_attention_cuda)
    from rbg_tpu_torch.ops.kernels.ragged_paged_q import ragged_paged_attention_q_cuda
    rng = np.random.RandomState(12)
    cases = [_ragged_case(rng, dev, torch.bfloat16, [(3, 9), (1, 5)], 2, 2, 96,
                          page=24, P=2),
             _ragged_case(rng, dev, torch.bfloat16, [(1, 3)] * (MAX_ROWS + 1), 1, 2,
                          64, P=1)]
    reset_launches()
    for q, k, v, table, qpos, lens, rows in cases:
        with pytest.raises(ValueError):
            ragged_paged_attention_cuda(q, k, v, table, qpos, lens, rows)
        kq, vq, ks, vs = _quantized(k, v)
        with pytest.raises(ValueError):
            ragged_paged_attention_q_cuda(q, kq, vq, ks, vs, table, qpos, lens, rows)
        with pytest.raises(ValueError):     # the dispatcher does not fall back
            ragged_paged_attention(q, k, v, table, qpos, lens, rows)
    assert LAUNCHES["ragged_paged"] == LAUNCHES["ragged_paged_q"] == 0


def _mla_tol(dtype):
    return (dict(rtol=5e-5, atol=5e-5) if dtype == torch.float32 else _tol(dtype))


# (H, dc, dr): deepseek-v2-lite, deepseek-v3's head count, tiny-mla.
MLA_SHAPES = [(16, 512, 64), (128, 512, 64), (4, 64, 16)]


def _latent_pools(rng, dev, dtype, NP, page, dc, dr):
    c = torch.from_numpy(rng.randn(NP, page, 1, dc).astype(np.float32))
    pe = torch.from_numpy(rng.randn(NP, page, 1, dr).astype(np.float32))
    return c.to(dev, dtype), pe.to(dev, dtype)


def _mla_decode_case(case):
    """(kv_lens, page size, table width P) of a decode case of kernels E
    and G (32-slot latent blocks)."""
    if case == "edges":     # lengths 0, 1, around a page and a block edge, a full table
        return [1, 15, 16, 17, 100, 8 * 16, 33, 0], 16, 8
    if case == "split":     # the kernels phase's rows: walks split up to 16 ways
        return DECODE_LENS + [0], 16, 128
    if case == "page24":    # blocks span pages of a size that is not a power of two
        return [1, 23, 24, 25, 500, 31, 33, 0], 24, 24
    if case == "page128":   # pages larger than a block
        return [1, 127, 129, 700, 2000, 0], 128, 16
    assert case == "long"   # an 8192-slot row in a 512-page table
    return [8192, 3, 4000], 16, 512


MLA_DECODE_CASES = ["edges", "split", "page24", "page128", "long"]


def _mla_decode_inputs(rng, dev, dtype, H, dc, dr, case):
    """(q_lat, q_pe, c, pe, table, pos, kv_lens) of a decode case, latent
    pools in dtype."""
    kv_lens_l, page, P = _mla_decode_case(case)
    B = len(kv_lens_l)
    NP = B * P + 1
    c, pe = _latent_pools(rng, dev, dtype, NP, page, dc, dr)
    table = torch.from_numpy((rng.permutation(NP - 1)[:B * P] + 1)
                             .reshape(B, P).astype(np.int32)).to(dev)
    kv_lens = torch.tensor(kv_lens_l, dtype=torch.int32, device=dev)
    q_lat = torch.from_numpy(rng.randn(B, 1, H, dc).astype(np.float32)).to(dev, dtype)
    q_pe = torch.from_numpy(rng.randn(B, 1, H, dr).astype(np.float32)).to(dev, dtype)
    pos = (kv_lens - 1).clamp(min=0)[:, None]
    return q_lat, q_pe, c, pe, table, pos, kv_lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dc,dr", MLA_SHAPES)
@pytest.mark.parametrize("case", MLA_DECODE_CASES)
def test_paged_mla_decode_matches_plain(dev, dtype, H, dc, dr, case):
    """Kernel E against the plain version: edge lengths, split walks, page
    sizes that are not powers of two or exceed a block, a long row."""
    rng = np.random.RandomState(5)
    q_lat, q_pe, c, pe, table, pos, kv_lens = _mla_decode_inputs(rng, dev, dtype, H, dc,
                                                                  dr, case)
    scale = (128 + dr) ** -0.5
    reset_launches()
    got = paged_mla_attention(q_lat, q_pe, c, pe, table, pos, kv_lens, scale,
                              use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["paged_mla_decode"] == 1 and _split_counts_zero()
    ref = paged_mla_attention_plain(q_lat, q_pe, c, pe, table, pos, kv_lens, scale)
    torch.testing.assert_close(got.float(), ref.float(), **_mla_tol(dtype))
    assert torch.all(got[kv_lens == 0] == 0)      # kv_len 0 gives 0


def _mla_ragged_case(rng, dev, dtype, specs, H, dc, dr, page=16, P=8, pads=0,
                     order=None):
    R = len(specs)
    NP = R * P + 1
    c, pe = _latent_pools(rng, dev, dtype, NP, page, dc, dr)
    table = torch.from_numpy((rng.permutation(NP - 1)[:R * P] + 1)
                             .reshape(R, P).astype(np.int32)).to(dev)
    rows, qpos = [], []
    for r, (ql, kvl) in enumerate(specs):
        rows += [r] * ql
        qpos += list(range(kvl - ql, kvl))
    rows = np.asarray(rows + [0] * pads, np.int32)
    qpos = np.asarray(qpos + [-1] * pads, np.int32)
    if order is not None:
        perm = order(len(rows))
        rows, qpos = rows[perm], qpos[perm]
    T = len(rows)
    q_lat = torch.from_numpy(rng.randn(1, T, H, dc).astype(np.float32)).to(dev, dtype)
    q_pe = torch.from_numpy(rng.randn(1, T, H, dr).astype(np.float32)).to(dev, dtype)
    return (q_lat, q_pe, c, pe, table, torch.from_numpy(qpos[None]).to(dev),
            torch.tensor([kv for _, kv in specs], dtype=torch.int32, device=dev),
            torch.from_numpy(rows).to(dev))


# (H, dc, dr) of kernels F and H: deepseek-v2-lite, deepseek-v3's head
# count, tiny-mla.
RAGGED_MLA_SHAPES = [(16, 512, 64), (128, 512, 64), (4, 64, 16)]


def _mla_layout(layout):
    """(specs, _mla_ragged_case kwargs) of a pack for kernels F and H."""
    if layout == "straddle":        # a prefill row across tiles + decodes, pads
        return [(12, 12), (1, 9), (20, 100)], dict(pads=5)
    if layout == "three_in_tile":
        return [(1, 9), (1, 21), (1, 33), (2, 6), (3, 7)], {}
    if layout == "pads":            # an all-pad tail after the real tokens
        return [(2, 9), (1, 13)], dict(pads=13)
    if layout == "shuffled":        # rows are not contiguous runs
        return [(5, 15), (1, 21), (1, 4), (3, 40)], dict(
            order=lambda n: np.random.RandomState(7).permutation(n))
    if layout == "empty_row":       # a row with kv_len 0 (bucket padding)
        return [(3, 30), (1, 5), (0, 0)], {}
    if layout == "split":           # walks split up to 8 ways, a chunk over a long row
        return [(1, 2048), (24, 1000), (1, 300)], dict(P=128, pads=7)
    if layout == "page24":          # 32-slot blocks span pages of a size not dividing 32
        return [(20, 300), (1, 50), (3, 24), (1, 1)], dict(page=24, P=13)
    if layout == "page128":         # pages larger than a block
        return [(18, 700), (1, 129), (2, 130)], dict(page=128, P=6)
    assert layout == "long"         # an 8192-slot row in a 512-page table
    return [(1, 8192), (5, 4000), (1, 3)], dict(P=512)


MLA_LAYOUTS = ["straddle", "three_in_tile", "pads", "shuffled", "empty_row", "split",
               "page24", "page128", "long"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dc,dr", RAGGED_MLA_SHAPES)
@pytest.mark.parametrize("layout", MLA_LAYOUTS)
def test_ragged_mla_matches_plain(dev, dtype, H, dc, dr, layout):
    """Kernel F against the plain version: B's layouts, split walks, page
    sizes that are not powers of two or exceed a block, a long row."""
    rng = np.random.RandomState(6)
    specs, kw = _mla_layout(layout)
    case = _mla_ragged_case(rng, dev, dtype, specs, H, dc, dr, **kw)
    scale = (128 + dr) ** -0.5
    reset_launches()
    got = ragged_paged_mla_attention(*case, scale, use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_mla"] == 1 and _split_counts_zero()
    ref = ragged_paged_mla_attention_plain(*case, scale)
    torch.testing.assert_close(got.float(), ref.float(), **_mla_tol(dtype))
    qpos = case[5]
    assert torch.all(got[0, qpos[0] < 0] == 0)


def _quantized_latents(c, pe):
    (cq, cs), (pq, ps) = quantize_kv(c), quantize_kv(pe)
    return cq, pq, cs, ps


# (H, dc, dr): deepseek-v2-lite and tiny-mla (int8 rows are 16-element vectors).
MLA_Q_SHAPES = [(16, 512, 64), (4, 64, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dc,dr", MLA_Q_SHAPES)
@pytest.mark.parametrize("case", MLA_DECODE_CASES)
def test_paged_mla_decode_q_matches_plain(dev, dtype, H, dc, dr, case):
    """Kernel G against the plain version on the same int8 latent pools:
    E's cases."""
    rng = np.random.RandomState(8)
    q_lat, q_pe, c, pe, table, pos, kv_lens = _mla_decode_inputs(rng, dev, dtype, H, dc,
                                                                  dr, case)
    cq, pq, cs, ps = _quantized_latents(c, pe)
    scale = (128 + dr) ** -0.5
    reset_launches()
    got = paged_mla_attention(q_lat, q_pe, cq, pq, table, pos, kv_lens, scale,
                              use_kernels="always", c_scales=cs, pe_scales=ps)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_mla_decode_q"] == 1 and LAUNCHES["paged_mla_decode"] == 0
    assert _split_counts_zero()
    ref = paged_mla_attention_plain(q_lat, q_pe, cq, pq, table, pos, kv_lens, scale,
                                    cs, ps)
    torch.testing.assert_close(got.float(), ref.float(), **_mla_tol(dtype))
    assert torch.all(got[kv_lens == 0] == 0)      # kv_len 0 gives 0


# The kernels phase's decode rows in 32-slot latent blocks: 64, 60, 48, 38,
# 32, 22, 11 and 3. Each splits into min(cap, ceil(blocks / 2)) walks, cap =
# min(16, SMs // (B * head groups)): on 132 SMs 16 at H = 16 (16 + 16 + 16 +
# 16 + 16 + 11 + 6 + 2 = 99 items on 8 x 16 blocks) and 2 at H = 128 (2 per
# row and head group: 128 items on 64 x 2 blocks).
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_paged_mla_decode_work_items(dev, H, pools):
    """The work items kernels E and G report for the kernels phase's rows,
    read back from their counts; the same output, bit for bit, in a table
    4x wider and from a second launch; the split counts back at 0."""
    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.paged_mla_decode import (paged_mla_decode_attention,
                                                            split_cap)
    from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
    rng = np.random.RandomState(16)
    dc, dr, scale = 512, 64, 192 ** -0.5
    q_lat, q_pe, c, pe, table, pos, kv_lens = _mla_decode_inputs(
        rng, dev, torch.bfloat16, H, dc, dr, "split")
    q_lat, q_pe, table, pos, kv_lens = q_lat[:-1], q_pe[:-1], table[:-1], pos[:-1], kv_lens[:-1]
    B, groups = len(DECODE_LENS), H // 16
    if pools == "int8":
        cq, pq, cs, ps = _quantized_latents(c, pe)
        fn = lambda t: paged_mla_decode_attention_q(q_lat, q_pe, cq, pq, cs, ps, t,  # noqa: E731
                                                    kv_lens, scale)
        ref = paged_mla_attention_plain(q_lat, q_pe, cq, pq, table, pos, kv_lens, scale,
                                        cs, ps)
    else:
        fn = lambda t: paged_mla_decode_attention(q_lat, q_pe, c, pe, t, kv_lens,  # noqa: E731
                                                  scale)
        ref = paged_mla_attention_plain(q_lat, q_pe, c, pe, table, pos, kv_lens, scale)
    cap = split_cap(q_lat.get_device(), B, groups)
    want = groups * sum(min(cap, -(-(-(-n // 32)) // 2)) for n in DECODE_LENS)
    grid = B * groups * min(cap, 128 * 16 // 32 // 2)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert (want, grid) == {16: (99, 128), 128: (128, 128)}[H]
    got = fn(table)
    assert launch_report(q_lat.device) == {"work_items": want, "grid_blocks": grid}
    wide = torch.nn.functional.pad(table, (0, 512 - table.shape[1]))
    assert torch.equal(fn(wide), got)
    assert launch_report(q_lat.device)["work_items"] == want
    assert torch.equal(fn(table), got)
    torch.cuda.synchronize()
    assert _split_counts_zero()
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))


def test_mla_decode_wrappers_refuse_unsupported_shapes(dev):
    """Kernels E and G take decode steps at (dc, dr) = (512, 64) or
    (64, 16); anything else is a ValueError before any launch, never the
    plain version."""
    from rbg_tpu_torch.ops.kernels.paged_mla_decode import paged_mla_decode_attention
    from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
    rng = np.random.RandomState(17)
    reset_launches()
    for H, dc, dr, T in [(4, 128, 32, 1), (4, 64, 64, 1), (16, 512, 64, 2)]:
        q_lat, q_pe, c, pe, table, pos, kv_lens = _mla_decode_inputs(
            rng, dev, torch.bfloat16, H, dc, dr, "edges")
        q_lat, q_pe = q_lat.expand(-1, T, -1, -1), q_pe.expand(-1, T, -1, -1)
        cq, pq, cs, ps = _quantized_latents(c, pe)
        with pytest.raises(ValueError):
            paged_mla_decode_attention(q_lat, q_pe, c, pe, table, kv_lens, 0.1)
        with pytest.raises(ValueError):
            paged_mla_decode_attention_q(q_lat, q_pe, cq, pq, cs, ps, table, kv_lens, 0.1)
        if T == 1:      # the dispatcher does not fall back
            with pytest.raises(ValueError):
                paged_mla_attention(q_lat, q_pe, c, pe, table, pos, kv_lens, 0.1)
    assert LAUNCHES["paged_mla_decode"] == LAUNCHES["paged_mla_decode_q"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dc,dr", RAGGED_MLA_SHAPES)
@pytest.mark.parametrize("layout", ["straddle", "shuffled", "empty_row", "split", "page24",
                                    "page128", "long"])
def test_ragged_mla_q_matches_plain(dev, dtype, H, dc, dr, layout):
    """Kernel H against the plain version on the same int8 latent pools:
    a row across tiles with pads, non-contiguous rows, a kv_len-0 row,
    split walks, page sizes 24 and 128, a long row."""
    rng = np.random.RandomState(9)
    specs, kw = _mla_layout(layout)
    case = list(_mla_ragged_case(rng, dev, dtype, specs, H, dc, dr, **kw))
    case[2], case[3], cs, ps = _quantized_latents(case[2], case[3])
    scale = (128 + dr) ** -0.5
    reset_launches()
    got = ragged_paged_mla_attention(*case, scale, use_kernels="always",
                                     c_scales=cs, pe_scales=ps)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_mla_q"] == 1 and LAUNCHES["ragged_paged_mla"] == 0
    assert _split_counts_zero()
    ref = ragged_paged_mla_attention_plain(*case, scale, cs, ps)
    torch.testing.assert_close(got.float(), ref.float(), **_mla_tol(dtype))
    qpos = case[5]
    assert torch.all(got[0, qpos[0] < 0] == 0)


@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_ragged_mla_work_items(dev, H, pools):
    """The work items kernels F and H report for the kernels phase's mixed
    pack (252 pads), read back from their counts: each row's split follows
    its own kv_len, so a table 4x wider gives the same items and the same
    output bits; the queue and split counts are back at 0."""
    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
        ragged_paged_mla_attention_q_cuda)
    rng = np.random.RandomState(19)
    dc, dr, scale = 512, 64, 192 ** -0.5
    case = list(_mla_ragged_case(rng, dev, torch.bfloat16, MIXED_SPEC, H, dc, dr, P=128,
                                 pads=252))
    q_lat, q_pe, c, pe, table, qpos, lens, rows = case
    if pools == "int8":
        cq, pq, cs, ps = _quantized_latents(c, pe)
        fn = lambda t: ragged_paged_mla_attention_q_cuda(  # noqa: E731
            q_lat, q_pe, cq, pq, cs, ps, t, qpos, lens, rows, scale)
        ref = ragged_paged_mla_attention_plain(q_lat, q_pe, cq, pq, table, qpos, lens, rows,
                                               scale, cs, ps)
    else:
        fn = lambda t: ragged_paged_mla_attention_cuda(  # noqa: E731
            q_lat, q_pe, c, pe, t, qpos, lens, rows, scale)
        ref = ragged_paged_mla_attention_plain(q_lat, q_pe, c, pe, table, qpos, lens, rows,
                                               scale)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    got = fn(table)
    rep = launch_report(q_lat.device)
    if sms == 132:      # the H100: splits capped at ceil(2 x 132 / (tiles x slices))
        assert rep["work_items"] == {16: 189, 128: 520}[H]
    assert rep["work_items"] >= 1
    assert 1 <= rep["grid_blocks"] <= sms
    wide = torch.nn.functional.pad(table, (0, 512 - table.shape[1]))
    assert torch.equal(fn(wide), got)
    assert launch_report(q_lat.device) == rep
    torch.cuda.synchronize()
    assert _split_counts_zero()
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))
    assert torch.all(got[0, qpos[0] < 0] == 0)


@pytest.mark.parametrize("H,specs", [(128, [(64, 2048)] * 8 + [(1, 8192)]),
                                     (16, [(1, 8192)] * 4)])
def test_ragged_mla_partials_bounded(dev, H, specs):
    """F's partials scratch, from fresh: a 513-token deepseek-v3 pack (no
    split is worth its traffic) and four long decode rows (all split) each
    leave it at most min(2 x 2 x SMs x 64, T x H x 8) rows of dc + 4 (the
    launcher's bound, one bf16 block per SM at dc = 512), where it held
    T x H x 8 rows whatever split; the output agrees with the plain
    version."""
    from rbg_tpu_torch.ops.kernels import _SCRATCH
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
    rng = np.random.RandomState(23)
    dc, dr, scale = 512, 64, 192 ** -0.5
    case = _mla_ragged_case(rng, dev, torch.bfloat16, specs, H, dc, dr, P=512)
    _SCRATCH.pop((torch.device(dev).index or 0, torch.cuda.current_stream().cuda_stream), None)
    got = ragged_paged_mla_attention_cuda(*case, scale)
    part = _SCRATCH[(got.get_device(), torch.cuda.current_stream().cuda_stream)][0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 0 < part.numel() <= min(4 * sms * 64, got.shape[1] * H * 8) * (dc + 4)
    torch.cuda.synchronize()
    assert _split_counts_zero()
    ref = ragged_paged_mla_attention_plain(*case, scale)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))


def test_ragged_mla_wrappers_refuse_unsupported_shapes(dev):
    """Kernels F and H take (dc, dr) = (512, 64) or (64, 16) and at most
    MAX_ROWS table rows (any H, any page size); anything else is a
    ValueError before any launch, never the plain version."""
    from rbg_tpu_torch.ops.kernels.ragged_paged import MAX_ROWS
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla import ragged_paged_mla_attention_cuda
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
        ragged_paged_mla_attention_q_cuda)
    rng = np.random.RandomState(20)
    cases = [_mla_ragged_case(rng, dev, torch.bfloat16, [(3, 9), (1, 5)], 4, dc, dr, P=2)
             for dc, dr in [(128, 32), (64, 64), (512, 16)]]
    cases.append(_mla_ragged_case(rng, dev, torch.bfloat16, [(1, 3)] * (MAX_ROWS + 1), 4,
                                  64, 16, P=1))
    reset_launches()
    for case in cases:
        q_lat, q_pe, c, pe, table, qpos, lens, rows = case
        cq, pq, cs, ps = _quantized_latents(c, pe)
        with pytest.raises(ValueError):
            ragged_paged_mla_attention_cuda(*case, 0.1)
        with pytest.raises(ValueError):
            ragged_paged_mla_attention_q_cuda(q_lat, q_pe, cq, pq, cs, ps, table, qpos, lens,
                                              rows, 0.1)
        with pytest.raises(ValueError):     # the dispatcher does not fall back
            ragged_paged_mla_attention(*case, 0.1)
    assert LAUNCHES["ragged_paged_mla"] == LAUNCHES["ragged_paged_mla_q"] == 0


def test_mla_q_wrappers_refuse_bad_inputs(dev):
    """Kernels G and H take int8 latent pools on the card: CPU tensors and
    model-dtype pools are refused, never sent to the plain version."""
    from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import paged_mla_decode_attention_q
    from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
        ragged_paged_mla_attention_q_cuda)
    rng = np.random.RandomState(10)
    case = list(_mla_ragged_case(rng, dev, torch.bfloat16, [(3, 9)], 4, 64, 16))
    c, pe = case[2], case[3]
    cq, pq, cs, ps = _quantized_latents(c, pe)
    table, lens = case[4], torch.tensor([9], dtype=torch.int32, device=dev)
    q_lat, q_pe = case[0][:, :1], case[1][:, :1]
    decode = (table, lens, 0.1)
    reset_launches()
    with pytest.raises(TypeError):          # a model-dtype pool
        paged_mla_decode_attention_q(q_lat, q_pe, c, pe, cs, ps, *decode)
    with pytest.raises(ValueError):         # CPU tensors
        paged_mla_decode_attention_q(*(x.cpu() for x in (q_lat, q_pe, cq, pq, cs, ps,
                                                         table, lens)), 0.1)
    ragged = (case[4], case[5], case[6], case[7], 0.1)
    with pytest.raises(TypeError):
        ragged_paged_mla_attention_q_cuda(case[0], case[1], c, pe, cs, ps, *ragged)
    with pytest.raises(ValueError):
        ragged_paged_mla_attention_q_cuda(*(x.cpu() for x in (case[0], case[1], cq, pq,
                                                              cs, ps, *ragged[:4])), 0.1)
    assert LAUNCHES["paged_mla_decode_q"] == LAUNCHES["ragged_paged_mla_q"] == 0


# Packs of kernel I's tokens; (specs, _ragged_case kwargs but P).
TOKENGRID_LAYOUTS = {
    "straddle": ([(12, 12), (1, 9), (20, 100)], {}),
    "pads": ([(2, 9), (1, 13)], dict(pads=13)),
    "shuffled": ([(5, 15), (1, 21), (1, 4), (3, 40)],
                 dict(order=lambda n: np.random.RandomState(7).permutation(n))),
    "empty_row": ([(3, 30), (1, 5), (0, 0)], {}),
    # 4 tokens at kv_len >= 1500 in an 8-token bucket: T * KV < 512, so
    # every walk splits (cap 8 at KV = 8, 16 at KV = 2) and merges on the card
    "split": ([(2, 1500), (1, 2000), (1, 1600)], dict(pads=4)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 128), (2, 7, 64)])
@pytest.mark.parametrize("layout", sorted(TOKENGRID_LAYOUTS))
@pytest.mark.parametrize("page", [16, 24, 128])
def test_tokengrid_matches_plain(dev, dtype, KV, G, hd, layout, page):
    """Kernel I against the plain version (B's function) on B's layouts, at
    page sizes 16, 24 (blocks span pages) and 128 (pages span blocks)."""
    rng = np.random.RandomState(11)
    specs, kw = TOKENGRID_LAYOUTS[layout]
    P = max(8, -(-max(kv for _, kv in specs) // page))
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, dtype, specs,
                                                    KV, G, hd, page=page, P=P, **kw)
    reset_launches()
    got = ragged_paged_attention_tokengrid(q, k, v, table, qpos, lens, rows,
                                           use_kernels="always")
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_tokengrid"] == 1 and LAUNCHES["ragged_paged"] == 0
    assert _split_counts_zero()
    ref = ragged_paged_attention_plain(q, k, v, table, qpos, lens, rows)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
    assert torch.all(got[0, qpos[0] < 0] == 0)


# Kernel I's items are (token, kv head, split), a token's walk of len =
# min(kv_len, q_pos + 1) slots splitting into min(cap, ceil(blocks / 2))
# parts, cap = min(16, ceil(512 / (T * KV))). The mixed pack (MIXED_SPEC,
# 260 real tokens and 252 pads, T = 512): T * KV reaches 512 at KV = 8 and
# KV = 2, so the cap is 1 and every real token is one item: 260 per kv
# head, on a grid of 512 * KV x 1 blocks. The split pack (tokens of kv_len
# 1499, 1500, 2000 and 1600 in 24, 24, 32 and 25 blocks, 4 pads, T = 8):
# at KV = 8 the cap is 8, so 8 + 8 + 8 + 8 = 32 items per kv head on 64 x 8
# blocks; at KV = 2 it is 16, so 12 + 12 + 16 + 13 = 53 on 16 x 16 (the
# grid's rows: min(cap, ceil(ceil(P * 16 / 64) / 2)), the same at P = 128
# and 512).
@pytest.mark.parametrize("KV,G,hd,pack,want,grid", [
    (8, 4, 128, "mixed", 260, 512 * 8), (2, 7, 64, "mixed", 260, 512 * 2),
    (8, 4, 128, "split", 32, 64 * 8), (2, 7, 64, "split", 53, 16 * 16)])
def test_tokengrid_work_items(dev, KV, G, hd, pack, want, grid):
    """The work items kernel I reports, read back from its counts; the
    same items and output bits in a table 4x wider; the split counts back
    at 0."""
    from rbg_tpu_torch.ops.kernels import launch_report
    from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
        ragged_paged_attention_tokengrid_cuda)
    rng = np.random.RandomState(16)
    specs, pads = ((MIXED_SPEC, 252) if pack == "mixed"
                   else ([(2, 1500), (1, 2000), (1, 1600)], 4))
    q, k, v, table, qpos, lens, rows = _ragged_case(rng, dev, torch.bfloat16, specs,
                                                    KV, G, hd, P=128, pads=pads)
    fn = lambda t: ragged_paged_attention_tokengrid_cuda(q, k, v, t, qpos, lens, rows)  # noqa: E731
    got = fn(table)
    assert launch_report(q.device) == {"work_items": want * KV, "grid_blocks": grid}
    wide = torch.nn.functional.pad(table, (0, 512 - table.shape[1]))
    assert torch.equal(fn(wide), got)
    assert launch_report(q.device) == {"work_items": want * KV, "grid_blocks": grid}
    torch.cuda.synchronize()
    assert _split_counts_zero()
    ref = ragged_paged_attention_plain(q, k, v, table, qpos, lens, rows)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(torch.bfloat16))


def test_tokengrid_refuses_unsupported_shapes(dev):
    """Kernel I takes hd 32, 64 or 128 and G <= 16 (A's limits); anything
    else is a ValueError before any launch, never the plain version."""
    from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
        ragged_paged_attention_tokengrid_cuda)
    rng = np.random.RandomState(17)
    reset_launches()
    for KV, G, hd in [(2, 2, 96), (1, 17, 64)]:
        case = _ragged_case(rng, dev, torch.bfloat16, [(3, 9), (1, 5)], KV, G, hd, P=2)
        with pytest.raises(ValueError):
            ragged_paged_attention_tokengrid_cuda(*case)
        with pytest.raises(ValueError):     # the dispatcher does not fall back
            ragged_paged_attention_tokengrid(*case)
    assert sum(LAUNCHES.values()) == 0


def test_block_ragged_probe_on_the_card(dev):
    """The probe's two kernels agree with the plain version and both were
    timed."""
    from rbg_tpu_torch.bench import block_ragged_probe
    out = block_ragged_probe()
    assert out["measurable"] and out["bit_identical"], out
    assert out["tokengrid_calls_per_s"] > 0 and out["block_ragged_calls_per_s"] > 0


def _params_on(params, dev):
    return {k: ({n: w.to(dev) for n, w in v.items()} if k == "blocks" else v.to(dev))
            for k, v in params.items()}


@pytest.mark.parametrize("model,page_size", [("tiny", 16), ("tiny-moe", 16),
                                             ("tiny-mla", 16), ("tiny", 128)])
@pytest.mark.parametrize("multi_step", [1, 4])
def test_engine_serves_tiny_models_on_the_card(dev, model, page_size, multi_step):
    """tiny and tiny-moe (hd 32, float32) serve on the card through Engine
    (ragged steps launch kernel B, decode windows kernel A), tiny-mla
    (float32 latents) through kernels F and E, and tiny at page size 128;
    the greedy tokens equal the CPU port's on the same weights."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    params = init_params(get_config(model), 0, "cpu")
    rng = np.random.RandomState(18)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 40, 23, 70)]
    sp = SamplingParams(max_new_tokens=12)
    kw = dict(model=model, num_pages=64, max_seq_len=256, prefill_chunk=16,
              multi_step=multi_step, page_size=page_size)
    want = Engine(EngineConfig(**kw, device="cpu"), params=params).generate(prompts, sp)
    reset_launches()
    got = Engine(EngineConfig(**kw), params=_params_on(params, dev), device=dev).generate(
        prompts, sp)
    ragged, decode = (("ragged_paged_mla", "paged_mla_decode") if model == "tiny-mla"
                      else ("ragged_paged", "paged_decode"))
    assert LAUNCHES[ragged] > 0 and LAUNCHES[decode] > 0
    assert got == want


def test_gumbel_noise_on_the_card_equals_the_cpu(dev):
    """The sampler's threefry noise is integer ops and float32 ops rounded
    once each (its fused multiply-adds go through float64), so the card
    gives the CPU's bits, which tests/test_torch_sampler.py holds to JAX's."""
    keys = row_keys([7, None, 0, 2 ** 32 - 1], 3, [0, 4, 5, 9], "cpu")
    pos = torch.tensor([0, 3, 1000, 2 ** 31 - 1])
    want = gumbel_noise(keys, pos, 128256)
    got = gumbel_noise(keys.to(dev), pos.to(dev), 128256).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
@pytest.mark.parametrize("mode", ["ragged_off", "ragged_off_ms4", "speculative", "lora"])
def test_engine_split_paths_on_the_card(dev, model, mode):
    """tiny and tiny-mla serve on the card through the split paths: the
    batched prefill step (a [B, chunk] block: kernel B, or F), decode
    windows (A, or E), the speculative verify (a [B, spec_k + 1] block) and
    adapter rows mixed with a base row; the greedy tokens equal the CPU
    port's on the same weights."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    cfg = get_config(model)
    params = init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(19)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 40, 23)] + [[1, 2, 3, 4] * 6]
    kw = dict(model=model, num_pages=64, max_seq_len=256, prefill_chunk=16)
    kw.update({"ragged_off": dict(ragged="off"),
               "ragged_off_ms4": dict(ragged="off", multi_step=4),
               "speculative": dict(speculative="ngram"),
               "lora": dict(multi_step=4)}[mode])
    names = [None] * 4
    adapters = {}
    if mode == "lora":
        names = ["a", None, "b", "a"]
        for i, name in enumerate(("a", "b")):
            g = np.random.default_rng(i)
            adapters[name] = {t: (g.normal(size=(cfg.num_layers, params["blocks"][t].shape[1], 4))
                                  .astype(np.float32) * 0.05,
                                  g.normal(size=(cfg.num_layers, 4, params["blocks"][t].shape[2]))
                                  .astype(np.float32) * 0.05)
                              for t in ("wq", "wo", "w_up")}

    def run(eng):
        for name, ad in adapters.items():
            eng.load_lora(name, ad, alpha=8.0)
        ids = [eng.add_request(p, SamplingParams(max_new_tokens=12, lora=n))
               for p, n in zip(prompts, names)]
        out = {i: [] for i in ids}
        while eng.has_work():
            for ev in eng.step():
                out[ev.request_id].append(ev.token)
        return [out[i] for i in ids], eng.metrics

    want, _ = run(Engine(EngineConfig(**kw, device="cpu"), params=params))
    reset_launches()
    got, metrics = run(Engine(EngineConfig(**kw), params=_params_on(params, dev), device=dev))
    ragged, decode = (("ragged_paged_mla", "paged_mla_decode") if cfg.mla
                      else ("ragged_paged", "paged_decode"))
    assert got == want
    assert metrics["unified_steps"] == 0 and LAUNCHES[ragged] > 0
    if mode == "speculative":
        assert metrics["spec_steps"] > 0 and LAUNCHES[decode] == 0
    else:
        assert LAUNCHES[decode] > 0
