"""rbg_tpu_torch ops against their JAX counterparts on the CPU: norms,
RoPE, the plain paged and ragged attention (against the XLA functions and
the Pallas kernels in interpret mode), the in-place KV writes, and the
kernel-or-plain dispatch policy. Inputs come from numpy seeds and go to
both frameworks; float32 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.ops.norms import rms_norm as j_rms_norm
from rbg_tpu.ops.paged_attention import paged_attention_xla, write_kv_pages as j_write
from rbg_tpu.ops.pallas.paged_attention_kernel import paged_attention_pallas
from rbg_tpu.ops.pallas.ragged_attention_kernel import (
    Q_TILE, ragged_paged_attention_pallas, ragged_paged_attention_pallas_tokengrid)
from rbg_tpu.ops.ragged_paged_attention import (
    _unpack_offsets as j_unpack, ragged_paged_attention_xla,
    write_kv_pages_ragged as j_write_ragged)
from rbg_tpu.ops.rope import apply_rope as j_rope
from rbg_tpu_torch.ops.norms import rms_norm
from rbg_tpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_plain,
                                               write_kv_pages)
from rbg_tpu_torch.ops.ragged_paged_attention import (
    _unpack_offsets, ragged_paged_attention, ragged_paged_attention_plain,
    write_kv_pages_ragged)
from rbg_tpu_torch.ops.rope import apply_rope

ATOL = 1e-5     # attention: the tolerance of tests/test_block_ragged.py


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(rms_norm(t(x), t(w)).numpy(),
                               np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-6, rtol=0)
    pos = rng.randint(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(apply_rope(t(x), t(pos), 10000.0).numpy(),
                               np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
                               atol=1e-6, rtol=0)


def _paged_case(seed, B=4, P=6, page=8, KV=2, G=3, hd=32, T=1):
    rng = np.random.RandomState(seed)
    NP = B * P + 1
    k = rng.randn(NP, page, KV, hd).astype(np.float32)
    v = rng.randn(NP, page, KV, hd).astype(np.float32)
    table = (rng.permutation(NP - 1)[:B * P] + 1).reshape(B, P).astype(np.int32)
    # T is the smallest length, so every query sees a slot.
    lens = np.asarray([T, page, page + 1, P * page][:B], np.int32)
    q = rng.randn(B, T, KV * G, hd).astype(np.float32)
    pos = (lens[:, None] - T + np.arange(T)[None]).astype(np.int32)
    return q, k, v, table, pos, lens


@pytest.mark.parametrize("T", [1, 3])
def test_paged_attention_plain_matches_xla(T):
    q, k, v, table, pos, lens = _paged_case(1, T=T)
    got = paged_attention_plain(t(q), t(k), t(v), t(table), t(pos), t(lens))
    ref = paged_attention_xla(*map(jnp.asarray, (q, k, v, table, pos, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_paged_attention_plain_matches_pallas_interpret():
    """GQA decode with edge kv_lens (1, one page, one past a page, full);
    compared where kv_len > 0 — and a kv_len-0 row gives 0 in both."""
    q, k, v, table, pos, lens = _paged_case(2)
    lens = lens.copy()
    lens[0] = 0
    pos = np.maximum(lens - 1, 0)[:, None].astype(np.int32)
    got = paged_attention_plain(t(q), t(k), t(v), t(table), t(pos), t(lens))
    ref = np.asarray(paged_attention_pallas(
        *map(jnp.asarray, (q, k, v, table, pos, lens)), interpret=True))
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=ATOL, rtol=ATOL)
    assert np.all(got.numpy()[~live] == 0) and np.all(ref[~live] == 0)


def _ragged_case(seed, specs, H=8, KV=2, hd=32, P=6, page=8, pads=0):
    rng = np.random.RandomState(seed)
    R = len(specs)
    NP = R * P + 1
    k = rng.randn(NP, page, KV, hd).astype(np.float32)
    v = rng.randn(NP, page, KV, hd).astype(np.float32)
    table = (rng.permutation(NP - 1)[:R * P] + 1).reshape(R, P).astype(np.int32)
    lens = np.asarray([kv for _, kv in specs], np.int32)
    rows, qpos = [], []
    for r, (ql, kv) in enumerate(specs):
        rows += [r] * ql
        qpos += list(range(kv - ql, kv))
    rows = np.asarray(rows + [0] * pads, np.int32)
    qpos = np.asarray([qpos + [-1] * pads], np.int32)
    q = rng.randn(1, rows.shape[0], H, hd).astype(np.float32)
    return q, k, v, table, qpos, lens, rows


LAYOUTS = {
    # a prefill row straddling two tiles, then a decode row
    "straddle": [(Q_TILE + 4, Q_TILE + 4), (1, 9)],
    # a decode row sharing a tile with a prefill tail
    "boundary_in_tile": [(Q_TILE - 1, 19), (1, 33), (2, 12)],
    # three and more rows inside one tile
    "three_in_tile": [(1, 9), (1, 21), (1, 33), (2, 6), (3, 7)],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ragged_plain_matches_xla_and_pallas(layout):
    case = _ragged_case(3, LAYOUTS[layout])
    got = ragged_paged_attention_plain(*map(t, case)).numpy()
    jc = list(map(jnp.asarray, case))
    np.testing.assert_allclose(got, np.asarray(ragged_paged_attention_xla(*jc)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_attention_pallas(*jc, interpret=True)),
        atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["pads_and_empty_row"])
def test_ragged_plain_matches_tokengrid_pallas(layout):
    """The plain version (kernel I's yardstick on the card) against the
    token-grid Pallas kernel in interpret mode on the layouts a token grid
    is sensitive to, pads included (both give a pad, q_pos -1, exactly 0),
    and beside a table row of kv_len 0."""
    if layout == "pads_and_empty_row":
        case = _ragged_case(11, [(3, 30), (1, 5), (0, 0)], pads=5)
    else:
        case = _ragged_case(11, LAYOUTS[layout])
    got = ragged_paged_attention_plain(*map(t, case)).numpy()
    ref = np.asarray(ragged_paged_attention_pallas_tokengrid(
        *map(jnp.asarray, case), interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    pads = case[4][0] < 0
    assert np.all(got[:, pads] == 0) and np.all(ref[:, pads] == 0)


def test_ragged_plain_all_pad_tile_and_max_q_len():
    """Real tokens fill less than a tile and a whole pad tile follows; pads
    give 0, and the engine's max_q_len bound changes nothing real."""
    case = _ragged_case(4, [(2, 9), (1, 13)], pads=2 * Q_TILE - 3)
    got = ragged_paged_attention_plain(*map(t, case), max_q_len=4).numpy()
    jc = list(map(jnp.asarray, case))
    ref = np.asarray(ragged_paged_attention_pallas(*jc, interpret=True))
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=ATOL, rtol=ATOL)
    assert np.all(got[:, 3:] == 0)


def test_ragged_plain_non_contiguous_rows_match_pallas():
    """Rows need not be contiguous runs of the pack (the Pallas kernel does
    not assume it; the XLA fallback does, so it is not the oracle here)."""
    q, k, v, table, qpos, lens, rows = _ragged_case(
        5, [(5, 15), (1, 21), (1, 4), (3, 40)])
    perm = np.random.RandomState(6).permutation(rows.shape[0])
    q, qpos, rows = q[:, perm], qpos[:, perm], rows[perm]
    case = (q, k, v, table, qpos, lens, rows)
    got = ragged_paged_attention_plain(*map(t, case)).numpy()
    ref = np.asarray(ragged_paged_attention_pallas(
        *map(jnp.asarray, case), interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_unpack_offsets_matches_jax_on_contiguous_pack():
    rows = np.asarray([0, 0, 0, 1, 2, 2, 3, 3, 3, 3], np.int32)
    np.testing.assert_array_equal(_unpack_offsets(t(rows)).numpy(),
                                  np.asarray(j_unpack(jnp.asarray(rows))))


def test_write_kv_pages_with_pads_matches_jax():
    rng = np.random.RandomState(7)
    NP, page, KV, hd, B, T, P = 9, 4, 2, 8, 2, 3, 4
    k = rng.randn(NP, page, KV, hd).astype(np.float32)
    v = rng.randn(NP, page, KV, hd).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.asarray([[3, 4, 5], [P * page, -1, 0]], np.int32)   # pads: odd positions
    mask = np.asarray([[True, True, True], [False, False, True]])
    kn = rng.randn(B, T, KV, hd).astype(np.float32)
    vn = rng.randn(B, T, KV, hd).astype(np.float32)
    jk, jv, _, _ = j_write(*map(jnp.asarray, (k, v, kn, vn, table, pos, mask)))
    tk, tv = t(k.copy()), t(v.copy())
    write_kv_pages(tk, tv, t(kn), t(vn), t(table), t(pos), t(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_kv_pages_ragged_with_pads_matches_jax():
    rng = np.random.RandomState(8)
    NP, page, KV, hd = 9, 4, 2, 8
    k = rng.randn(NP, page, KV, hd).astype(np.float32)
    v = rng.randn(NP, page, KV, hd).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rows = np.asarray([0, 0, 1, 0, 0], np.int32)
    pos = np.asarray([[6, 7, 2, -1, -1]], np.int32)
    mask = pos >= 0
    kn = rng.randn(1, 5, KV, hd).astype(np.float32)
    vn = rng.randn(1, 5, KV, hd).astype(np.float32)
    jk, jv, _, _ = j_write_ragged(*map(jnp.asarray, (k, v, kn, vn, table, rows,
                                                     pos, mask)))
    tk, tv = t(k.copy()), t(v.copy())
    write_kv_pages_ragged(tk, tv, t(kn), t(vn), t(table), t(rows), t(pos), t(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dispatch_policy_on_cpu():
    """CPU tensors: auto and never run the plain version; always raises
    (the kernel cannot take them) instead of falling back."""
    q, k, v, table, pos, lens = map(t, _paged_case(9))
    ref = paged_attention_plain(q, k, v, table, pos, lens)
    for mode in ("auto", "never"):
        torch.testing.assert_close(
            paged_attention(q, k, v, table, pos, lens, use_kernels=mode), ref)
    with pytest.raises(RuntimeError):
        paged_attention(q, k, v, table, pos, lens, use_kernels="always")
    case = list(map(t, _ragged_case(10, [(3, 5)])))
    with pytest.raises(RuntimeError):
        ragged_paged_attention(*case, use_kernels="always")
    with pytest.raises(ValueError):
        ragged_paged_attention(*case, use_kernels="sometimes")
