"""Ragged paged attention: prefill chunks and decode steps of many rows in
ONE dispatch (``rbg_tpu/ops/ragged_paged_attention.py``).

Layout, shared by every implementation here:

* ``q``            ``[1, T, H, hd]`` — every row's query tokens packed on one
  token axis;
* ``row_ids``      ``[T] int32`` — token → batch row;
* ``q_positions``  ``[1, T] int32`` — the token's absolute position; ``-1``
  marks a pad token, whose output is 0;
* ``page_table``   ``[R, P] int32`` / ``kv_lens [R] int32`` — per row, as in
  ``paged_attention`` (``kv_lens`` is the cache length after the write).

Token ``t`` attends slots ``< min(kv_lens[row_ids[t]], q_positions[t] + 1)``.

* ``ragged_paged_attention_plain`` — scatters the pack into a padded
  ``[R, max_q_len]`` batch, runs ``paged_attention_plain`` and gathers the
  tokens back (the reference's XLA detour). A token's slot in its row is
  its rank among the row's real tokens, so the pack need not hold each row
  as one contiguous run.
* the CUDA kernels ``ops/kernels/ragged_paged.py`` (model-dtype pools)
  and ``ops/kernels/ragged_paged_q.py`` (int8 pools with scales) — per-row
  query tiles (up to 64 // G of one row's live tokens, pads never in a
  tile), each walking its row's pages once, a long walk split across
  blocks and merged;
* the token-grid CUDA kernel ``ops/kernels/ragged_paged_tokengrid.py`` —
  the same function with one block per packed token, each walking its
  row's pages alone: the baseline the block-ragged kernel is measured
  against (``bench.block_ragged_probe``), not on the serving path.
"""

from __future__ import annotations

from typing import Optional

import torch

from rbg_tpu_torch.ops.paged_attention import (dispatch, paged_attention_plain,
                                               write_slots)


def unpack_to_rows(row_ids: torch.Tensor, q_positions: torch.Tensor, R: int,
                   T: int, max_q_len: Optional[int]):
    """Where each packed token goes in a padded ``[R, Tmax]`` batch: its
    (scatter row, index in row). Pads (``q_positions < 0``) scatter into a
    spare row ``R``, dropped before attention. Returns (pad mask, rows,
    scatter rows, idx, Tmax)."""
    Tmax = T if max_q_len is None else min(max_q_len, T)
    pad = q_positions[0] < 0
    idx = torch.clamp(_unpack_offsets(row_ids, ~pad), max=Tmax - 1)
    rows = row_ids.long()
    return pad, rows, torch.where(pad, torch.full_like(rows, R), rows), idx, Tmax


def _unpack_offsets(row_ids: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token index WITHIN its row: the number of earlier tokens of the
    same row. For a row-major contiguous pack this is ``t - (first index of
    the row's run)``, the reference's value. Tokens with ``valid`` False
    (pads) are ranked apart and never shift a real token's index."""
    T = row_ids.shape[0]
    key = row_ids.long()
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, -1))
    order = torch.argsort(key, stable=True)
    sk = key[order]
    t_idx = torch.arange(T, device=row_ids.device)
    is_start = torch.ones(T, dtype=torch.bool, device=row_ids.device)
    is_start[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(is_start, t_idx, 0), dim=0).values
    rank = torch.empty_like(t_idx)
    rank[order] = t_idx - start
    return rank


def ragged_paged_attention_plain(
    q: torch.Tensor,            # [1, T, H, hd] packed tokens
    k_pages: torch.Tensor,      # [NP, page, KV, hd] (one layer)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [R, P] int32, per row
    q_positions: torch.Tensor,  # [1, T] int32; -1 = pad
    kv_lens: torch.Tensor,      # [R] int32, per-row cache length after the write
    row_ids: torch.Tensor,      # [T] int32
    max_q_len: Optional[int] = None,  # bound on any row's query count
                                      # (the engine's prefill_chunk); None = T
    k_scales: Optional[torch.Tensor] = None,  # [NP, page, KV, 1] (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unpack → padded batch attention → repack."""
    _, T, H, hd = q.shape
    R = page_table.shape[0]
    pad, rows, scatter_row, idx, Tmax = unpack_to_rows(row_ids, q_positions, R,
                                                       T, max_q_len)
    qp = torch.zeros((R + 1, Tmax, H, hd), dtype=q.dtype, device=q.device)
    qp[scatter_row, idx] = q[0]
    pp = torch.zeros((R + 1, Tmax), dtype=torch.int32, device=q.device)
    pp[scatter_row, idx] = q_positions[0].to(torch.int32)
    out = paged_attention_plain(qp[:R], k_pages, v_pages, page_table, pp[:R],
                                kv_lens, k_scales, v_scales)
    res = out[rows, idx]                                   # [T, H, hd]
    return torch.where(pad[:, None, None], 0.0, res.float()).to(q.dtype)[None]


def write_kv_pages_ragged(k_pages, v_pages, k_new, v_new, page_table,
                          row_ids, positions, token_mask, k_scales=None,
                          v_scales=None):
    """Scatter packed new K/V (``[1, T, KV, d]``) into the pool, in place
    (quantizing into an int8 pool and its scales when ``k_scales`` is
    given). Each token's page comes from ITS row's table line; pad tokens
    (token_mask False) write nothing."""
    page_size = k_pages.shape[1]
    pos = positions[0].long()
    page_idx = torch.clamp(pos // page_size, 0, page_table.shape[1] - 1)
    phys = page_table.long()[row_ids.long(), page_idx]
    write_slots(k_pages, v_pages, k_new[0], v_new[0], phys, pos % page_size,
                token_mask[0], k_scales, v_scales)


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_positions,
                           kv_lens, row_ids, *, use_kernels: str = "auto",
                           max_q_len: Optional[int] = None, k_scales=None,
                           v_scales=None):
    """A ragged CUDA kernel for CUDA tensors (kernel D for an int8 pool with
    scales, else kernel B), or the plain version (see ``dispatch``).
    ``max_q_len`` only shapes the plain version's padded batch; the kernels
    need no padding."""
    def kernel():
        if k_scales is not None:
            from rbg_tpu_torch.ops.kernels.ragged_paged_q import (
                ragged_paged_attention_q_cuda)
            return ragged_paged_attention_q_cuda(q, k_pages, v_pages, k_scales,
                                                 v_scales, page_table,
                                                 q_positions, kv_lens, row_ids)
        from rbg_tpu_torch.ops.kernels.ragged_paged import ragged_paged_attention_cuda
        return ragged_paged_attention_cuda(q, k_pages, v_pages, page_table,
                                           q_positions, kv_lens, row_ids)

    return dispatch(use_kernels, q, kernel, lambda: ragged_paged_attention_plain(
        q, k_pages, v_pages, page_table, q_positions, kv_lens, row_ids,
        max_q_len, k_scales, v_scales))


def ragged_paged_attention_tokengrid(q, k_pages, v_pages, page_table,
                                     q_positions, kv_lens, row_ids, *,
                                     use_kernels: str = "auto"):
    """The token-grid kernel I for CUDA tensors (model-dtype pools), or the
    plain version (see ``dispatch``)."""
    def kernel():
        from rbg_tpu_torch.ops.kernels.ragged_paged_tokengrid import (
            ragged_paged_attention_tokengrid_cuda)
        return ragged_paged_attention_tokengrid_cuda(q, k_pages, v_pages, page_table,
                                                     q_positions, kv_lens, row_ids)

    return dispatch(use_kernels, q, kernel, lambda: ragged_paged_attention_plain(
        q, k_pages, v_pages, page_table, q_positions, kv_lens, row_ids))
