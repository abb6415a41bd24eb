"""Multi-head latent attention (DeepSeek-V2/V3) in the absorbed inference
form over the paged latent pools (``rbg_tpu/ops/mla_attention.py``).

The pool stores one latent ``c [dc]`` (the "k" pool, ``[NP, page, 1, dc]``)
and one shared RoPE key ``pe [dr]`` (the "v" pool, ``[NP, page, 1, dr]``)
per slot. With ``q_nope`` absorbed through ``W_uk`` into ``q_lat [.., H, dc]``,
head h scores slot i as ``(q_lat[h]·c[i] + q_pe[h]·pe[i])·scale`` and the
values are the latents, so the output stays in latent space ``[.., H, dc]``;
the model applies ``W_uv`` after.

* ``mla_attention`` — the shared dense float32 math over a gathered view;
* ``paged_mla_attention_plain`` / ``ragged_paged_mla_attention_plain`` —
  gather the rows' pages (dequantizing an int8 pool's view), then
  ``mla_attention``; they run for CPU tensors and ``use_kernels="never"``.
  A query that sees no slot gives 0, as the kernels do (the reference's
  XLA functions give an average there). The ragged one takes packs whose
  rows are not contiguous runs;
* the CUDA kernels ``ops/kernels/paged_mla_decode.py`` (kernel E, decode)
  and ``ops/kernels/ragged_paged_mla.py`` (kernel F, ragged packs), and
  their int8-latent-pool forms ``ops/kernels/paged_mla_decode_q.py``
  (kernel G) and ``ops/kernels/ragged_paged_mla_q.py`` (kernel H), which
  the dispatchers ``paged_mla_attention`` / ``ragged_paged_mla_attention``
  launch for CUDA tensors; ``paged_mla_attention`` at T > 1 sends its
  [B, T] block to F / H as a pack of B rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from rbg_tpu_torch.ops.paged_attention import _NEG_INF, as_pack, dispatch
from rbg_tpu_torch.ops.ragged_paged_attention import unpack_to_rows


def mla_attention(
    q_lat: torch.Tensor,       # [B, T, H, dc]  q_nope absorbed through W_uk
    q_pe: torch.Tensor,        # [B, T, H, dr]  RoPE'd query part
    c_cache: torch.Tensor,     # [B, S, dc]     latent cache (post-norm)
    pe_cache: torch.Tensor,    # [B, S, dr]     shared RoPE key cache
    q_positions: torch.Tensor,  # [B, T] int32 absolute positions
    kv_valid: torch.Tensor,    # [B, S] bool, slot holds a real token
    scale: float,              # (qk_nope_head_dim + qk_rope_head_dim) ** -0.5
) -> torch.Tensor:
    """Causal MLA over a contiguous latent view (slot index == position).
    Returns the latent output [B, T, H, dc] in q_lat's dtype; a query that
    sees no slot gives 0."""
    S = c_cache.shape[1]
    cf, ef = c_cache.float(), pe_cache.float()
    scores = (torch.einsum("bthc,bsc->bhts", q_lat.float(), cf)
              + torch.einsum("bthr,bsr->bhts", q_pe.float(), ef)) * scale
    slot = torch.arange(S, dtype=torch.int32, device=q_lat.device)
    ok = ((slot[None, None, :] <= q_positions.to(torch.int32)[:, :, None])
          & kv_valid[:, None, :])                                   # [B, T, S]
    scores = torch.where(ok[:, None], scores,
                         torch.tensor(_NEG_INF, device=q_lat.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bsc->bthc", w, cf)
    seen = ok.any(dim=-1)                                           # [B, T]
    return torch.where(seen[:, :, None, None], out, 0.0).to(q_lat.dtype)


def _gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages [NP, page, 1, d] + table [B, P] -> [B, P*page, d]."""
    B, P = page_table.shape
    return pages[page_table.long()][:, :, :, 0].reshape(B, P * pages.shape[1], -1)


def paged_mla_attention_plain(
    q_lat: torch.Tensor,       # [B, T, H, dc]
    q_pe: torch.Tensor,        # [B, T, H, dr]
    c_pages: torch.Tensor,     # [NP, page, 1, dc] (one layer)
    pe_pages: torch.Tensor,    # [NP, page, 1, dr]
    page_table: torch.Tensor,  # [B, P] int32
    q_positions: torch.Tensor,  # [B, T] int32
    kv_lens: torch.Tensor,     # [B] int32, valid tokens after the write
    scale: float,
    c_scales: Optional[torch.Tensor] = None,   # [NP, page, 1, 1] (int8 pools)
    pe_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather the rows' pages into [B, S, d] views (dequantized for an int8
    pool), then ``mla_attention``."""
    c = _gather(c_pages, page_table)
    pe = _gather(pe_pages, page_table)
    if c_scales is not None:
        c = c.float() * _gather(c_scales, page_table)
        pe = pe.float() * _gather(pe_scales, page_table)
    S = c.shape[1]
    valid = (torch.arange(S, dtype=torch.int32, device=c.device)[None, :]
             < kv_lens.to(torch.int32)[:, None])
    return mla_attention(q_lat, q_pe, c, pe, q_positions, valid, scale)


def ragged_paged_mla_attention_plain(
    q_lat: torch.Tensor,       # [1, T, H, dc] packed tokens
    q_pe: torch.Tensor,        # [1, T, H, dr]
    c_pages: torch.Tensor,     # [NP, page, 1, dc]
    pe_pages: torch.Tensor,    # [NP, page, 1, dr]
    page_table: torch.Tensor,  # [R, P] int32, per row
    q_positions: torch.Tensor,  # [1, T] int32; -1 = pad
    kv_lens: torch.Tensor,     # [R] int32
    row_ids: torch.Tensor,     # [T] int32
    scale: float,
    c_scales: Optional[torch.Tensor] = None,
    pe_scales: Optional[torch.Tensor] = None,
    max_q_len: Optional[int] = None,
) -> torch.Tensor:
    """Unpack → padded batch MLA → repack (as
    ``ragged_paged_attention_plain``); pads give 0."""
    _, T, H, dc = q_lat.shape
    R = page_table.shape[0]
    pad, rows, scatter_row, idx, Tmax = unpack_to_rows(row_ids, q_positions, R,
                                                       T, max_q_len)
    dev = q_lat.device
    qlp = torch.zeros((R + 1, Tmax, H, dc), dtype=q_lat.dtype, device=dev)
    qlp[scatter_row, idx] = q_lat[0]
    qpp = torch.zeros((R + 1, Tmax, H, q_pe.shape[-1]), dtype=q_pe.dtype, device=dev)
    qpp[scatter_row, idx] = q_pe[0]
    pp = torch.zeros((R + 1, Tmax), dtype=torch.int32, device=dev)
    pp[scatter_row, idx] = q_positions[0].to(torch.int32)
    out = paged_mla_attention_plain(qlp[:R], qpp[:R], c_pages, pe_pages,
                                    page_table, pp[:R], kv_lens, scale,
                                    c_scales, pe_scales)
    res = out[rows, idx]                                   # [T, H, dc]
    return torch.where(pad[:, None, None], 0.0, res.float()).to(q_lat.dtype)[None]


def paged_mla_attention(q_lat, q_pe, c_pages, pe_pages, page_table,
                        q_positions, kv_lens, scale, *, use_kernels: str = "auto",
                        c_scales=None, pe_scales=None):
    """Paged MLA through a CUDA kernel for CUDA tensors, or the plain
    version (see ``dispatch``). T == 1: kernel G for int8 latent pools with
    scales, else kernel E. T > 1: the block as a pack (``as_pack``)
    through kernel H, else F; pads must come at position -1."""
    def kernel():
        if q_lat.shape[1] > 1:
            ql, pos, rows = as_pack(q_lat, q_positions)
            qe = q_pe.reshape(1, -1, *q_pe.shape[2:]).contiguous()
            return ragged_paged_mla_attention(
                ql, qe, c_pages, pe_pages, page_table, pos, kv_lens, rows, scale,
                use_kernels=use_kernels, c_scales=c_scales,
                pe_scales=pe_scales).reshape(q_lat.shape)
        if c_scales is not None:
            from rbg_tpu_torch.ops.kernels.paged_mla_decode_q import (
                paged_mla_decode_attention_q)
            return paged_mla_decode_attention_q(q_lat, q_pe, c_pages, pe_pages,
                                                c_scales, pe_scales, page_table,
                                                kv_lens, scale)
        from rbg_tpu_torch.ops.kernels.paged_mla_decode import (
            paged_mla_decode_attention)
        return paged_mla_decode_attention(q_lat, q_pe, c_pages, pe_pages,
                                          page_table, kv_lens, scale)

    return dispatch(use_kernels, q_lat, kernel, lambda: paged_mla_attention_plain(
        q_lat, q_pe, c_pages, pe_pages, page_table, q_positions, kv_lens, scale,
        c_scales, pe_scales))


def ragged_paged_mla_attention(q_lat, q_pe, c_pages, pe_pages, page_table,
                               q_positions, kv_lens, row_ids, scale, *,
                               use_kernels: str = "auto", c_scales=None,
                               pe_scales=None, max_q_len: Optional[int] = None):
    """Ragged MLA through a CUDA kernel for CUDA tensors (kernel H for int8
    latent pools with scales, else kernel F), or the plain version (see
    ``dispatch``). ``max_q_len`` only shapes the plain version's padded
    batch."""
    def kernel():
        if c_scales is not None:
            from rbg_tpu_torch.ops.kernels.ragged_paged_mla_q import (
                ragged_paged_mla_attention_q_cuda)
            return ragged_paged_mla_attention_q_cuda(q_lat, q_pe, c_pages, pe_pages,
                                                     c_scales, pe_scales, page_table,
                                                     q_positions, kv_lens, row_ids,
                                                     scale)
        from rbg_tpu_torch.ops.kernels.ragged_paged_mla import (
            ragged_paged_mla_attention_cuda)
        return ragged_paged_mla_attention_cuda(q_lat, q_pe, c_pages, pe_pages,
                                               page_table, q_positions, kv_lens,
                                               row_ids, scale)

    return dispatch(use_kernels, q_lat, kernel,
                    lambda: ragged_paged_mla_attention_plain(
                        q_lat, q_pe, c_pages, pe_pages, page_table, q_positions,
                        kv_lens, row_ids, scale, c_scales, pe_scales, max_q_len))
