"""Paged attention: GQA over a page-table-indirected KV pool
(``rbg_tpu/ops/paged_attention.py``).

Two implementations behind one signature:

* ``paged_attention_plain`` — gather the row's pages into a contiguous
  view, then dense float32 softmax attention (the XLA function of the
  reference). It runs for CPU tensors, and wherever a caller asks for
  ``use_kernels="never"``.
* the CUDA kernels ``ops/kernels/paged_decode.py`` (model-dtype pools)
  and ``ops/kernels/paged_decode_q.py`` (int8 pools with per-(slot, kv
  head) scales) — decode (T == 1) attention that walks each row's pages
  in shared memory and never materialises the gathered view;
* at T > 1 (prefill chunks, speculative verifies) the ragged kernels
  ``ops/kernels/ragged_paged.py`` / ``ragged_paged_q.py``: the [B, T]
  block is a row-major pack of B rows (``as_pack``), whose function is
  exactly the ragged pack's.

``dispatch`` is the one kernel-versus-plain policy of the package.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30
USE_KERNELS = ("auto", "always", "never")


def dispatch(use_kernels: str, x: torch.Tensor, kernel_fn, plain_fn):
    """Pick the kernel or the plain version for the tensor ``x``.

    A CUDA tensor under ``auto`` or ``always`` launches the kernel, with no
    fallback: a kernel that cannot run raises. A CPU tensor under ``auto``
    runs the plain version; under ``always`` it raises. ``never`` runs the
    plain version on any device."""
    if use_kernels not in USE_KERNELS:
        raise ValueError(f"use_kernels {use_kernels!r} not in {USE_KERNELS}")
    if use_kernels == "never":
        return plain_fn()
    if x.is_cuda:
        return kernel_fn()
    if use_kernels == "always":
        raise RuntimeError("use_kernels='always' needs CUDA tensors; the "
                           f"kernel cannot run on {x.device}")
    return plain_fn()


def gather_kv(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages [NP, page, KV, hd] + table [B, P] -> [B, P*page, KV, hd]."""
    B, P = page_table.shape
    g = pages[page_table.long()]                      # [B, P, page, KV, hd]
    return g.reshape(B, P * pages.shape[1], *pages.shape[2:])


def paged_attention_plain(
    q: torch.Tensor,            # [B, T, H, hd]
    k_pages: torch.Tensor,      # [NP, page, KV, hd] (one layer)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, P] int32
    q_positions: torch.Tensor,  # [B, T] int32 absolute positions
    kv_lens: torch.Tensor,      # [B] int32, valid cache tokens after the write
    k_scales: Optional[torch.Tensor] = None,  # [NP, page, KV, 1] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather (dequantizing an int8 pool's view), then dense float32
    attention. A query that sees no cache slot (``kv_len == 0`` or a
    negative position) gives 0, as the kernels do."""
    B, T, H, hd = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    S = page_table.shape[1] * k_pages.shape[1]
    k = gather_kv(k_pages, page_table).float()        # [B, S, KV, hd]
    v = gather_kv(v_pages, page_table).float()
    if k_scales is not None:
        k = k * gather_kv(k_scales, page_table)
        v = v * gather_kv(v_scales, page_table)
    qg = q.reshape(B, T, KV, G, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k) / torch.sqrt(
        torch.tensor(float(hd)))
    slot = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]
    qpos = q_positions.to(torch.int32)
    lens = kv_lens.to(torch.int32)
    mask = (slot <= qpos[:, :, None]) & (slot < lens[:, None, None])  # [B,T,S]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(_NEG_INF, device=q.device))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v).reshape(B, T, H, hd)
    seen = mask.any(dim=-1)                                          # [B, T]
    return torch.where(seen[:, :, None, None], out, 0.0).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) absmax int8 quantization (``rbg_tpu``'s
    ``quantize_kv``, bit for bit: ``torch.round`` rounds half to even like
    ``jnp.round``). x: [..., hd] -> (int8 values, f32 scales [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-10))
    return q.clamp(-127, 127).to(torch.int8), scale


def _write_slots(pools, news, phys, slot, token_mask):
    """Write ``news[i]`` ([N, ...] rows) into ``pools[i]`` IN PLACE at
    (phys, slot), every pair alike (K and V, and an int8 pool's scales).

    Pad tokens (``token_mask`` False) are sent to slot 0 of page 0 — the
    null page the allocator never hands out — carrying that slot's own
    contents, so the pool is unchanged there. This keeps the write free of
    host syncs (a boolean filter would wait for the device on every layer)
    and matches the reference's dropped out-of-range writes."""
    keep = token_mask.reshape(-1)
    zero = torch.zeros((), dtype=torch.long, device=pools[0].device)
    phys = torch.where(keep, phys.reshape(-1).long(), zero)
    slot = torch.where(keep, slot.reshape(-1).long(), zero)
    m = keep[:, None, None]
    for pool, new in zip(pools, news):
        pool.index_put_((phys, slot), torch.where(m, new.to(pool.dtype), pool[0, 0]))


def write_slots(k_pages, v_pages, k_new, v_new, phys, slot, token_mask,
                k_scales=None, v_scales=None):
    """K/V rows [N, KV, d] (MLA: the latent c and the RoPE key, each one
    "head" of its own width) into the pools at (phys, slot), quantized
    when the pools are int8 (``k_scales`` given)."""
    if k_scales is None:
        _write_slots((k_pages, v_pages), (k_new, v_new), phys, slot, token_mask)
        return
    k_q, k_s = quantize_kv(k_new)
    v_q, v_s = quantize_kv(v_new)
    _write_slots((k_pages, v_pages, k_scales, v_scales), (k_q, v_q, k_s, v_s),
                 phys, slot, token_mask)


def write_kv_pages(k_pages, v_pages, k_new, v_new, page_table, positions,
                   token_mask, k_scales=None, v_scales=None):
    """Scatter new K/V into the pool, in place (quantizing into an int8
    pool and its scales when ``k_scales`` is given).

    k_new/v_new: [B, T, KV, d]; positions: [B, T] absolute; pad tokens
    (token_mask False) write nothing. Returns nothing: the pool tensors
    themselves change."""
    B, T = k_new.shape[:2]
    page_size = k_pages.shape[1]
    pos = positions.long()
    # Clamped so a pad token's position (-1, or a finished row's limit)
    # still indexes the table; its write is discarded below.
    page_idx = torch.clamp(pos // page_size, 0, page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, page_idx)
    write_slots(k_pages, v_pages, k_new.reshape(B * T, *k_new.shape[2:]),
                v_new.reshape(B * T, *v_new.shape[2:]), phys, pos % page_size,
                token_mask, k_scales, v_scales)


def as_pack(q: torch.Tensor, q_positions: torch.Tensor):
    """A [B, T, ...] block as the ragged kernels' pack, built on the device
    with no host sync: q [1, B·T, ...], positions [1, B·T] int32 (a pad
    must already be -1), row_ids [B·T] int32 (row b's T tokens in order)."""
    B, T = q.shape[:2]
    rows = torch.arange(B, dtype=torch.int32, device=q.device)
    return (q.reshape(1, B * T, *q.shape[2:]).contiguous(),
            q_positions.reshape(1, B * T).to(torch.int32).contiguous(),
            rows.repeat_interleave(T))


def paged_attention(q, k_pages, v_pages, page_table, q_positions, kv_lens,
                    *, use_kernels: str = "auto", k_scales=None, v_scales=None,
                    invariant: bool = False):
    """Paged attention through a CUDA kernel for CUDA tensors, or the plain
    version (see ``dispatch``). T == 1: kernel C for an int8 pool with
    scales, else kernel A. T > 1: the block as a pack (``as_pack``)
    through kernel D, else B; pads must come at position -1.
    ``invariant``: the kernels' batch-invariant switch (``ops/rows.py``)."""
    def kernel():
        if q.shape[1] > 1:
            from rbg_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention
            qp, pos, rows = as_pack(q, q_positions)
            return ragged_paged_attention(
                qp, k_pages, v_pages, page_table, pos, kv_lens, rows,
                use_kernels=use_kernels, k_scales=k_scales,
                v_scales=v_scales, invariant=invariant).reshape(q.shape)
        if k_scales is not None:
            from rbg_tpu_torch.ops.kernels.paged_decode_q import (
                paged_decode_attention_q)
            return paged_decode_attention_q(q, k_pages, v_pages, k_scales,
                                            v_scales, page_table, kv_lens, invariant)
        from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
        return paged_decode_attention(q, k_pages, v_pages, page_table,
                                      kv_lens, invariant)

    return dispatch(use_kernels, q, kernel, lambda: paged_attention_plain(
        q, k_pages, v_pages, page_table, q_positions, kv_lens, k_scales,
        v_scales))
