"""Paged attention: GQA over a page-table-indirected KV pool
(``rbg_tpu/ops/paged_attention.py``).

Two implementations behind one signature:

* ``paged_attention_plain`` — gather the row's pages into a contiguous
  view, then dense float32 softmax attention (the XLA function of the
  reference). It runs for CPU tensors, and wherever a caller asks for
  ``use_kernels="never"``.
* the CUDA kernel ``ops/kernels/paged_decode.py`` — decode (T == 1)
  attention that walks each row's pages in shared memory and never
  materialises the gathered view.

``dispatch`` is the one kernel-versus-plain policy of the package.
"""

from __future__ import annotations

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
) -> torch.Tensor:
    """Gather, then dense float32 attention. A query that sees no cache slot
    (``kv_len == 0`` or a negative position) gives 0, as the kernels do."""
    B, T, H, hd = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    S = page_table.shape[1] * k_pages.shape[1]
    k = gather_kv(k_pages, page_table).float()        # [B, S, KV, hd]
    v = gather_kv(v_pages, page_table).float()
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


def _write_slots(k_pages, v_pages, k_new, v_new, phys, slot, token_mask):
    """Write [N, KV, hd] rows into the pool IN PLACE at (phys, slot).

    Pad tokens (``token_mask`` False) are sent to slot 0 of page 0 — the
    null page the allocator never hands out — carrying that slot's own
    contents, so the pool is unchanged there. This keeps the write free of
    host syncs (a boolean filter would wait for the device on every layer)
    and matches the reference's dropped out-of-range writes."""
    keep = token_mask.reshape(-1)
    zero = torch.zeros((), dtype=torch.long, device=k_pages.device)
    phys = torch.where(keep, phys.reshape(-1).long(), zero)
    slot = torch.where(keep, slot.reshape(-1).long(), zero)
    m = keep[:, None, None]
    kn = torch.where(m, k_new.to(k_pages.dtype), k_pages[0, 0])
    vn = torch.where(m, v_new.to(v_pages.dtype), v_pages[0, 0])
    k_pages.index_put_((phys, slot), kn)
    v_pages.index_put_((phys, slot), vn)


def write_kv_pages(k_pages, v_pages, k_new, v_new, page_table, positions,
                   token_mask):
    """Scatter new K/V into a model-dtype pool, in place.

    k_new/v_new: [B, T, KV, hd]; positions: [B, T] absolute; pad tokens
    (token_mask False) write nothing. Returns nothing: the pool tensors
    themselves change."""
    B, T, KV, hd = k_new.shape
    page_size = k_pages.shape[1]
    pos = positions.long()
    # Clamped so a pad token's position (-1, or a finished row's limit)
    # still indexes the table; its write is discarded below.
    page_idx = torch.clamp(pos // page_size, 0, page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, page_idx)
    _write_slots(k_pages, v_pages, k_new.reshape(B * T, KV, hd),
                 v_new.reshape(B * T, KV, hd), phys, pos % page_size,
                 token_mask)


def paged_attention(q, k_pages, v_pages, page_table, q_positions, kv_lens,
                    *, use_kernels: str = "auto"):
    """Decode attention through the CUDA kernel for CUDA tensors, or the
    plain version (see ``dispatch``)."""
    def kernel():
        from rbg_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
        return paged_decode_attention(q, k_pages, v_pages, page_table,
                                      kv_lens)

    return dispatch(use_kernels, q, kernel, lambda: paged_attention_plain(
        q, k_pages, v_pages, page_table, q_positions, kv_lens))
