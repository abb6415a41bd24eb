"""Grouped-query attention over a contiguous K/V (``rbg_tpu/ops/attention.py``).

The reference's dense formulation in torch ops: float32 einsum, mask,
softmax, einsum. It serves the cache-free forward (``encode_hidden``, the
embeddings path); the serving hot path uses the paged kernels instead.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def gqa_attention(
    q: torch.Tensor,            # [B, T, H, hd]
    k: torch.Tensor,            # [B, S, KV, hd]
    v: torch.Tensor,            # [B, S, KV, hd]
    q_positions: torch.Tensor,  # [B, T] int — absolute position of each query
    kv_valid: torch.Tensor,     # [B, S] bool — slot holds a real token
) -> torch.Tensor:
    """Causal GQA with slot index == absolute position: query t sees slot s
    when ``s <= q_positions[t]`` and the slot is valid. A query that sees
    no slot averages every value, as the reference does. Returns
    [B, T, H, hd] in q.dtype. Holds float32 scores [B, KV, G, T, S]."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) / math.sqrt(hd)
    slot = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]
    causal = slot <= q_positions.to(torch.int32)[:, :, None]         # [B, T, S]
    mask = causal & kv_valid[:, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(_NEG_INF, device=q.device))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
