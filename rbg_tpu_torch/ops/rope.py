"""Rotary position embeddings, rotate-half form on the last dim, with
float32 angles (``rbg_tpu/ops/rope.py``). Positions are explicit, so one
code path serves prefill chunks and decode steps."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions broadcastable to [..., seq]."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * inv_freq       # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
