"""Ring attention: exact causal attention over sequence shards
(``rbg_tpu/parallel/ring.py``).

Each rank on the mesh's ``sp`` axis holds one sequence shard of Q/K/V. The
K/V blocks (and their global positions) travel one hop around the ring per
step while each rank keeps its queries' online-softmax accumulators, so a
rank never holds more than one remote block. The hop is ``shift``, a
differentiable ``ppermute``: forward it sends to the next rank and receives
from the previous one (``dist.batch_isend_irecv``), backward it sends the
gradient the other way, so autograd differentiates the ring loop as JAX
differentiates the reference's ``lax.scan`` — no hand-written backward.

Causality is positional: blocks carry their global positions, so the mask
is exact for any layout (pads get a position past every query).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from rbg_tpu_torch.parallel.mesh import axis_group, axis_size, neighbour

_NEG_INF = -1e30


def exchange(x: torch.Tensor, dst: Optional[int], src: Optional[int],
             group) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and return what arrives from
    ``src`` (zeros where ``src`` is None)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x, dst, group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst, src):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        return exchange(x, dst, src, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.src, ctx.dst, ctx.group), None, None, None


def shift(x: torch.Tensor, group, dst: Optional[int], src: Optional[int]) -> torch.Tensor:
    """A differentiable ppermute: ``x`` goes to ``dst``, the result comes
    from ``src``; the gradient travels back the other way."""
    return _Shift.apply(x, group, dst, src)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   mesh, axis: str = "sp") -> torch.Tensor:
    """Causal GQA over the sequence shards on ``axis``. This rank's shards:
    q [B, Sq, H, hd]; k/v [B, Sk, KV, hd]; positions [B, S] global (a
    slot is seen when its position is <= the query's). Returns this rank's
    [B, Sq, H, hd] in q's dtype; float32 accumulators, as the reference."""
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis) if n > 1 else None
    dst = neighbour(mesh, axis, 1) if n > 1 else None
    src = neighbour(mesh, axis, -1) if n > 1 else None
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, Sq, KV, H // KV, hd).float()
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, KV, H // KV, Sq, 1), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, Sq, hd), device=q.device)
    neg = torch.tensor(_NEG_INF, device=q.device)
    kb, vb, kvp = k, v, kv_positions
    for i in range(n):
        scores = torch.einsum("btkgh,bskh->bkgts", qf, kb.float()) * scale
        causal = kvp[:, None, :] <= q_positions[:, :, None]           # [B, Sq, Sk]
        scores = torch.where(causal[:, None, None], scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(scores - m_new)
        l = l * alpha + probs.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgts,bskh->bkgth", probs, vb.float())
        m = m_new
        if i < n - 1:              # the reference's last hop only brings them home
            kb, vb = shift(kb, group, dst, src), shift(vb, group, dst, src)
            kvp = exchange(kvp, dst, src, group)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
