"""Token sampling with per-row parameters as tensors
(``rbg_tpu/engine/sampler.py``): greedy / temperature / top-k / top-p /
min-p, optional repetition/presence/frequency penalties and logprobs.

The reference's rule holds: a row's randomness is a pure function of
(row key, token position), so a decode-state rebuild or a preemption
replays the same stream. The keys and the noise are JAX's own, bit for
bit: threefry2x32 ``key`` / ``fold_in`` and ``jax.random.gumbel`` (the
default ``threefry2x32`` PRNG with ``jax_threefry_partitionable``) written
in torch integer ops, with uint32 values held in int64 tensors. So a
seeded request replays the reference's token stream. Sampling is split in
three: keys (``row_keys``) → noise (``gumbel_noise``) →
``sample_from_noise``, the math, which takes the noise as a tensor.

Semantics follow the reference: repetition_penalty divides positive /
multiplies negative logits of any token seen in prompt or output;
presence/frequency penalties subtract from output-seen tokens; temperature
scales before top-k/top-p/min-p; logprobs report the model distribution
after penalties, before temperature.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of ``jax._src.prng``, on
    int64 tensors holding uint32 values (broadcast together). Returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``key_data(jax.random.key(seed))`` of a 32-bit seed: [0, seed]."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` of [.., 2] key data with uint32 ``data`` (broadcast):
    threefry of the key over the counter pair (0, data)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def _f32(x: float) -> float:
    return float(np.float32(x))


# XLA's float32 log on the CPU (its Cephes polynomial): log(x) = log(m) +
# e·ln 2 with m in [sqrt(1/2), sqrt(2)), ln 2 split as Q2 + Q1.
_LOG_P = tuple(map(_f32, (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), 0.693359375
_SQRT_HALF = _f32(0.707106781186547524)


def _fma(a, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once, as a fused multiply-add: the product of
    two float32 values is exact in float64."""
    wide = lambda x: x.double() if torch.is_tensor(x) else x
    return (wide(a) * wide(b) + wide(c)).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive finite x, bit for bit the one JAX's
    CPU backend compiles (the Cephes polynomial with the multiply-adds that
    LLVM fuses), so the noise below equals ``jax.random.gumbel``'s."""
    x = torch.clamp(x, min=torch.finfo(torch.float32).tiny)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.float()
    xm = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = xm * xm
    x3 = z * xm
    p = _LOG_P
    y = _fma(_fma(xm, p[0], p[1]), xm, p[2])
    y1 = _fma(_fma(xm, p[3], p[4]), xm, p[5])
    y2 = _fma(_fma(xm, p[6], p[7]), xm, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, _fma(z, -0.5, xm) + y)


def row_keys(seeds: Sequence[Optional[int]], base_seed: int,
             ids: Sequence[int], device) -> torch.Tensor:
    """[B, 2] row key data (the reference's ``row_keys``): a row with a seed
    gets ``key(seed)`` (reproducible per request), a row without gets
    ``fold_in(key(base_seed), request id)``."""
    has = torch.tensor([s is not None for s in seeds])
    seeded = torch.stack([key(s if s is not None else 0) for s in seeds])
    rids = torch.tensor([int(i) & _M32 for i in ids], dtype=torch.int64)
    fallback = fold_in(key(base_seed), rids)
    return torch.where(has[:, None], seeded, fallback).to(device)


def gumbel_noise(keys: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] float32 Gumbel(0, 1) noise for sampling the token at
    ``positions`` of each row: ``jax.random.gumbel(fold_in(row_key, pos),
    (V,), float32)`` per row, bit for bit. The random bits of vocab id i
    are the xor of threefry's two words over the counter pair (0, i); the
    uniform takes their top 23 bits as a mantissa in [1, 2), minus 1,
    moved into [tiny, 1)."""
    k = fold_in(keys, positions.long())
    i = torch.arange(vocab, device=keys.device, dtype=torch.int64)[None, :]
    a, b = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(i), i)
    mant = ((a ^ b) >> 9) | 0x3F800000
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(mant.to(torch.int32).view(torch.float32) - 1.0 + tiny, min=tiny)
    return -_log(-_log(u))


def apply_penalties(logits, prompt_mask, out_counts, rep, pres, freq):
    seen = prompt_mask | (out_counts > 0)
    rp = rep[:, None]
    logits = torch.where(
        seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    logits = logits - pres[:, None] * (out_counts > 0)
    return logits - freq[:, None] * out_counts.to(logits.dtype)


def _mask_top_k(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, V - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    return torch.where((top_k[:, None] > 0) & (scaled < kth), NEG_INF, scaled)


def _mask_top_p_min_p(scaled, top_p, min_p):
    probs = torch.softmax(scaled, dim=-1)
    # top-p: keep the smallest prefix of sorted-desc probs whose exclusive
    # cumulative mass is < top_p; threshold = smallest kept probability.
    sp = torch.sort(probs, dim=-1, descending=True).values
    kept = (torch.cumsum(sp, dim=-1) - sp) < top_p[:, None]
    thresh = torch.where(kept, sp, torch.inf).amin(dim=-1, keepdim=True)
    scaled = torch.where((top_p[:, None] < 1.0) & (probs < thresh),
                         NEG_INF, scaled)
    pmax = probs.amax(dim=-1, keepdim=True)
    return torch.where((min_p[:, None] > 0.0) & (probs < min_p[:, None] * pmax),
                       NEG_INF, scaled)


def sample_from_noise(
    logits: torch.Tensor,            # [B, V] f32
    noise: Optional[torch.Tensor],   # [B, V] f32 Gumbel noise; None = greedy
    temperature: torch.Tensor,       # [B] f32; 0 = greedy
    top_k: torch.Tensor,             # [B] int; 0 = full vocab
    top_p: torch.Tensor,             # [B] f32; 1.0 = disabled
    min_p: torch.Tensor,             # [B] f32; 0.0 = disabled
    *,
    prompt_mask: Optional[torch.Tensor] = None,   # [B, V] bool
    out_counts: Optional[torch.Tensor] = None,    # [B, V] int
    rep: Optional[torch.Tensor] = None,           # [B] f32
    pres: Optional[torch.Tensor] = None,          # [B] f32
    freq: Optional[torch.Tensor] = None,          # [B] f32
    want_logprobs: bool = False,
    use_top_p_min_p: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (token ids [B] int64, logprobs [B] f32 or None). Penalty
    arguments are all-or-nothing. With ``noise`` None every row is greedy
    (the caller passes None only when no row has temperature > 0)."""
    if prompt_mask is not None:
        logits = apply_penalties(logits, prompt_mask, out_counts, rep, pres, freq)
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        toks = greedy
    else:
        scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
        scaled = _mask_top_k(scaled, top_k)
        if use_top_p_min_p:
            scaled = _mask_top_p_min_p(scaled, top_p, min_p)
        sampled = torch.argmax(scaled + noise, dim=-1)
        toks = torch.where(temperature > 0, sampled, greedy)
    lps = None
    if want_logprobs:
        lps = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                           toks[:, None])[:, 0]
    return toks, lps


def sample(logits, keys, positions, temperature, top_k, top_p, min_p, *,
           any_sampled: bool = True, **kw):
    """Keys → noise → ``sample_from_noise``. ``any_sampled`` (host-known:
    some row has temperature > 0) skips the noise for all-greedy batches."""
    noise = (gumbel_noise(keys, positions, logits.shape[-1])
             if any_sampled else None)
    return sample_from_noise(logits, noise, temperature, top_k, top_p, min_p,
                             **kw)
