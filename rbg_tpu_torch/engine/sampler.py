"""Token sampling with per-row parameters as tensors
(``rbg_tpu/engine/sampler.py``): greedy / temperature / top-k / top-p /
min-p, optional repetition/presence/frequency penalties and logprobs.

The reference's rule holds: a row's randomness is a pure function of
(row key, token position), so a decode-state rebuild or a preemption
replays the same stream. JAX's threefry keys cannot be reproduced from
torch, so the Gumbel noise here comes from a counter-based integer hash
in torch ops (``gumbel_noise``). Sampling is split in three: keys
(``row_keys``) → noise → ``sample_from_noise``, the math, which takes the
noise as a tensor; the parity tests feed it JAX's own noise.

Semantics follow the reference: repetition_penalty divides positive /
multiplies negative logits of any token seen in prompt or output;
presence/frequency penalties subtract from output-seen tokens; temperature
scales before top-k/top-p/min-p; logprobs report the model distribution
after penalties, before temperature.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash of int64 tensors holding values in [0, 2^32).
    The multipliers are below 2^31, so no product overflows int64."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def row_keys(seeds: Sequence[Optional[int]], base_seed: int,
             ids: Sequence[int], device) -> torch.Tensor:
    """[B] int64 row keys: a row with a seed gets the seed (reproducible
    per request), a row without gets a hash of (engine seed, request id)."""
    seeds_t = torch.tensor([(s if s is not None else 0) & _M32 for s in seeds],
                           dtype=torch.int64)
    has = torch.tensor([s is not None for s in seeds])
    rids = torch.tensor([int(i) & _M32 for i in ids], dtype=torch.int64)
    fallback = _mix32(_mix32(torch.full_like(rids, base_seed & _M32)) ^ rids)
    return torch.where(has, seeds_t, fallback).to(device)


def gumbel_noise(keys: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] float32 Gumbel(0, 1) noise for sampling the token at
    ``positions`` of each row: a pure function of (key, position, vocab id)."""
    row = _mix32(_mix32(keys ^ 0x9E3779B9) ^ (positions.long() & _M32))
    col = _mix32(torch.arange(vocab, device=keys.device, dtype=torch.int64)
                 + 0x632BE5AB)
    h = _mix32((_mix32(row[:, None] ^ col[None, :]) + row[:, None]) & _M32)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))        # (0, 1)
    return -torch.log(-torch.log(u))


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
