"""Llama-family decoder (pre-norm, RoPE, GQA, SwiGLU) over a paged KV pool
(``rbg_tpu/models/llama.py``, dense serving forwards).

Parameters are a plain dict of tensors in the reference's layout: stacked
``[num_layers, ...]`` block weights, ``[in, out]`` matrices used as
``x @ w``, so the weight bridge (``models/convert.py``) is a copy. The
reference's ``lax.scan`` over layers is a Python loop here, and the
``[L, NP, page, KV, hd]`` pools are written IN PLACE, one layer view
``k_pages[l]`` at a time.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from rbg_tpu_torch.models.config import ModelConfig
from rbg_tpu_torch.ops.norms import rms_norm
from rbg_tpu_torch.ops.paged_attention import paged_attention, write_kv_pages
from rbg_tpu_torch.ops.ragged_paged_attention import (ragged_paged_attention,
                                                      write_kv_pages_ragged)
from rbg_tpu_torch.ops.rope import apply_rope


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense GQA models only."""
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA models are not ported yet (ROADMAP queue 1: MLA)")
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE models are not ported yet (ROADMAP queue 1: MoE)")


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Random init from a seed, with the reference's distributions (normal,
    0.02 scale on input projections, 0.02/sqrt(2L) on output projections,
    ones for norms) in cfg.dtype, drawn on ``device`` by a torch.Generator.
    The numbers differ from JAX's; parity tests convert JAX's own weights
    (``convert.params_from_numpy``). Layers are drawn one at a time so the
    float32 draw never holds a whole stacked weight."""
    check_supported(cfg)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, h, kv, L = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2.0 * L)

    def nrm(shape, scale, stacked=True):
        out = torch.empty(shape, dtype=dt, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32) * scale)
        return out

    blocks = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=device),
        "mlp_norm": torch.ones((L, d), dtype=dt, device=device),
        "wq": nrm((L, d, h * hd), s_in),
        "wk": nrm((L, d, kv * hd), s_in),
        "wv": nrm((L, d, kv * hd), s_in),
        "wo": nrm((L, h * hd, d), s_out),
        "w_gate": nrm((L, d, f), s_in),
        "w_up": nrm((L, d, f), s_in),
        "w_down": nrm((L, f, d), s_out),
    }
    params = {
        "embed": nrm((v, d), s_in, stacked=False),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((d, v), s_in, stacked=False)
    return params


def layer_params(params: dict, l: int) -> dict:
    return {k: w[l] for k, w in params["blocks"].items()}


def _qkv(cfg: ModelConfig, blk: dict, x: torch.Tensor, positions: torch.Tensor):
    """norm → projections → RoPE. x [B, T, D] → q [B,T,H,hd], k/v [B,T,KV,hd]."""
    B, T, _ = x.shape
    hd, h, kv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    xa = rms_norm(x, blk["attn_norm"], cfg.rms_norm_eps)
    q = (xa @ blk["wq"]).reshape(B, T, h, hd)
    k = (xa @ blk["wk"]).reshape(B, T, kv, hd)
    v = (xa @ blk["wv"]).reshape(B, T, kv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _mlp(blk: dict, xm: torch.Tensor) -> torch.Tensor:
    return (F.silu(xm @ blk["w_gate"]) * (xm @ blk["w_up"])) @ blk["w_down"]


def _post_attention(cfg: ModelConfig, blk: dict, x: torch.Tensor,
                    attn: torch.Tensor) -> torch.Tensor:
    """residual → norm → MLP → residual."""
    B, T, _ = x.shape
    x = x + attn.reshape(B, T, -1) @ blk["wo"]
    return x + _mlp(blk, rms_norm(x, blk["mlp_norm"], cfg.rms_norm_eps))


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """final norm + (tied) LM head, float32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (x @ head.to(cfg.torch_dtype)).float()


@torch.no_grad()
def forward_paged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, T] int
    positions: torch.Tensor,    # [B, T] int32 absolute positions
    token_mask: torch.Tensor,   # [B, T] bool, real (non-pad) tokens
    kv_lens: torch.Tensor,      # [B] int32, cache length AFTER this step
    page_table: torch.Tensor,   # [B, P] int32 physical page ids
    k_pages: torch.Tensor,      # [L, NP, page, KV, hd], written in place
    v_pages: torch.Tensor,
    use_kernels: str = "auto",
) -> torch.Tensor:
    """Serving forward over the paged pool. On CUDA its attention is the
    decode kernel, which takes T == 1 (the fused decode window). Writes
    this step's K/V into the pools in place; returns logits [B, T, V] f32."""
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    for l in range(cfg.num_layers):
        blk = layer_params(params, l)
        q, k, v = _qkv(cfg, blk, x, positions)
        write_kv_pages(k_pages[l], v_pages[l], k, v, page_table, positions,
                       token_mask)
        attn = paged_attention(q, k_pages[l], v_pages[l], page_table,
                               positions, kv_lens, use_kernels=use_kernels)
        x = _post_attention(cfg, blk, x, attn)
    return _head(params, cfg, x)


@torch.no_grad()
def forward_ragged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [1, T] int, every row's tokens packed
    positions: torch.Tensor,    # [1, T] int32 absolute positions; -1 = pad
    token_mask: torch.Tensor,   # [1, T] bool, real (non-pad) tokens
    row_ids: torch.Tensor,      # [T] int32 token → batch row
    kv_lens: torch.Tensor,      # [R] int32 per-row cache length AFTER step
    page_table: torch.Tensor,   # [R, P] int32
    k_pages: torch.Tensor,      # [L, NP, page, KV, hd], written in place
    v_pages: torch.Tensor,
    use_kernels: str = "auto",
    max_q_len: Optional[int] = None,  # bound on a row's query count
                                      # (the engine's prefill_chunk)
) -> torch.Tensor:
    """Serving forward over a ragged pack of prefill chunks and decode
    steps in one dispatch. Writes K/V into the pools in place; returns
    logits [1, T, V] f32."""
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    for l in range(cfg.num_layers):
        blk = layer_params(params, l)
        q, k, v = _qkv(cfg, blk, x, positions)
        write_kv_pages_ragged(k_pages[l], v_pages[l], k, v, page_table,
                              row_ids, positions, token_mask)
        attn = ragged_paged_attention(q, k_pages[l], v_pages[l], page_table,
                                      positions, kv_lens, row_ids,
                                      use_kernels=use_kernels,
                                      max_q_len=max_q_len)
        x = _post_attention(cfg, blk, x, attn)
    return _head(params, cfg, x)
