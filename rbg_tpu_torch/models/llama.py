"""Llama-family decoder (pre-norm, RoPE, GQA or MLA attention, SwiGLU or
MoE MLP) over a paged KV pool (``rbg_tpu/models/llama.py``, serving
forwards), with per-row multi-LoRA on the dense projections, and the
contiguous-cache ``forward`` the reference keeps as its plain loop.

Parameters are a plain dict of tensors in the reference's layout: stacked
``[num_layers, ...]`` block weights, ``[in, out]`` matrices used as
``x @ w``, so the weight bridge (``models/convert.py``) is a copy. The
reference's ``lax.scan`` over layers is a Python loop here, and the
``[L, NP, page, KV, hd]`` pools (and an int8 pool's scales) are written IN
PLACE, one layer view ``k_pages[l]`` at a time. An MLA model's pools are
latent: the latent ``c`` goes to the "k" pool as one head, the RoPE key to
the "v" pool. ``encode_hidden`` is the cache-free causal forward of the
embeddings path, and ``forward_train`` the same body with autograd (no
``torch.no_grad``), remat and the parallel plane of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from rbg_tpu_torch.models.config import ModelConfig
from rbg_tpu_torch.ops.attention import gqa_attention
from rbg_tpu_torch.ops.mla_attention import (mla_attention, paged_mla_attention,
                                             ragged_paged_mla_attention)
from rbg_tpu_torch.ops.norms import rms_norm
from rbg_tpu_torch.ops.paged_attention import paged_attention, write_kv_pages
from rbg_tpu_torch.ops.ragged_paged_attention import (ragged_paged_attention,
                                                      write_kv_pages_ragged)
from rbg_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass
class KVCache:
    """Contiguous KV cache: slot index == absolute position. k, v:
    ``[L, B, S, KV, hd]`` (MLA: the latent ``c`` and the RoPE key, one
    "head" each); length ``[B]`` int32, the filled length."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> "KVCache":
        if cfg.mla:
            kshape = (cfg.num_layers, batch, max_len, 1, cfg.kv_lora_rank)
            vshape = kshape[:-1] + (cfg.qk_rope_head_dim,)
        else:
            kshape = vshape = (cfg.num_layers, batch, max_len,
                               cfg.num_kv_heads, cfg.head_dim_)
        dt = cfg.torch_dtype
        return KVCache(k=torch.zeros(kshape, dtype=dt, device=device),
                       v=torch.zeros(vshape, dtype=dt, device=device),
                       length=torch.zeros(batch, dtype=torch.int32, device=device))


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int, device, mesh=None) -> dict:
    """Random init from a seed, with the reference's distributions (normal,
    0.02 scale on input projections, 0.02/sqrt(2L) on output projections,
    ones for norms) in cfg.dtype, drawn on ``device`` by a torch.Generator.
    The numbers differ from JAX's; parity tests convert JAX's own weights
    (``convert.params_from_numpy``). Layers are drawn one at a time so the
    float32 draw never holds a whole stacked weight. With a ``mesh``
    (``parallel/``) each layer is still drawn whole, so the numbers equal
    the full tree's, and only this rank's slice (``param_specs``) is kept:
    no rank ever holds the whole model."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, h, kv, L = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2.0 * L)
    specs = None
    if mesh is not None:
        from rbg_tpu_torch.parallel.sharding import local_shard, param_specs, split_factor
        specs = param_specs(cfg)
        specs.update(specs.pop("blocks"))

    def nrm(key, shape, scale, stacked=True):
        """Weight ``key`` (its name in the tree) of ``shape``, a layer at a
        time when ``stacked``; under a mesh, this rank's slice of it."""
        spec = None if specs is None else specs[key]
        local = shape if spec is None else tuple(
            n // k for n, k in zip(shape, split_factor(spec, mesh)))
        out = torch.empty(local, dtype=dt, device=device)
        for part in (out if stacked else [out]):
            w = torch.randn(shape[1:] if stacked else shape, generator=gen,
                            device=device, dtype=torch.float32) * scale
            if spec is not None:
                w = local_shard(w, spec[1:] if stacked else spec, mesh)
            part.copy_(w)
        return out

    blocks = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=device),
        "mlp_norm": torch.ones((L, d), dtype=dt, device=device),
    }
    if cfg.mla:
        dc, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
        blocks.update({
            "wq": nrm("wq", (L, d, h * (dn + dr)), s_in),
            "w_dkv": nrm("w_dkv", (L, d, dc + dr), s_in),
            "kv_norm": torch.ones((L, dc), dtype=dt, device=device),
            "w_uk": nrm("w_uk", (L, dc, h * dn), s_in),
            "w_uv": nrm("w_uv", (L, dc, h * dv), s_in),
            "wo": nrm("wo", (L, h * dv, d), s_out),
        })
    else:
        blocks.update({
            "wq": nrm("wq", (L, d, h * hd), s_in),
            "wk": nrm("wk", (L, d, kv * hd), s_in),
            "wv": nrm("wv", (L, d, kv * hd), s_in),
            "wo": nrm("wo", (L, h * hd, d), s_out),
        })
    if cfg.num_experts == 0 or cfg.moe_shared_expert:
        # The shared expert (DeepSeek-style) may be narrower than the dense
        # FFN (moe_shared_expert_size); plain dense models use f.
        fs = cfg.moe_shared_f if cfg.num_experts else f
        blocks["w_gate"] = nrm("w_gate", (L, d, fs), s_in)
        blocks["w_up"] = nrm("w_up", (L, d, fs), s_in)
        blocks["w_down"] = nrm("w_down", (L, fs, d), s_out)
    if cfg.num_experts:
        E, mf = cfg.num_experts, cfg.moe_f
        blocks["router"] = nrm("router", (L, d, E), s_in)
        blocks["moe_gate"] = nrm("moe_gate", (L, E, d, mf), s_in)
        blocks["moe_up"] = nrm("moe_up", (L, E, d, mf), s_in)
        blocks["moe_down"] = nrm("moe_down", (L, E, mf, d), s_out)
    params = {
        "embed": nrm("embed", (v, d), s_in, stacked=False),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm("lm_head", (d, v), s_in, stacked=False)
    return params


def layer_params(params: dict, l: int) -> dict:
    """Layer ``l``'s weights: a view of each stacked ``[L, ...]`` tensor, or
    the trainer's own dict when ``params["blocks"]`` is a list of per-layer
    dicts (``models/training.py`` keeps one leaf per layer and weight)."""
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        return blocks[l]
    return {k: w[l] for k, w in blocks.items()}


def lora_delta(x: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """Batched multi-LoRA: each row's adapter gathered, then two skinny
    products. x [B, T, d]; A [n, d, r]; B_ [n, r, o] with alpha/r folded in;
    ids [B] adapter slot per row (slot 0 is zeros: no adapter). Returns
    [B, T, o] in x's dtype."""
    mid = torch.bmm(x, A[ids].to(x.dtype))
    return torch.bmm(mid, B_[ids].to(x.dtype))


def _lora_proj(xa: torch.Tensor, w: torch.Tensor, name: str,
               lora: Optional[dict], lora_ids: Optional[torch.Tensor]):
    y = xa @ w
    if lora is not None and name in lora:
        A, B_ = lora[name]
        y = y + lora_delta(xa, A, B_, lora_ids)
    return y


def _qkv(cfg: ModelConfig, blk: dict, x: torch.Tensor, positions: torch.Tensor,
         lora: Optional[dict] = None, lora_ids: Optional[torch.Tensor] = None,
         par=None):
    """norm → projections (+ LoRA, + the Qwen2 attention biases when the
    tree has them) → RoPE. x [B, T, D] → q [B,T,H,hd], k/v [B,T,KV,hd];
    under tensor parallelism (``par``, ``parallel/sharding.py``) the
    rank's own heads, read off the weights' widths."""
    B, T, _ = x.shape
    hd = cfg.head_dim_
    xa = rms_norm(x, blk["attn_norm"], cfg.rms_norm_eps)
    if par is not None:
        xa = par.copy_tp(xa)
    q = _lora_proj(xa, blk["wq"], "wq", lora, lora_ids)
    k = _lora_proj(xa, blk["wk"], "wk", lora, lora_ids)
    v = _lora_proj(xa, blk["wv"], "wv", lora, lora_ids)
    if "bq" in blk:
        q = q + blk["bq"]
        k = k + blk["bk"]
        v = v + blk["bv"]
    q, k, v = (t.reshape(B, T, -1, hd) for t in (q, k, v))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _mla_qkv(cfg: ModelConfig, blk: dict, x: torch.Tensor,
             positions: torch.Tensor, lora: Optional[dict] = None,
             lora_ids: Optional[torch.Tensor] = None, par=None):
    """MLA pre-attention math in the absorbed form: norm → q projection
    (split nope/rope, W_uk absorbed into q) → latent down-projection
    (+ kv norm) and the shared RoPE key. LoRA applies to wq and w_dkv; the
    absorbed w_uk / w_uv are no targets. Returns (q_lat [B,T,H,dc],
    q_pe [B,T,H,dr], c [B,T,dc], k_pe [B,T,dr]); under tensor parallelism
    the rank's own heads, beside the replicated latent."""
    B, T, _ = x.shape
    dc, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    xa = rms_norm(x, blk["attn_norm"], cfg.rms_norm_eps)
    xq = xa if par is None else par.copy_tp(xa)
    q = _lora_proj(xq, blk["wq"], "wq", lora, lora_ids).reshape(B, T, -1, dn + dr)
    q_pe = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    # Absorb: q_lat·c == q_nope·(c @ W_uk); per-head K never materialises.
    q_lat = torch.einsum("bthn,chn->bthc", q[..., :dn],
                         blk["w_uk"].reshape(dc, -1, dn)).contiguous()
    kv = _lora_proj(xa, blk["w_dkv"], "w_dkv", lora, lora_ids)  # [B, T, dc + dr]
    c = rms_norm(kv[..., :dc], blk["kv_norm"], cfg.rms_norm_eps)
    # RoPE on a singleton head axis, as the reference does.
    k_pe = apply_rope(kv[..., None, dc:], positions, cfg.rope_theta)[:, :, 0]
    if par is not None:
        # The latent is replicated; each rank's heads read it.
        c, k_pe = par.copy_tp(c), par.copy_tp(k_pe)
    return q_lat, q_pe, c, k_pe


def _mla_out(cfg: ModelConfig, blk: dict, attn_lat: torch.Tensor) -> torch.Tensor:
    """Latent attention output [B,T,H,dc] → per-head values [B,T,H,dv]
    through W_uv."""
    dc, dv = cfg.kv_lora_rank, cfg.v_head_dim
    return torch.einsum("bthc,chv->bthv", attn_lat, blk["w_uv"].reshape(dc, -1, dv))


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _swiglu(blk: dict, xm: torch.Tensor, lora: Optional[dict],
            lora_ids: Optional[torch.Tensor], par) -> torch.Tensor:
    """The dense SwiGLU MLP (a MoE model's shared expert too); under tensor
    parallelism the rank's columns of w_gate / w_up and rows of w_down,
    summed over tp."""
    if par is not None:
        xm = par.copy_tp(xm)
    gate = F.silu(_lora_proj(xm, blk["w_gate"], "w_gate", lora, lora_ids))
    up = _lora_proj(xm, blk["w_up"], "w_up", lora, lora_ids)
    out = _lora_proj(gate * up, blk["w_down"], "w_down", lora, lora_ids)
    return out if par is None else par.reduce_tp(out)


def _mlp(cfg: ModelConfig, blk: dict, xm: torch.Tensor,
         lora: Optional[dict] = None,
         lora_ids: Optional[torch.Tensor] = None, par=None) -> torch.Tensor:
    if cfg.num_experts:
        return _moe_mlp(cfg, blk, xm, par)  # LoRA targets dense layers only
    return _swiglu(blk, xm, lora, lora_ids, par)


def _moe_mlp(cfg: ModelConfig, blk: dict, xm: torch.Tensor,
             par=None) -> torch.Tensor:
    """Top-k MoE in the reference's dense-dispatch form: every expert runs
    and is combined with its (mostly zero) routing weight. An expert is
    kept when its probability is >= the k-th largest, so ties may keep
    more than k, as in the reference. The combine is one
    [B·T, E·F] @ [E·F, D] product, never a [B, T, E, F, D] tensor. Under
    expert (and tensor) parallelism the router stays replicated, each rank
    runs its own experts (and columns) over every token, and the combine
    is summed over ep and tp."""
    B, T, D = xm.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax((xm @ blk["router"]).float(), dim=-1)      # [B, T, E]
    threshold = torch.topk(probs, K, dim=-1).values[..., -1:]        # k-th largest
    weights = torch.where(probs >= threshold, probs, 0.0)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    weights = weights.to(xm.dtype).reshape(B * T, E)
    x2 = xm.reshape(B * T, D)
    if par is not None:
        e0, n = par.experts(blk["moe_gate"].shape[0])
        weights = par.copy_moe(weights)[:, e0:e0 + n]
        x2 = par.copy_moe(x2)
    h = F.silu(torch.matmul(x2, blk["moe_gate"])) * torch.matmul(x2, blk["moe_up"])
    hw = (weights.T[:, :, None] * h).transpose(0, 1).reshape(B * T, -1)  # [BT, E·F]
    out = hw @ blk["moe_down"].reshape(-1, D)
    if par is not None:
        out = par.reduce_moe(out)
    out = out.reshape(B, T, D)
    if cfg.moe_shared_expert:
        out = out + _swiglu(blk, xm, None, None, par)
    return out


def _post_attention(cfg: ModelConfig, blk: dict, x: torch.Tensor,
                    attn: torch.Tensor, lora: Optional[dict] = None,
                    lora_ids: Optional[torch.Tensor] = None,
                    par=None) -> torch.Tensor:
    """residual → norm → MLP (or MoE) → residual."""
    B, T, _ = x.shape
    o = _lora_proj(attn.reshape(B, T, -1), blk["wo"], "wo", lora, lora_ids)
    x = x + (o if par is None else par.reduce_tp(o))
    return x + _mlp(cfg, blk, rms_norm(x, blk["mlp_norm"], cfg.rms_norm_eps),
                    lora, lora_ids, par)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           par=None) -> torch.Tensor:
    """Token embeddings in cfg's dtype; under tensor parallelism the
    vocab-parallel lookup."""
    if par is not None:
        return par.embed(params["embed"], tokens).to(cfg.torch_dtype)
    return params["embed"][tokens.long()].to(cfg.torch_dtype)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor,
          par=None) -> torch.Tensor:
    """final norm + (tied) LM head, float32 logits; under tensor
    parallelism the rank's vocab columns, gathered over tp."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if par is None:
        return (x @ head.to(cfg.torch_dtype)).float()
    return par.gather_vocab((par.copy_tp(x) @ head.to(cfg.torch_dtype)).float())


def _layer_view(pool: Optional[torch.Tensor], l: int) -> Optional[torch.Tensor]:
    return None if pool is None else pool[l]


def _layer_lora(lora: Optional[dict], l: int) -> Optional[dict]:
    return None if lora is None else {k: (A[l], B_[l]) for k, (A, B_) in lora.items()}


def _paged_layer(params: dict, cfg: ModelConfig, l: int, x: torch.Tensor,
                 positions: torch.Tensor, apos: torch.Tensor,
                 token_mask: torch.Tensor, kv_lens: torch.Tensor,
                 page_table: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, use_kernels: str,
                 k_scales: Optional[torch.Tensor], v_scales: Optional[torch.Tensor],
                 lora: Optional[dict], lora_ids: Optional[torch.Tensor],
                 par=None) -> torch.Tensor:
    """Layer ``l`` of the paged forward: write this step's K/V into layer
    l's pages in place, attend over them (``apos``: the attention's
    positions, -1 for a T > 1 block's pads), then the MLP. ``forward_paged``
    and ``forward_paged_window`` are chains of this one body. Under tensor
    parallelism (``par``) the pools hold this rank's KV heads (an MLA
    model's latent pool is whole) and the attention runs its own heads."""
    blk = layer_params(params, l)
    lr = _layer_lora(lora, l)
    ks, vs = _layer_view(k_scales, l), _layer_view(v_scales, l)
    if cfg.mla:
        q_lat, q_pe, c, k_pe = _mla_qkv(cfg, blk, x, positions, lr, lora_ids, par)
        write_kv_pages(k_pages[l], v_pages[l], c[:, :, None], k_pe[:, :, None],
                       page_table, positions, token_mask, ks, vs)
        attn = _mla_out(cfg, blk, paged_mla_attention(
            q_lat, q_pe, k_pages[l], v_pages[l], page_table, apos,
            kv_lens, _mla_scale(cfg), use_kernels=use_kernels, c_scales=ks,
            pe_scales=vs))
    else:
        q, k, v = _qkv(cfg, blk, x, positions, lr, lora_ids, par)
        write_kv_pages(k_pages[l], v_pages[l], k, v, page_table, positions,
                       token_mask, ks, vs)
        attn = paged_attention(q, k_pages[l], v_pages[l], page_table,
                               apos, kv_lens, use_kernels=use_kernels,
                               k_scales=ks, v_scales=vs)
    return _post_attention(cfg, blk, x, attn, lr, lora_ids, par)


def _attention_positions(tokens_or_x: torch.Tensor, positions: torch.Tensor,
                         token_mask: torch.Tensor) -> torch.Tensor:
    """Positions the attention sees: a T > 1 block's pads at -1, so they
    attend nothing; RoPE and the writes keep the given positions."""
    if tokens_or_x.shape[1] > 1:
        return torch.where(token_mask, positions, torch.full_like(positions, -1))
    return positions


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
    v_pages: torch.Tensor,      #   (int8 when quantized; MLA: latent pools)
    use_kernels: str = "auto",
    k_scales: Optional[torch.Tensor] = None,  # [L, NP, page, KV, 1] (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,    # {target: (A [L, n, d, r], B [L, n, r, o])},
                                    # alpha/r folded into B; slot 0 is zeros
    lora_ids: Optional[torch.Tensor] = None,  # [B] adapter slot per row
    par=None,                   # ModelParallel: this rank's heads (tp / ep)
) -> torch.Tensor:
    """Serving forward over the paged pool: decode steps (T == 1) and
    [B, T] blocks of prefill chunks or speculative verifies (T > 1). On
    CUDA its attention is a decode kernel at T == 1 (A, C for int8 pools,
    E, G for MLA) and a ragged kernel at T > 1 (B, D, F, H), the block
    seen as a pack of B rows. Pads (token_mask False) reach a T > 1
    attention at position -1, so they attend nothing; RoPE and the writes
    keep the given positions. Writes this step's K/V into the pools in
    place; returns logits [B, T, V] f32 (under ``par``, the whole vocab on
    every rank)."""
    x = _embed(params, cfg, tokens, par)
    apos = _attention_positions(tokens, positions, token_mask)
    for l in range(cfg.num_layers):
        x = _paged_layer(params, cfg, l, x, positions, apos, token_mask,
                         kv_lens, page_table, k_pages, v_pages, use_kernels,
                         k_scales, v_scales, lora, lora_ids, par)
    return _head(params, cfg, x, par)


@torch.no_grad()
def forward_paged_window(
    params: dict,
    cfg: ModelConfig,
    layer_lo: int,              # first layer of the window
    layer_hi: int,              # one past the last layer
    x: torch.Tensor,            # [B, T, D] hidden states ENTERING layer_lo
    positions: torch.Tensor,    # [B, T] int32 absolute positions
    token_mask: torch.Tensor,   # [B, T] bool, real (non-pad) tokens
    kv_lens: torch.Tensor,      # [B] int32, cache length AFTER this step
    page_table: torch.Tensor,   # [B, P] int32 physical page ids
    k_pages: torch.Tensor,      # [L, NP, page, KV, hd], the FULL pool
    v_pages: torch.Tensor,
    use_kernels: str = "auto",
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    par=None,
) -> torch.Tensor:
    """One LAYER WINDOW of ``forward_paged``: layers ``[layer_lo,
    layer_hi)`` over hidden states, writing and attending only those
    layers' pages, in place. The layer-sliced decode admission
    (``engine/pd.py``) chains these windows so a row's first decode step
    starts as soon as its leading layers' KV has landed; the caller embeds
    the tokens before window 0 and applies ``_head`` after the last.

    Each layer is ``forward_paged``'s own body (``_paged_layer``), so a
    chain over every layer is ``forward_paged``'s arithmetic. On CUDA the
    attention at T == 1 is kernel A (C, E or G by pool and model). Returns
    the hidden states leaving layer ``layer_hi - 1``."""
    apos = _attention_positions(x, positions, token_mask)
    for l in range(layer_lo, layer_hi):
        x = _paged_layer(params, cfg, l, x, positions, apos, token_mask,
                         kv_lens, page_table, k_pages, v_pages, use_kernels,
                         k_scales, v_scales, None, None, par)
    return x


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
    v_pages: torch.Tensor,      #   (int8 when quantized; MLA: latent pools)
    use_kernels: str = "auto",
    max_q_len: Optional[int] = None,  # bound on a row's query count
                                      # (the engine's prefill_chunk)
    k_scales: Optional[torch.Tensor] = None,  # [L, NP, page, KV, 1] (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
    par=None,                   # ModelParallel: this rank's heads (tp / ep)
) -> torch.Tensor:
    """Serving forward over a ragged pack of prefill chunks and decode
    steps in one dispatch (on CUDA: kernel B, D for int8 pools, F for
    MLA). Writes K/V into the pools in place; returns logits [1, T, V]
    f32."""
    x = _embed(params, cfg, tokens, par)
    for l in range(cfg.num_layers):
        blk = layer_params(params, l)
        ks, vs = _layer_view(k_scales, l), _layer_view(v_scales, l)
        if cfg.mla:
            q_lat, q_pe, c, k_pe = _mla_qkv(cfg, blk, x, positions, par=par)
            write_kv_pages_ragged(k_pages[l], v_pages[l], c[:, :, None],
                                  k_pe[:, :, None], page_table, row_ids,
                                  positions, token_mask, ks, vs)
            attn = _mla_out(cfg, blk, ragged_paged_mla_attention(
                q_lat, q_pe, k_pages[l], v_pages[l], page_table, positions,
                kv_lens, row_ids, _mla_scale(cfg), use_kernels=use_kernels,
                c_scales=ks, pe_scales=vs, max_q_len=max_q_len))
        else:
            q, k, v = _qkv(cfg, blk, x, positions, par=par)
            write_kv_pages_ragged(k_pages[l], v_pages[l], k, v, page_table,
                                  row_ids, positions, token_mask, ks, vs)
            attn = ragged_paged_attention(q, k_pages[l], v_pages[l], page_table,
                                          positions, kv_lens, row_ids,
                                          use_kernels=use_kernels,
                                          max_q_len=max_q_len, k_scales=ks,
                                          v_scales=vs)
        x = _post_attention(cfg, blk, x, attn, par=par)
    return _head(params, cfg, x, par)


def seq_range(mesh, T: int) -> Tuple[int, int]:
    """The positions ``[lo, hi)`` of a ``[B, T]`` sequence whose hidden
    states this rank computes: its own ``T / sp`` shard when the mesh's
    ``sp`` axis is > 1 and divides T (ring attention), else all of them."""
    if mesh is None:
        return 0, T
    from rbg_tpu_torch.parallel.mesh import axis_rank, axis_size
    sp = axis_size(mesh, "sp")
    if sp == 1 or T % sp:
        return 0, T
    s = axis_rank(mesh, "sp")
    return s * (T // sp), (s + 1) * (T // sp)


def _train_block(cfg: ModelConfig, blk: dict, h: torch.Tensor,
                 positions: torch.Tensor, token_mask: torch.Tensor,
                 par=None) -> torch.Tensor:
    """One cache-free causal block: attention over the current tokens only
    (``gqa_attention``, or ``mla_attention`` on the latents), then the
    MLP. Writes nothing in place, so autograd runs through it."""
    if cfg.mla:
        q_lat, q_pe, c, k_pe = _mla_qkv(cfg, blk, h, positions, par=par)
        attn = _mla_out(cfg, blk, mla_attention(
            q_lat, q_pe, c, k_pe, positions, token_mask, _mla_scale(cfg)))
    else:
        q, k, v = _qkv(cfg, blk, h, positions, par=par)
        attn = gqa_attention(q, k, v, positions, token_mask)
    return _post_attention(cfg, blk, h, attn, par=par)


def _encode_core(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 token_mask: Optional[torch.Tensor], mesh=None,
                 remat: bool = False, final_norm: bool = True) -> torch.Tensor:
    """The reference's cache-free causal body, shared by training and the
    embeddings path: embed, every block attending over the current tokens
    only (``_train_block``), and the final norm unless ``final_norm`` is
    False (``forward_train`` feeds ``_head``, which norms). ``remat``
    recomputes each block's activations in the backward
    (``torch.utils.checkpoint``). With a ``DeviceMesh`` (``parallel/``)
    the params are this rank's shards: tp and ep run the Megatron
    collectives, and an ``sp`` axis > 1 that divides T runs ring attention
    over this rank's positions ``seq_range(mesh, T)``, pad K/V slots at
    position 1 << 30 so no query sees them. Returns hidden states
    [B, hi - lo, D]."""
    B, T = tokens.shape
    dev = tokens.device
    if token_mask is None:
        token_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    par = None
    if mesh is not None:
        from rbg_tpu_torch.parallel.sharding import ModelParallel
        par = ModelParallel.of(mesh)
    lo, hi = seq_range(mesh, T)
    if hi - lo < T:
        if cfg.mla:
            raise NotImplementedError("ring attention covers GQA models; an "
                                      "MLA model trains with sp = 1")
        from rbg_tpu_torch.parallel.ring import ring_attention
        kv_positions = torch.where(token_mask, positions,
                                   torch.full_like(positions, 1 << 30))[:, lo:hi]

        def body(h, blk):
            q, k, v = _qkv(cfg, blk, h, positions[:, lo:hi], par=par)
            attn = ring_attention(q, k, v, positions[:, lo:hi], kv_positions, mesh)
            return _post_attention(cfg, blk, h, attn, par=par)
    else:
        def body(h, blk):
            return _train_block(cfg, blk, h, positions, token_mask, par)

    x = _embed(params, cfg, tokens[:, lo:hi], par)
    for l in range(cfg.num_layers):
        blk = layer_params(params, l)
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x, blk, use_reentrant=False)
        else:
            x = body(x, blk)
    if final_norm:
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x


def forward_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  token_mask: Optional[torch.Tensor] = None, mesh=None,
                  remat: bool = False) -> torch.Tensor:
    """Cache-free causal forward for training, with autograd: ``tokens``
    [B, T] int, ``token_mask`` [B, T] bool (real tokens). Returns logits
    [B, T, V] float32 (with an sp mesh: this rank's positions
    ``seq_range(mesh, T)``). ``remat=True`` recomputes each block in the
    backward, trading FLOPs for memory; ``mesh`` as in ``_encode_core``."""
    par = None
    if mesh is not None:
        from rbg_tpu_torch.parallel.sharding import ModelParallel
        par = ModelParallel.of(mesh)
    return _head(params, cfg, _encode_core(params, cfg, tokens, token_mask, mesh,
                                           remat, final_norm=False), par)


@torch.no_grad()
def encode_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  token_mask: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """Final-norm hidden states [B, T, D] of a cache-free causal forward (no
    LM head): what the embeddings path pools. ``tokens`` [B, T] int,
    ``token_mask`` [B, T] bool (real tokens; pads after them). With a
    ``mesh`` the params are this rank's shards (``_encode_core``); a ring
    over sp gives each rank its positions, gathered here, so every rank
    returns the whole sequence."""
    h = _encode_core(params, cfg, tokens, token_mask, mesh)
    if h.shape[1] == tokens.shape[1]:
        return h
    from rbg_tpu_torch.parallel.mesh import axis_group, axis_size
    parts = [torch.empty_like(h) for _ in range(axis_size(mesh, "sp"))]
    torch.distributed.all_gather(parts, h.contiguous(), group=axis_group(mesh, "sp"))
    return torch.cat(parts, dim=1)


def _block(cfg: ModelConfig, blk: dict, x: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, positions: torch.Tensor,
           write_pos: torch.Tensor, kv_valid: torch.Tensor) -> torch.Tensor:
    """One block over one layer of the contiguous cache ``[B, S, KV, d]``:
    this step's K/V (MLA: latent and RoPE key) written in place at
    ``write_pos`` (S for a pad: dropped), then dense attention."""
    B, S = k_cache.shape[:2]
    keep = write_pos < S
    b_idx = torch.arange(B, device=x.device)[:, None].expand_as(write_pos)[keep]
    slot = write_pos.long()[keep]
    if cfg.mla:
        q_lat, q_pe, c, k_pe = _mla_qkv(cfg, blk, x, positions)
        k_cache[b_idx, slot] = c[keep][:, None].to(k_cache.dtype)
        v_cache[b_idx, slot] = k_pe[keep][:, None].to(v_cache.dtype)
        attn = _mla_out(cfg, blk, mla_attention(
            q_lat, q_pe, k_cache[:, :, 0], v_cache[:, :, 0], positions, kv_valid,
            _mla_scale(cfg)))
    else:
        q, k, v = _qkv(cfg, blk, x, positions)
        k_cache[b_idx, slot] = k[keep].to(k_cache.dtype)
        v_cache[b_idx, slot] = v[keep].to(v_cache.dtype)
        attn = gqa_attention(q, k_cache, v_cache, positions, kv_valid)
    return _post_attention(cfg, blk, x, attn)


@torch.no_grad()
def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: KVCache,
            positions: Optional[torch.Tensor] = None,
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """The decoder over ``tokens`` [B, T], reading and writing the
    contiguous ``cache`` in place (prefill at length 0 and decode at T = 1
    alike). Positions default to ``length + arange(T)``; pads
    (``token_mask`` False) write nothing. Returns (logits [B, T, V] f32,
    the cache with its new length)."""
    B, T = tokens.shape
    S = cache.k.shape[2]
    if T > S:
        raise ValueError(f"token block T={T} exceeds KV cache capacity S={S}")
    dev = tokens.device
    if positions is None:
        positions = (cache.length[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None])
    if token_mask is None:
        token_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    filled = torch.where(token_mask, positions + 1, 0).amax(dim=1).to(torch.int32)
    length = torch.maximum(cache.length, filled)
    kv_valid = torch.arange(S, dtype=torch.int32, device=dev)[None] < length[:, None]
    write_pos = torch.where(token_mask, positions, S)
    x = _embed(params, cfg, tokens)
    for l in range(cfg.num_layers):
        x = _block(cfg, layer_params(params, l), x, cache.k[l], cache.v[l],
                   positions, write_pos, kv_valid)
    return _head(params, cfg, x), KVCache(cache.k, cache.v, length)


@torch.no_grad()
def prefill_and_decode_greedy(params: dict, cfg: ModelConfig, prompt: torch.Tensor,
                              steps: int) -> torch.Tensor:
    """The reference's plain loop: prefill ``prompt`` [B, T] into a
    contiguous cache, then greedy-decode ``steps`` tokens. Returns
    [B, steps]."""
    B, T = prompt.shape
    cache = KVCache.create(cfg, B, T + steps, device=prompt.device)
    logits, cache = forward(params, cfg, prompt, cache)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = forward(params, cfg, tok, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
