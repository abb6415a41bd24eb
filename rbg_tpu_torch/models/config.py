"""Model configurations for the llama-family decoder (a copy of
``rbg_tpu/models/config.py`` with ``torch_dtype`` in place of ``jax_dtype``).

The serving path of this package runs every preset: dense GQA, MoE and
MLA (deepseek-v2-lite is the MLA + MoE preset that fits on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of a llama-family (pre-norm, RoPE, GQA, SwiGLU) decoder."""

    name: str = "tiny"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    num_experts: int = 0
    experts_per_token: int = 2
    moe_intermediate_size: int = 0
    moe_shared_expert: bool = False
    moe_shared_expert_size: int = 0
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def moe_f(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def moe_shared_f(self) -> int:
        return self.moe_shared_expert_size or self.intermediate_size

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hd = self.head_dim_
        if self.mla:
            h, dc = self.num_heads, self.kv_lora_rank
            dn, dr, dv = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                          self.v_head_dim)
            attn = (d * h * (dn + dr) + d * (dc + dr) + dc + dc * h * dn
                    + dc * h * dv + h * dv * d)
        else:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.num_experts:
            mlp = self.num_experts * 3 * d * self.moe_f + d * self.num_experts
            if self.moe_shared_expert:
                mlp += 3 * d * self.moe_shared_f
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        head = 0 if self.tie_word_embeddings else d * v
        return v * d + self.num_layers * per_layer + d + head


_PRESETS = {
    "tiny": ModelConfig(
        name="tiny", vocab_size=256, hidden_size=128, intermediate_size=384,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
        rope_theta=10000.0, dtype="float32",
    ),
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b", vocab_size=151936, hidden_size=896,
        intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
        head_dim=64, max_seq_len=32768, rope_theta=1000000.0,
        tie_word_embeddings=True,
    ),
    "llama3-1b": ModelConfig(
        name="llama3-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        max_seq_len=131072, rope_theta=500000.0, tie_word_embeddings=True,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_seq_len=131072, rope_theta=500000.0,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
        max_seq_len=131072, rope_theta=500000.0,
    ),
    "tiny-moe": ModelConfig(
        name="tiny-moe", vocab_size=256, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
        rope_theta=10000.0, dtype="float32",
        num_experts=4, experts_per_token=2, moe_intermediate_size=96,
        moe_shared_expert=True,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_seq_len=32768, rope_theta=1000000.0,
        num_experts=8, experts_per_token=2,
    ),
    "deepseek-v2-lite": ModelConfig(
        name="deepseek-v2-lite", vocab_size=102400, hidden_size=2048,
        intermediate_size=10944, num_layers=27, num_heads=16, num_kv_heads=16,
        max_seq_len=163840, rope_theta=10000.0,
        num_experts=64, experts_per_token=6, moe_intermediate_size=1408,
        moe_shared_expert=True, moe_shared_expert_size=2816,
        mla=True, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128,
    ),
    "deepseek-v3": ModelConfig(
        name="deepseek-v3", vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, num_layers=61, num_heads=128,
        num_kv_heads=128, max_seq_len=163840, rope_theta=10000.0,
        num_experts=256, experts_per_token=8, moe_intermediate_size=2048,
        moe_shared_expert=True, moe_shared_expert_size=2048,
        mla=True, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128,
    ),
    "tiny-mla": ModelConfig(
        name="tiny-mla", vocab_size=256, hidden_size=128,
        intermediate_size=384, num_layers=2, num_heads=4, num_kv_heads=4,
        max_seq_len=256, rope_theta=10000.0, dtype="float32",
        mla=True, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32,
    ),
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(_PRESETS)}")
    cfg = _PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_presets():
    return sorted(_PRESETS)
