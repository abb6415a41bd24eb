"""Paged KV cache: device page pool + host page allocator
(``rbg_tpu/engine/kvcache.py``).

* Device: ``k_pages/v_pages [L, num_pages, page_size, KV, hd]`` — one pool
  shared by every sequence; the model writes it in place. An int8 pool
  keeps per-(slot, head) absmax scales beside it (``[L, NP, page, KV, 1]``
  float32). An MLA model's pool is latent: the "k" pool holds the latent
  ``c`` (``[L, NP, page, 1, kv_lora_rank]``), the "v" pool the shared RoPE
  key (``[L, NP, page, 1, qk_rope_head_dim]``).
* Host: ``PageAllocator`` free list with reference counts (radix-shared
  prefix pages hold more than one), and per-sequence page tables as plain
  ints.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from rbg_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int = 16,
               device=None, quantize: bool = False) -> "PagedKVCache":
        """Zeroed pools of the four kinds: GQA or MLA, each in the model's
        dtype or int8 with float32 scales."""
        if cfg.mla:
            kshape = (cfg.num_layers, num_pages, page_size, 1, cfg.kv_lora_rank)
            vshape = kshape[:-1] + (cfg.qk_rope_head_dim,)
        else:
            kshape = vshape = (cfg.num_layers, num_pages, page_size,
                               cfg.num_kv_heads, cfg.head_dim_)
        dt = torch.int8 if quantize else cfg.torch_dtype
        cache = PagedKVCache(k_pages=torch.zeros(kshape, dtype=dt, device=device),
                             v_pages=torch.zeros(vshape, dtype=dt, device=device))
        if quantize:
            sshape = kshape[:-1] + (1,)
            cache.k_scales = torch.zeros(sshape, dtype=torch.float32, device=device)
            cache.v_scales = torch.zeros(sshape, dtype=torch.float32, device=device)
        return cache

    @staticmethod
    def hbm_bytes(cfg: ModelConfig, num_pages: int, page_size: int = 16,
                  dtype_bytes: int = 2) -> int:
        """Device bytes of the pages (scales not counted), as the reference
        counts them."""
        if cfg.mla:
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            return cfg.num_layers * num_pages * page_size * per_tok * dtype_bytes
        return (2 * cfg.num_layers * num_pages * page_size
                * cfg.num_kv_heads * cfg.head_dim_ * dtype_bytes)


class PageAllocator:
    """Host-side page free list with reference counting (shared prefix pages
    from the radix cache hold refcount > 1; only fully-frozen pages are
    shared, so no copy-on-write)."""

    def __init__(self, num_pages: int):
        # Page 0 is the reserved null page: padding rows of page tables
        # point at it (their slots are masked), and pad-token KV writes
        # land on it without changing it.
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros(num_pages, np.int32)
        self._refs[0] = 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate n pages or None (caller evicts/preempts and retries)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def share(self, pages: List[int]) -> None:
        for p in pages:
            assert self._refs[p] > 0, f"share of free page {p}"
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
            assert self._refs[p] >= 0, f"double free of page {p}"

    def refcount(self, p: int) -> int:
        """Current reference count of one page (the host-tier spill hook
        reads it: a page another holder still pins must not spill — it
        stays device-resident)."""
        return int(self._refs[p])


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    return (n_tokens + page_size - 1) // page_size
