"""Paged KV cache: device page pool + host page allocator
(``rbg_tpu/engine/kvcache.py``, model-dtype pools).

* Device: ``k_pages/v_pages [L, num_pages, page_size, KV, hd]`` — one pool
  shared by every sequence; the model writes it in place.
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

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int = 16,
               device=None) -> "PagedKVCache":
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim_)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            v_pages=torch.zeros(shape, dtype=cfg.torch_dtype, device=device))


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


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    return (n_tokens + page_size - 1) // page_size
