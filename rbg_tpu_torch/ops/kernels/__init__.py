"""Hand-written CUDA kernels (``rbg_tpu_torch/csrc``) and their wrappers.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run that
must show the serving path went through the kernels sets the counts to 0
with ``reset_launches()`` and reads them afterwards.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "ragged_paged": 0,
                            "paged_decode_q": 0, "ragged_paged_q": 0,
                            "paged_mla_decode": 0, "ragged_paged_mla": 0,
                            "paged_mla_decode_q": 0, "ragged_paged_mla_q": 0,
                            "ragged_paged_tokengrid": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dtype_code(q: torch.Tensor, *pools: torch.Tensor,
               pool_dtype: Optional[torch.dtype] = None) -> int:
    """The kernels' dtype code of q (and of the output). The pools share
    q's dtype, or are all ``pool_dtype`` when one is given (int8 pools)."""
    want = q.dtype if pool_dtype is None else pool_dtype
    if q.dtype not in _DTYPE_CODES or any(t.dtype != want for t in pools):
        raise TypeError(f"kernel takes q in one of {sorted(map(str, _DTYPE_CODES))} "
                        f"and pools in {'q' if pool_dtype is None else pool_dtype}'s "
                        f"dtype; got q {q.dtype}, pools {[str(t.dtype) for t in pools]}")
    return _DTYPE_CODES[q.dtype]


def check_tensors(q: torch.Tensor, pools=(), int32=(), others=()) -> None:
    """Every tensor on q's CUDA device and contiguous; ``int32`` ones int32;
    the pools 16-byte aligned for the kernels' vector loads. (Device
    indices, not ``Tensor.device`` objects: this runs before every launch.)"""
    dev = q.get_device()
    if dev < 0:
        raise ValueError(f"CUDA kernel needs CUDA tensors; got {q.device}")
    for t in (q, *pools, *int32, *others):
        if t.get_device() != dev:
            raise ValueError(f"kernel inputs must share {q.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in int32:
        if t.dtype != torch.int32:
            raise TypeError(f"page tables, lengths and ids must be int32, got {t.dtype}")
    for t in pools:
        if t.data_ptr() % 16:
            raise ValueError("KV pools must be 16-byte aligned")


# The int32 counts of the kernels that merge split walks on the card (A-I):
# slot 0 is the ragged kernels' (B, D, F, H) work queue head, slots 1 and 2
# the last launch's work items and grid blocks, the rest each split walk's
# finished-split count.
_ITEMS, _GRID = 1, 2

# Their scratch per (device index, stream), grown as needed: (float32
# partials, int32 counts). The kernels' atomicInc wraps the queue head and
# every split count back to 0 at its last use in a launch, so the counts
# are zeroed once, when made, and launches on one stream reuse both buffers
# in order.
_SCRATCH: dict = {}


def scratch(q: torch.Tensor, stream: int, n_part: int, n_counts: int):
    """The merging kernels' scratch on q's device and ``stream``: at least
    ``n_part`` float32 partials and ``n_counts`` int32 counts."""
    key = (q.get_device(), stream)
    part, counts = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    if counts is None or counts.numel() < n_counts:
        counts = torch.zeros(max(n_counts, 4096), dtype=torch.int32, device=q.device)
    _SCRATCH[key] = part, counts
    return part, counts


def launch_report(device: torch.device) -> dict:
    """What the last launch of A-I on ``device``'s current stream derived,
    as the kernel wrote it: ``work_items`` (the items it ran) and
    ``grid_blocks``. Waits for the stream."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    counts = _SCRATCH[(idx, torch.cuda.current_stream(idx).cuda_stream)][1]
    items, grid = counts[_ITEMS:_GRID + 1].tolist()
    return {"work_items": items, "grid_blocks": grid}


def check_scales(k_pages: torch.Tensor, k_scales: torch.Tensor,
                 v_scales: torch.Tensor) -> None:
    """int8 pools' scales: float32 [NP, page, KV, 1], one per (slot, kv
    head). For MLA latent pools ``k_pages`` is the latent pool c
    [NP, page, 1, dc], and c and pe each have float32 [NP, page, 1, 1]."""
    want = tuple(k_pages.shape[:-1]) + (1,)
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or tuple(s.shape) != want:
            raise ValueError(f"scales must be float32 {want}; got {s.dtype} "
                             f"{tuple(s.shape)}")
