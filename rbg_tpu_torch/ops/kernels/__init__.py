"""Hand-written CUDA kernels (``rbg_tpu_torch/csrc``) and their wrappers.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run that
must show the serving path went through the kernels sets the counts to 0
with ``reset_launches()`` and reads them afterwards.
"""

from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "ragged_paged": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernels' dtype code; every tensor must share one dtype."""
    dt = tensors[0].dtype
    if any(t.dtype != dt for t in tensors) or dt not in _DTYPE_CODES:
        raise TypeError("kernel takes q and both pools in one dtype of "
                        f"{sorted(map(str, _DTYPE_CODES))}; got "
                        f"{[str(t.dtype) for t in tensors]}")
    return _DTYPE_CODES[dt]


def check_tensors(q: torch.Tensor, pools=(), int32=()) -> None:
    """Every tensor on q's CUDA device and contiguous; ``int32`` ones int32;
    the pools 16-byte aligned for the kernels' vector loads."""
    if not q.is_cuda:
        raise ValueError(f"CUDA kernel needs CUDA tensors; got {q.device}")
    for t in (q, *pools, *int32):
        if t.device != q.device:
            raise ValueError(f"kernel inputs must share {q.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in int32:
        if t.dtype != torch.int32:
            raise TypeError(f"page tables, lengths and ids must be int32, got {t.dtype}")
    for t in pools:
        if t.data_ptr() % 16:
            raise ValueError("KV pools must be 16-byte aligned")
