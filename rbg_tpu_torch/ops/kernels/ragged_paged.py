"""Wrapper of the block-ragged paged attention kernel
(``csrc/ragged_paged.cu``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_attention_pallas``. Its plain PyTorch version is
``ops/ragged_paged_attention.py::ragged_paged_attention_plain``."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_decode import MAX_GROUP, MAX_HEAD_DIM

Q_TILE = 8              # packed tokens per block (kTile in the source)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P)


def ragged_paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, page_table: torch.Tensor,
                                q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                row_ids: torch.Tensor) -> torch.Tensor:
    """q [1, T, H, hd] packed; pools [NP, page, KV, hd] in q's dtype;
    page_table [R, P], q_positions [1, T], kv_lens [R], row_ids [T], all
    int32. Returns [1, T, H, hd] in q's dtype."""
    one, T, H, hd = q.shape
    NP, page, KV, hd_k = k_pages.shape
    if one != 1 or v_pages.shape != k_pages.shape or hd_k != hd or H % KV:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    G = H // KV
    if G > MAX_GROUP or hd > MAX_HEAD_DIM or hd % (16 // q.element_size()):
        raise ValueError(f"ragged_paged takes G <= {MAX_GROUP} and hd <= "
                         f"{MAX_HEAD_DIM} a multiple of 16 bytes; got G={G} hd={hd}")
    R = page_table.shape[0]
    if (page_table.dim() != 2 or kv_lens.shape != (R,)
            or q_positions.shape != (1, T) or row_ids.shape != (T,)):
        raise ValueError("page_table [R, P], kv_lens [R], q_positions [1, T] "
                         "and row_ids [T] expected")
    check_tensors(q, pools=(k_pages, v_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions))
    code = dtype_code(q, k_pages, v_pages)
    out = torch.empty_like(q)
    fn = load_function("ragged_paged", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), row_ids.data_ptr(),
                q_positions.data_ptr(), out.data_ptr(), T, R, KV, G, hd, page,
                page_table.shape[1], hd ** -0.5, code,
                torch.cuda.current_stream(q.device).cuda_stream)
    check("ragged_paged", rc)
    if T:
        LAUNCHES["ragged_paged"] += 1
    return out
