"""Wrapper of the int8-pool block-ragged paged attention kernel
(``csrc/ragged_paged_q.cu``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_attention_pallas_q``. Its plain PyTorch version is
``ops/ragged_paged_attention.py::ragged_paged_attention_plain`` with
scales."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import (LAUNCHES, check_scales, check_tensors,
                                       dtype_code)
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.ragged_paged import (check_pack, check_ragged_shapes,
                                                    scratch)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, ctypes.c_float, _I, _P)


def ragged_paged_attention_q_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor, k_scales: torch.Tensor,
                                  v_scales: torch.Tensor, page_table: torch.Tensor,
                                  q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                  row_ids: torch.Tensor) -> torch.Tensor:
    """q [1, T, H, hd] packed, float32 or bfloat16; pools [NP, page, KV, hd]
    int8; scales [NP, page, KV, 1] float32; page_table [R, P], q_positions
    [1, T], kv_lens [R], row_ids [T], all int32. Returns [1, T, H, hd] in
    q's dtype. Shape limits: ``ragged_paged.check_ragged_shapes``."""
    KV, G, hd, page = check_ragged_shapes("ragged_paged_q", q, k_pages, v_pages,
                                          page_table)
    T, R = check_pack(q, page_table, q_positions, kv_lens, row_ids)
    check_scales(k_pages, k_scales, v_scales)
    check_tensors(q, pools=(k_pages, v_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions),
                  others=(k_scales, v_scales))
    code = dtype_code(q, k_pages, v_pages, pool_dtype=torch.int8)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counts = scratch(q, stream, R, KV, G, hd)
    fn = load_function("ragged_paged_q", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), page_table.data_ptr(),
                kv_lens.data_ptr(), row_ids.data_ptr(), q_positions.data_ptr(),
                out.data_ptr(), part.data_ptr(), counts.data_ptr(), T, R, KV, G, hd,
                page, page_table.shape[1], hd ** -0.5, code, stream)
    check("ragged_paged_q", rc)
    if T:
        LAUNCHES["ragged_paged_q"] += 1
    return out
