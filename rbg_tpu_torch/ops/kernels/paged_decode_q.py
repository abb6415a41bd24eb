"""Wrapper of the int8-pool paged decode attention kernel
(``csrc/paged_decode_q.cu``), the port of
``rbg_tpu/ops/pallas/paged_attention_kernel.py`` ``paged_attention_pallas_q``.
Its plain PyTorch version is ``ops/paged_attention.py::paged_attention_plain``
with scales."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import (LAUNCHES, check_scales, check_tensors,
                                       dtype_code)
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_decode import check_decode

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P)


def paged_decode_attention_q(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, k_scales: torch.Tensor,
                             v_scales: torch.Tensor, page_table: torch.Tensor,
                             kv_lens: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, hd] float32 or bfloat16; pools [NP, page, KV, hd] int8;
    scales [NP, page, KV, 1] float32; page_table [B, P] int32; kv_lens [B]
    int32. Returns [B, 1, H, hd] in q's dtype."""
    B, KV, G, hd, page = check_decode("paged_decode_q", q, k_pages, v_pages,
                                      page_table, kv_lens)
    check_scales(k_pages, k_scales, v_scales)
    check_tensors(q, others=(k_scales, v_scales))
    code = dtype_code(q, k_pages, v_pages, pool_dtype=torch.int8)
    out = torch.empty_like(q)
    fn = load_function("paged_decode_q", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), page_table.data_ptr(),
                kv_lens.data_ptr(), out.data_ptr(), B, KV, G, hd, page,
                page_table.shape[1], hd ** -0.5, code,
                torch.cuda.current_stream(q.device).cuda_stream)
    check("paged_decode_q", rc)
    if B:
        LAUNCHES["paged_decode_q"] += 1
    return out
