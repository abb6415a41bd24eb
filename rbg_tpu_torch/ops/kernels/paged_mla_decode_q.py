"""Wrapper of the int8-latent-pool MLA decode kernel
(``csrc/paged_mla_decode_q.cu``), the port of
``rbg_tpu/ops/pallas/paged_attention_kernel.py``
``paged_mla_attention_pallas_q``. Its plain PyTorch version is
``ops/mla_attention.py::paged_mla_attention_plain`` with scales."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import (LAUNCHES, check_scales, check_tensors,
                                       dtype_code)
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_mla_decode import check_mla_shapes, head_group

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P)


def paged_mla_decode_attention_q(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                 c_pages: torch.Tensor, pe_pages: torch.Tensor,
                                 c_scales: torch.Tensor, pe_scales: torch.Tensor,
                                 page_table: torch.Tensor, kv_lens: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q_lat [B, 1, H, dc], q_pe [B, 1, H, dr] float32 or bfloat16; pools c
    [NP, page, 1, dc], pe [NP, page, 1, dr] int8 with float32 scales
    [NP, page, 1, 1] each; page_table [B, P] int32; kv_lens [B] int32;
    ``scale`` the softmax scale. Returns the latent output [B, 1, H, dc] in
    q's dtype; each block holds ``head_group(H, 1, ...)`` heads."""
    B, T = q_lat.shape[:2]
    if T != 1:
        raise ValueError(f"paged_mla_decode_q takes decode steps (T == 1), got T={T}")
    H, dc, dr, page = check_mla_shapes("paged_mla_decode_q", q_lat, q_pe, c_pages,
                                       pe_pages)
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and kv_lens [B]")
    check_scales(c_pages, c_scales, pe_scales)
    hg = head_group(H, 1, dc, dr, page)
    check_tensors(q_lat, pools=(c_pages, pe_pages), int32=(page_table, kv_lens),
                  others=(q_pe, c_scales, pe_scales))
    code = dtype_code(q_lat, q_pe)
    dtype_code(q_lat, c_pages, pe_pages, pool_dtype=torch.int8)
    out = torch.empty_like(q_lat)
    fn = load_function("paged_mla_decode_q", _ARGTYPES)
    with torch.cuda.device(q_lat.device):
        rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(),
                pe_pages.data_ptr(), c_scales.data_ptr(), pe_scales.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), B, H, hg,
                dc, dr, page, page_table.shape[1], float(scale), code,
                torch.cuda.current_stream(q_lat.device).cuda_stream)
    check("paged_mla_decode_q", rc)
    if B:
        LAUNCHES["paged_mla_decode_q"] += 1
    return out
