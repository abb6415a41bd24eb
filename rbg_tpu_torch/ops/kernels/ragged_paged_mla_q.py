"""Wrapper of the int8-latent-pool block-ragged MLA kernel
(``csrc/ragged_paged_mla_q.cu``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_mla_attention_pallas_q``. Its plain PyTorch version is
``ops/mla_attention.py::ragged_paged_mla_attention_plain`` with scales."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import (LAUNCHES, check_scales, check_tensors,
                                       dtype_code)
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_mla_decode import check_mla_shapes
from rbg_tpu_torch.ops.kernels.ragged_paged import check_pack
from rbg_tpu_torch.ops.kernels.ragged_paged_mla import Q_TILE, head_group

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _I, ctypes.c_float, _I, _P)


def ragged_paged_mla_attention_q_cuda(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                      c_pages: torch.Tensor, pe_pages: torch.Tensor,
                                      c_scales: torch.Tensor, pe_scales: torch.Tensor,
                                      page_table: torch.Tensor,
                                      q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                      row_ids: torch.Tensor, scale: float
                                      ) -> torch.Tensor:
    """q_lat [1, T, H, dc], q_pe [1, T, H, dr] packed, float32 or bfloat16;
    pools c [NP, page, 1, dc], pe [NP, page, 1, dr] int8 with float32
    scales [NP, page, 1, 1] each; page_table [R, P], q_positions [1, T],
    kv_lens [R], row_ids [T], all int32. Returns the latent output
    [1, T, H, dc] in q's dtype; each block holds ``head_group(H, Q_TILE,
    ...)`` heads of a Q_TILE-token tile."""
    H, dc, dr, page = check_mla_shapes("ragged_paged_mla_q", q_lat, q_pe, c_pages,
                                       pe_pages)
    T, R = check_pack(q_lat, page_table, q_positions, kv_lens, row_ids)
    check_scales(c_pages, c_scales, pe_scales)
    hg = head_group(H, Q_TILE, dc, dr, page)
    check_tensors(q_lat, pools=(c_pages, pe_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions),
                  others=(q_pe, c_scales, pe_scales))
    code = dtype_code(q_lat, q_pe)
    dtype_code(q_lat, c_pages, pe_pages, pool_dtype=torch.int8)
    out = torch.empty_like(q_lat)
    fn = load_function("ragged_paged_mla_q", _ARGTYPES)
    with torch.cuda.device(q_lat.device):
        rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(),
                pe_pages.data_ptr(), c_scales.data_ptr(), pe_scales.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), row_ids.data_ptr(),
                q_positions.data_ptr(), out.data_ptr(), T, R, H, hg, dc, dr, page,
                page_table.shape[1], float(scale), code,
                torch.cuda.current_stream(q_lat.device).cuda_stream)
    check("ragged_paged_mla_q", rc)
    if T:
        LAUNCHES["ragged_paged_mla_q"] += 1
    return out
