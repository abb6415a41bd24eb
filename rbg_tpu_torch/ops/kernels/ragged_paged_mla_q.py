"""Wrapper of the int8-latent-pool block-ragged MLA kernel H
(``csrc/ragged_paged_mla_q.cu``, body in ``csrc/ragged_paged_mla.cuh``),
the port of ``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_mla_attention_pallas_q``. Its plain PyTorch version is
``ops/mla_attention.py::ragged_paged_mla_attention_plain`` with scales.
Work items, splits and shape limits: kernel F's (``ragged_paged_mla.py``)."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import check_scales, dtype_code
from rbg_tpu_torch.ops.kernels.ragged_paged_mla import launch_ragged_mla

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_long, _P, _I, _I, _I,
             _I, _I, _I, _I, ctypes.c_float, _I, _I, _P)


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
    [1, T, H, dc] in q's dtype. Shape limits: ``check_ragged_mla``."""
    check_scales(c_pages, c_scales, pe_scales)
    code = dtype_code(q_lat, q_pe)
    dtype_code(q_lat, c_pages, pe_pages, pool_dtype=torch.int8)
    return launch_ragged_mla("ragged_paged_mla_q", q_lat, q_pe, c_pages, pe_pages,
                             (c_scales, pe_scales), page_table, q_positions, kv_lens,
                             row_ids, scale, code, _ARGTYPES)
