"""Wrapper of the int8-latent-pool MLA decode kernel G
(``csrc/paged_mla_decode_q.cu``, body in ``csrc/paged_mla_decode.cuh``),
the port of ``rbg_tpu/ops/pallas/paged_attention_kernel.py``
``paged_mla_attention_pallas_q``. Its plain PyTorch version is
``ops/mla_attention.py::paged_mla_attention_plain`` with scales. Work items,
splits and shape limits: kernel E's (``paged_mla_decode.py``)."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import check_scales, dtype_code
from rbg_tpu_torch.ops.kernels.paged_mla_decode import launch_mla_decode

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P)


def paged_mla_decode_attention_q(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                 c_pages: torch.Tensor, pe_pages: torch.Tensor,
                                 c_scales: torch.Tensor, pe_scales: torch.Tensor,
                                 page_table: torch.Tensor, kv_lens: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q_lat [B, 1, H, dc], q_pe [B, 1, H, dr] float32 or bfloat16; pools c
    [NP, page, 1, dc], pe [NP, page, 1, dr] int8 with float32 scales
    [NP, page, 1, 1] each; page_table [B, P] int32; kv_lens [B] int32;
    ``scale`` the softmax scale. Returns the latent output [B, 1, H, dc] in
    q's dtype. Shape limits: ``check_mla_decode``."""
    check_scales(c_pages, c_scales, pe_scales)
    code = dtype_code(q_lat, q_pe)
    dtype_code(q_lat, c_pages, pe_pages, pool_dtype=torch.int8)
    return launch_mla_decode("paged_mla_decode_q", q_lat, q_pe, c_pages, pe_pages,
                             (c_scales, pe_scales), page_table, kv_lens, scale, code,
                             _ARGTYPES)
