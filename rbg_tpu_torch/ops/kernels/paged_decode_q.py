"""Wrapper of the int8-pool paged decode attention kernel C
(``csrc/paged_decode_q.cu``, kernel A's body in ``csrc/paged_decode.cuh``),
the port of ``rbg_tpu/ops/pallas/paged_attention_kernel.py``
``paged_attention_pallas_q``. Its plain PyTorch version is
``ops/paged_attention.py::paged_attention_plain`` with scales. Work items,
splits and shape limits: ``paged_decode.py``."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import (LAUNCHES, check_scales, check_tensors,
                                       dtype_code)
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_decode import (MAX_SPLITS, check_decode,
                                                    decode_scratch, split_cap)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P)


def paged_decode_attention_q(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, k_scales: torch.Tensor,
                             v_scales: torch.Tensor, page_table: torch.Tensor,
                             kv_lens: torch.Tensor, invariant: bool = False) -> torch.Tensor:
    """q [B, 1, H, hd] float32 or bfloat16; pools [NP, page, KV, hd] int8;
    scales [NP, page, KV, 1] float32; page_table [B, P] int32; kv_lens [B]
    int32. Returns [B, 1, H, hd] in q's dtype. ``invariant``: as A's."""
    B, KV, G, hd, page = check_decode("paged_decode_q", q, k_pages, v_pages,
                                      page_table, kv_lens)
    check_scales(k_pages, k_scales, v_scales)
    check_tensors(q, others=(k_scales, v_scales))
    code = dtype_code(q, k_pages, v_pages, pool_dtype=torch.int8)
    out = torch.empty_like(q)
    dev = q.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = MAX_SPLITS if invariant else split_cap(B, KV)
    part, counts = decode_scratch(q, stream, B, KV, G, hd, cap)
    rc = load_function("paged_decode_q", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), counts.data_ptr(), B, KV, G, hd, page, page_table.shape[1], cap,
        hd ** -0.5, code, dev, stream)
    check("paged_decode_q", rc)
    if B:
        LAUNCHES["paged_decode_q"] += 1
    return out
