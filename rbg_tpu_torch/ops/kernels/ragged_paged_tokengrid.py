"""Wrapper of the token-grid ragged paged attention kernel I
(``csrc/ragged_paged_tokengrid.cu``, kernel A's body in
``csrc/paged_decode.cuh``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_attention_pallas_tokengrid``: kernel B's function on a
(packed token, kv head) grid, the baseline of ``bench.block_ragged_probe``.
Its plain PyTorch version is
``ops/ragged_paged_attention.py::ragged_paged_attention_plain``.

Each work item is a packed token, a kv head and one of ``ns`` contiguous
parts of the token's walk of its row, as kernel A's items are a decode
row's (``paged_decode.py``), with the cap from ``split_cap(T, KV)``. The
kernel takes A's shapes, hd in ``HEAD_DIMS``, G <= 16 and any page size;
``check_body_shapes`` refuses anything else with a ``ValueError`` before
any launch."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_decode import (check_aligned, check_body_shapes,
                                                    decode_scratch, split_cap)
from rbg_tpu_torch.ops.kernels.ragged_paged import check_pack

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P)


def ragged_paged_attention_tokengrid_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                          v_pages: torch.Tensor,
                                          page_table: torch.Tensor,
                                          q_positions: torch.Tensor,
                                          kv_lens: torch.Tensor,
                                          row_ids: torch.Tensor) -> torch.Tensor:
    """q [1, T, H, hd] packed; pools [NP, page, KV, hd] in q's dtype
    (float32 or bfloat16); page_table [R, P], q_positions [1, T], kv_lens
    [R], row_ids [T], all int32. Returns [1, T, H, hd] in q's dtype."""
    KV, G, hd, page = check_body_shapes("ragged_paged_tokengrid", q, k_pages, v_pages)
    T, R = check_pack(q, page_table, q_positions, kv_lens, row_ids)
    check_tensors(q, pools=(k_pages, v_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions))
    check_aligned("ragged_paged_tokengrid", q)
    code = dtype_code(q, k_pages, v_pages)
    out = torch.empty_like(q)
    dev = q.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = split_cap(T, KV)
    part, counts = decode_scratch(q, stream, T, KV, G, hd, cap)
    rc = load_function("ragged_paged_tokengrid", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), row_ids.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        part.data_ptr(), counts.data_ptr(), T, R, KV, G, hd, page, page_table.shape[1],
        cap, hd ** -0.5, code, dev, stream)
    check("ragged_paged_tokengrid", rc)
    if T:
        LAUNCHES["ragged_paged_tokengrid"] += 1
    return out
