"""Wrapper of the block-ragged MLA latent attention kernel
(``csrc/ragged_paged_mla.cu``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_mla_attention_pallas``. Its plain PyTorch version is
``ops/mla_attention.py::ragged_paged_mla_attention_plain``."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_mla_decode import check_mla_shapes
from rbg_tpu_torch.ops.kernels.ragged_paged import check_pack

Q_TILE = 8              # packed tokens per block (kTile in csrc/paged_attn_common.cuh)
MAX_ROWS = 16           # query rows (tokens x heads) of one block's plan
SMEM_LIMIT = 232448     # shared memory one block may use on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, ctypes.c_float, _I, _P)


def smem_bytes(nq: int, dc: int, dr: int, page: int) -> int:
    """Shared memory of the MLA plan (``rbg::mla_plan`` + ``smem_bytes``)."""
    floats = nq * (2 * dc + dr) + page * (dc + dr + 1) + nq * page + 3 * nq + 2 * page
    return 4 * floats + 4 * 2 * nq


def head_group(H: int, tokens: int, dc: int, dr: int, page: int) -> int:
    """Heads per block: the largest divisor hg of H with tokens·hg <=
    MAX_ROWS query rows whose plan fits in shared memory."""
    for hg in range(min(H, max(MAX_ROWS // tokens, 1)), 0, -1):
        if H % hg == 0 and smem_bytes(tokens * hg, dc, dr, page) <= SMEM_LIMIT:
            return hg
    raise ValueError(f"no head group of H={H} fits shared memory at dc={dc}, "
                     f"dr={dr}, page={page}")


def ragged_paged_mla_attention_cuda(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                    c_pages: torch.Tensor, pe_pages: torch.Tensor,
                                    page_table: torch.Tensor,
                                    q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                    row_ids: torch.Tensor, scale: float
                                    ) -> torch.Tensor:
    """q_lat [1, T, H, dc], q_pe [1, T, H, dr] packed; pools c
    [NP, page, 1, dc], pe [NP, page, 1, dr] in q's dtype; page_table
    [R, P], q_positions [1, T], kv_lens [R], row_ids [T], all int32.
    Returns the latent output [1, T, H, dc] in q's dtype; each block holds
    ``head_group(H, Q_TILE, ...)`` heads of a Q_TILE-token tile."""
    H, dc, dr, page = check_mla_shapes("ragged_paged_mla", q_lat, q_pe, c_pages,
                                       pe_pages)
    T, R = check_pack(q_lat, page_table, q_positions, kv_lens, row_ids)
    hg = head_group(H, Q_TILE, dc, dr, page)
    check_tensors(q_lat, pools=(c_pages, pe_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions), others=(q_pe,))
    code = dtype_code(q_lat, q_pe, c_pages, pe_pages)
    out = torch.empty_like(q_lat)
    fn = load_function("ragged_paged_mla", _ARGTYPES)
    with torch.cuda.device(q_lat.device):
        rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(),
                pe_pages.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
                row_ids.data_ptr(), q_positions.data_ptr(), out.data_ptr(), T, R,
                H, hg, dc, dr, page, page_table.shape[1], float(scale), code,
                torch.cuda.current_stream(q_lat.device).cuda_stream)
    check("ragged_paged_mla", rc)
    if T:
        LAUNCHES["ragged_paged_mla"] += 1
    return out
