"""Wrapper of the MLA latent decode kernel (``csrc/paged_mla_decode.cu``),
the port of ``rbg_tpu/ops/pallas/paged_attention_kernel.py``
``paged_mla_attention_pallas``. Its plain PyTorch version is
``ops/mla_attention.py::paged_mla_attention_plain``."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels.build import check, load_function

MAX_ROWS = 16               # query rows (tokens x heads) of one block's plan
SMEM_LIMIT = 232448         # shared memory one block may use on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P)


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


def check_mla_shapes(name: str, q_lat, q_pe, c_pages, pe_pages):
    """q_lat [.., H, dc], q_pe [.., H, dr]; pools c [NP, page, 1, dc] and
    pe [NP, page, 1, dr] in q's dtype, widths multiples of 16 bytes.
    Returns (H, dc, dr, page)."""
    H, dc = q_lat.shape[-2:]
    dr = q_pe.shape[-1]
    NP, page, one, dc_k = c_pages.shape
    if (q_pe.shape[:-1] != q_lat.shape[:-1] or one != 1 or dc_k != dc
            or tuple(pe_pages.shape) != (NP, page, 1, dr)):
        raise ValueError(f"bad shapes q_lat {tuple(q_lat.shape)} q_pe "
                         f"{tuple(q_pe.shape)} pools {tuple(c_pages.shape)} / "
                         f"{tuple(pe_pages.shape)}")
    vec = 16 // c_pages.element_size()
    if dc % vec or dr % vec:
        raise ValueError(f"{name} takes dc and dr multiples of 16 bytes; got "
                         f"dc={dc} dr={dr}")
    return H, dc, dr, page


def paged_mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                               c_pages: torch.Tensor, pe_pages: torch.Tensor,
                               page_table: torch.Tensor, kv_lens: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """q_lat [B, 1, H, dc], q_pe [B, 1, H, dr]; pools c [NP, page, 1, dc],
    pe [NP, page, 1, dr] in q's dtype; page_table [B, P] int32; kv_lens [B]
    int32; ``scale`` the softmax scale (``_mla_scale``, (dn + dr)^-0.5).
    Returns the latent output [B, 1, H, dc] in q's dtype; each block holds
    ``head_group(H, 1, ...)`` heads."""
    B, T = q_lat.shape[:2]
    if T != 1:
        raise ValueError(f"paged_mla_decode takes decode steps (T == 1), got T={T}")
    H, dc, dr, page = check_mla_shapes("paged_mla_decode", q_lat, q_pe, c_pages,
                                       pe_pages)
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and kv_lens [B]")
    hg = head_group(H, 1, dc, dr, page)
    check_tensors(q_lat, pools=(c_pages, pe_pages), int32=(page_table, kv_lens),
                  others=(q_pe,))
    code = dtype_code(q_lat, q_pe, c_pages, pe_pages)
    out = torch.empty_like(q_lat)
    fn = load_function("paged_mla_decode", _ARGTYPES)
    with torch.cuda.device(q_lat.device):
        rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(),
                pe_pages.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
                out.data_ptr(), B, H, hg, dc, dr, page, page_table.shape[1],
                float(scale), code, torch.cuda.current_stream(q_lat.device).cuda_stream)
    check("paged_mla_decode", rc)
    if B:
        LAUNCHES["paged_mla_decode"] += 1
    return out
