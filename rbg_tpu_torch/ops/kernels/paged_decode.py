"""Wrapper of the paged decode attention kernel (``csrc/paged_decode.cu``),
the port of ``rbg_tpu/ops/pallas/paged_attention_kernel.py``
``paged_attention_pallas``. Its plain PyTorch version is
``ops/paged_attention.py::paged_attention_plain``."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels.build import check, load_function

MAX_GROUP = 16          # query heads per kv head the shared-memory plan holds
MAX_HEAD_DIM = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _P)


def check_shapes(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor):
    """GQA kernels' shape limits: q [.., H, hd], pools [NP, page, KV, hd],
    G = H / KV <= MAX_GROUP, hd <= MAX_HEAD_DIM and a multiple of 16 bytes
    of the POOL's element. Returns (KV, G, hd, page)."""
    H, hd = q.shape[-2:]
    NP, page, KV, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd or H % KV:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    G = H // KV
    if G > MAX_GROUP or hd > MAX_HEAD_DIM or hd % (16 // k_pages.element_size()):
        raise ValueError(f"{name} takes G <= {MAX_GROUP} and hd <= {MAX_HEAD_DIM} "
                         f"a multiple of 16 bytes; got G={G} hd={hd}")
    return KV, G, hd, page


def check_decode(name: str, q, k_pages, v_pages, page_table, kv_lens):
    """Decode kernels' argument checks; returns (B, KV, G, hd, page)."""
    B, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"{name} takes decode steps (T == 1), got T={T}")
    KV, G, hd, page = check_shapes(name, q, k_pages, v_pages)
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and kv_lens [B]")
    check_tensors(q, pools=(k_pages, v_pages), int32=(page_table, kv_lens))
    return B, KV, G, hd, page


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           kv_lens: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, hd]; pools [NP, page, KV, hd] in q's dtype; page_table
    [B, P] int32; kv_lens [B] int32. Returns [B, 1, H, hd] in q's dtype."""
    B, KV, G, hd, page = check_decode("paged_decode", q, k_pages, v_pages,
                                      page_table, kv_lens)
    code = dtype_code(q, k_pages, v_pages)
    out = torch.empty_like(q)
    fn = load_function("paged_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
                B, KV, G, hd, page, page_table.shape[1], hd ** -0.5, code,
                torch.cuda.current_stream(q.device).cuda_stream)
    check("paged_decode", rc)
    if B:
        LAUNCHES["paged_decode"] += 1
    return out
