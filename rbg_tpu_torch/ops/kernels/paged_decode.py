"""Wrapper of the paged decode attention kernel A (``csrc/paged_decode.cu``,
body in ``csrc/paged_decode.cuh``), the port of
``rbg_tpu/ops/pallas/paged_attention_kernel.py`` ``paged_attention_pallas``.
Its plain PyTorch version is ``ops/paged_attention.py::paged_attention_plain``.

Each work item of A (and of C, ``paged_decode_q.py``) is a row, a kv head
and one of ``ns`` contiguous parts of the row's walk in ``KV_BLOCK``-slot
blocks, ``ns = min(cap, ceil(blocks / 2))`` from the row's own kv_len and
``cap = split_cap(B, KV)`` (``csrc/paged_decode.cuh``); the split that
finishes last merges the others' partials on the card. The kernel takes hd
in ``HEAD_DIMS``, G <= 16 and any page size (each slot's page is looked up
as the walk goes, so a block may span parts of pages or lie inside one);
``check_decode`` refuses anything else with a ``ValueError`` before any
launch. Kernel I (``ragged_paged_tokengrid.py``) runs the same body with a
packed token in the row's place."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code, scratch
from rbg_tpu_torch.ops.kernels.build import check, load_function

MAX_GROUP = 16          # query heads per kv head the shared-memory plan holds
MAX_HEAD_DIM = 256
KV_BLOCK = 64           # KV slots per pipeline step (any page size)
HEAD_DIMS = (32, 64, 128)   # the decode kernels' template instances
MAX_SPLITS = 16         # the decode kernels' largest cap (pd::kMaxSplits in the source)
TARGET_ITEMS = 512      # B * KV blocks at which a decode walk no longer splits
_DONE0 = 3              # first (row, kv head) count in the counts buffer

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P)


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


def check_body_shapes(name: str, q, k_pages, v_pages):
    """The limits of the decode body (kernels A, C and I): ``check_shapes``
    and hd in HEAD_DIMS. Returns (KV, G, hd, page)."""
    KV, G, hd, page = check_shapes(name, q, k_pages, v_pages)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} takes hd in {HEAD_DIMS}; got hd={hd}")
    return KV, G, hd, page


def check_aligned(name: str, q) -> None:
    """The decode body reads q in 16-byte-aligned pieces."""
    if q.data_ptr() % 16:
        raise ValueError(f"{name} needs q 16-byte aligned")


def check_decode(name: str, q, k_pages, v_pages, page_table, kv_lens):
    """Decode kernels' argument checks: T == 1, ``check_body_shapes`` and
    q 16-byte aligned. Returns (B, KV, G, hd, page)."""
    B, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"{name} takes decode steps (T == 1), got T={T}")
    KV, G, hd, page = check_body_shapes(name, q, k_pages, v_pages)
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and kv_lens [B]")
    check_tensors(q, pools=(k_pages, v_pages), int32=(page_table, kv_lens))
    check_aligned(name, q)
    return B, KV, G, hd, page


def split_cap(B: int, KV: int) -> int:
    """Most parts a row's walk splits into at this launch size: enough for
    about TARGET_ITEMS blocks, none once B * KV blocks reach it."""
    return min(MAX_SPLITS, max(1, -(-TARGET_ITEMS // max(1, B * KV))))


def decode_scratch(q: torch.Tensor, stream: int, B: int, KV: int, G: int, hd: int,
                   cap: int):
    """A, C and I's share of the merging kernels' scratch on ``stream``:
    float32 partials [B * KV, cap, G, hd + 4] and a count per (row or
    token, kv head) after the first _DONE0."""
    return scratch(q, stream, B * KV * cap * G * (hd + 4), _DONE0 + B * KV)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           kv_lens: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, hd]; pools [NP, page, KV, hd] in q's dtype; page_table
    [B, P] int32; kv_lens [B] int32. Returns [B, 1, H, hd] in q's dtype.
    Shape limits: ``check_decode``."""
    B, KV, G, hd, page = check_decode("paged_decode", q, k_pages, v_pages,
                                      page_table, kv_lens)
    code = dtype_code(q, k_pages, v_pages)
    out = torch.empty_like(q)
    dev = q.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = split_cap(B, KV)
    part, counts = decode_scratch(q, stream, B, KV, G, hd, cap)
    rc = load_function("paged_decode", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(), counts.data_ptr(), B, KV,
        G, hd, page, page_table.shape[1], cap, hd ** -0.5, code, dev, stream)
    check("paged_decode", rc)
    if B:
        LAUNCHES["paged_decode"] += 1
    return out
