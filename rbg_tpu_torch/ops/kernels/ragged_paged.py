"""Wrapper of the block-ragged paged attention kernel B
(``csrc/ragged_paged.cu``, body in ``csrc/ragged_paged.cuh``), the port of
``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_attention_pallas``. Its plain PyTorch version is
``ops/ragged_paged_attention.py::ragged_paged_attention_plain``.

Each work item of B (and of D, ``ragged_paged_q.py``) is a row, up to
``tile_tokens(G)`` of that row's live tokens, a kv head and one of up to
``MAX_SPLITS`` parts of the row's walk; the kernel derives the items and
splits from the pack on the card, each row's from its own kv_len.
The kernel takes hd in ``HEAD_DIMS``, G <= 16, any page size and at most
``MAX_ROWS`` table rows; ``check_ragged_shapes`` refuses anything else with
a ``ValueError`` before any launch."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code
from rbg_tpu_torch.ops.kernels import scratch as _scratch
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_decode import check_shapes

TILE_ROWS = 64          # query rows per block: tile_tokens(G) tokens x G heads
MAX_ROWS = 1024         # table rows the kernel's shared row counts hold
HEAD_DIMS = (32, 64, 128)   # the kernel's template instances
MAX_SPLITS = 4          # items of one tile's walk at most (kMaxSplits in the source)
# The int32 counts (kHeadSlot.. in the source): the work queue's head, the
# last launch's work items and grid blocks, then each (tile, kv head)'s
# finished splits (``ops/kernels/__init__.py``).
_HEAD, _TILES = 0, 3

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P)


def check_pack(q, page_table, q_positions, kv_lens, row_ids):
    """The ragged kernels' pack metadata: q [1, T, ...], page_table [R, P],
    kv_lens [R], q_positions [1, T], row_ids [T]. Returns (T, R)."""
    one, T = q.shape[:2]
    R = page_table.shape[0]
    if (one != 1 or page_table.dim() != 2 or kv_lens.shape != (R,)
            or q_positions.shape != (1, T) or row_ids.shape != (T,)):
        raise ValueError("q [1, T, ...], page_table [R, P], kv_lens [R], "
                         "q_positions [1, T] and row_ids [T] expected")
    return T, R


def tile_tokens(G: int) -> int:
    """Packed tokens of one row per block (kRows / G in the source)."""
    return TILE_ROWS // G


def check_ragged_shapes(name: str, q, k_pages, v_pages, page_table):
    """Kernels B and D's limits on top of ``check_shapes``, and q 16-byte
    aligned for their vector loads. Returns (KV, G, hd, page)."""
    KV, G, hd, page = check_shapes(name, q, k_pages, v_pages)
    R = page_table.shape[0]
    if hd not in HEAD_DIMS or R > MAX_ROWS:
        raise ValueError(f"{name} takes hd in {HEAD_DIMS} and at most {MAX_ROWS} "
                         f"table rows; got hd={hd} R={R}")
    if q.data_ptr() % 16:
        raise ValueError(f"{name} needs q 16-byte aligned")
    return KV, G, hd, page


def scratch(q: torch.Tensor, stream: int, R: int, KV: int, G: int, hd: int):
    """B and D's share of the merging kernels' scratch on ``stream``
    (``ops/kernels/__init__.py``): float32 partials for the cross-block
    merge, [T * G, KV, MAX_SPLITS, hd + 4] (a split tile's query rows,
    numbered by live token of the rows that split), and the counts, _TILES + (tiles bound) * KV of
    them, tiles bound = ceil(T / tile_tokens(G)) + R."""
    T = q.shape[1]
    return _scratch(q, stream, T * G * KV * MAX_SPLITS * (hd + 4),
                    _TILES + (-(-T // tile_tokens(G)) + R) * KV)


def ragged_paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, page_table: torch.Tensor,
                                q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                row_ids: torch.Tensor) -> torch.Tensor:
    """q [1, T, H, hd] packed; pools [NP, page, KV, hd] in q's dtype;
    page_table [R, P], q_positions [1, T], kv_lens [R], row_ids [T], all
    int32. Returns [1, T, H, hd] in q's dtype. Shape limits:
    ``check_ragged_shapes``."""
    KV, G, hd, page = check_ragged_shapes("ragged_paged", q, k_pages, v_pages,
                                          page_table)
    T, R = check_pack(q, page_table, q_positions, kv_lens, row_ids)
    check_tensors(q, pools=(k_pages, v_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions))
    code = dtype_code(q, k_pages, v_pages)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counts = scratch(q, stream, R, KV, G, hd)
    fn = load_function("ragged_paged", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), row_ids.data_ptr(),
                q_positions.data_ptr(), out.data_ptr(), part.data_ptr(),
                counts.data_ptr(), T, R, KV, G, hd, page, page_table.shape[1],
                hd ** -0.5, code, stream)
    check("ragged_paged", rc)
    if T:
        LAUNCHES["ragged_paged"] += 1
    return out
