"""Wrapper of the block-ragged MLA latent attention kernel F
(``csrc/ragged_paged_mla.cu``, body in ``csrc/ragged_paged_mla.cuh``), the
port of ``rbg_tpu/ops/pallas/ragged_attention_kernel.py``
``ragged_paged_mla_attention_pallas``. Its plain PyTorch version is
``ops/mla_attention.py::ragged_paged_mla_attention_plain``.

Each work item of F (and of H, ``ragged_paged_mla_q.py``) is a row, a tile
of that row's live tokens x a slice of the heads (``TILE_ROWS`` query rows
filled token-major, ``tile_shape``) and one of up to 8 parts of the
row's walk in 32-slot latent blocks; the kernel derives the items
and splits from the pack on the card (kernel B's derivation), each row's
from its own kv_len, and the split that finishes last merges the others'
partials there. F and H take (dc, dr) in ``LATENT_DIMS``, any H, any page
size and at most ``MAX_ROWS`` table rows; ``check_ragged_mla`` refuses
anything else with a ``ValueError`` before any launch."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code, scratch
from rbg_tpu_torch.ops.kernels.build import check, load_function
from rbg_tpu_torch.ops.kernels.paged_mla_decode import LATENT_DIMS, check_mla_shapes
from rbg_tpu_torch.ops.kernels.ragged_paged import MAX_ROWS, check_pack

# Query rows of a tile by q's dtype (kRows in the source): bf16 queries run
# on the tensor cores, float32 ones on CUDA cores.
TILE_ROWS = {torch.bfloat16: 64, torch.float32: 16}
_TILES = 3              # first (tile, head slice) count in the counts buffer

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_long, _P, _I, _I, _I, _I, _I,
             _I, _I, ctypes.c_float, _I, _I, _P)


def tile_shape(H: int, dtype: torch.dtype):
    """(heads of a tile HG, head slices NHG, tokens of a tile TM): HG =
    min(H, rows), NHG = ceil(H / HG), TM = rows // HG."""
    rows = TILE_ROWS[dtype]
    hg = min(H, rows)
    return hg, -(-H // hg), rows // hg


def check_ragged_mla(name: str, q_lat, q_pe, c_pages, pe_pages, page_table, q_positions,
                     kv_lens, row_ids):
    """F and H's argument checks: ``check_mla_shapes``, (dc, dr) in
    LATENT_DIMS, the pack (``check_pack``), at most MAX_ROWS table rows and
    q_lat, q_pe 16-byte aligned. Returns (T, R, H, dc, dr, page)."""
    H, dc, dr, page = check_mla_shapes(name, q_lat, q_pe, c_pages, pe_pages)
    if (dc, dr) not in LATENT_DIMS:
        raise ValueError(f"{name} takes (dc, dr) in {LATENT_DIMS}; got ({dc}, {dr})")
    T, R = check_pack(q_lat, page_table, q_positions, kv_lens, row_ids)
    if R > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} table rows; got {R}")
    if q_lat.data_ptr() % 16 or q_pe.data_ptr() % 16:
        raise ValueError(f"{name} needs q_lat and q_pe 16-byte aligned")
    return T, R, H, dc, dr, page


def launch_ragged_mla(name: str, q_lat, q_pe, c_pages, pe_pages, scales, page_table,
                      q_positions, kv_lens, row_ids, scale: float, code: int, argtypes):
    """Launch F (``scales`` empty) or H (``scales`` = (c_scales, pe_scales))
    on q's device and current stream after ``check_ragged_mla`` and the
    tensor checks. Returns the latent output [1, T, H, dc] in q's dtype."""
    T, R, H, dc, dr, page = check_ragged_mla(name, q_lat, q_pe, c_pages, pe_pages,
                                             page_table, q_positions, kv_lens, row_ids)
    check_tensors(q_lat, pools=(c_pages, pe_pages),
                  int32=(page_table, kv_lens, row_ids, q_positions),
                  others=(q_pe, *scales))
    out = torch.empty_like(q_lat)
    dev = q_lat.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, nhg, tm = tile_shape(H, q_lat.dtype)
    # The merging kernels' scratch (``ops/kernels/__init__.py``): the
    # counts, _TILES + (ceil(T / TM) + R) * NHG of them, and float32
    # partial rows of dc + 4, as many as the launcher says the launch may
    # write (it returns minus that number, launching nothing, when the
    # scratch holds fewer: at most 2 x 2 x the blocks the card holds x the
    # tile's rows: ~70 MB at dc = 512 for bf16 queries on an H100).
    fn = load_function(name, argtypes)
    n_counts = _TILES + (-(-T // tm) + R) * nhg
    part, counts = scratch(q_lat, stream, 0, n_counts)

    def launch(part):
        return fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(), pe_pages.data_ptr(),
                  *(s.data_ptr() for s in scales), page_table.data_ptr(), kv_lens.data_ptr(),
                  row_ids.data_ptr(), q_positions.data_ptr(), out.data_ptr(), part.data_ptr(),
                  part.numel() // (dc + 4), counts.data_ptr(), T, R, H, dc, dr, page,
                  page_table.shape[1], float(scale), code, dev, stream)

    rc = launch(part)
    if rc < 0:
        part, counts = scratch(q_lat, stream, -rc * (dc + 4), n_counts)
        rc = launch(part)
    check(name, rc)
    if T:
        LAUNCHES[name] += 1
    return out


def ragged_paged_mla_attention_cuda(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                    c_pages: torch.Tensor, pe_pages: torch.Tensor,
                                    page_table: torch.Tensor,
                                    q_positions: torch.Tensor, kv_lens: torch.Tensor,
                                    row_ids: torch.Tensor, scale: float
                                    ) -> torch.Tensor:
    """q_lat [1, T, H, dc], q_pe [1, T, H, dr] packed; pools c
    [NP, page, 1, dc], pe [NP, page, 1, dr] in q's dtype; page_table
    [R, P], q_positions [1, T], kv_lens [R], row_ids [T], all int32.
    Returns the latent output [1, T, H, dc] in q's dtype. Shape limits:
    ``check_ragged_mla``."""
    code = dtype_code(q_lat, q_pe, c_pages, pe_pages)
    return launch_ragged_mla("ragged_paged_mla", q_lat, q_pe, c_pages, pe_pages, (),
                             page_table, q_positions, kv_lens, row_ids, scale, code,
                             _ARGTYPES)
