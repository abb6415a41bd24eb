"""Wrapper of the MLA latent decode kernel E (``csrc/paged_mla_decode.cu``,
body in ``csrc/paged_mla_decode.cuh``), the port of
``rbg_tpu/ops/pallas/paged_attention_kernel.py`` ``paged_mla_attention_pallas``.
Its plain PyTorch version is ``ops/mla_attention.py::paged_mla_attention_plain``.

Each work item of E (and of G, ``paged_mla_decode_q.py``) is a row, a group
of ``HEAD_GROUP`` heads and one of ``ns`` contiguous parts of the row's walk
in 32-slot latent blocks, ``ns = min(cap, ceil(blocks / 2))`` from the
row's own kv_len and ``cap = split_cap(device, B, groups)``; the split that
finishes last merges the others' partials on the card. E and G take
(dc, dr) in ``LATENT_DIMS``, any H, any page size and any table width;
``check_mla_decode`` refuses anything else with a ``ValueError`` before any
launch.
``check_mla_shapes`` also serves the ragged MLA kernels F and H."""

from __future__ import annotations

import ctypes

import torch

from rbg_tpu_torch.ops.kernels import LAUNCHES, check_tensors, dtype_code, scratch
from rbg_tpu_torch.ops.kernels.build import check, load_function

LATENT_DIMS = ((512, 64), (64, 16))   # E and G's (dc, dr) template instances
HEAD_GROUP = 16             # heads of one E/G work item (one m16 tile)
MAX_SPLITS = 16             # E/G's largest cap (pm::kMaxSplits in the source)
BLOCKS_PER_SM = 1           # E/G blocks the card holds at once on each SM
_DONE0 = 3                  # first (row, head group) count in the counts buffer

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _I, _P)
_SMS: dict = {}             # multiprocessors per device index


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


def check_mla_decode(name: str, q_lat, q_pe, c_pages, pe_pages, page_table,
                     kv_lens):
    """E and G's argument checks: ``check_mla_shapes``, T == 1, (dc, dr) in
    LATENT_DIMS, page_table [B, P] and kv_lens [B] on q's device. Returns
    (B, H, dc, dr, page)."""
    B, T = q_lat.shape[:2]
    if T != 1:
        raise ValueError(f"{name} takes decode steps (T == 1), got T={T}")
    H, dc, dr, page = check_mla_shapes(name, q_lat, q_pe, c_pages, pe_pages)
    if (dc, dr) not in LATENT_DIMS:
        raise ValueError(f"{name} takes (dc, dr) in {LATENT_DIMS}; got ({dc}, {dr})")
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and kv_lens [B]")
    return B, H, dc, dr, page


def split_cap(dev: int, B: int, groups: int) -> int:
    """Most parts a row's walk splits into: as many items as the card holds
    blocks at once (``BLOCKS_PER_SM`` on each SM of device ``dev``), from
    the launch's sizes, never from the table width."""
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(MAX_SPLITS, max(1, sms * BLOCKS_PER_SM // max(1, B * groups)))


def launch_mla_decode(name: str, q_lat, q_pe, c_pages, pe_pages, scales,
                      page_table, kv_lens, scale: float, code: int, argtypes):
    """Launch E (``scales`` empty) or G (``scales`` = (c_scales,
    pe_scales)) on q's device and current stream after ``check_mla_decode``
    and the tensor checks. Returns the output [B, 1, H, dc] in q's dtype."""
    B, H, dc, dr, page = check_mla_decode(name, q_lat, q_pe, c_pages, pe_pages,
                                          page_table, kv_lens)
    check_tensors(q_lat, pools=(c_pages, pe_pages), int32=(page_table, kv_lens),
                  others=(q_pe, *scales))
    out = torch.empty_like(q_lat)
    dev = q_lat.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    groups = -(-H // HEAD_GROUP)
    cap = split_cap(dev, B, groups)
    # The merging kernels' scratch (``ops/kernels/__init__.py``): float32
    # partials [B * groups, cap, HEAD_GROUP, dc + 4], a count per (row, head
    # group) after the first _DONE0.
    part, counts = scratch(q_lat, stream, B * groups * cap * HEAD_GROUP * (dc + 4),
                           _DONE0 + B * groups)
    rc = load_function(name, argtypes)(
        q_lat.data_ptr(), q_pe.data_ptr(), c_pages.data_ptr(), pe_pages.data_ptr(),
        *(s.data_ptr() for s in scales), page_table.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), counts.data_ptr(), B, H, dc, dr, page,
        page_table.shape[1], cap, float(scale), code, dev, stream)
    check(name, rc)
    if B:
        LAUNCHES[name] += 1
    return out


def paged_mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                               c_pages: torch.Tensor, pe_pages: torch.Tensor,
                               page_table: torch.Tensor, kv_lens: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """q_lat [B, 1, H, dc], q_pe [B, 1, H, dr]; pools c [NP, page, 1, dc],
    pe [NP, page, 1, dr] in q's dtype; page_table [B, P] int32; kv_lens [B]
    int32; ``scale`` the softmax scale (``_mla_scale``, (dn + dr)^-0.5).
    Returns the latent output [B, 1, H, dc] in q's dtype. Shape limits:
    ``check_mla_decode``."""
    code = dtype_code(q_lat, q_pe, c_pages, pe_pages)
    return launch_mla_decode("paged_mla_decode", q_lat, q_pe, c_pages, pe_pages, (),
                             page_table, kv_lens, scale, code, _ARGTYPES)
