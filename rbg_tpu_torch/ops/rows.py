"""Fixed row blocks: batch-invariant serving (``EngineConfig.batch_invariant``).

A library kernel picks its algorithm by the shape it is given: cuBLAS its
GEMM (split-K among them) by the row count, torch's reductions their
block layout by the number of outputs. At a free row count a row's bits
depend on how many rows share its step (on the card, llama3-8b's wk, wv
and w_down, and RMSNorm's sum of squares, differ between 1 and 4 rows),
so a request's greedy tokens depend on the requests beside it, its
prefill chunk boundaries and its decode bucket.

A serving forward called with ``rows=True`` (``models/llama.py``) keeps
the residual rows padded with zero rows to a multiple of ``ROWS`` from the
embedding to the head and runs every product (``mm``) and RMSNorm
(``ops/norms.py``) over them as calls of exactly ``ROWS`` rows, so a row's
result is its own; its attention kernels take their ``invariant`` switch.
Every other caller keeps one call of its own row count.

``ROWS``: a decode step pads its few rows up to it, and a prefill pack of
M rows reads every weight ceil(M / ROWS) times (at 256 a 512-token pack
stays compute-bound, where 128 doubled its weight reads). The cost against
the default path is in ``PERF.md`` (``scripts/rows_ab.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROWS = 256


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] as [Mp, K], Mp = its rows rounded up to ROWS, the added
    rows zero."""
    x2 = x.reshape(-1, x.shape[-1])
    pad = -x2.shape[0] % ROWS
    return F.pad(x2, (0, 0, 0, pad)) if pad else x2


def unpad_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """The first B·T rows of padded rows x [Mp, K] as [B, T, K]
    (``shape`` = (B, T))."""
    B, T = shape
    return x[:B * T].reshape(B, T, x.shape[-1])


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for padded rows x [Mp, K] (Mp a multiple of ROWS) and w
    [K, N], as products of exactly ROWS rows each."""
    M = x.shape[0]
    if M == ROWS:
        return x @ w
    out = x.new_empty((M, w.shape[1]))
    for i in range(0, M, ROWS):
        torch.mm(x[i:i + ROWS], w, out=out[i:i + ROWS])
    return out
