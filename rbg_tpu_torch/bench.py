"""Kernel probes of the port (the counterparts of ``bench.py``'s probes).

    python -m rbg_tpu_torch.bench            # on the card
    python -m rbg_tpu_torch.bench --device cpu

``block_ragged_probe`` holds the token-grid ragged kernel I (one block per
packed token, each walking its row's pages alone) against the block-ragged
kernel B (a tile's tokens of one row share one page walk) on a
prefill-heavy pack, the mix the tile grid exists for: long prefill rows
straddle tiles, decode singles share tiles with prefill tails. Both
kernels are first checked against the plain version; then interleaved
timed reps give each one's calls per second.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import numpy as np
import torch

from rbg_tpu_torch.engine.config import resolve_device
from rbg_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain,
    ragged_paged_attention_tokengrid)

BLOCK_RAGGED_SPECS = ((40, 40), (1, 96), (64, 64), (1, 30), (24, 24),
                      (1, 80), (48, 48))          # (q_len, kv_len) per row
BLOCK_RAGGED_REPS = 5
BLOCK_RAGGED_ITERS = 20
SPREAD_GATE_PCT = 5.0


def spread_of(runs):
    """Spread of repeated measurements: (max - min) / median, in percent."""
    med = statistics.median(runs)
    return 100.0 * (max(runs) - min(runs)) / med if med else float("inf")


def trimmed_spread_of(runs):
    """Spread over the middle runs (the single min and max dropped)."""
    if len(runs) < 4:
        return spread_of(runs)
    return spread_of(sorted(runs)[1:-1])


def block_ragged_pack(device) -> tuple:
    """The probe's float32 pack, drawn from numpy seed 31 in the reference
    probe's order: H=8, hd=64, KV=4, page 16, NP=128 pages, P=6 per row.
    Returns (q, k_pages, v_pages, page_table, q_positions, kv_lens,
    row_ids)."""
    H, hd, KV, page, NP, P = 8, 64, 4, 16, 128, 6
    rng = np.random.RandomState(31)
    k = rng.randn(NP, page, KV, hd)
    v = rng.randn(NP, page, KV, hd)
    perm = rng.permutation(NP - 1)[: len(BLOCK_RAGGED_SPECS) * P] + 1
    table = perm.reshape(len(BLOCK_RAGGED_SPECS), P)
    kv_lens = [kv for _, kv in BLOCK_RAGGED_SPECS]
    T = sum(ql for ql, _ in BLOCK_RAGGED_SPECS)
    q = rng.randn(1, T, H, hd)
    row_ids, q_pos = [], []
    for r, (ql, kv) in enumerate(BLOCK_RAGGED_SPECS):
        row_ids += [r] * ql
        q_pos += list(range(kv - ql, kv))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return (f32(q), f32(k), f32(v), i32(table), i32([q_pos]), i32(kv_lens),
            i32(row_ids))


def block_ragged_probe(device=None) -> dict:
    """Kernel I (token grid) against kernel B (block-ragged) on the
    prefill-heavy pack: both within 1e-5 of the plain version, then
    BLOCK_RAGGED_REPS interleaved reps of BLOCK_RAGGED_ITERS calls each.
    Runs on the card; on the CPU there are no kernels, so it checks the
    pack and the plain version only and reports ``measurable: false``."""
    dev = resolve_device(device)
    args = block_ragged_pack(dev)
    T = int(args[0].shape[1])
    measurable = dev.type == "cuda"
    out = {
        "metric": ("ragged_kernel_tokengrid_vs_block_"
                   f"T{T}_rows{len(BLOCK_RAGGED_SPECS)}"),
        "prefill_heavy_specs": [list(s) for s in BLOCK_RAGGED_SPECS],
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if measurable else "cpu",
        "measurable": measurable,
    }
    ref = ragged_paged_attention_plain(*args)
    if not measurable:
        out["plain_finite"] = bool(torch.isfinite(ref).all())
        out["detail"] = ("the CUDA kernels run only on the card; the pack and "
                         "the plain version were checked, nothing was timed")
        out["gate"] = "not_measurable"
        return out

    old = ragged_paged_attention_tokengrid(*args)
    new = ragged_paged_attention(*args)
    out["max_abs_diff_vs_plain"] = {
        "tokengrid": float((old - ref).abs().max()),
        "block_ragged": float((new - ref).abs().max()),
    }
    identical = bool(torch.allclose(old, ref, rtol=1e-5, atol=1e-5)
                     and torch.allclose(new, ref, rtol=1e-5, atol=1e-5))
    out["bit_identical"] = identical

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(BLOCK_RAGGED_ITERS):
            fn(*args)
        torch.cuda.synchronize(dev)
        return BLOCK_RAGGED_ITERS / (time.perf_counter() - t0)

    old_runs, new_runs = [], []
    for _ in range(BLOCK_RAGGED_REPS):
        old_runs.append(timed(ragged_paged_attention_tokengrid))
        new_runs.append(timed(ragged_paged_attention))
    ratio = statistics.median(new_runs) / statistics.median(old_runs)
    spread = max(trimmed_spread_of(old_runs), trimmed_spread_of(new_runs))
    out.update({
        "tokengrid_calls_per_s": statistics.median(old_runs),
        "block_ragged_calls_per_s": statistics.median(new_runs),
        "speedup": ratio,
        "spread_pct": spread if math.isfinite(spread) else None,
        "spread_estimator": "trimmed_minmax_drop1",
        "gate": ("pass" if identical and ratio >= 1.15
                 and spread <= SPREAD_GATE_PCT else "fail"),
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' checks only)")
    args = ap.parse_args(argv)
    print(json.dumps({"block_ragged": block_ragged_probe(args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
