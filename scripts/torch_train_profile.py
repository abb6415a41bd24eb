#!/usr/bin/env python3
"""Where one training step's time goes on the card.

    python3 scripts/torch_train_profile.py [--layers 32] [--tokens 512] [--lr 1e-6]

llama3-8b at full width (``--layers`` deep, bf16, remat) trains on one
``[1, --tokens]`` batch through ``make_train_step``: two warm steps, then one
step under ``torch.profiler`` (CPU and CUDA activities). Prints the top
ops and kernels by device time, then one JSON line: the step's wall ms,
the device time the profiler recorded (the sum of every kernel's), the
device's busy share of the wall, and the card's name and power limit.
Needs one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rbg_tpu_torch.models.config import get_config
    from rbg_tpu_torch.models.llama import init_params
    from rbg_tpu_torch.models.training import make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = get_config("llama3-8b", num_layers=args.layers)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, args.tokens))).cuda()
    init_fn, step = make_train_step(cfg, learning_rate=args.lr, remat=True)
    params, opt = init_fn(init_params(cfg, 0, "cuda"))
    torch.cuda.empty_cache()
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15),
          flush=True)
    # The kernels' own time: device events, not the CPU ops that launched
    # them nor user annotations (each would count the same kernels again).
    device_us = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    print(json.dumps({"profile": "train_step", "card": card, "layers": args.layers,
                      "tokens": args.tokens, "loss": float(loss), "wall_ms": wall_ms,
                      "device_ms": device_us / 1e3,
                      "busy_share": device_us / 1e3 / wall_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
