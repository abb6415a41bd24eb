#!/usr/bin/env python3
"""What bounds the distance between bf16 embeddings of one prompt run alone
and in a batch, and how far a padding fault moves them: llama3-8b at full
depth on the card, random weights from seed 0.

    python3 scripts/embed_tolerance.py

The prompts are ``chip_smoke.py``'s embed request (100, 230, 377 and 500
tokens, ``numpy.random.RandomState(4)``). Prints the card's name and power
limit, then JSON lines:

- ``gemm``: each projection of layer 0 on 512 rows against its first 128
  rows alone: the share of those rows whose bf16 output bits differ, and
  the largest relative difference, with cuBLAS's reduced-precision bf16
  reduction allowed (PyTorch's default) and forbidden;
- ``alone_vs_batch``: the 100-token prompt alone at T 128, 256 and 512
  (B 1) and in the 4-prompt batch (B 4, T 512), each as a relative L2
  distance from the float32 forward of the same prompt, and from the
  batched bf16 vector, under both reduction settings;
- ``faults``: the batched request with a planted fault against its prompts
  run alone: pooling over the pads, and attention that is neither causal
  nor masked (pads visible to every token);
- ``memory``: ``embed_prompts`` on 32 prompts of 2048 tokens, its spans,
  seconds and peak device memory above the weights.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
LENS = (100, 230, 377, 500)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main():
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.service import _chunk_bucket, _embed_spans, embed_prompts
    from rbg_tpu_torch.models import llama
    from rbg_tpu_torch.models.config import get_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mm = torch.backends.cuda.matmul
    cfg = get_config("llama3-8b")
    params = llama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in LENS]

    def emit(kind, **kw):
        print(json.dumps({"record": kind, **kw}), flush=True)

    gemm = {}
    blk = llama.layer_params(params, 0)
    for reduced in (True, False):
        mm.allow_bf16_reduced_precision_reduction = reduced
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            if name not in blk:
                continue
            w = blk[name]
            x = torch.randn(512, w.shape[0], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1)
                            ).to(w.dtype)
            y512, y128 = (x @ w)[:128], x[:128] @ w
            diff = (y512 != y128).any(dim=1).float().mean().item()
            d = ((y512.float() - y128.float()).norm() / y128.float().norm()).item()
            gemm[f"{name}{'' if reduced else ' exact'}"] = {
                "rows_differ": diff, "rel": d, "k_n": list(w.shape)}
    emit("gemm", **gemm)

    def pooled(p, mcfg, rows, T, hidden=llama.encode_hidden, pool_pads=False):
        B = len(rows)
        toks = np.zeros((B, T), np.int64)
        mask = np.zeros((B, T), bool)
        for i, r in enumerate(rows):
            toks[i, :len(r)] = r
            mask[i, :len(r)] = True
        m = torch.from_numpy(mask).cuda()
        h = hidden(p, mcfg, torch.from_numpy(toks).cuda(), m).float()
        w = torch.ones_like(m) if pool_pads else m
        w = w[:, :, None].float()
        return ((h * w).sum(1) / w.sum(1)).cpu().numpy()

    p32 = {k: ({n: t.float() for n, t in v.items()} if k == "blocks" else v.float())
           for k, v in params.items()}
    c32 = dataclasses.replace(cfg, dtype="float32")
    mm.allow_bf16_reduced_precision_reduction = True
    f32_alone = pooled(p32, c32, [prompts[0]], 128)[0]
    f32_batch = pooled(p32, c32, prompts, 512)[0]
    del p32
    torch.cuda.empty_cache()
    out = {"f32_T128_vs_f32_batch": rel(f32_alone, f32_batch)}
    for reduced in (True, False):
        mm.allow_bf16_reduced_precision_reduction = reduced
        tag = "" if reduced else " exact"
        batch = pooled(params, cfg, prompts, 512)
        out[f"batch_vs_f32{tag}"] = rel(batch[0], f32_alone)
        for T in (128, 256, 512):
            v = pooled(params, cfg, [prompts[0]], T)[0]
            out[f"T{T}_vs_f32{tag}"] = rel(v, f32_alone)
            out[f"T{T}_vs_batch{tag}"] = rel(v, batch[0])
    emit("alone_vs_batch", prompt_len=LENS[0], **out)

    mm.allow_bf16_reduced_precision_reduction = True
    singles = np.stack([pooled(params, cfg, [p], _chunk_bucket(len(p), 64))[0]
                        for p in prompts])
    honest = pooled(params, cfg, prompts, 512)
    real = llama.gqa_attention

    def unmasked(q, k, v, pos, valid):
        T = k.shape[1]
        return real(q, k, v, torch.full_like(pos, T - 1), torch.ones_like(valid))

    llama.gqa_attention = unmasked
    try:
        visible = pooled(params, cfg, prompts, 512)
    finally:
        llama.gqa_attention = real
    pads_pooled = pooled(params, cfg, prompts, 512, pool_pads=True)
    emit("faults", prompt_lens=list(LENS),
         honest=[rel(honest[i], singles[i]) for i in range(4)],
         pads_pooled=[rel(pads_pooled[i], singles[i]) for i in range(4)],
         pads_visible_not_causal=[rel(visible[i], singles[i]) for i in range(4)])

    eng = Engine(EngineConfig(model="llama3-8b", num_pages=64, max_seq_len=2048),
                 params=params)
    big = [rng.randint(1, cfg.vocab_size, 2048).tolist() for _ in range(32)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vecs = embed_prompts(eng, big)
    torch.cuda.synchronize()
    emit("memory", prompts=32, prompt_len=2048,
         spans=len(_embed_spans([2048] * 32, cfg.num_heads, eng.cfg.prefill_chunk)),
         seconds=time.perf_counter() - t0,
         peak_above_weights_bytes=torch.cuda.max_memory_allocated() - base,
         finite=bool(np.isfinite(np.asarray(vecs)).all()))


if __name__ == "__main__":
    main()
