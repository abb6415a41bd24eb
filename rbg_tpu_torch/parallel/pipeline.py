"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis
(``rbg_tpu/parallel/pipeline.py``).

The block stack's layer axis splits across the stages (stage s owns layers
``[s·L/S, (s+1)·L/S)``); microbatches flow stage to stage through
``ring.shift`` with no wraparound (stage 0 receives zeros). As in the
reference's SPMD form, every stage runs every one of the ``M + S - 1``
steps, stage s on microbatch ``t - s`` (clipped), and the last stage's
outputs, summed to every stage, are the result. Schedule: plain fill-drain,
bubble ``(S - 1) / (M + S - 1)``.

Gradients: the embedding's output enters through a copy-to over ``pp``
and the result leaves through a reduce-from, so the embedding, final norm
and head get the whole gradient on every stage; each stage's block
gradients are its own layers' (zero elsewhere in a stacked tensor), so a
caller sums the block gradients over ``pp``. The mesh is a one-dim
``DeviceMesh`` named ``pp``, as the reference's tests build a one-axis
``Mesh(devices, ("pp",))``. The train step does not call the pipeline, as
the reference's does not either.
"""

from __future__ import annotations

import torch

from rbg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from rbg_tpu_torch.parallel.ring import shift
from rbg_tpu_torch.parallel.sharding import copy_to, reduce_from


def _num_layers(params_blocks) -> int:
    if isinstance(params_blocks, (list, tuple)):
        return len(params_blocks)
    return next(iter(params_blocks.values())).shape[0]


def pipeline_blocks(params_blocks, cfg, x: torch.Tensor, token_mask: torch.Tensor,
                    mesh, num_microbatches: int, axis: str = "pp") -> torch.Tensor:
    """The block stack through the pipeline. x: [B, T, D] embeddings;
    token_mask: [B, T]. Returns the final hidden states [B, T, D] on every
    stage. B must divide by ``num_microbatches``, L by the pp size."""
    import torch.distributed as dist

    from rbg_tpu_torch.models.llama import _train_block, layer_params

    B, T, D = x.shape
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    S = axis_size(mesh, axis)
    L = _num_layers(params_blocks)
    if L % S:
        raise ValueError(f"layers {L} not divisible by pp={S}")
    group, stage = axis_group(mesh, axis), axis_rank(mesh, axis)
    local = [layer_params({"blocks": params_blocks}, stage * (L // S) + j)
             for j in range(L // S)]
    dst = dist.get_global_rank(group, stage + 1) if stage < S - 1 else None
    src = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    x_micro = copy_to(x, group).reshape(M, B // M, T, D)
    mask_micro = token_mask.reshape(M, B // M, T)
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B // M, T)
    first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros((B // M, T, D), dtype=x.dtype, device=x.device)
    outs = [buf] * M
    for t in range(M + S - 1):
        mb = min(max(t - stage, 0), M - 1)
        h = torch.where(first, x_micro[mb], buf)
        for blk in local:
            h = _train_block(cfg, blk, h, positions, mask_micro[mb])
        # The last stage finished microbatch t - (S - 1): record it when
        # valid. A select, as in the reference, on every stage: each step's
        # output stays in the graph, so every stage's backward runs every
        # shift its neighbours run.
        idx = min(max(t - (S - 1), 0), M - 1)
        valid = stage == S - 1 and 0 <= t - (S - 1) < M
        outs[idx] = torch.where(torch.tensor(valid, device=x.device), h, outs[idx])
        if t < M + S - 2:          # the last step's shift would feed nothing
            buf = shift(h, group, dst, src)
    return reduce_from(torch.stack(outs), group).reshape(B, T, D)


def pipeline_forward_train(params: dict, cfg, tokens: torch.Tensor,
                           token_mask=None, *, mesh, num_microbatches: int = 0,
                           axis: str = "pp") -> torch.Tensor:
    """``forward_train`` with the block stack pipelined over ``axis``:
    logits [B, T, V] float32 on every stage."""
    from rbg_tpu_torch.models.llama import _embed, _head

    B, T = tokens.shape
    if token_mask is None:
        token_mask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    if not num_microbatches:
        num_microbatches = min(B, max(2 * axis_size(mesh, axis), 1))
        while B % num_microbatches:
            num_microbatches -= 1
    x = _embed(params, cfg, tokens)
    h = pipeline_blocks(params["blocks"], cfg, x, token_mask, mesh,
                        num_microbatches, axis=axis)
    return _head(params, cfg, h)
