"""RMSNorm, computed in float32 whatever the input dtype and cast back
(the llama-family numerics of ``rbg_tpu/ops/norms.py``). With ``rows``
the input is padded rows [Mp, D] (``ops/rows.py``), reduced in calls of
exactly ROWS rows, so a row's bits do not depend on the rows beside it."""

from __future__ import annotations

import torch

from rbg_tpu_torch.ops.rows import ROWS


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             rows: bool = False) -> torch.Tensor:
    if not rows or x.shape[0] == ROWS:
        return _rms_norm(x, weight, eps)
    return torch.cat([_rms_norm(x[i:i + ROWS], weight, eps)
                      for i in range(0, x.shape[0], ROWS)])
