"""Weight bridge: a reference parameter tree as numpy arrays → this
package's parameter dict, value for value.

The caller turns the JAX tree into numpy (``jax.tree.map(np.asarray,
params)``); this module never sees JAX. A bfloat16 JAX array arrives as an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` refuses, so
such arrays travel as their uint16 bit patterns and are viewed back as
``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from rbg_tpu_torch.models.config import ModelConfig


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device) if device is not None else t


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """Convert ``{"embed", "blocks": {...}, "final_norm", ["lm_head"]}``.
    Every array keeps its layout and dtype; a dtype other than cfg's is
    refused rather than silently cast."""
    want = cfg.torch_dtype

    def conv(a):
        t = tensor_from_numpy(a, device)
        if t.dtype != want:
            raise TypeError(f"weight dtype {t.dtype} does not match the "
                            f"config's {want}")
        return t

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: conv(v) for k, v in tree["blocks"].items()}
    return out
