"""Sharding rules and the collectives that run them
(``rbg_tpu/parallel/sharding.py``).

A spec is a tuple with one entry per tensor dim: a mesh axis name (the dim
is split over that axis) or None (replicated), as the reference's
``PartitionSpec``. The layout is Megatron's, as there:

* column-parallel projections (wq/wk/wv/w_gate/w_up, MLA's w_uk/w_uv):
  output dim on ``tp``;
* row-parallel projections (wo/w_down): input dim on ``tp``;
* embedding and lm_head: vocab dim on ``tp``;
* MoE experts on ``ep`` (and tp inside each expert), the router replicated;
* activations: batch on ``dp``, sequence on ``sp``.

Where XLA inserts the collectives from these specs in the reference, here
they are explicit ``torch.autograd.Function``s over the mesh's groups
(``ModelParallel``, which the model's functions take as ``par``):

* copy-to: identity forward, all-reduce backward, where a replicated
  activation enters a rank's own columns;
* reduce-from: all-reduce forward, identity backward, after a row-parallel
  product (wo, w_down, the experts' combine);
* the vocab-parallel embedding (ids outside the rank's rows masked, then
  reduce-from) and head (logits all-gathered before the loss).

Data-parallel and sequence-parallel gradients are all-reduced by the
train step (``models/training.py``).

Serving (``Engine(mesh=...)``) uses the same rules: each rank keeps its
slices of the weights (``shard_pytree``, or ``init_params(mesh=...)``
drawing them itself), its KV heads of a GQA pool (``PagedKVCache.create``)
and its share of a LoRA stack (``lora_specs``), and every forward runs with
``ModelParallel.of(mesh)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rbg_tpu_torch.models.config import ModelConfig
from rbg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


# Each leaf's spec by name: column-parallel projections (and their biases)
# split their output dim, row-parallel ones their input dim, experts split
# on ep with tp inside; MLA's latent down-projection and its norm, the
# norms and the router replicate. The leading dim of a block leaf is the
# layer axis (unsharded).
BLOCK_SPECS = {
    "attn_norm": (None, None), "mlp_norm": (None, None), "kv_norm": (None, None),
    "wq": (None, None, "tp"), "wk": (None, None, "tp"), "wv": (None, None, "tp"),
    "w_uk": (None, None, "tp"), "w_uv": (None, None, "tp"),
    "w_gate": (None, None, "tp"), "w_up": (None, None, "tp"),
    "wo": (None, "tp", None), "w_down": (None, "tp", None),
    "w_dkv": (None, None, None), "router": (None, None, None),
    "moe_gate": (None, "ep", None, "tp"), "moe_up": (None, "ep", None, "tp"),
    "moe_down": (None, "ep", "tp", None),
    "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
}
TOP_SPECS = {"embed": ("tp", None), "final_norm": (None,), "lm_head": (None, "tp")}


def param_specs(cfg: ModelConfig, params=None) -> dict:
    """The spec tree matching ``models.llama.init_params``. The leading
    axis of every block param is the layer axis (unsharded). Pass
    ``params`` (a tree, or the names of its block leaves) to cover the
    optional checkpoint keys the config alone cannot predict (the Qwen2
    attention biases)."""
    keys = ["attn_norm", "wq", "wo", "mlp_norm"]
    # MLA: query-side weights split by heads; the latent down-projection
    # and its norm replicate (the latent is shared by every head).
    keys += ["w_dkv", "kv_norm", "w_uk", "w_uv"] if cfg.mla else ["wk", "wv"]
    if cfg.num_experts == 0 or cfg.moe_shared_expert:
        keys += ["w_gate", "w_up", "w_down"]
    if cfg.num_experts:
        keys += ["router", "moe_gate", "moe_up", "moe_down"]
    if params is not None and "bq" in _block_keys(params):
        keys += ["bq", "bk", "bv"]
    specs = {"embed": TOP_SPECS["embed"], "blocks": {k: BLOCK_SPECS[k] for k in keys},
             "final_norm": TOP_SPECS["final_norm"]}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = TOP_SPECS["lm_head"]
    return specs


def leaf_spec(name: str) -> tuple:
    """The spec of a flattened leaf name (``embed``, ``blocks.wq``, ...),
    as ``param_specs`` gives it."""
    block = name[len("blocks."):] if name.startswith("blocks.") else None
    spec = BLOCK_SPECS.get(block) if block is not None else TOP_SPECS.get(name)
    if spec is None:
        raise ValueError(f"no sharding rule for parameter {name!r}")
    return spec


def _block_keys(params):
    if not isinstance(params, dict):
        return set(params)
    blocks = params.get("blocks", {})
    return blocks[0] if isinstance(blocks, (list, tuple)) else blocks


# LoRA targets by Megatron role: a column target's delta keeps the
# projection's output split (B's columns on tp); a row target's input
# arrives split, so A's rows are on tp and its delta joins the partial sum
# that reduce_tp adds up. MLA's w_dkv (the latent) is replicated.
LORA_COLUMN_TARGETS = ("wq", "wk", "wv", "w_gate", "w_up")
LORA_ROW_TARGETS = ("wo", "w_down")


def lora_specs(targets) -> dict:
    """{target: (spec of A [L, n, d_in, r], spec of B [L, n, r, d_out])}
    of a LoRA stack (``Engine._rebuild_lora_stack``)."""
    whole = (None,) * 4
    out = {}
    for t in targets:
        if t in LORA_COLUMN_TARGETS:
            out[t] = (whole, (None, None, None, "tp"))
        elif t in LORA_ROW_TARGETS:
            out[t] = ((None, None, "tp", None), whole)
        else:
            out[t] = (whole, whole)
    return out


def split_factor(spec: tuple, mesh) -> tuple:
    """How many ways each dim of a tensor under ``spec`` is split."""
    return tuple(axis_size(mesh, a) if a else 1 for a in spec)


def cache_specs() -> dict:
    """Specs of a contiguous KV cache's fields (k/v: [L, B, S, KV, hd])."""
    kv = (None, "dp", None, "tp", None)
    return {"k": kv, "v": kv, "length": ("dp",)}


def tokens_spec() -> tuple:
    return ("dp", None)


def logits_spec() -> tuple:
    return ("dp", None, "tp")


def shard_bounds(shape, spec: tuple, mesh) -> list:
    """This rank's ``(start, length)`` along each dim of a tensor of
    ``shape`` under ``spec`` (None for a dim it keeps whole); raises
    ``ValueError`` for a dim that does not split evenly."""
    out = []
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis) if axis else 1
        if n == 1:
            out.append(None)
            continue
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {axis}={n}")
        size = shape[dim] // n
        out.append((axis_rank(mesh, axis) * size, size))
    return out


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (a view)."""
    for dim, cut in enumerate(shard_bounds(t.shape, spec, mesh)):
        if cut is not None:
            t = t.narrow(dim, *cut)
    return t


def shard_pytree(tree: dict, specs: dict, mesh) -> dict:
    """Each leaf's ``local_shard`` (views of the caller's tensors)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec, as the reference's ``NamedSharding``."""

    mesh: object
    spec: tuple


def named(mesh, spec_tree):
    """A spec tree → a ``NamedSharding`` tree."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


# -- the Megatron collectives ------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the gradient passes as it is."""
    return _ReduceFrom.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along the last dim; the backward keeps this rank's
    columns of the (replicated) gradient."""
    return _GatherLast.apply(x, group)


class ModelParallel:
    """The tensor- and expert-parallel collectives of one rank, handed to
    the model's functions as ``par`` (``models/llama.py``)."""

    def __init__(self, mesh):
        self.tp, self.ep = axis_size(mesh, "tp"), axis_size(mesh, "ep")
        self.tp_rank, self.ep_rank = axis_rank(mesh, "tp"), axis_rank(mesh, "ep")
        self.tp_group = axis_group(mesh, "tp") if self.tp > 1 else None
        self.ep_group = axis_group(mesh, "ep") if self.ep > 1 else None

    @classmethod
    def of(cls, mesh) -> Optional["ModelParallel"]:
        """None when the mesh splits no weight (tp = ep = 1)."""
        if axis_size(mesh, "tp") == 1 and axis_size(mesh, "ep") == 1:
            return None
        return cls(mesh)

    def copy_tp(self, x):
        return x if self.tp == 1 else copy_to(x, self.tp_group)

    def reduce_tp(self, x):
        return x if self.tp == 1 else reduce_from(x, self.tp_group)

    def copy_moe(self, x):
        """Into the rank's experts (and their tp columns)."""
        x = self.copy_tp(x)
        return x if self.ep == 1 else copy_to(x, self.ep_group)

    def reduce_moe(self, x):
        x = self.reduce_tp(x)
        return x if self.ep == 1 else reduce_from(x, self.ep_group)

    def experts(self, local: int) -> Tuple[int, int]:
        """(first expert id, count) of this rank's ``local`` experts."""
        return self.ep_rank * local, local

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: this rank's rows, others' ids masked to
        zero, summed over tp."""
        if self.tp == 1:
            return table[tokens.long()]
        rows = table.shape[0]
        local = tokens.long() - self.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = table[torch.where(inside, local, 0)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
        return reduce_from(x, self.tp_group)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return logits if self.tp == 1 else gather_last(logits, self.tp_group)

    def tp_slice(self, n: int) -> slice:
        """This rank's part of ``n`` items split over tp (its KV heads)."""
        size = n // self.tp
        return slice(self.tp_rank * size, (self.tp_rank + 1) * size)

    def gather_tp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every tp rank's ``x`` joined along ``dim`` (no gradient): a
        pool's pages with all of their KV heads."""
        if self.tp == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x.contiguous(), group=self.tp_group)
        return torch.cat(parts, dim=dim)
