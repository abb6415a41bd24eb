"""Training step: next-token cross-entropy and AdamW, optionally over a
mesh (``rbg_tpu/models/training.py``).

The optimizer is the reference's ``optax.adamw(learning_rate)``: b1 0.9,
b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf, moments in each
parameter's dtype. ``torch.optim.AdamW`` with those arguments computes the
same update (its decay before the step and optax's decay added to the
step are the same sum); on the card it runs fused, never the ``foreach``
path, whose whole-group temporaries (a square root of every second moment
at once) do not fit beside an 8B model's state on one card.

The trainer holds one leaf per layer and weight (``params["blocks"]`` a
list of per-layer dicts): a stacked ``[L, ...]`` leaf indexed per layer
would make each layer's backward write a zero-filled gradient of the whole
stack. ``init_fn`` splits the reference's stacked tree (copying it, so the
caller's tree survives, as the reference's does) and ``stack_params``
stacks it back for checkpoints and comparisons. The step updates the
leaves in place.

With a ``DeviceMesh`` (``parallel/``) each rank holds its shards of the
params and its ``dp`` rows of the batch; the loss is the reference's one
mean over every unmasked target of the global batch (the token count is
summed over dp before dividing; under ``sp`` each rank takes the targets
of its own positions from the whole sequence), and the gradients are
summed over ``dp`` and ``sp``. A mesh is None at world size 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from rbg_tpu_torch.models.config import ModelConfig
from rbg_tpu_torch.models.llama import forward_train, seq_range

ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _loss_positions(mesh, T: int) -> Tuple[int, int]:
    """The positions whose next-token terms this rank adds: its ring shard,
    or (sp > 1 without a ring) its share of the replicated sequence, so
    that every term is counted once over sp."""
    from rbg_tpu_torch.parallel.mesh import axis_rank, axis_size

    lo, hi = seq_range(mesh, T)
    sp = axis_size(mesh, "sp")
    if hi - lo == T and sp > 1:
        s = axis_rank(mesh, "sp")
        lo, hi = s * T // sp, (s + 1) * T // sp
    return lo, min(hi, T - 1)


def next_token_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    token_mask: Optional[torch.Tensor] = None, mesh=None,
                    remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over non-pad targets (float32
    log-softmax; the mean over ``token_mask[:, 1:]``, divided by at least
    1). With a mesh, ``tokens`` are this rank's dp rows and the result is
    the global mean on every rank."""
    from rbg_tpu_torch.parallel.mesh import axis_group, axis_size
    from rbg_tpu_torch.parallel.sharding import reduce_from

    B, T = tokens.shape
    if token_mask is None:
        token_mask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    logits = forward_train(params, cfg, tokens, token_mask, mesh=mesh, remat=remat)
    lo = seq_range(mesh, T)[0]
    a, b = _loss_positions(mesh, T)
    logp = F.log_softmax(logits[:, a - lo:b - lo].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, a + 1:b + 1].long()[..., None])[..., 0]
    w = token_mask[:, a + 1:b + 1].float()
    count = token_mask[:, 1:].float().sum()
    if axis_size(mesh, "dp") > 1:
        dist.all_reduce(count, group=axis_group(mesh, "dp"))
    loss = (nll * w).sum() / torch.clamp(count, min=1.0)
    for axis in ("dp", "sp"):
        if axis_size(mesh, axis) > 1:
            loss = reduce_from(loss, axis_group(mesh, axis))
    return loss


def param_leaves(params: dict):
    """Every tensor of a trainer's tree, in a fixed order."""
    out = [v for k, v in params.items() if k != "blocks"]
    for blk in params["blocks"]:
        out.extend(blk.values())
    return out


def stack_params(params: dict) -> dict:
    """A trainer's per-layer tree → the reference's stacked layout
    (detached copies)."""
    out = {k: v.detach().clone() for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    out["blocks"] = {k: torch.stack([blk[k].detach() for blk in blocks])
                     for k in blocks[0]}
    return out


def _trainer_device(mesh, device) -> torch.device:
    if mesh is not None:
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(mesh.device_type)
    from rbg_tpu_torch.engine.config import resolve_device
    return resolve_device(device)


def make_train_step(cfg: ModelConfig, mesh=None, learning_rate: float = 3e-4,
                    remat: bool = False, device=None):
    """Build ``(init_fn, step)``. ``init_fn(params)`` takes a stacked tree
    (the reference's layout, on any device) and returns ``(params,
    opt_state)``: this rank's shards as per-layer leaves on the trainer's
    device, and the AdamW optimizer over them. ``step(params, opt_state,
    tokens)`` takes the global ``[B, T]`` batch, updates
    the params in place and returns ``(params, opt_state, loss)``, the loss
    before the update. The device is the mesh's, else ``device`` (the card
    unless the CPU is asked for; without a card this raises)."""
    from rbg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
    from rbg_tpu_torch.parallel.sharding import param_specs, shard_pytree

    dev = _trainer_device(mesh, device)
    dp = axis_size(mesh, "dp")
    reduce_over = [axis_group(mesh, a) for a in ("dp", "sp") if axis_size(mesh, a) > 1]

    def init_fn(params: dict):
        if mesh is not None:
            params = shard_pytree(params, param_specs(cfg, params), mesh)
        out = {k: v.detach().to(dev, copy=True) for k, v in params.items()
               if k != "blocks"}
        blocks = params["blocks"]
        if not isinstance(blocks, (list, tuple)):
            blocks = [{k: w[l] for k, w in blocks.items()}
                      for l in range(cfg.num_layers)]
        out["blocks"] = [{k: w.detach().to(dev, copy=True) for k, w in blk.items()}
                         for blk in blocks]
        leaves = param_leaves(out)
        for t in leaves:
            t.requires_grad_()
        kw = {"fused": True} if dev.type == "cuda" else {"foreach": False}
        return out, torch.optim.AdamW(leaves, lr=learning_rate, **ADAMW, **kw)

    def step(params: dict, opt_state, tokens: torch.Tensor):
        tokens = tokens.to(dev)
        if dp > 1:
            B = tokens.shape[0]
            if B % dp:
                raise ValueError(f"batch {B} does not split over dp={dp}")
            r = axis_rank(mesh, "dp")
            tokens = tokens[r * (B // dp):(r + 1) * (B // dp)]
        opt_state.zero_grad(set_to_none=True)
        loss = next_token_loss(params, cfg, tokens, mesh=mesh, remat=remat)
        loss.backward()
        for group in reduce_over:
            for t in param_leaves(params):
                dist.all_reduce(t.grad, group=group)
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step


def train_n_steps(cfg: ModelConfig, mesh, params: dict, tokens: torch.Tensor,
                  n: int, device=None) -> Tuple[dict, torch.Tensor]:
    """Run n steps; return (params in the reference's stacked layout, the
    last step's loss)."""
    init_fn, step = make_train_step(cfg, mesh, device=device)
    params, opt_state = init_fn(params)
    loss = None
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, tokens)
    return stack_params(params), loss
