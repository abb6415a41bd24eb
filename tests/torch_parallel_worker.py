"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py WORLD RANK PORT INPUTS.npz OUT.npz

Every rank runs the same checks of the port's parallel plane on the inputs
the test wrote (weights and batches from a seed); rank 0 writes the
gathered results to OUT.npz, which the test holds against rbg_tpu. Imports
no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rbg_tpu_torch.models.config import get_config  # noqa: E402
from rbg_tpu_torch.models.llama import forward_train  # noqa: E402
from rbg_tpu_torch.models.training import (make_train_step, next_token_loss,  # noqa: E402
                                           stack_params)
from rbg_tpu_torch.parallel import make_mesh, param_specs, shard_pytree  # noqa: E402
from rbg_tpu_torch.parallel.mesh import axis_rank, axis_size  # noqa: E402
from rbg_tpu_torch.parallel.pipeline import pipeline_forward_train  # noqa: E402
from rbg_tpu_torch.parallel.ring import ring_attention  # noqa: E402

OUT = {}


def unshard_pytree(tree, specs, mesh):
    """The inverse of shard_pytree: every leaf whole (all-gathered along
    each split dim), on every rank."""
    if isinstance(tree, dict):
        return {k: unshard_pytree(v, specs[k], mesh) for k, v in tree.items()}
    t = tree
    for dim, axis in enumerate(specs):
        n = axis_size(mesh, axis) if axis else 1
        if n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
            t = torch.cat(parts, dim=dim)
    return t


def tree_of(inp, model):
    """The stacked parameter tree of ``model`` from the flat inputs."""
    tree = {"blocks": {}}
    for key in inp.files:
        m, _, name = key.partition("/")
        if m != model:
            continue
        if name.startswith("blocks."):
            tree["blocks"][name[7:]] = torch.from_numpy(inp[key].copy())
        else:
            tree[name] = torch.from_numpy(inp[key].copy())
    return tree


def flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def leaves(tree):
    return [v for k, v in tree.items() if k != "blocks"] + list(tree["blocks"].values())


def gather_seq(t, mesh, dim=1):
    """This rank's sequence shard → the whole sequence (over sp)."""
    n = axis_size(mesh, "sp")
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("sp"))
    return torch.cat(parts, dim=dim)


def ring_check(inp, sp):
    mesh = make_mesh(sp=sp, device="cpu")
    T = inp["rq"].shape[1]
    lo, hi = axis_rank(mesh, "sp") * T // sp, (axis_rank(mesh, "sp") + 1) * T // sp
    q, k, v = (torch.from_numpy(inp[n][:, lo:hi].copy()).requires_grad_()
               for n in ("rq", "rk", "rv"))
    pos, kvpos = (torch.from_numpy(inp[n][:, lo:hi].copy()) for n in ("rpos", "rkvpos"))
    out = ring_attention(q, k, v, pos, kvpos, mesh)
    (out * torch.from_numpy(inp["rcot"][:, lo:hi].copy())).sum().backward()
    for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        OUT[f"ring{sp}/{name}"] = gather_seq(t.detach(), mesh).numpy()


def loss_and_grads(inp, model, mesh, tag, remat=False, masked=True):
    """The global loss and every leaf's whole gradient under ``mesh``, each
    rank holding its shards and its dp rows."""
    cfg = get_config(model)
    full = tree_of(inp, model)
    specs = param_specs(cfg, full)
    local = shard_pytree(full, specs, mesh)
    local = {k: ({n: w.clone().requires_grad_() for n, w in v.items()} if k == "blocks"
                 else v.clone().requires_grad_()) for k, v in local.items()}
    tokens = torch.from_numpy(inp["tokens"].copy())
    mask = torch.from_numpy(inp["mask"].copy()) if masked else None
    dp = axis_size(mesh, "dp")
    rows = slice(axis_rank(mesh, "dp") * tokens.shape[0] // dp,
                 (axis_rank(mesh, "dp") + 1) * tokens.shape[0] // dp)
    loss = next_token_loss(local, cfg, tokens[rows], None if mask is None else mask[rows],
                           mesh=mesh, remat=remat)
    loss.backward()
    for axis in ("dp", "sp"):
        if axis_size(mesh, axis) > 1:
            for t in leaves(local):
                dist.all_reduce(t.grad, group=mesh.get_group(axis))
    grads = {k: ({n: w.grad for n, w in v.items()} if k == "blocks" else v.grad)
             for k, v in local.items()}
    OUT[f"{tag}/loss"] = loss.detach().numpy()
    for name, g in flat(unshard_pytree(grads, specs, mesh)).items():
        OUT[f"{tag}/grad/{name}"] = g.numpy()


def logits_check(inp, model, mesh, tag):
    """forward_train's logits under ``mesh`` (rank 0's dp rows, all
    positions)."""
    cfg = get_config(model)
    full = tree_of(inp, model)
    local = shard_pytree(full, param_specs(cfg, full), mesh)
    tokens = torch.from_numpy(inp["tokens"].copy())
    mask = torch.from_numpy(inp["mask"].copy())
    with torch.no_grad():
        logits = forward_train(local, cfg, tokens, mask, mesh=mesh)
    OUT[f"{tag}/logits"] = gather_seq(logits, mesh).numpy()


def train_check(inp, mesh, tag, n=3):
    """n steps of make_train_step over ``mesh`` on tiny: the last loss and
    the whole params after."""
    cfg = get_config("tiny")
    full = tree_of(inp, "tiny")
    init_fn, step = make_train_step(cfg, mesh)
    params, opt = init_fn(full)
    tokens = torch.from_numpy(inp["tokens"].copy())
    for _ in range(n):
        params, opt, loss = step(params, opt, tokens)
    OUT[f"{tag}/loss"] = loss.numpy()
    whole = unshard_pytree(stack_params(params), param_specs(cfg, full), mesh)
    for name, t in flat(whole).items():
        OUT[f"{tag}/param/{name}"] = t.numpy()


def pipeline_check(inp):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pp",))
    cfg = get_config("tiny")
    tokens = torch.from_numpy(inp["tokens"].copy())
    mask = torch.from_numpy(inp["mask"].copy())
    full = tree_of(inp, "tiny")
    with torch.no_grad():
        for micro in (4, 2):
            OUT[f"pp/micro{micro}"] = pipeline_forward_train(
                full, cfg, tokens, mesh=mesh, num_microbatches=micro).numpy()
        OUT["pp/masked"] = pipeline_forward_train(
            full, cfg, tokens, mask, mesh=mesh, num_microbatches=4).numpy()
    params = {k: ({n: w.clone().requires_grad_() for n, w in v.items()} if k == "blocks"
                  else v.clone().requires_grad_()) for k, v in full.items()}
    logits = pipeline_forward_train(params, cfg, tokens, mesh=mesh, num_microbatches=2)
    (logits.float() ** 2).mean().backward()
    for name, t in flat(params).items():
        g = t.grad
        if name.startswith("blocks."):      # each stage holds its own layers'
            dist.all_reduce(g, group=mesh.get_group("pp"))
        OUT[f"pp/grad/{name}"] = g.numpy()


def main():
    world, rank, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    inp = np.load(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    torch.manual_seed(0)
    ring_check(inp, world)
    if world == 2:
        loss_and_grads(inp, "tiny", make_mesh(dp=2, device="cpu"), "dp2")
        loss_and_grads(inp, "tiny", make_mesh(sp=2, device="cpu"), "sp2_remat",
                       remat=True)
        loss_and_grads(inp, "tiny-mla", make_mesh(tp=2, device="cpu"), "mla_tp2")
        logits_check(inp, "tiny-mla", make_mesh(tp=2, device="cpu"), "mla_tp2")
        loss_and_grads(inp, "tiny-moe", make_mesh(ep=2, device="cpu"), "moe_ep2")
        logits_check(inp, "tiny-moe", make_mesh(ep=2, device="cpu"), "moe_ep2")
        pipeline_check(inp)
    else:
        loss_and_grads(inp, "tiny", make_mesh(sp=2, tp=2, device="cpu"), "sp2tp2",
                       masked=False)
        loss_and_grads(inp, "tiny", make_mesh(sp=2, tp=2, device="cpu"), "sp2tp2_remat",
                       remat=True)
        loss_and_grads(inp, "tiny", make_mesh(dp=2, tp=2, device="cpu"), "dp2tp2")
        loss_and_grads(inp, "tiny-moe", make_mesh(ep=2, tp=2, device="cpu"), "moe_ep2tp2")
        train_check(inp, make_mesh(dp=2, tp=2, device="cpu"), "train_dp2tp2")
    dist.barrier()
    if rank == 0:
        np.savez(sys.argv[5], **OUT)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
