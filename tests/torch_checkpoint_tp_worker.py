"""One rank of a gloo world of 2 on the CPU for tests/test_torch_checkpoint_tp.py.

    python tests/torch_checkpoint_tp_worker.py RANK PORT CASES.json OUT_DIR

Every rank reads the checkpoints the test wrote under a mesh (tp 2, or
ep 2 for tiny-moe), each its own slices straight from the file
(``load_checkpoint`` / ``load_hf_llama`` with ``mesh=``), and writes them
with the read's counts to OUT_DIR/rank<R>.npz; then builds
``Engine(EngineConfig(checkpoint_path=...), mesh=...)`` beside
``Engine(mesh=..., params=<the whole tree>)`` and records both engines'
params and greedy tokens, and the refusals that must come before any byte
is read. Imports no JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams  # noqa: E402
from rbg_tpu_torch.engine.engine import Engine  # noqa: E402
from rbg_tpu_torch.models import safetensors_io  # noqa: E402
from rbg_tpu_torch.models.checkpoint import (load_checkpoint, load_hf_llama,  # noqa: E402
                                             load_params)
from rbg_tpu_torch.models.config import get_config  # noqa: E402
from rbg_tpu_torch.parallel import make_mesh  # noqa: E402

BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=16, enable_radix_cache=False, device="cpu")
PROMPTS = [[5, 6, 7], [9] * 11, list(range(40, 60))]
OUT, RESULTS = {}, {}


def flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def store(tag, tree):
    for k, t in flat(tree).items():
        OUT[f"{tag}/{k}"] = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def counted(fn):
    """fn()'s result and what the read copied out (bytes, tensors, largest
    host staging buffer)."""
    safetensors_io.reset_reads()
    out = fn()
    return out, dict(safetensors_io.READS)


def refused(fn):
    """The ValueError fn raises and the bytes read before it."""
    safetensors_io.reset_reads()
    try:
        fn()
    except ValueError as e:
        return {"error": str(e), "bytes": safetensors_io.READS["bytes"]}
    return {"error": None, "bytes": safetensors_io.READS["bytes"]}


def main():
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        cases = json.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    meshes = {"tp2": make_mesh(tp=2, device="cpu"), "ep2": make_mesh(ep=2, device="cpu")}
    for tag, (path, model, axes) in cases["native"].items():
        tree, RESULTS[f"{tag}/reads"] = counted(
            lambda: load_checkpoint(path, device="cpu", mesh=meshes[axes]))
        store(tag, tree)
        # The rank's own tree is a `like` that matches; the whole tree is not.
        RESULTS[f"{tag}/like_ok"] = refused(
            lambda: load_checkpoint(path, like=tree, mesh=meshes[axes]))["error"] is None
        whole = load_checkpoint(path, device="cpu")
        RESULTS[f"{tag}/like_whole"] = refused(
            lambda: load_checkpoint(path, like=whole, mesh=meshes[axes]))
    mesh = meshes["tp2"]
    for tag, path in cases["hf"].items():
        tree, RESULTS[f"{tag}/reads"] = counted(
            lambda: load_hf_llama(path, get_config("tiny"), "cpu", mesh))
        store(tag, tree)
    sp = SamplingParams(max_new_tokens=8)
    for tag, path in cases["engine"].items():
        whole = load_params(path, get_config("tiny"), device="cpu")
        want = Engine(EngineConfig(model="tiny", **BASE), params=whole, mesh=mesh)
        eng, reads = counted(lambda: Engine(EngineConfig(model="tiny", checkpoint_path=path,
                                                         **BASE), mesh=mesh))
        a, b = flat(eng.params), flat(want.params)
        RESULTS[f"engine/{tag}"] = {
            "reads": reads, "same_names": sorted(a) == sorted(b),
            "equal_params": sorted(a) == sorted(b) and all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
            "tokens": eng.generate(PROMPTS, sp), "want": want.generate(PROMPTS, sp)}
    RESULTS["refused/uneven_read"] = refused(
        lambda: load_checkpoint(cases["uneven"], device="cpu", mesh=mesh))
    RESULTS["refused/uneven_engine"] = refused(
        lambda: Engine(EngineConfig(model="tiny", vocab_size=255,
                                    checkpoint_path=cases["uneven"], **BASE), mesh=mesh))
    RESULTS["refused/uneven_hf"] = refused(
        lambda: load_hf_llama(cases["uneven_hf"], get_config("tiny", vocab_size=255),
                              "cpu", mesh))
    OUT["results"] = np.array(json.dumps(RESULTS))
    np.savez(os.path.join(sys.argv[4], f"rank{rank}.npz"), **OUT)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
