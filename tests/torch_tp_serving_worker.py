"""One rank of a gloo world on the CPU for tests/test_torch_tp_serving.py.

    python tests/torch_tp_serving_worker.py WORLD RANK PORT INPUTS.npz OUT.npz

Every rank builds the same sharded engines (``Engine(mesh=...)``) and makes
the same calls with the same inputs (weights and prompts the test wrote).
Each case's tokens, first-step logits and inputs, and each rank's weight
and pool bytes, are gathered; rank 0 writes them to OUT.npz, which the test
holds against rbg_tpu's single-device engine. Imports no JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import rbg_tpu_torch.engine.engine as engine_mod  # noqa: E402
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams  # noqa: E402
from rbg_tpu_torch.engine.engine import Engine  # noqa: E402
from rbg_tpu_torch.engine.pd import PDPair, PDStreamPair  # noqa: E402
from rbg_tpu_torch.engine.service import embed_prompts  # noqa: E402
from rbg_tpu_torch.models.config import get_config  # noqa: E402
from rbg_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from rbg_tpu_torch.models.llama import init_params  # noqa: E402
from rbg_tpu_torch.parallel import make_mesh, param_specs  # noqa: E402
from rbg_tpu_torch.parallel.sharding import local_shard, split_factor  # noqa: E402

BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=16, enable_radix_cache=False, device="cpu")
OUT = {}
RESULTS = {}
FIRST = []


def recording(name, fn):
    """The engine's forward, recording the first call's inputs and logits
    (a fresh engine's first step writes into empty pools, so the test can
    replay it through the reference)."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        if not FIRST:
            n = 8 if name == "ragged" else 7
            FIRST.append(None if "lora" in kw else (
                name, [a.numpy().copy() for a in args[2:n]], out.numpy().copy()))
        return out
    return wrapper


engine_mod.forward_ragged = recording("ragged", engine_mod.forward_ragged)
engine_mod.forward_paged = recording("paged", engine_mod.forward_paged)


def tree_of(inp, model):
    flat = {}
    for key in inp.files:
        m, _, name = key.partition("/")
        if m == model:
            flat[name] = inp[key]
    tree = {k: v for k, v in flat.items() if not k.startswith("blocks.")}
    tree["blocks"] = {k[7:]: v for k, v in flat.items() if k.startswith("blocks.")}
    return params_from_numpy(tree, get_config(model), "cpu")


def nbytes(tree):
    leaves = [v for k, v in tree.items() if k != "blocks"] + list(tree["blocks"].values())
    return sum(t.numel() * t.element_size() for t in leaves)


def split_bytes(tree, mesh, model):
    """(bytes of the leaves tp or ep splits, bytes of the rest)."""
    specs = param_specs(get_config(model), tree)
    pairs = [(tree[k], specs[k]) for k in tree if k != "blocks"]
    pairs += [(w, specs["blocks"][k]) for k, w in tree["blocks"].items()]
    split = sum(w.numel() * w.element_size() for w, sp in pairs
                if any(f > 1 for f in split_factor(sp, mesh)))
    return split, sum(w.numel() * w.element_size() for w, _ in pairs) - split


def run_case(tag, model, trees, mesh, prompts, sp, lora=None, **cfg):
    FIRST.clear()
    eng = Engine(EngineConfig(model=model, **{**BASE, **cfg}), params=trees[model],
                 mesh=mesh)
    samplings = sp if isinstance(sp, list) else [sp] * len(prompts)
    if lora is not None:
        eng.load_lora("a", lora, alpha=8.0)
    ids = [eng.add_request(p, s) for p, s in zip(prompts, samplings)]
    out = {i: [] for i in ids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append(ev.token)
    RESULTS[tag] = [out[i] for i in ids]
    if FIRST[0] is not None:
        name, args, logits = FIRST[0]
        OUT[f"{tag}/first_fn"] = np.array(name)
        for j, a in enumerate(args):
            OUT[f"{tag}/first_arg{j}"] = a
        OUT[f"{tag}/first_logits"] = logits
    c = eng.cache
    pools = [c.k_pages, c.v_pages] + ([c.k_scales, c.v_scales] if c.quantized else [])
    split, rest = split_bytes(eng.params, mesh, model)
    RESULTS[f"{tag}/bytes"] = {"weights": nbytes(eng.params), "split": split, "rest": rest,
                               "pools": sum(t.numel() * t.element_size() for t in pools)}
    return eng


def refusals(world, mesh_tp, tiny):
    """The ValueErrors a sharded engine raises before any launch."""
    got = {}

    def catch(key, fn):
        try:
            fn()
            got[key] = None
        except ValueError as e:
            got[key] = str(e)

    if world == 2:
        catch("vocab", lambda: Engine(EngineConfig(model="tiny", vocab_size=255, **BASE),
                                      mesh=mesh_tp))
        catch("dense_ep", lambda: Engine(EngineConfig(model="tiny", **BASE), params=tiny,
                                         mesh=make_mesh(ep=2, device="cpu")))
    else:
        catch("num_kv_heads", lambda: Engine(EngineConfig(model="tiny", **BASE),
                                             mesh=mesh_tp))
        catch("num_heads", lambda: Engine(EngineConfig(model="qwen2-0.5b", **BASE),
                                          mesh=mesh_tp))
    return got


def main():
    world, rank, port = (int(x) for x in sys.argv[1:4])
    inp = np.load(sys.argv[4])
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    trees = {m: tree_of(inp, m) for m in ("tiny", "tiny-mla", "tiny-moe")}
    prompts = json.loads(str(inp["prompts"]))
    greedy = SamplingParams(max_new_tokens=8)
    if world == 2:
        mesh = make_mesh(tp=2, device="cpu")
        eng = run_case("tiny_auto", "tiny", trees, mesh, prompts, greedy, multi_step=4)
        RESULTS["embed/tp"] = embed_prompts(eng, prompts)
        RESULTS["embed/sp"] = embed_prompts(Engine(EngineConfig(model="tiny", **BASE),
                                                   params=trees["tiny"],
                                                   mesh=make_mesh(sp=2, device="cpu")),
                                            prompts)
        run_case("tiny_off", "tiny", trees, mesh, prompts, greedy, ragged="off")
        run_case("tiny_int8", "tiny", trees, mesh, prompts, greedy, kv_dtype="int8")
        lora = {k[5:-2]: (inp[k], inp[k[:-2] + ".B"])
                for k in inp.files if k.startswith("lora/") and k.endswith(".A")}
        run_case("tiny_lora", "tiny", trees, mesh, prompts,
                 [greedy, SamplingParams(max_new_tokens=8, lora="a"), greedy], lora=lora)
        run_case("tiny_sampled", "tiny", trees, mesh, prompts,
                 SamplingParams(max_new_tokens=8, temperature=0.9, top_k=40, seed=5))
        spec = run_case("tiny_spec", "tiny", trees, mesh,
                        json.loads(str(inp["spec_prompts"])),
                        SamplingParams(max_new_tokens=24), speculative="ngram")
        RESULTS["tiny_spec/accepted"] = spec.metrics["spec_accepted"]
        run_case("mla", "tiny-mla", trees, mesh, prompts, greedy, multi_step=4)
        run_case("moe", "tiny-moe", trees, mesh, prompts, greedy, multi_step=4)
        pair = PDPair(EngineConfig(model="tiny", **BASE), params=trees["tiny"], mesh=mesh)
        bundle = pair.prefill.prefill(prompts[1], greedy)
        OUT["pd/k"], OUT["pd/v"] = bundle.k_data, bundle.v_data
        RESULTS["pd/first"] = bundle.first_token
        RESULTS["pd"] = pair.generate(prompts, greedy)
        RESULTS["pd_stream"] = PDStreamPair(EngineConfig(model="tiny", **BASE),
                                            params=trees["tiny"], mesh=mesh,
                                            layer_split=1).generate(prompts, greedy)
        for model in ("tiny", "tiny-mla"):
            local = init_params(get_config(model), 3, "cpu", mesh=mesh)
            whole = init_params(get_config(model), 3, "cpu")
            specs = param_specs(get_config(model))
            same = all(torch.equal(local[k], local_shard(whole[k], specs[k], mesh))
                       for k in local if k != "blocks")
            same &= all(torch.equal(w, local_shard(whole["blocks"][k], specs["blocks"][k],
                                                   mesh))
                        for k, w in local["blocks"].items())
            RESULTS[f"init/{model}"] = {"equal_slices": bool(same),
                                        "bytes": nbytes(local), "whole": nbytes(whole)}
        RESULTS["refused"] = refusals(world, mesh, trees["tiny"])
    else:
        mesh = make_mesh(ep=2, tp=2, device="cpu")
        eng = run_case("moe_ep2", "tiny-moe", trees, mesh, prompts, greedy, multi_step=4)
        RESULTS["embed/ep_tp"] = embed_prompts(eng, prompts)
        RESULTS["refused"] = refusals(world, make_mesh(tp=4, device="cpu"), trees["tiny"])
    gathered = [None] * world
    dist.all_gather_object(gathered, RESULTS)
    if rank == 0:
        OUT["results"] = np.array(json.dumps(gathered))
        np.savez(sys.argv[5], **OUT)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
