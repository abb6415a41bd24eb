"""Tensor-parallel serving (``Engine(mesh=...)``) in gloo worlds of 2 and 4
CPU processes against rbg_tpu's single-device engine (use_pallas="never")
on the same weights, float32: tiny at tp 2 (ragged auto and off, int8
pools, a LoRA row, a seeded sampled request, speculative ngram), tiny-mla
at tp 2, tiny-moe at tp 2 and at ep 2 x tp 2, a PDPair and a
PDStreamPair at tp 2, each
rank's weight and pool bytes, the rank-local init, embeddings over tp,
sp and ep x tp, and the refusals.

Each world is one spawn (tests/torch_tp_serving_worker.py) that runs every
case and writes an .npz. Greedy and seeded tokens must be identical on
every rank and to the reference; the first step's logits, replayed through
the reference's forward on its inputs, within 1e-4."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.kvcache import PagedKVCache as JPagedKVCache
from rbg_tpu.engine.pd import PDPair as JPDPair
from rbg_tpu.engine.service import embed_prompts as j_embed_prompts
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import forward_paged as j_forward_paged
from rbg_tpu.models.llama import forward_ragged as j_forward_ragged
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.parallel import param_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_serving_worker.py")
MODELS = ("tiny", "tiny-mla", "tiny-moe")
BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=16, enable_radix_cache=False)
LOGIT_ATOL = 1e-4
GREEDY = dict(max_new_tokens=8)
# case → (world, model, engine config, samplings by prompt, prompts): the
# speculative case's repetitive rows draft and accept (tests/test_torch_spec.py)
SPEC_PROMPTS = [[1, 2, 3, 4] * 8, [9, 8, 7, 6, 5], [4] * 8]
CASES = {
    "tiny_auto": (2, "tiny", dict(multi_step=4), None, None),
    "tiny_off": (2, "tiny", dict(ragged="off"), None, None),
    "tiny_int8": (2, "tiny", dict(kv_dtype="int8"), None, None),
    "tiny_lora": (2, "tiny", {}, [GREEDY, dict(GREEDY, lora="a"), GREEDY], None),
    "tiny_sampled": (2, "tiny", {}, dict(max_new_tokens=8, temperature=0.9, top_k=40,
                                         seed=5), None),
    "tiny_spec": (2, "tiny", dict(speculative="ngram"), dict(max_new_tokens=24),
                  SPEC_PROMPTS),
    "mla": (2, "tiny-mla", dict(multi_step=4), None, None),
    "moe": (2, "tiny-moe", dict(multi_step=4), None, None),
    "moe_ep2": (4, "tiny-moe", dict(multi_step=4), None, None),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    params = {m: j_init(j_get_config(m), jax.random.key(0)) for m in MODELS}
    flat = {}
    for m, tree in params.items():
        for k, v in tree.items():
            if k == "blocks":
                flat.update({f"{m}/blocks.{n}": np.asarray(w) for n, w in v.items()})
            else:
                flat[f"{m}/{k}"] = np.asarray(v)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 19, 11)]
    cfg = j_get_config("tiny")
    d, hd, H, KV, F, L, r = (cfg.hidden_size, cfg.head_dim_, cfg.num_heads,
                             cfg.num_kv_heads, cfg.intermediate_size, cfg.num_layers, 4)
    dims = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd), "wo": (H * hd, d),
            "w_gate": (d, F), "w_up": (d, F), "w_down": (F, d)}
    lora = {t: ((rng.randn(L, i, r) * 0.1).astype(np.float32),
                (rng.randn(L, r, o) * 0.1).astype(np.float32)) for t, (i, o) in dims.items()}
    for t, (A, B) in lora.items():
        flat[f"lora/{t}.A"], flat[f"lora/{t}.B"] = A, B
    flat["prompts"] = np.array(json.dumps(prompts))
    flat["spec_prompts"] = np.array(json.dumps(SPEC_PROMPTS))
    return params, flat, prompts, lora


def _spawn(world, inp, tmp):
    path = os.path.join(tmp, f"in{world}.npz")
    out = os.path.join(tmp, f"out{world}.npz")
    np.savez(path, **inp)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(world), str(r), str(port),
                               path, out], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = dict(np.load(out))
    got["results"] = json.loads(str(got["results"]))
    return got


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, inputs[1], str(tmp_path_factory.mktemp(f"w{world}")))
        return cache[world]
    return get


def _reference(jp, model, cfg, prompts, samplings, lora):
    eng = JEngine(JConfig(model=model, use_pallas="never", **BASE, **cfg), params=jp)
    if lora is not None:
        eng.load_lora("a", lora, alpha=8.0)
    ids = [eng.add_request(p, JSampling(**s)) for p, s in zip(prompts, samplings)]
    out = {i: [] for i in ids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append(ev.token)
    return [out[i] for i in ids]


def _replay(jp, model, cfg, got, case):
    """The reference's forward on the inputs of the sharded engine's first
    step, over empty pools as that step found them; and the step's token
    mask (a pad's logits are never read)."""
    jcfg = j_get_config(model)
    c = JPagedKVCache.create(jcfg, BASE["num_pages"], BASE["page_size"],
                             quantize=cfg.get("kv_dtype") == "int8")
    args = [got[f"{case}/first_arg{j}"] for j in range(6 if str(got[f"{case}/first_fn"])
                                                         == "ragged" else 5)]
    kw = dict(use_pallas="never", k_scales=c.k_scales, v_scales=c.v_scales)
    if str(got[f"{case}/first_fn"]) == "ragged":
        out = j_forward_ragged(jp, jcfg, *args, c.k_pages, c.v_pages,
                               max_q_len=BASE["prefill_chunk"], **kw)
    else:
        out = j_forward_paged(jp, jcfg, *args, c.k_pages, c.v_pages, **kw)
    return np.asarray(out[0]), args[2]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_engine_matches_reference(case, inputs, worlds):
    """Every rank's tokens equal rbg_tpu's single-device engine's; the
    first step's logits within LOGIT_ATOL of the reference's forward."""
    params, _, prompts, lora = inputs
    world, model, cfg, samplings, own_prompts = CASES[case]
    prompts = own_prompts or prompts
    if not isinstance(samplings, list):
        samplings = [samplings or GREEDY] * len(prompts)
    got = worlds(world)
    want = _reference(params[model], model, cfg, prompts, samplings,
                      lora if case == "tiny_lora" else None)
    for r, res in enumerate(got["results"]):
        assert res[case] == want, f"rank {r}: {res[case]} vs reference {want}"
    if case == "tiny_spec":
        assert got["results"][0]["tiny_spec/accepted"] > 0
    if case != "tiny_lora":
        ref, real = _replay(params[model], model, cfg, got, case)
        np.testing.assert_allclose(got[f"{case}/first_logits"][real], ref[real], rtol=0,
                                   atol=LOGIT_ATOL)


def test_pd_pair_bundle_and_tokens_match_reference(inputs, worlds):
    """A PDPair at tp 2: its bundle carries the unsharded pair's bytes (every
    KV head, the same shapes and dtype; values within 1e-4), and its
    tokens, and a PDStreamPair's, equal the reference pair's."""
    params, _, prompts, _ = inputs
    got = worlds(2)
    pair = JPDPair(JConfig(model="tiny", use_pallas="never", **BASE), params=params["tiny"])
    bundle = pair.prefill.prefill(prompts[1], JSampling(**GREEDY))
    for name, want in (("k", bundle.k_data), ("v", bundle.v_data)):
        have = got[f"pd/{name}"]
        assert have.shape == np.asarray(want).shape and have.dtype == np.asarray(want).dtype
        assert have.nbytes == np.asarray(want).nbytes
        np.testing.assert_allclose(have, np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert got["results"][0]["pd/first"] == bundle.first_token
    want = JPDPair(JConfig(model="tiny", use_pallas="never", **BASE),
                   params=params["tiny"]).generate(prompts, JSampling(**GREEDY))
    for res in got["results"]:
        assert res["pd"] == want
        assert res["pd_stream"] == want     # chunk streams, a layer per chunk


def _whole_bytes(tree, model, world_tp):
    """(bytes of the leaves a mesh splits, the rest) of the whole tree."""
    specs = param_specs(get_config(model))
    pairs = [(tree[k], specs[k]) for k in tree if k != "blocks"]
    pairs += [(w, specs["blocks"][k]) for k, w in tree["blocks"].items()]
    split = sum(np.asarray(w).nbytes for w, sp in pairs
                if any(a in world_tp for a in sp if a))
    return split, sum(np.asarray(w).nbytes for w, _ in pairs) - split


@pytest.mark.parametrize("case", ["tiny_auto", "tiny_int8", "mla", "moe", "moe_ep2"])
def test_rank_holds_its_share(case, inputs, worlds):
    """Each rank holds 1/n of every leaf split n ways (tp 2; ep 2 x tp 2:
    the experts 1/4, the rest of the split leaves 1/2) and the replicated
    rest whole; a GQA pool's KV heads 1/tp, an MLA latent pool whole."""
    params, _, _, _ = inputs
    world, model, cfg, _, _ = CASES[case]
    got = worlds(world)
    split, rest = _whole_bytes(params[model], model, {"tp", "ep"})
    specs = param_specs(get_config(model))
    tree = params[model]
    want_split = 0
    for k, w in [(k, tree[k]) for k in tree if k != "blocks"] + list(tree["blocks"].items()):
        sp = specs[k] if k in specs else specs["blocks"][k]
        n = (2 if "tp" in sp else 1) * (2 if "ep" in sp and world == 4 else 1)
        if n > 1:
            want_split += np.asarray(w).nbytes // n
    jcfg = j_get_config(model)
    c = JPagedKVCache.create(jcfg, BASE["num_pages"], BASE["page_size"],
                             quantize=cfg.get("kv_dtype") == "int8")
    pools = [c.k_pages, c.v_pages] + ([c.k_scales, c.v_scales] if c.k_scales is not None
                                      else [])
    pool_bytes = sum(np.asarray(t).nbytes for t in pools)
    for res in got["results"]:
        b = res[f"{case}/bytes"]
        assert (b["split"], b["rest"]) == (want_split, rest) and split > 0
        assert b["pools"] == (pool_bytes if jcfg.mla else pool_bytes // 2)


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_rank_local_init_draws_the_whole_trees_slices(model, worlds):
    """init_params(mesh=...) keeps each weight's slice of the whole draw,
    bit for bit, and holds less than the whole tree."""
    for res in worlds(2)["results"]:
        r = res[f"init/{model}"]
        assert r["equal_slices"] and r["bytes"] < r["whole"]


@pytest.mark.parametrize("world,key,model", [(2, "tp", "tiny"), (2, "sp", "tiny"),
                                             (4, "ep_tp", "tiny-moe")])
def test_embeddings_on_the_mesh_match_reference(world, key, model, inputs, worlds):
    """embed_prompts on a sharded engine (tp 2; sp 2: ring attention, each
    rank's positions gathered; ep 2 x tp 2) equals the reference's within
    LOGIT_ATOL on every rank."""
    params, _, prompts, _ = inputs
    ref = JEngine(JConfig(model=model, use_pallas="never", **BASE), params=params[model])
    want = np.asarray(j_embed_prompts(ref, prompts))
    for res in worlds(world)["results"]:
        np.testing.assert_allclose(np.asarray(res[f"embed/{key}"]), want, rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("world,key,needle,roadmap", [
    (2, "vocab", "vocab_size=255", True), (2, "host_tier", "host KV tier under tp", True),
    (2, "service", "multi-rank EngineService", True), (2, "admit_layers", "multi-rank", True),
    (2, "dense_ep", "a dense model", False),
    (4, "num_kv_heads", "num_kv_heads=2", True), (4, "num_heads", "num_heads=14", True)])
def test_refusals_name_the_roadmap_item(world, key, needle, roadmap, worlds):
    """A mesh the engine cannot serve is a ValueError before any launch,
    naming the ROADMAP.md item that lifts it; an ep axis on a dense model,
    which has no experts to split, names none."""
    for res in worlds(world)["results"]:
        msg = res["refused"][key]
        assert msg is not None and needle in msg, msg
        assert ("ROADMAP.md" in msg) == roadmap, msg
