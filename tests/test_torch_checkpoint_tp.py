"""Rank-local checkpoint reads under a mesh (models/checkpoint.py and
models/safetensors_io.py with ``mesh=``) against rbg_tpu's sharded restore,
on the CPU, in one spawned gloo world of 2 (tests/torch_checkpoint_tp_worker.py).

Native checkpoints of tiny, tiny-mla and tiny-moe (tp 2; tiny-moe also ep
2) are held against ``rbg_tpu.models.checkpoint.load_checkpoint(path,
like=<the sharded tree>)``, each rank's read against the restored array's
shard on the device of its mesh coordinate; HF directories (llama and
Qwen2 layouts, one file, a sharded index, bf16, ``pytorch_model.bin``)
against rbg_tpu's importer's tree put on the mesh by its
``shard_pytree``. Bit for bit. Each rank copies out exactly its share of
the file's bytes and stages at most one layer's slice of one tensor;
``Engine(EngineConfig(checkpoint_path=...), mesh=...)`` holds the params
and gives the greedy tokens of ``Engine(mesh=..., params=<whole tree>)``;
an uneven split and a mismatched ``like`` raise before any byte is read."""

import json
import os
import socket
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import safetensors.numpy
import torch

from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.checkpoint import (load_checkpoint as j_load_checkpoint,
                                       load_hf_llama as j_load_hf,
                                       save_checkpoint as j_save_checkpoint)
from rbg_tpu.parallel import make_mesh as j_make_mesh
from rbg_tpu.parallel.sharding import (param_specs as j_param_specs,
                                       shard_pytree as j_shard_pytree)
from rbg_tpu_torch.models import safetensors_io as st
from rbg_tpu_torch.models.checkpoint import save_checkpoint
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_checkpoint_tp_worker.py")
NATIVE = {"tiny-tp2": ("tiny", "tp2"), "tiny-mla-tp2": ("tiny-mla", "tp2"),
          "tiny-moe-tp2": ("tiny-moe", "tp2"), "tiny-moe-ep2": ("tiny-moe", "ep2")}
HF = ("llama", "qwen2", "sharded", "bf16", "bin")
ENGINE = ("native", "qwen2", "sharded", "bf16", "bin")
JAX_AXES = {"tp2": dict(tp=2), "ep2": dict(ep=2)}


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


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def _hf_tree(bias, vocab=None, seed=0):
    """HF-named float32 weights of the tiny preset's shapes (untied head)."""
    cfg = j_get_config("tiny")
    rng = np.random.RandomState(seed)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, vocab or cfg.vocab_size
    hq, hk = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_

    def w(*shape, scale=0.05):
        return (scale * rng.randn(*shape)).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
          "lm_head.weight": w(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(D),
                   p + "post_attention_layernorm.weight": 1 + w(D),
                   p + "self_attn.q_proj.weight": w(hq, D),
                   p + "self_attn.k_proj.weight": w(hk, D),
                   p + "self_attn.v_proj.weight": w(hk, D),
                   p + "self_attn.o_proj.weight": w(D, hq),
                   p + "mlp.gate_proj.weight": w(F, D),
                   p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
        if bias:
            sd.update({p + "self_attn.q_proj.bias": w(hq, scale=0.5),
                       p + "self_attn.k_proj.bias": w(hk, scale=0.5),
                       p + "self_attn.v_proj.bias": w(hk, scale=0.5)})
    return sd


def _write_hf(root):
    """The HF layouts: {name: directory}."""
    dirs = {name: os.path.join(root, f"hf-{name}") for name in HF}
    for d in dirs.values():
        os.makedirs(d)
    llama, qwen2 = _hf_tree(False), _hf_tree(True, seed=1)
    safetensors.numpy.save_file(llama, os.path.join(dirs["llama"], "model.safetensors"))
    safetensors.numpy.save_file(qwen2, os.path.join(dirs["qwen2"], "model.safetensors"))
    names = sorted(qwen2)
    halves = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for fname, keys in halves.items():
        safetensors.numpy.save_file({k: qwen2[k] for k in keys},
                                    os.path.join(dirs["sharded"], fname))
    with open(os.path.join(dirs["sharded"], "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": {k: fn for fn, keys in halves.items() for k in keys}}, f)
    st.save_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in qwen2.items()},
                 os.path.join(dirs["bf16"], "model.safetensors"))
    torch.save({k: torch.from_numpy(v) for k, v in qwen2.items()},
               os.path.join(dirs["bin"], "pytorch_model.bin"))
    uneven = os.path.join(root, "hf-uneven")
    os.makedirs(uneven)
    safetensors.numpy.save_file(_hf_tree(False, vocab=255),
                                os.path.join(uneven, "model.safetensors"))
    return dirs, uneven


def _shard_of(arr, rank):
    (shard,) = [s for s in arr.addressable_shards if s.device.id == rank]
    return np.asarray(shard.data)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes every checkpoint, spawns the world once, and makes the
    reference's per-rank shards: {"ranks": [rank0, rank1], "want": {case:
    [{leaf: shard} per rank]}, "files": {case: path}}."""
    root = str(tmp_path_factory.mktemp("ckpt_tp"))
    cases = {"native": {}, "hf": {}, "engine": {}}
    want = {}
    for tag, (model, axes) in NATIVE.items():
        jcfg = j_get_config(model)
        tree = j_init(jcfg, jax.random.key(3))
        path = os.path.join(root, f"native-{tag}")
        save_checkpoint(path, params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                                get_config(model), "cpu"))
        cases["native"][tag] = (path, model, axes)
        # The reference's restore into a sharded target: orbax puts each
        # leaf on the target's shardings, saved with them.
        mesh = j_make_mesh(**JAX_AXES[axes])
        sharded = j_shard_pytree(tree, j_param_specs(jcfg, tree), mesh)
        j_save_checkpoint(os.path.join(root, f"orbax-{tag}"), sharded)
        back = j_load_checkpoint(os.path.join(root, f"orbax-{tag}"), like=sharded)
        want[tag] = [{k: _shard_of(v, r) for k, v in _flat(back).items()} for r in (0, 1)]
    dirs, uneven_hf = _write_hf(root)
    mesh = j_make_mesh(tp=2)
    for name, d in dirs.items():
        jcfg = j_get_config("tiny")
        tree = j_load_hf(d, jcfg)
        sharded = j_shard_pytree(tree, j_param_specs(jcfg, tree), mesh)
        cases["hf"][f"hf-{name}"] = d
        want[f"hf-{name}"] = [{k: _shard_of(v, r) for k, v in _flat(sharded).items()}
                              for r in (0, 1)]
    cases["engine"] = {"native": cases["native"]["tiny-tp2"][0],
                       **{n: dirs[n] for n in ENGINE if n != "native"}}
    cases["uneven"] = os.path.join(root, "native-uneven")
    save_checkpoint(cases["uneven"],
                    params_from_numpy(jax.tree_util.tree_map(
                        np.asarray, j_init(j_get_config("tiny", vocab_size=255),
                                           jax.random.key(4))),
                        get_config("tiny", vocab_size=255), "cpu"))
    cases["uneven_hf"] = uneven_hf
    spec = os.path.join(root, "cases.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(port), spec, root],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = []
    for r in (0, 1):
        got = dict(np.load(os.path.join(root, f"rank{r}.npz")))
        got["results"] = json.loads(str(got.pop("results")))
        ranks.append(got)
    return {"ranks": ranks, "want": want, "files": {**{t: c[0] for t, c in
                                                       cases["native"].items()},
                                                    **cases["hf"]}}


def _held(world, case):
    for r, got in enumerate(world["ranks"]):
        want = world["want"][case][r]
        have = sorted(k[len(case) + 1:] for k in got if k.startswith(case + "/"))
        assert have == sorted(want), (r, have, sorted(want))
        for k, w in want.items():
            g = got[f"{case}/{k}"]
            assert g.shape == w.shape and g.dtype == w.dtype, (r, k, g.shape, w.shape)
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), (r, k)


@pytest.mark.parametrize("case", sorted(NATIVE))
def test_native_rank_local_read_equals_the_reference_sharded_restore(world, case):
    """Each rank's leaves are the reference's restored shards on its mesh
    coordinate, bit for bit (tp splits of heads, vocab and MLP columns; the
    expert axis on ep; MLA's latent weights whole)."""
    _held(world, case)


@pytest.mark.parametrize("layout", HF)
def test_hf_rank_local_read_equals_the_reference_shards(world, layout):
    """The HF importer under tp 2 slices each HF tensor before its
    transpose: each rank's tree is the reference importer's tree cut by its
    shard_pytree, bit for bit (bf16 files rounded as the reference reads
    them; pytorch_model.bin read whole, then sliced)."""
    _held(world, f"hf-{layout}")


def _file_share(path, want):
    """A rank's share of the file's bytes in the stored dtypes: its shards'
    element counts times each tensor's stored width."""
    return sum(w.size * (2 if "bf16" in path else 4) for w in want.values())


@pytest.mark.parametrize("case", sorted(NATIVE) + [f"hf-{n}" for n in HF if n != "bin"])
def test_a_rank_copies_its_share_and_stages_one_layer(world, case):
    """Bytes copied out equal the rank's share of the file (the sum of its
    local_shard bytes); the largest host staging buffer is at most the
    largest one-layer slice of one tensor, and a strided split stages."""
    for r, got in enumerate(world["ranks"]):
        want = world["want"][case][r]
        reads = got["results"][f"{case}/reads"]
        assert reads["bytes"] == _file_share(case, want), (r, reads)
        item = 2 if "bf16" in case else 4
        layer = max(w.size // w.shape[0] * item for k, w in want.items()
                    if k.startswith("blocks."))
        assert reads["staging_max"] <= layer, (r, reads, layer)
        # Under ep alone every split is of a leading dim, contiguous in the
        # file: nothing stages.
        assert (reads["staging_max"] > 0) == (case != "tiny-moe-ep2"), (r, reads)


@pytest.mark.parametrize("case", ENGINE)
def test_engine_reads_its_slices_from_the_checkpoint(world, case):
    """Engine(EngineConfig(checkpoint_path=...), mesh) holds _shard_state of
    the whole read, bit for bit, and gives the greedy tokens of
    Engine(mesh, params=whole) on every rank; from a safetensors file it
    copies out no more than the rank's share."""
    toks = []
    for got in world["ranks"]:
        res = got["results"][f"engine/{case}"]
        assert res["same_names"] and res["equal_params"], res
        assert res["tokens"] == res["want"], res
        if case != "bin":
            full = sum(os.path.getsize(os.path.join(d, f)) for d in [_engine_dir(world, case)]
                       for f in os.listdir(d) if f.endswith(".safetensors"))
            assert 0 < res["reads"]["bytes"] < 0.75 * full, res["reads"]
        toks.append(res["tokens"])
    assert toks[0] == toks[1]


def _engine_dir(world, case):
    return world["files"]["tiny-tp2" if case == "native" else f"hf-{case}"]


def test_uneven_split_and_mismatched_like_raise_before_any_byte(world):
    for got in world["ranks"]:
        res = got["results"]
        for key in ("refused/uneven_read", "refused/uneven_engine", "refused/uneven_hf"):
            err = res[key]["error"] or ""
            assert "does not split" in err or "does not divide" in err, (key, res[key])
            assert res[key]["bytes"] == 0, (key, res[key])
        for tag in NATIVE:
            assert res[f"{tag}/like_ok"], tag
            assert "does not match" in res[f"{tag}/like_whole"]["error"], tag
            assert res[f"{tag}/like_whole"]["bytes"] == 0, tag


# ---- read_slice alone (no mesh) ----

def _misaligned_file(path, arrays):
    """A safetensors file whose data start is 3 bytes past an 8-byte
    boundary: every float32 tensor sits misaligned in the map."""
    header, offset = {}, 0
    for name, a in arrays.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * ((3 - (8 + len(blob))) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for a in arrays.values():
            f.write(a.tobytes())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("stage_bytes", [None, 4 * 6 * 5, 1 << 20])
def test_read_slice_copies_the_slice_and_counts(tmp_path, aligned, stage_bytes):
    """Contiguous and strided narrowings, aligned and misaligned data,
    staged in chunks of whole leading indices: the values of numpy's
    slice; bytes counted; staging at most the chunk."""
    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(4, 6, 10).astype(np.float32),
              "b": rng.randn(7, 5).astype(np.float32),
              "s": np.array(rng.randn(), dtype=np.float32)}
    path = str(tmp_path / "x.safetensors")
    if aligned:
        st.save_file({k: torch.from_numpy(v) for k, v in arrays.items()}, path)
    else:
        _misaligned_file(path, arrays)
    cuts = [("a", [None, (2, 3), None], np.s_[:, 2:5, :]),
            ("a", [None, None, (5, 5)], np.s_[:, :, 5:10]),
            ("a", [(1, 2), None, (0, 4)], np.s_[1:3, :, 0:4]),
            ("a", [(3, 1)], np.s_[3:4]),
            ("b", [None, (1, 3)], np.s_[:, 1:4]),
            ("s", [], np.s_[()])]
    with st.SafeFile(path) as f:
        assert f.shape("a") == (4, 6, 10) and f.dtype("a") == torch.float32
        for name, narrow, sl in cuts:
            st.reset_reads()
            got = f.read_slice(name, narrow, stage_bytes=stage_bytes)
            want = arrays[name][sl]
            assert got.shape == want.shape and np.array_equal(got.numpy(), want), name
            assert st.READS["bytes"] == want.nbytes and st.READS["tensors"] == 1
            row = want[0].nbytes if want.ndim else want.nbytes
            chunk = max(row, (stage_bytes or row) // row * row)
            assert st.READS["staging_max"] <= min(chunk, want.nbytes), (name, narrow)
            got[...] = 0                    # a tensor of its own, not the map
        assert np.array_equal(f["a"].numpy(), arrays["a"])


def test_bounds_match_local_shard():
    """shard_bounds is local_shard's arithmetic: the narrowings the reads
    take are the views the engine's _shard_state takes."""
    from rbg_tpu_torch.parallel.sharding import leaf_spec, param_specs

    for model in ("tiny", "tiny-mla", "tiny-moe", "qwen2-0.5b", "deepseek-v2-lite"):
        specs = param_specs(get_config(model))
        flat = {k: v for k, v in specs.items() if k != "blocks"}
        flat.update({f"blocks.{k}": v for k, v in specs["blocks"].items()})
        for name, spec in flat.items():
            assert leaf_spec(name) == spec, (model, name)
    assert "bq" in param_specs(get_config("tiny"), ["wq", "bq"])["blocks"]
    with pytest.raises(ValueError, match="no sharding rule"):
        leaf_spec("blocks.unknown")
