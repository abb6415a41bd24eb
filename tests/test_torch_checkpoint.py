"""The port's checkpoints (rbg_tpu_torch/models/safetensors_io.py and
models/checkpoint.py) against rbg_tpu's importer on the same files, on the
CPU: the safetensors format against the ``safetensors`` package (a witness
here; the port never imports it), HF llama and Qwen2 directories written
from random numpy weights (float32, and bfloat16 twins), the
native format, and ``Engine(checkpoint_path=...)``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from rbg_tpu.models import KVCache as JKVCache, forward as j_forward
from rbg_tpu.models import get_config as j_get_config
from rbg_tpu.models.checkpoint import (is_hf_checkpoint as j_is_hf,
                                       load_hf_llama as j_load_hf)
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.engine.engine import Engine
from rbg_tpu_torch.engine.server import build_config, parse_args
from rbg_tpu_torch.models import safetensors_io as st
from rbg_tpu_torch.models.checkpoint import (NATIVE_FILE, _hf_state_dict, is_hf_checkpoint,
                                             load_checkpoint, load_hf_llama, load_params,
                                             save_checkpoint)
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.llama import KVCache, forward, init_params

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "U8": torch.uint8, "I8": torch.int8}


def _sample(dtype, shape=(3, 5, 7), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    lo, hi = (0, 255) if dtype == torch.uint8 else (-100, 100)
    return torch.randint(lo, hi, shape, generator=g).to(dtype)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _load(path):
    with st.SafeFile(path) as f:
        return dict(f)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_round_trips_and_matches_the_package(name, tmp_path):
    """Each dtype: the port's writer → its reader and the package's, the
    package's writer → the port's reader, bit for bit (BF16 as
    torch.bfloat16 bits), beside odd-sized tensors of other dtypes."""
    dt = DTYPES[name]
    tensors = {"x": _sample(dt), "odd": _sample(torch.int8, (5,), 1),
               "scalar": _sample(dt, (), 2), "wide": _sample(torch.float32, (2, 3), 3)}
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    nbytes = st.save_file(tensors, mine, {"note": "x"})
    assert nbytes == os.path.getsize(mine)
    for got in (_load(mine), safetensors.torch.load_file(mine)):
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape
            assert torch.equal(_bits(got[k]), _bits(t)), k
    with st.SafeFile(mine) as f:
        assert f.metadata == {"note": "x"} and f.header["x"]["dtype"] == name
    safetensors.torch.save_file(tensors, theirs)
    got = _load(theirs)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(_bits(got[k]), _bits(t)), k


def test_safetensors_stacks_lists_and_reads_sharded_indexes(tmp_path):
    parts = [_sample(torch.bfloat16, (4, 6), i) for i in range(3)]
    path = str(tmp_path / "a.safetensors")
    st.save_file({"stacked": parts, "one": parts[0]}, path)
    got = safetensors.torch.load_file(path)
    assert torch.equal(_bits(got["stacked"]), _bits(torch.stack(parts)))
    st.save_file({"b": parts[1]}, str(tmp_path / "b.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"stacked": "a.safetensors", "one": "a.safetensors",
                                  "b": "b.safetensors"}}, f)
    with st.open_index(str(tmp_path / "model.safetensors.index.json")) as files:
        assert sorted(files) == ["b", "one", "stacked"]
        assert torch.equal(_bits(files["b"]), _bits(parts[1]))


# ---- HF directories ----

def _hf_tree(bias, seed=0):
    """HF-named float32 weights of the tiny preset's shapes (untied head)."""
    cfg = j_get_config("tiny")
    rng = np.random.RandomState(seed)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
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


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """llama and qwen2 layouts: float32 through the package's numpy writer,
    and each one's bfloat16 twin through the port's writer."""
    out = {}
    for layout, bias in (("llama", False), ("qwen2", True)):
        sd = _hf_tree(bias)
        f32 = tmp_path_factory.mktemp(f"{layout}-f32")
        safetensors.numpy.save_file(sd, str(f32 / "model.safetensors"))
        bf16 = tmp_path_factory.mktemp(f"{layout}-bf16")
        st.save_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                     str(bf16 / "model.safetensors"))
        out[layout] = (sd, str(f32), str(bf16))
    return out


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


@pytest.mark.parametrize("layout", ["llama", "qwen2"])
def test_hf_import_matches_reference(hf_dirs, layout):
    """The reference's importer and the port's load the same float32
    directory to equal params (the Qwen2 biases included) and logits."""
    _, f32, _ = hf_dirs[layout]
    jcfg, cfg = j_get_config("tiny"), get_config("tiny")
    want = j_load_hf(f32, jcfg)
    got = load_hf_llama(f32, cfg, "cpu")
    assert sorted(_flat(got)) == sorted(_flat(want))
    assert ("bq" in got["blocks"]) == (layout == "qwen2")
    for k, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k].numpy(), np.asarray(w), err_msg=k)
    tokens = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    jl, _ = j_forward(want, jcfg, jnp.asarray(tokens), JKVCache.create(jcfg, 2, 16))
    tl, _ = forward(got, cfg, torch.from_numpy(tokens), KVCache.create(cfg, 2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jl)).max()))


@pytest.mark.parametrize("layout", ["llama", "qwen2"])
def test_bf16_directory_loads_rounded_like_the_reference(hf_dirs, layout):
    """A BF16 directory loads in the port to its float32 twin's values
    rounded to bfloat16, bit for bit, into a bf16 config; into a float32
    config it gives those rounded values, equal to what the reference's
    importer makes of the same files (it reads them through numpy, whose
    bfloat16 comes from ml_dtypes here)."""
    sd, f32, bf16 = hf_dirs[layout]
    from_f32 = load_hf_llama(f32, get_config("tiny", dtype="bfloat16"), "cpu")
    got = load_hf_llama(bf16, get_config("tiny", dtype="bfloat16"), "cpu")
    for k, t in _flat(from_f32).items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(_bits(_flat(got)[k]), _bits(t)), k
    wide = load_hf_llama(bf16, get_config("tiny"), "cpu")
    want = _flat(j_load_hf(bf16, j_get_config("tiny")))
    for k, t in _flat(from_f32).items():
        assert torch.equal(_flat(wide)[k], t.float()), k
        np.testing.assert_array_equal(_flat(wide)[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_pytorch_bin_and_sharded_directories_load(hf_dirs, tmp_path):
    sd, f32, _ = hf_dirs["qwen2"]
    want = load_hf_llama(f32, get_config("tiny"), "cpu")
    binary = tmp_path / "bin"
    binary.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(binary / "pytorch_model.bin"))
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    names = sorted(sd)
    halves = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for fname, keys in halves.items():
        safetensors.numpy.save_file({k: sd[k] for k in keys}, str(sharded / fname))
    with open(sharded / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: fn for fn, keys in halves.items() for k in keys}}, f)
    for d in (binary, sharded):
        assert is_hf_checkpoint(str(d)) and j_is_hf(str(d))
        got = load_hf_llama(str(d), get_config("tiny"), "cpu")
        for k, t in _flat(want).items():
            assert torch.equal(_flat(got)[k], t), (d, k)
    assert sorted(_hf_state_dict(str(sharded))) == names


def test_moe_and_mla_imports_refuse_with_the_reference_messages(hf_dirs):
    _, f32, _ = hf_dirs["llama"]
    for model in ("tiny-moe", "tiny-mla"):
        with pytest.raises(NotImplementedError) as want:
            j_load_hf(f32, j_get_config(model))
        with pytest.raises(NotImplementedError) as got:
            load_hf_llama(f32, get_config(model), "cpu")
        assert str(got.value) == str(want.value)


# ---- the native format ----

def test_native_round_trip_and_detection(hf_dirs, tmp_path):
    """save_checkpoint / load_checkpoint give the tree back bit for bit
    (stacked or a trainer's per-layer tree; bf16 too); the directory is not
    taken for an HF one by either package, so load_params reads it as
    native; a tree of other shapes is refused."""
    for model, dtype in (("tiny", "float32"), ("tiny-moe", "bfloat16"), ("tiny-mla", "float32")):
        cfg = get_config(model, dtype=dtype)
        params = init_params(cfg, 4, "cpu")
        d = str(tmp_path / f"{model}-{dtype}")
        nbytes = save_checkpoint(d, params)
        assert nbytes == os.path.getsize(os.path.join(d, NATIVE_FILE))
        assert not is_hf_checkpoint(d) and not j_is_hf(d)
        for back in (load_checkpoint(d, device="cpu"), load_params(d, cfg, device="cpu"),
                     load_checkpoint(d, like=params)):
            assert sorted(_flat(back)) == sorted(_flat(params))
            for k, t in _flat(params).items():
                assert _flat(back)[k].dtype == t.dtype and torch.equal(
                    _bits(_flat(back)[k]), _bits(t)), k
    per_layer = dict(params, blocks=[{k: w[l] for k, w in params["blocks"].items()}
                                     for l in range(cfg.num_layers)])
    save_checkpoint(str(tmp_path / "per-layer"), per_layer)
    back = load_checkpoint(str(tmp_path / "per-layer"), device="cpu")
    for k, t in _flat(params).items():
        assert torch.equal(_flat(back)[k], t), k
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(d, like=init_params(get_config("tiny"), 4, "cpu"))
    for layout in ("llama", "qwen2"):
        _, f32, bf16 = hf_dirs[layout]
        for path in (f32, bf16):
            assert is_hf_checkpoint(path) and j_is_hf(path)
    assert not is_hf_checkpoint(str(tmp_path / "missing"))
    assert not is_hf_checkpoint(os.path.join(hf_dirs["llama"][1], "model.safetensors"))


@pytest.mark.parametrize("fmt", ["native", "hf"])
def test_engine_loads_checkpoint_path(hf_dirs, fmt, tmp_path):
    """Engine(checkpoint_path=...) gives the greedy tokens of an engine on
    the same weights in memory (tests/test_checkpoint.py's scenario; the
    HF one through the Qwen2 directory, biases and all)."""
    cfg = get_config("tiny")
    if fmt == "native":
        params = init_params(cfg, 7, "cpu")
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, params)
    else:
        path = hf_dirs["qwen2"][1]
        params = load_hf_llama(path, cfg, "cpu")
    kw = dict(model="tiny", page_size=8, num_pages=64, max_seq_len=128, device="cpu")
    sp = SamplingParams(max_new_tokens=6)
    expect = Engine(EngineConfig(**kw), params=params).generate([[5, 6, 7], [9] * 11], sp)
    eng = Engine(EngineConfig(**kw, checkpoint_path=path))
    assert eng.generate([[5, 6, 7], [9] * 11], sp) == expect
    random = Engine(EngineConfig(**kw)).generate([[5, 6, 7], [9] * 11], sp)
    assert random != expect
    other = str(tmp_path / "bf16")
    save_checkpoint(other, init_params(get_config("tiny", dtype="bfloat16"), 0, "cpu"))
    with pytest.raises(TypeError, match="serves torch.float32"):
        Engine(EngineConfig(**kw, checkpoint_path=other))


def test_checkpoint_path_flag(monkeypatch):
    assert build_config(parse_args(["--device", "cpu"])).checkpoint_path == ""
    cfg = build_config(parse_args(["--device", "cpu", "--checkpoint-path", "/w/ckpt"]))
    assert cfg.checkpoint_path == "/w/ckpt"
    monkeypatch.setenv("RBG_CHECKPOINT_PATH", "/from/env")
    assert build_config(parse_args(["--device", "cpu"])).checkpoint_path == "/from/env"
