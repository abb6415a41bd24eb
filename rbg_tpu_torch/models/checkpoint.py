"""Checkpoints: the native format and HuggingFace llama-family import
(``rbg_tpu/models/checkpoint.py``).

Two formats, as the reference's:

* **native** — one safetensors file, ``params.safetensors``, of the
  flattened tree (``embed``, ``blocks.wq``, ..., ``final_norm``,
  ``lm_head``) in a directory. It stands where the reference writes orbax,
  which the card's image lacks; orbax directories are not read here. The
  file is not named ``model.safetensors``, so ``is_hf_checkpoint`` never
  takes a native directory for an HF one.
* **HF** — a local ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` directory
  (``model.safetensors``, a sharded ``model.safetensors.index.json``, or
  ``pytorch_model.bin``), in any of F32 / F16 / BF16. Weights are
  transposed into the ``[in, out]`` layout and stacked along the layer
  axis, the Qwen2 q/k/v biases and an untied ``lm_head`` included.

Safetensors are read by ``models/safetensors_io.py`` (no ``safetensors``
package). The stacked ``[L, ...]`` tensors are filled on the target device
one layer's slice at a time, so the host never holds a whole float32 copy
of the model (the reference's import builds one: 32 GB at llama3-8b).

Under a mesh (``mesh=``, the counterpart of the reference's restore into a
sharded ``like``), each rank reads only its slice of every leaf, as
``parallel.sharding.local_shard`` would cut it, straight from the mapped
file: a rank copies out its share of the bytes and the host stages at most
one layer's slice of one tensor. The HF importer slices each HF tensor
before its transpose (the spec of ``[in, out]`` read on HF's ``[out, in]``).
``pytorch_model.bin`` has no map to slice: it is read whole, then sliced.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import torch

from rbg_tpu_torch.models import safetensors_io
from rbg_tpu_torch.models.config import ModelConfig

NATIVE_FILE = "params.safetensors"


def _flatten(params: dict) -> dict:
    """``{"blocks.wq": ...}`` names; a trainer's per-layer blocks (a list of
    dicts) become lists, which the writer stacks."""
    flat = {k: v for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        flat.update({f"blocks.{k}": [blk[k] for blk in blocks] for k in blocks[0]})
    else:
        flat.update({f"blocks.{k}": w for k, w in blocks.items()})
    return flat


def save_checkpoint(path: str, params: dict) -> int:
    """Write ``params`` (stacked, or a trainer's per-layer tree) as a native
    checkpoint directory. Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    return safetensors_io.save_file(_flatten(params), os.path.join(path, NATIVE_FILE),
                                    {"format": "rbg_tpu_torch"})


def _bounds(shapes: Mapping[str, tuple], spec_of, mesh) -> dict:
    """Each tensor's narrowing under ``mesh`` by ``spec_of(name)`` (all
    None without a mesh); an uneven split raises before any byte is read."""
    from rbg_tpu_torch.parallel.sharding import shard_bounds

    if mesh is None:
        return {k: [None] * len(shape) for k, shape in shapes.items()}
    return {k: shard_bounds(shape, spec_of(k), mesh) for k, shape in shapes.items()}


def _sliced(shape, bounds) -> tuple:
    cuts = list(bounds) + [None] * (len(shape) - len(bounds))
    return tuple(n if cut is None else cut[1] for n, cut in zip(shape, cuts))


def load_checkpoint(path: str, like: Optional[dict] = None, device=None,
                    mesh=None) -> dict:
    """Read a native checkpoint directory onto ``device`` (default: the
    device of ``like``'s embedding, else the card). With ``mesh``, only
    this rank's slice of each leaf (``local_shard`` of it under its spec)
    is read. With ``like`` (this rank's tree under a mesh), the names,
    shapes and dtypes must be ``like``'s; a mismatch, like an uneven
    split, raises before any byte is read."""
    from rbg_tpu_torch.engine.config import resolve_device
    from rbg_tpu_torch.parallel.sharding import leaf_spec

    if device is None and like is not None:
        device = like["embed"].device
    device = resolve_device(device)
    with safetensors_io.SafeFile(os.path.join(path, NATIVE_FILE), device) as f:
        bounds = _bounds({k: f.shape(k) for k in f}, leaf_spec, mesh)
        dtypes = {k: f.dtype(k) for k in f}
        shapes = {k: _sliced(f.shape(k), bounds[k]) for k in f}
        if like is not None:
            want = {k: ((len(v),) + tuple(v[0].shape), v[0].dtype) if isinstance(v, list)
                    else (tuple(v.shape), v.dtype) for k, v in _flatten(like).items()}
            have = {k: (shapes[k], dtypes[k]) for k in f}
            if want != have:
                raise ValueError(f"checkpoint {path} does not match the given tree: "
                                 f"{sorted(set(want.items()) ^ set(have.items()))[:4]}")
        stacked = [k for k in f if k.startswith("blocks.")]
        # The host staging budget of a strided read: the largest one-layer
        # slice of a stacked leaf.
        cap = max((dtypes[k].itemsize * math.prod(shapes[k][1:]) for k in stacked),
                  default=0)
        params = {"blocks": {}}
        for name in f:
            # A stacked leaf goes one layer at a time; a 2-D one in row
            # blocks of at most one layer's slice of the largest.
            t = f.read_slice(name, bounds[name],
                             stage_bytes=None if name in stacked else cap)
            if name in stacked:
                params["blocks"][name[len("blocks."):]] = t
            else:
                params[name] = t
    return params


def is_hf_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "model.safetensors"))
        or os.path.exists(os.path.join(path, "model.safetensors.index.json"))
        or os.path.exists(os.path.join(path, "pytorch_model.bin"))
    )


def _hf_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """The tensors of a local HF checkpoint directory as a mapping of CPU
    tensors in their stored dtype; safetensors are read from the mapped
    file one tensor at a time, on access."""
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        return safetensors_io.open_index(index)
    if os.path.exists(single):
        return safetensors_io.SafeFile(single)
    return torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)


# HF tensor names of each layer and the port's leaf each fills: (HF name
# after "model.layers.{i}.", leaf, transposed from HF's [out, in]).
_HF_LAYER = (("input_layernorm.weight", "attn_norm", False),
             ("self_attn.q_proj.weight", "wq", True),
             ("self_attn.k_proj.weight", "wk", True),
             ("self_attn.v_proj.weight", "wv", True),
             ("self_attn.o_proj.weight", "wo", True),
             ("post_attention_layernorm.weight", "mlp_norm", False),
             ("mlp.gate_proj.weight", "w_gate", True),
             ("mlp.up_proj.weight", "w_up", True),
             ("mlp.down_proj.weight", "w_down", True))
_HF_BIAS = (("self_attn.q_proj.bias", "bq", False),   # Qwen2 attention bias
            ("self_attn.k_proj.bias", "bk", False),
            ("self_attn.v_proj.bias", "bv", False))


def load_hf_llama(path: str, cfg: ModelConfig, device=None, mesh=None) -> dict:
    """Map an HF llama-family checkpoint (LlamaForCausalLM / Qwen2ForCausalLM
    layout) into the stacked parameter tree, in cfg's dtype on ``device``
    (default: the card). With ``mesh``, this rank's slices only."""
    from rbg_tpu_torch.engine.config import resolve_device
    from rbg_tpu_torch.parallel.sharding import param_specs

    if cfg.num_experts:
        raise NotImplementedError(
            "HF import currently covers dense llama-family layouts only; "
            "MoE checkpoints (Mixtral block_sparse_moe / DeepSeek experts) "
            "need a dedicated mapping — load via orbax instead.")
    if cfg.mla:
        raise NotImplementedError(
            "HF import does not map MLA layouts yet (kv_a/kv_b projections "
            "→ w_dkv/w_uk/w_uv) — load via orbax instead.")
    device = resolve_device(device)
    sd = _hf_state_dict(path)
    dt, L = cfg.torch_dtype, cfg.num_layers
    p = "model.layers.{}."
    layer = _HF_LAYER + (_HF_BIAS if p.format(0) + _HF_BIAS[0][0] in sd else ())
    specs = param_specs(cfg, [leaf for _, leaf, _ in layer])
    try:
        # Every tensor this rank reads (HF name → its spec on HF's layout:
        # a transposed leaf's spec reversed), then every narrowing, so an
        # uneven split raises before any byte is read.
        plan = {"model.embed_tokens.weight": specs["embed"],
                "model.norm.weight": specs["final_norm"]}
        if "lm_head" in specs and "lm_head.weight" in sd:
            plan["lm_head.weight"] = specs["lm_head"][::-1]
        for hf, leaf, transposed in layer:
            spec = specs["blocks"][leaf][1:]
            plan.update({p.format(i) + hf: spec[::-1] if transposed else spec
                         for i in range(L)})
        sliced = hasattr(sd, "read_slice")
        shape = sd.shape if sliced else (lambda k: tuple(sd[k].shape))
        bounds = _bounds({k: shape(k) for k in plan}, plan.get, mesh)
        # Each HF layer tensor is one layer: a strided slice of it is staged
        # whole, so the host stages at most the largest such slice.
        cap = max(sd.dtype(k).itemsize * math.prod(_sliced(shape(k), bounds[k]))
                  for k in bounds if k.startswith("model.layers.")) if sliced else None

        def get(name):
            if sliced:
                return sd.read_slice(name, bounds[name], device, stage_bytes=cap)
            t = sd[name]
            for dim, cut in enumerate(bounds[name]):
                if cut is not None:
                    t = t.narrow(dim, *cut)
            return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)

        def stack(fmt, transpose):
            out = None
            for i in range(L):
                w = get(fmt.format(i))
                w = w.T if transpose else w
                if out is None:
                    out = torch.empty((L, *w.shape), dtype=dt, device=device)
                out[i].copy_(w)
            return out

        params = {
            "embed": get("model.embed_tokens.weight").to(dt),
            "blocks": {leaf: stack(p + hf, transposed) for hf, leaf, transposed in layer},
            "final_norm": get("model.norm.weight").to(dt),
        }
        if "lm_head.weight" in plan:
            params["lm_head"] = get("lm_head.weight").to(dt).T.contiguous()
    finally:
        if hasattr(sd, "close"):
            sd.close()
    return params


def load_params(path: str, cfg: ModelConfig, like: Optional[dict] = None,
                device=None, mesh=None) -> dict:
    """Detect the format (an HF directory first, else a native one) and
    load onto ``device`` (default: the card); with ``mesh``, this rank's
    slices only."""
    if is_hf_checkpoint(path):
        return load_hf_llama(path, cfg, device, mesh)
    return load_checkpoint(path, like=like, device=device, mesh=mesh)
