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
"""

from __future__ import annotations

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


def load_checkpoint(path: str, like: Optional[dict] = None, device=None) -> dict:
    """Read a native checkpoint directory onto ``device`` (default: the
    device of ``like``'s embedding, else the card). With ``like``, the
    names, shapes and dtypes must be ``like``'s."""
    from rbg_tpu_torch.engine.config import resolve_device

    if device is None and like is not None:
        device = like["embed"].device
    device = resolve_device(device)
    with safetensors_io.SafeFile(os.path.join(path, NATIVE_FILE), device) as f:
        if like is not None:
            want = {k: ((len(v),) + tuple(v[0].shape), v[0].dtype) if isinstance(v, list)
                    else (tuple(v.shape), v.dtype) for k, v in _flatten(like).items()}
            have = {k: (tuple(f.header[k]["shape"]),
                        safetensors_io.DTYPES.get(f.header[k]["dtype"])) for k in f}
            if want != have:
                raise ValueError(f"checkpoint {path} does not match the given tree: "
                                 f"{sorted(set(want.items()) ^ set(have.items()))[:4]}")
        params = {"blocks": {}}
        for name in f:
            if name.startswith("blocks."):
                params["blocks"][name[len("blocks."):]] = f[name]
            else:
                params[name] = f[name]
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


def load_hf_llama(path: str, cfg: ModelConfig, device=None) -> dict:
    """Map an HF llama-family checkpoint (LlamaForCausalLM / Qwen2ForCausalLM
    layout) into the stacked parameter tree, in cfg's dtype on ``device``
    (default: the card)."""
    from rbg_tpu_torch.engine.config import resolve_device

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

    def get(name):
        return sd[name].to(device)

    def stack(fmt, transpose=True):
        out = None
        for i in range(L):
            w = get(fmt.format(i))
            w = w.T if transpose else w
            if out is None:
                out = torch.empty((L, *w.shape), dtype=dt, device=device)
            out[i].copy_(w)
        return out

    try:
        p = "model.layers.{}."
        blocks = {
            "attn_norm": stack(p + "input_layernorm.weight", transpose=False),
            "wq": stack(p + "self_attn.q_proj.weight"),
            "wk": stack(p + "self_attn.k_proj.weight"),
            "wv": stack(p + "self_attn.v_proj.weight"),
            "wo": stack(p + "self_attn.o_proj.weight"),
            "mlp_norm": stack(p + "post_attention_layernorm.weight", transpose=False),
            "w_gate": stack(p + "mlp.gate_proj.weight"),
            "w_up": stack(p + "mlp.up_proj.weight"),
            "w_down": stack(p + "mlp.down_proj.weight"),
        }
        if p.format(0) + "self_attn.q_proj.bias" in sd:  # Qwen2 attention bias
            blocks["bq"] = stack(p + "self_attn.q_proj.bias", transpose=False)
            blocks["bk"] = stack(p + "self_attn.k_proj.bias", transpose=False)
            blocks["bv"] = stack(p + "self_attn.v_proj.bias", transpose=False)
        params = {
            "embed": get("model.embed_tokens.weight").to(dt),
            "blocks": blocks,
            "final_norm": get("model.norm.weight").to(dt),
        }
        if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
            params["lm_head"] = get("lm_head.weight").to(dt).T.contiguous()
    finally:
        if hasattr(sd, "close"):
            sd.close()
    return params


def load_params(path: str, cfg: ModelConfig, like: Optional[dict] = None,
                device=None) -> dict:
    """Detect the format (an HF directory first, else a native one) and
    load onto ``device`` (default: the card)."""
    if is_hf_checkpoint(path):
        return load_hf_llama(path, cfg, device)
    return load_checkpoint(path, like=like, device=device)
