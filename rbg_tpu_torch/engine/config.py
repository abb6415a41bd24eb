"""Engine configuration (``rbg_tpu/engine/config.py``) plus the device.

The fields are the reference's serving knobs this port runs. Features the
reference has and this port does not yet (int8 KV, speculative decoding,
the host KV tier, PD modes, the split non-ragged paths, grammar and LoRA)
are refused in ``validate`` / at admission with ``NotImplementedError``
naming the ROADMAP item, never ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from rbg_tpu_torch.models.config import ModelConfig, get_config


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. With no device given and no card present this raises —
    nothing drops to the CPU silently."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny"
    page_size: int = 16
    num_pages: int = 256                    # KV pool size (pages)
    max_batch: int = 8                      # decode batch ceiling
    max_seq_len: int = 512                  # per-sequence ceiling
    prefill_chunk: int = 64                 # chunked-prefill bucket
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    enable_radix_cache: bool = True
    host_tier_bytes: int = 0                # only 0 is ported
    # Decode steps run per window before the sampled tokens reach the host
    # (one device→host fetch per window).
    multi_step: int = 1
    speculative: str = "off"                # only "off" is ported
    ragged: str = "auto"                    # only "auto" is ported
    mode: str = "unified"                   # only "unified" is ported
    kv_dtype: str = "model"                 # only "model" is ported
    vocab_size: int = 0                     # override preset vocab (0 = keep)
    seed: int = 0
    device: Optional[str] = None            # None = cuda (raises without a card)

    @property
    def model_config(self) -> ModelConfig:
        if self.vocab_size:
            return get_config(self.model, vocab_size=self.vocab_size)
        return get_config(self.model)

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_seq_len + self.page_size - 1) // self.page_size

    def validate(self) -> None:
        if self.max_batch > max(self.decode_buckets):
            raise ValueError("max_batch exceeds largest decode bucket")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if self.multi_step < 1:
            raise ValueError("multi_step must be >= 1")
        if self.kv_dtype == "int8":
            raise _todo("kv_dtype='int8'", "kernels C, D and the int8 pool")
        if self.kv_dtype != "model":
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in (model, int8)")
        if self.speculative != "off":
            raise _todo(f"speculative={self.speculative!r}",
                        "speculative decoding")
        if self.host_tier_bytes:
            raise _todo("host_tier_bytes", "host KV tier")
        if self.mode != "unified":
            raise _todo(f"mode={self.mode!r}", "PD prefill/decode modes")
        if self.ragged != "auto":
            raise _todo(f"ragged={self.ragged!r}",
                        "split prefill path (_prefill_step)")
        from rbg_tpu_torch.models.llama import check_supported
        check_supported(self.model_config)


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    top_k: int = 0                  # 0 = full vocab
    top_p: float = 1.0              # nucleus mass; 1.0 = disabled
    min_p: float = 0.0              # min prob ratio vs argmax; 0.0 = disabled
    repetition_penalty: float = 1.0  # >1 discourages prompt+output tokens
    presence_penalty: float = 0.0   # subtract once per distinct output token
    frequency_penalty: float = 0.0  # subtract per output occurrence
    seed: Optional[int] = None      # per-request random stream (reproducible)
    logprobs: bool = False          # emit chosen-token logprob per step
    # Wire fields of the reference that this port refuses at admission.
    json_mode: bool = False
    regex: Optional[str] = None
    json_schema: Optional[dict] = None
    lora: Optional[str] = None
    stop_token: Optional[int] = None

    def needs_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    def validate(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not 0.0 <= self.min_p < 1.0:
            raise ValueError("min_p must be in [0, 1)")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")

    def check_supported(self) -> None:
        if (self.json_mode or self.regex is not None
                or self.json_schema is not None):
            raise _todo("grammar-constrained decoding (json_mode / regex / "
                        "json_schema)", "grammar")
        if self.lora is not None:
            raise _todo("LoRA adapters", "LoRA")

    @classmethod
    def from_wire(cls, obj: dict, *, default_max_tokens: int = 16) -> "SamplingParams":
        """Parse sampling fields off a protocol message (the reference's
        field names)."""
        sp = cls(
            max_new_tokens=int(obj.get("max_new_tokens", default_max_tokens)),
            temperature=float(obj.get("temperature", 0.0)),
            top_k=int(obj.get("top_k", 0)),
            top_p=float(obj.get("top_p", 1.0)),
            min_p=float(obj.get("min_p", 0.0)),
            repetition_penalty=float(obj.get("repetition_penalty", 1.0)),
            presence_penalty=float(obj.get("presence_penalty", 0.0)),
            frequency_penalty=float(obj.get("frequency_penalty", 0.0)),
            seed=(int(obj["seed"]) if obj.get("seed") is not None else None),
            logprobs=bool(obj.get("logprobs", False)),
            json_mode=bool(obj.get("json_mode", False)),
            regex=(str(obj["regex"]) if obj.get("regex") is not None else None),
            json_schema=(dict(obj["json_schema"])
                         if obj.get("json_schema") is not None else None),
            lora=(str(obj["lora"]) if obj.get("lora") else None),
            stop_token=(None if obj.get("stop_token") is None
                        else int(obj["stop_token"])),
        )
        sp.validate()
        return sp


def warm_prompt(input_len: int, wave: int = 0, row: int = 0) -> list:
    """Deterministic warmup prompt, distinct per (wave, row) so warm waves
    never radix-hit each other. Token ids stay in [1, 200)."""
    base = (wave * 131 + row * 17) % 199
    return [1 + (base + j) % 199 for j in range(input_len)]
