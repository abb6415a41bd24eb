"""Engine configuration (``rbg_tpu/engine/config.py``) plus the device.

The fields are the reference's serving knobs this port runs. ``mode`` is
the PD-disaggregation role: ``unified`` serves generate, ``prefill`` runs
prompts to their first token and exports the KV pages, ``decode`` imports
them and decodes (``engine/pd.py``). ``kv_dtype="int8"`` serves every
model, GQA pools and MLA latent pools alike, in unified mode.
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
    host_tier_bytes: int = 0                # host-DRAM KV spill tier (0 = off)
    # Decode steps run per window before the sampled tokens reach the host
    # (one device→host fetch per window).
    multi_step: int = 1
    # Speculative decoding: "ngram" = prompt-lookup drafting and one
    # (B, spec_k + 1) verify forward per step. Sampling keys are a function
    # of (row, position), so the output is the non-speculative stream,
    # greedy and sampled. It owns the decode dispatch: multi_step must be 1.
    speculative: str = "off"                # off | ngram
    spec_k: int = 4                         # most drafted tokens per step
    spec_ngram: int = 3                     # trailing n-gram for the lookup
    # "auto": while any row prefills, the whole batch rides one ragged
    # forward. "off" keeps the split paths: batched (B, chunk) prefill
    # forwards, then the fused decode window. Speculative mode and batches
    # holding an adapter row take the split paths either way.
    ragged: str = "auto"                    # auto | off
    mode: str = "unified"                   # unified | prefill | decode
    # {"dp": 1, "tp": 4}, from discovery; the engine reads its mesh from
    # Engine(mesh=...) (parallel.mesh_from_spec builds one from this).
    mesh_spec: Optional[dict] = None
    kv_dtype: str = "model"                 # model | int8 (quantized KV pool)
    # Batch-invariant serving (ops/rows.py): a request's logits, and so its
    # greedy tokens, do not depend on the requests beside it, its prefill
    # chunk boundaries or its decode bucket; every forward pads its rows to
    # whole ROWS-row blocks, at a cost in device time (PERF.md). A dense GQA
    # model without a mesh or LoRA adapters.
    batch_invariant: bool = False
    # Per-request SLO targets every finished request is judged against
    # (obs/slo.py): seconds to first token, seconds per output token after
    # the first. 0 disables a dimension.
    slo_ttft_s: float = 2.0
    slo_tpot_s: float = 0.5
    # Early rejection: "auto" (with slo_ttft_s > 0) sheds a submission at
    # admission when its predicted TTFT (queue wait plus prefill net of
    # its prefix hit) exceeds early_reject_factor x slo_ttft_s.
    early_reject: str = "off"               # off | auto
    early_reject_factor: float = 1.5
    # Grammar-constrained decoding: "auto" compiles finite-state grammars
    # (regex / json_schema) to device tables [S, V] so their rows decode
    # inside the fused window; a grammar over grammar_state_budget states,
    # the pushdown json_mode grammar, or "off" takes the host-masked K = 0
    # verify instead.
    grammar_table: str = "auto"             # auto | off
    grammar_state_budget: int = 512
    vocab_size: int = 0                     # override preset vocab (0 = keep)
    checkpoint_path: str = ""               # native or local HF dir (else random)
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
        """Refuse what the port cannot serve, before anything is built.
        Every page size serves, on the card and on the CPU alike."""
        if self.max_batch > max(self.decode_buckets):
            raise ValueError("max_batch exceeds largest decode bucket")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if self.multi_step < 1:
            raise ValueError("multi_step must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in (model, int8)")
        if self.slo_ttft_s < 0 or self.slo_tpot_s < 0:
            raise ValueError("slo_ttft_s / slo_tpot_s must be >= 0 "
                             "(0 disables that SLO dimension)")
        if self.early_reject not in ("off", "auto"):
            raise ValueError(f"early_reject {self.early_reject!r} not in "
                             "(off, auto)")
        if self.early_reject_factor <= 0:
            raise ValueError("early_reject_factor must be > 0")
        if self.speculative not in ("off", "ngram"):
            raise ValueError(f"speculative {self.speculative!r} not in "
                             "(off, ngram)")
        if self.speculative != "off":
            if self.multi_step != 1:
                raise ValueError("speculative decoding and multi_step are "
                                 "mutually exclusive (both own the decode "
                                 "dispatch)")
            if self.spec_k < 1 or self.spec_ngram < 1:
                raise ValueError("spec_k and spec_ngram must be >= 1")
        if self.ragged not in ("auto", "off"):
            raise ValueError(f"ragged {self.ragged!r} not in (auto, off)")
        if self.grammar_table not in ("auto", "off"):
            raise ValueError(f"grammar_table {self.grammar_table!r} not in "
                             "(auto, off)")
        if self.grammar_state_budget < 2:
            raise ValueError("grammar_state_budget must be >= 2 (initial "
                             "state + at least one successor)")
        if self.host_tier_bytes < 0:
            raise ValueError("host_tier_bytes must be >= 0 (0 disables "
                             "the host spill tier)")
        if self.host_tier_bytes and self.kv_dtype == "int8":
            raise ValueError("host_tier_bytes with kv_dtype='int8': the "
                             "spill tier does not carry page scales yet")
        if self.host_tier_bytes and not self.enable_radix_cache:
            raise ValueError(
                "host_tier_bytes needs the radix cache (spills come from "
                "its evictions) — a silently absent tier would discard "
                "every evicted prefix the operator budgeted RAM to keep")
        if self.mode not in ("unified", "prefill", "decode"):
            raise ValueError(f"mode {self.mode!r} not in (unified, prefill, "
                             "decode)")
        if self.kv_dtype == "int8" and self.mode != "unified":
            raise ValueError(
                "int8 KV is unified-mode only for now (PD bundles carry "
                "unquantized pages)")
        self.model_config   # unknown preset → KeyError, before anything binds


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
    # Grammar constraints (at most one): the engine needs
    # enable_json_grammar(tokenizer) to admit them.
    json_mode: bool = False
    regex: Optional[str] = None
    json_schema: Optional[dict] = None
    lora: Optional[str] = None      # adapter name (Engine.load_lora)
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
        constraints = ((1 if self.json_mode else 0)
                       + (1 if self.regex is not None else 0)
                       + (1 if self.json_schema is not None else 0))
        if constraints > 1:
            raise ValueError("json_mode, regex, and json_schema are "
                             "mutually exclusive constraints")

    @classmethod
    def from_wire(cls, obj: dict, *, default_max_tokens: int = 16,
                  stop_token: Optional[int] = None) -> "SamplingParams":
        """Parse sampling fields off a protocol message (the reference's
        field names); ``stop_token`` is the default when the message
        names none."""
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
            # `is not None`: regex="" means "empty output only" and
            # json_schema={} means "any JSON".
            regex=(str(obj["regex"]) if obj.get("regex") is not None else None),
            json_schema=(dict(obj["json_schema"])
                         if obj.get("json_schema") is not None else None),
            lora=(str(obj["lora"]) if obj.get("lora") else None),
            stop_token=(None if obj.get("stop_token") is None
                        else int(obj["stop_token"])),
        )
        if stop_token is not None and sp.stop_token is None:
            sp.stop_token = stop_token
        sp.validate()
        return sp


def warm_prompt(input_len: int, wave: int = 0, row: int = 0) -> list:
    """Deterministic warmup prompt, distinct per (wave, row) so warm waves
    never radix-hit each other. Token ids stay in [1, 200)."""
    base = (wave * 131 + row * 17) % 199
    return [1 + (base + j) % 199 for j in range(input_len)]
