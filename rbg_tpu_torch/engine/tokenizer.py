"""Tokenizers (``rbg_tpu/engine/tokenizer.py``): a byte-level tokenizer
with no dependencies, and an HF tokenizer from a local directory.

Nothing downloads. ``load_tokenizer`` takes a local HF tokenizer directory
when given one (``transformers`` is imported then, not before), else the
byte tokenizer, which any model with a vocab of at least 259 serves.
"""

from __future__ import annotations

import os
from typing import List, Optional


class ByteTokenizer:
    """UTF-8 bytes plus BOS/EOS: ids 0..255 bytes, 256 BOS, 257 EOS, 258 PAD."""

    bos_id = 256
    eos_id = 257
    pad_id = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A tokenizer directory read by ``transformers`` (local files only)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                f"--tokenizer-path {path!r} needs the transformers package, "
                "which is not installed; without a path the byte tokenizer "
                "serves") from e
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


class IncrementalDetokenizer:
    """Streaming token→text decoding that never emits half a character.

    ``feed`` returns the newly safe text; a decode ending in U+FFFD is
    held back until the token that completes it arrives, and ``flush``
    emits the rest. The deltas concatenate to ``tokenizer.decode(ids)``."""

    # Tail tokens kept as context after a commit; commits happen at twice
    # this, so each feed re-decodes O(WINDOW) tokens, not the whole stream.
    WINDOW = 16

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._tail: List[int] = []   # un-committed trailing ids
        self._emitted = 0            # chars of decode(self._tail) emitted

    def feed(self, ids) -> str:
        if isinstance(ids, int):
            ids = [ids]
        self._tail.extend(ids)
        text = self._tok.decode(self._tail)
        safe = len(text)
        while safe > self._emitted and text[safe - 1] == "�":
            safe -= 1   # incomplete sequence pending more tokens
        delta = text[self._emitted:safe]
        self._emitted = safe
        if len(self._tail) > 2 * self.WINDOW and safe == len(text):
            self._commit(text)
        return delta

    def _commit(self, text: str) -> None:
        """Drop emitted leading ids, keeping WINDOW ids of context, when the
        kept tail re-decodes to a suffix of the full text."""
        keep = self._tail[-self.WINDOW:]
        suffix = self._tok.decode(keep)
        if suffix and text.endswith(suffix):
            self._tail = keep
            self._emitted -= len(text) - len(suffix)

    def flush(self) -> str:
        text = self._tok.decode(self._tail)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta


def load_tokenizer(path: Optional[str] = None):
    """The HF tokenizer in directory ``path``, else the byte tokenizer. A
    path that is not a directory is refused."""
    if not path:
        return ByteTokenizer()
    if not os.path.isdir(path):
        raise ValueError(f"tokenizer path {path!r} is not a directory")
    return HFTokenizer(path)
