"""Prompt-lookup (n-gram) drafting for speculative decoding
(``rbg_tpu/engine/spec.py``).

The engine's sampling randomness is a function of (request key, token
position), so the verify forward recomputes exactly the token the
sequential path would sample at every drafted position: drafts are
accepted while they match, and the recomputed sample at the first
mismatch is the true next token. This module is the host half: an
incremental n-gram index over a request's prompt + output. The verify is
``Engine._spec_decode_step`` (one (B, spec_k + 1) ``forward_paged``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class NGramIndex:
    """Incremental last-occurrence n-gram index over one token sequence.

    ``draft(k)`` proposes the k tokens that followed the most recent
    earlier occurrence of the trailing n-gram. O(1) per appended token,
    O(k) per draft."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError("ngram n must be >= 1")
        self.n = n
        self.tokens: List[int] = []
        # gram -> index just past its most recent occurrence, and the one
        # before: at draft time the tail itself is the most recent
        # occurrence, so the useful one is ``_prev``.
        self._last: Dict[Tuple[int, ...], int] = {}
        self._prev: Dict[Tuple[int, ...], int] = {}

    def extend(self, tokens: List[int]) -> None:
        for t in tokens:
            self.append(t)

    def append(self, tok: int) -> None:
        self.tokens.append(tok)
        n = self.n
        if len(self.tokens) >= n:
            gram = tuple(self.tokens[-n:])
            old = self._last.get(gram)
            if old is not None:
                self._prev[gram] = old
            self._last[gram] = len(self.tokens)

    def draft(self, k: int) -> List[int]:
        """Up to k tokens continuing the current tail; [] when the trailing
        n-gram has no earlier occurrence."""
        n = self.n
        if k <= 0 or len(self.tokens) < n:
            return []
        gram = tuple(self.tokens[-n:])
        cont = self._last.get(gram)
        if cont is not None and cont >= len(self.tokens):
            cont = self._prev.get(gram)
        if cont is None:
            return []
        return self.tokens[cont:cont + k]
