"""Radix prefix cache: share KV pages across requests with common prefixes
(a copy of ``rbg_tpu/engine/radix_cache.py``, which imports no framework).

SGLang's signature serving optimization (RadixAttention), page-granular for
TPU: only whole frozen pages are shared (no copy-on-write on device), so a
cache hit contributes ``(match_len // page_size) * page_size`` reusable
tokens. Eviction is LRU over leaves, integrated with the PageAllocator's
refcounts: a cached page is freed only when no running request references it.

Recency is a logical clock (one tick per touch), where the reference reads
``time.monotonic()``: the same order wherever that clock advances between
touches, and ties broken by the trie alone. The ranks of a mesh
(``Engine(mesh=...)``), making the same calls, so evict the same leaves
(and spill the same pages to a host tier) whatever their clocks read.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

_ticks = itertools.count()


class _Node:
    __slots__ = ("key", "pages", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], pages: List[int], parent):
        self.key = key           # token chunk (page_size tokens per page)
        self.pages = pages       # physical page ids, len == len(key)/page_size
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_used = next(_ticks)


class RadixCache:
    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _Node((), [], None)
        self._nodes = 0
        self._cached_pages = 0

    # ---- lookup ----

    def match(self, tokens: List[int]) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix. Returns (matched_tokens,
        pages). Caller must ``allocator.share`` via ``lock()`` if it uses
        them (we do it here for atomicity)."""
        ps = self.page_size
        node = self.root
        pages: List[int] = []
        i = 0
        n = len(tokens)
        while True:
            node.last_used = next(_ticks)
            if i >= n:
                break
            child = node.children.get(tokens[i])
            if child is None:
                break
            # Page-granular partial-node matching: take every fully-agreeing
            # page of the child, even when the query ends inside its key.
            kl = len(child.key)
            limit = min(kl, n - i)
            common = 0
            while common < limit and child.key[common] == tokens[i + common]:
                common += 1
            full_pages = common // ps
            pages.extend(child.pages[:full_pages])
            i += full_pages * ps
            if common < kl:
                break  # diverged or query exhausted inside this node
            node = child
        if pages:
            self.allocator.share(pages)  # lock for the caller
        return i, pages

    def peek(self, tokens: List[int]) -> int:
        """Advisory matched-token depth: no page sharing, no LRU touch.
        The admission-side TTFT predictor reads this from a submitter
        thread while the loop thread owns the trie — pure dict reads,
        tolerant of a stale answer (callers wrap it best-effort)."""
        ps = self.page_size
        node = self.root
        i, n = 0, len(tokens)
        while i < n:
            child = node.children.get(tokens[i])
            if child is None:
                break
            kl = len(child.key)
            limit = min(kl, n - i)
            common = 0
            while common < limit and child.key[common] == tokens[i + common]:
                common += 1
            i += (common // ps) * ps
            if common < kl:
                break
            node = child
        return i

    # ---- insert ----

    def insert(self, tokens: List[int], pages: List[int]) -> None:
        """Insert a finished sequence's page-aligned prefix. Takes a NEW
        reference on the inserted pages (caller keeps its own and releases it
        separately)."""
        ps = self.page_size
        usable = (len(tokens) // ps) * ps
        tokens = tokens[:usable]
        pages = pages[:usable // ps]
        node = self.root
        i = 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                key = tuple(tokens[i:])
                new_pages = pages[i // ps:]
                self.allocator.share(new_pages)
                node.children[tokens[i]] = _Node(key, list(new_pages), node)
                self._nodes += 1
                self._cached_pages += len(new_pages)
                return
            kl = len(child.key)
            if tuple(tokens[i:i + kl]) == child.key:
                node = child
                node.last_used = next(_ticks)
                i += kl
                continue
            # Diverging inside a node: split at the longest common
            # page-aligned boundary.
            common_pages = 0
            for j in range(min(kl, len(tokens) - i) // ps):
                if child.key[j * ps:(j + 1) * ps] == tuple(tokens[i + j * ps:i + (j + 1) * ps]):
                    common_pages += 1
                else:
                    break
            if common_pages == 0:
                return  # nothing page-aligned in common under this child
            split = common_pages * ps
            mid = _Node(child.key[:split], child.pages[:common_pages], node)
            child.key = child.key[split:]
            child.pages = child.pages[common_pages:]
            child.parent = mid
            mid.children[child.key[0]] = child
            node.children[tokens[i]] = mid
            self._nodes += 1
            node = mid
            i += split

    # ---- eviction ----

    def evict(self, need_pages: int, on_evict=None) -> int:
        """Evict LRU leaves until ``need_pages`` pages were released (or the
        tree is empty). Returns pages released. Pages still referenced by
        running requests survive via refcounts.

        ``on_evict(prefix_tokens, pages)`` — called per evicted leaf
        BEFORE its pages are released, with the FULL root→leaf token
        prefix — is the device→host spill hook: the page contents are
        still valid on device at that point, so the host tier can copy
        them out before the allocator may recycle the ids."""
        released = 0
        while released < need_pages:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            if on_evict is not None and leaf.pages:
                on_evict(self._full_prefix(leaf), list(leaf.pages))
            free_before = self.allocator.free_pages
            self.allocator.release(leaf.pages)
            # Only pages whose refcount hit zero actually freed — pages still
            # pinned by running requests don't count toward the goal.
            released += self.allocator.free_pages - free_before
            parent = leaf.parent
            parent.children = {
                t: c for t, c in parent.children.items() if c is not leaf
            }
            self._nodes -= 1
            self._cached_pages -= len(leaf.pages)
        return released

    @staticmethod
    def _full_prefix(node: "_Node") -> List[int]:
        """Root→node token prefix (page-aligned by construction — every
        node's pages cover its whole key)."""
        parts = []
        while node is not None and node.key:
            parts.append(node.key)
            node = node.parent
        out: List[int] = []
        for key in reversed(parts):
            out.extend(key)
        return out

    def _lru_leaf(self) -> Optional[_Node]:
        best = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            kids = list(node.children.values())
            if not kids and node is not self.root:
                if best is None or node.last_used < best.last_used:
                    best = node
            stack.extend(kids)
        return best

    @property
    def num_nodes(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        """Pages this cache currently indexes — the DEVICE tier's
        population for the rbg_kvcache_tier_pages accounting."""
        return self._cached_pages
