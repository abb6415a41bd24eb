"""Host-DRAM KV spill tier — the device pool's second cache level
(``rbg_tpu/engine/kvtier.py``).

Mooncake's core claim (PAPERS.md: "Mooncake: A KVCache-centric
Disaggregated Architecture for LLM Serving") is "more storage for less
computation": a multi-tier KV cache where device memory is only the top
level. Without this tier, a device page-pool eviction throws the prefix
away forever — the next request with the same system prompt pays full
prefill. Here the radix cache's eviction hook copies the evicted pages
into this bounded host-DRAM trie, and an admission hit promotes them
back onto device (a MOVE, not a copy — every cached page lives in
exactly one tier, the ``tier_accounting`` invariant).

Backing store: ``engine.kvpool.KVPoolStore`` — the trie-over-numpy-pages
structure of the cluster KV pool — with placeholder path nodes (radix
eviction is leaf-first, so DEEP pages spill before shallow ones and the
route to them must survive) and LRU-by-hotness byte-budget eviction.

Device copies: a spill is one gather of the leaf's pages from both pools
(``index_select`` on the page axis by a device index) and one copy into
pinned host memory; a promotion is one host-to-device copy and an
in-place ``index_copy_`` into the engine's pools. Both run on the
engine's current stream: the gather is ordered after every kernel that
wrote the pool before it (a fused decode window still in flight
included), and the promoted pages land before the next forward reads
them. Pages whose dtype numpy lacks (bfloat16) are kept as a view of
their raw bits (int16), so a host page's ``nbytes`` and CRC are those of
the device page.

Accounting contract (``rbg_kvcache_tier_*``):

    spilled_pages_total == promoted_pages_total
                           + evicted_pages_total{tier="host"}
                           + tier_pages{tier="host"}

i.e. every page that ever entered the host tier either went back to
device, was evicted by the byte budget, or is still resident.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from rbg_tpu_torch.engine.kvpool import KVPoolStore
from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs.metrics import REGISTRY

TIER_DEVICE = "device"
TIER_HOST = "host"

# torch dtypes numpy has no type for: stored as a same-width integer view.
_BITS_VIEW = {torch.bfloat16: torch.int16}

# The reference pads every spill and promotion to a power-of-two page
# count (``_pow2_bucket``: one XLA program per distinct size) and scatters
# through a jitted program with donated pool buffers
# (``_promote_scatter``: an eager ``.at[].set`` would copy both pools).
# Eager PyTorch compiles nothing per size and ``index_copy_`` writes the
# pools in place, so neither reason holds here: the copies move exactly
# the pages asked for, and nothing is padded onto page 0.


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A gathered device tensor as a host numpy array of the same bytes.
    On the card: one synchronous copy into pinned memory (the host reads
    the bytes right after, for the page CRCs)."""
    if t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    bits = _BITS_VIEW.get(t.dtype)
    return (t.view(bits) if bits is not None else t).numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host pages back as a tensor of ``like``'s dtype on its device: one
    copy into host memory (pinned on the card; read-only wire buffers
    welcome), then one host-to-device copy on the current stream."""
    bits = _BITS_VIEW.get(like.dtype)
    host = torch.empty(a.shape, dtype=bits or like.dtype,
                       pin_memory=like.device.type != "cpu")
    host.numpy()[...] = a
    t = host.view(like.dtype) if bits is not None else host
    if like.device.type != "cpu":
        t = t.to(like.device, non_blocking=True)
    return t


class HostKVTier:
    """Bounded host-DRAM tier under the device page pool.

    Single-writer: every method is called from the engine loop thread
    (spill inside ``_alloc``'s eviction, promotion inside ``_admit``),
    except ``peek`` which the admission TTFT predictor reads from
    submitter threads — the backing store's lock covers that.
    """

    def __init__(self, page_size: int, max_bytes: int,
                 directory=None, advertise_addr: str = "",
                 slice_id: str = ""):
        self.page_size = page_size
        # The store invalidates directory keys itself on byte-budget
        # eviction (KVPoolStore.put contract) — a directory lookup can
        # never return a host page this tier no longer holds.
        self.store = KVPoolStore(page_size, max_bytes=max_bytes,
                                 directory=directory)
        self.store.owner_backend = advertise_addr
        self.directory = directory
        self.advertise_addr = advertise_addr
        self.slice_id = slice_id
        # Lifetime counters (the accounting identity above; store.stats()
        # carries the live pages/bytes side).
        self.spilled_pages = 0
        self.promoted_pages = 0

    # ---- device -> host (radix eviction hook) ----

    def spill_from_device(self, prefix_tokens: List[int],
                          page_ids: List[int], cache) -> int:
        """Copy an evicted radix leaf's device pages into the host trie.
        ``prefix_tokens`` is the FULL root→leaf prefix; ``page_ids`` are
        the leaf's device pages (its tail ``len(page_ids)`` pages of the
        prefix — shallower pages become placeholder path nodes until
        their own eviction spills them). Returns pages stored."""
        ps = self.page_size
        from_page = len(prefix_tokens) // ps - len(page_ids)
        if from_page < 0:
            return 0
        t0 = time.perf_counter()
        ids = torch.tensor(page_ids, dtype=torch.long,
                           device=cache.k_pages.device)
        k = _to_host(cache.k_pages.index_select(1, ids))
        v = _to_host(cache.v_pages.index_select(1, ids))
        evicted_before = self.store.stats()["evicted_pages"]
        stored = self.store.put(prefix_tokens, k, v,
                                data_from_page=from_page)
        REGISTRY.observe(names.KVC_TIER_SPILL_SECONDS,
                         time.perf_counter() - t0)
        if stored:
            self.spilled_pages += stored
            REGISTRY.inc(names.KVC_TIER_SPILLED_PAGES_TOTAL, float(stored))
        evicted = self.store.stats()["evicted_pages"] - evicted_before
        if evicted:
            REGISTRY.inc(names.KVC_TIER_EVICTED_PAGES_TOTAL, float(evicted),
                         tier=TIER_HOST)
        # Register only what the store ACTUALLY retained: put's own
        # byte-budget eviction may have dropped (and invalidated) the
        # very pages just stored — re-claiming them would hand the
        # router an unbacked host hit exactly under the memory pressure
        # this tier exists to absorb.
        retained = self.store.peek(prefix_tokens, from_page * ps) // ps
        self._register_spill(prefix_tokens, from_page,
                             from_page + retained)
        self.publish_gauges()
        return stored

    # ---- host -> device (admission promotion) ----

    def promote_to_device(self, tokens: List[int], start_tokens: int,
                          alloc_fn, cache,
                          release_fn=None) -> Tuple[int, List[int], object]:
        """Move the host-resident continuation of ``tokens`` past
        ``start_tokens`` (the device radix hit depth) onto device pages.
        ``alloc_fn(n)`` allocates device pages (None = no capacity, even
        after eviction — nothing is touched); ``release_fn(pages)``
        returns surplus pages when the run shrank between peek and take.
        Returns ``(extra_tokens, page_ids, cache)``; ``(0, [], cache)``
        when the host tier has nothing to add. The pools are written in
        place, so the returned cache is the one passed in."""
        t0 = time.perf_counter()
        # Peek → alloc → bounded take, in that order: taking first and
        # putting back on alloc failure would copy the full run out and
        # back EVERY STEP while a blocked head-of-queue request retries
        # against an exhausted pool — burning serving-loop memcpy and
        # spinning the store's hit/put counters during the exact
        # overload the hierarchy exists to survive. (peek mutates no
        # hotness/LRU state, so a failed attempt leaves no trace.)
        peeked = self.store.peek(tokens, start_tokens)
        if not peeked:
            return 0, [], cache
        pages = alloc_fn(peeked // self.page_size)
        if pages is None:
            return 0, [], cache
        # The alloc may have evicted INTO this store (spill hook), so
        # the run can only have GROWN — cap the take at what we can
        # place; a shrink (host byte-budget eviction) just takes less.
        extra, k, v = self.store.extend(tokens, start_tokens, take=True,
                                        max_tokens=peeked)
        n = extra // self.page_size
        if not extra:
            # Gone between peek and take (byte-budget eviction raced
            # via the alloc's spill) — return the unused device pages.
            if release_fn is not None:
                release_fn(pages)
            return 0, [], cache
        if n < len(pages):
            if release_fn is not None:
                release_fn(pages[n:])
            pages = pages[:n]
        ids = torch.tensor(pages, dtype=torch.long,
                           device=cache.k_pages.device)
        cache.k_pages.index_copy_(1, ids, _to_device(k, cache.k_pages))
        cache.v_pages.index_copy_(1, ids, _to_device(v, cache.v_pages))
        REGISTRY.observe(names.KVC_TIER_PROMOTE_SECONDS,
                         time.perf_counter() - t0)
        self.promoted_pages += n
        REGISTRY.inc(names.KVC_TIER_PROMOTED_PAGES_TOTAL, float(n))
        # Tier hit/miss counters are the ENGINE's, on admission success
        # only — a blocked head-of-queue request re-attempts every step
        # and would otherwise inflate the cache panel's rates exactly
        # when the pool-exhaustion it diagnoses is happening.
        # The prefix is device-held again: re-register so the cluster
        # directory's tier tag steers routing cost back to ~free.
        self._register(tokens[:start_tokens + extra], tier=TIER_DEVICE)
        self.publish_gauges()
        return extra, pages, cache

    def peek(self, tokens: List[int], start_tokens: int = 0) -> int:
        """Advisory continuation depth (no hotness/LRU mutation) — what
        a request would gain from this tier, for the TTFT predictor."""
        return self.store.peek(tokens, start_tokens)

    def wire_directory(self, directory, advertise_addr: str,
                       slice_id: str = "") -> None:
        """Late directory wiring (the server builds the directory client
        after the engine): both this tier's registrations AND the backing
        store's eviction invalidations must go to the same place."""
        self.directory = directory
        self.store.directory = directory
        # Scope the store's eviction invalidations to THIS replica's
        # claims — shared prefix hashes must not lose siblings' entries.
        self.store.owner_backend = advertise_addr
        self.advertise_addr = advertise_addr
        self.slice_id = slice_id

    # ---- accounting ----

    def _register(self, tokens: List[int], tier: str = TIER_HOST) -> None:
        if self.directory is None or not self.advertise_addr or not tokens:
            return
        try:
            self.directory.register(tokens, self.advertise_addr,
                                    slice_id=self.slice_id, tier=tier)
        except (OSError, RuntimeError, ValueError):
            pass  # the directory is an optimization, never a dependency

    def _register_spill(self, prefix_tokens: List[int], from_page: int,
                        until_page: int) -> None:
        """Per-tier-accurate registration of an evicted leaf's chain:
        the pages BELOW the leaf stay device-resident (radix eviction is
        leaf-first — the parent path survives until its own eviction),
        and only the spilled pages the store RETAINED ([from_page,
        until_page)) are claimed host-tier. Blanket-tagging the whole
        chain host would clobber a live device claim for the shallow
        pages or claim pages the byte budget already dropped."""
        if self.directory is None or not self.advertise_addr:
            return
        from rbg_tpu_torch.kvtransfer.chunks import prefix_keys
        keys = prefix_keys(prefix_tokens, self.page_size)
        try:
            if from_page:
                self.directory.register_keys(
                    keys[:from_page], self.advertise_addr,
                    slice_id=self.slice_id, tier=TIER_DEVICE)
            if until_page > from_page:
                self.directory.register_keys(
                    keys[from_page:until_page], self.advertise_addr,
                    slice_id=self.slice_id, tier=TIER_HOST)
        except (OSError, RuntimeError, ValueError):
            pass  # optimization, never a dependency

    def publish_gauges(self) -> None:
        s = self.store.stats()
        REGISTRY.set_gauge(names.KVC_TIER_PAGES, float(s["pages"]),
                           tier=TIER_HOST)
        REGISTRY.set_gauge(names.KVC_TIER_BYTES, float(s["bytes"]),
                           tier=TIER_HOST)

    def stats(self) -> dict:
        s = self.store.stats()
        s.update(spilled_pages=self.spilled_pages,
                 promoted_pages=self.promoted_pages)
        return s

    def accounting_closes(self) -> bool:
        """The exactly-one-tier identity: every page that ever spilled in
        is either promoted back out, byte-budget evicted, or resident."""
        s = self.store.stats()
        return self.spilled_pages == (self.promoted_pages
                                      + s["evicted_pages"] + s["pages"])
