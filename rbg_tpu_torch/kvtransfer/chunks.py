"""KV chunk model for the transfer plane.

A prefill→decode KV handoff is a STREAM of frames instead of one
monolithic ``KVBundle`` (Mooncake's KVCache-centric transfer, PAPERS.md):

* ``StreamMeta``  — opens the stream: prompt, page geometry, dtypes.
  Arrives first; the receiver allocates its host staging buffers from it.
* ``KVChunk``     — one page-aligned, layer-ranged slab of K+V payload:
  ``[layer_lo:layer_hi) x [page_lo:page_hi)``. Chunks are published in
  layer order within a page group, page groups in prompt order — AS the
  prefill computes them — but the receiver tolerates reordering and
  duplicate delivery (a lossy link's retransmit must not corrupt KV).
* ``StreamFirstToken`` — the prefill-sampled first token, sent the moment
  prefill compute ends. Decode admission needs (full coverage AND the
  first token); everything after this frame is bookkeeping.
* ``StreamFin``   — closes the stream: chunk count for truncation
  detection. Admission deliberately does NOT wait for it — that is the
  overlap the plane exists to create.

Everything here is numpy/stdlib only (no torch): the wire processes
import it before an engine exists. numpy has no bfloat16, so a bfloat16
payload is held as an int16 view of its bits (``host_dtype``); the wire
keeps the reference's ``"bfloat16"`` name and bytes, so a ``rbg_tpu``
peer and a port peer read each other's frames.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from rbg_tpu_torch.engine.protocol import CODE_KV_INTEGRITY, CODE_KV_STREAM
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY


# Wire dtype name → (host numpy dtype, bytes per element). The names are
# the reference's (``str`` of a JAX array's dtype); bfloat16 rides as the
# same-width integer view of its bits.
WIRE_DTYPES = {
    "float32": (np.float32, 4),
    "float16": (np.float16, 2),
    "bfloat16": (np.int16, 2),
    "int8": (np.int8, 1),
}


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a payload of wire dtype ``name`` is held in."""
    entry = WIRE_DTYPES.get(name)
    return np.dtype(entry[0] if entry is not None else name)


def dtype_width(name: str) -> int:
    """Bytes per element of wire dtype ``name``."""
    entry = WIRE_DTYPES.get(name)
    return entry[1] if entry is not None else np.dtype(name).itemsize


@dataclasses.dataclass
class StreamMeta:
    stream_id: str
    prompt: List[int]
    n_pages: int
    # Per-page payload shapes EXCLUDING the layer and page axes:
    # k page slab is [L, n_pages, *k_page_shape] (e.g. (page, KV, hd)).
    k_page_shape: Tuple[int, ...]
    v_page_shape: Tuple[int, ...]
    dtype: str
    layers: int
    page_size: int

    def k_shape(self) -> Tuple[int, ...]:
        return (self.layers, self.n_pages) + tuple(self.k_page_shape)

    def v_shape(self) -> Tuple[int, ...]:
        return (self.layers, self.n_pages) + tuple(self.v_page_shape)

    def nbytes(self) -> int:
        item = dtype_width(self.dtype)
        per_page = (int(np.prod(self.k_page_shape))
                    + int(np.prod(self.v_page_shape)))
        return self.layers * self.n_pages * per_page * item


@dataclasses.dataclass
class KVChunk:
    stream_id: str
    seq: int
    layer_lo: int
    layer_hi: int
    page_lo: int
    page_hi: int
    k_bytes: bytes
    v_bytes: bytes
    # End-to-end payload checksum minted by the PRODUCER (slab_to_chunks)
    # and verified at decode commit (ChunkAssembler.feed) — None only for
    # frames from a pre-checksum sender (back-compat: verify when present).
    checksum: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return len(self.k_bytes) + len(self.v_bytes)

    def key(self) -> Tuple[int, int, int, int]:
        return (self.layer_lo, self.layer_hi, self.page_lo, self.page_hi)


@dataclasses.dataclass
class StreamFirstToken:
    stream_id: str
    first_token: int


@dataclasses.dataclass
class StreamFin:
    stream_id: str
    n_chunks: int
    aborted: bool = False
    error: str = ""


# Any frame kind riding a transport.
Frame = object


class StreamError(RuntimeError):
    """Structured stream failure (truncated, aborted, shape mismatch) —
    the receiver surfaces it instead of wedging on a never-ready row.
    ``wire_code`` rides error frames so the ROUTER recognizes the class
    and recovers by re-prefilling in bundle mode instead of surfacing a
    raw error to the client."""

    wire_code = CODE_KV_STREAM


class KVIntegrityError(StreamError):
    """A KV payload failed its end-to-end checksum — bytes corrupted
    between the producer's compute and the consumer's commit. A subclass
    of ``StreamError`` so every existing recovery path (receiver error
    surface, router bundle-fallback replay) engages unchanged; the
    distinct ``wire_code`` keeps "bytes lied" separable from "link
    flaked" at the edge and in accounting."""

    wire_code = CODE_KV_INTEGRITY


def payload_checksum(k_bytes: bytes, v_bytes: bytes) -> int:
    """CRC32 over the concatenated K+V payload — cheap enough to run on
    every chunk/page, strong enough to catch the bit flips and torn
    writes partitioned links actually produce (not an adversarial MAC)."""
    return zlib.crc32(v_bytes, zlib.crc32(k_bytes))


def plan_chunks(meta: StreamMeta, page_lo: int, page_hi: int,
                layer_split: int) -> List[Tuple[int, int, int, int]]:
    """(layer_lo, layer_hi, page_lo, page_hi) plan for one page group,
    layer-ordered: the receiver sees low layers of a page group first, so
    a layer-pipelining decoder could start before the group completes.
    ``layer_split`` caps layers per chunk (1 = one chunk per layer)."""
    out = []
    step = max(1, int(layer_split))
    for lo in range(0, meta.layers, step):
        out.append((lo, min(lo + step, meta.layers), page_lo, page_hi))
    return out


def slab_to_chunks(meta: StreamMeta, k_slab: np.ndarray, v_slab: np.ndarray,
                   page_lo: int, seq0: int,
                   layer_split: int) -> List[KVChunk]:
    """Cut one freshly-computed page group (``k_slab``/``v_slab`` are
    ``[L, pages, ...]`` covering pages ``[page_lo, page_lo+pages)``) into
    layer-ordered chunks ready to send."""
    chunks = []
    pages = k_slab.shape[1]
    for i, (llo, lhi, plo, phi) in enumerate(
            plan_chunks(meta, page_lo, page_lo + pages, layer_split)):
        kb = np.ascontiguousarray(
            k_slab[llo:lhi, plo - page_lo:phi - page_lo]).tobytes()
        vb = np.ascontiguousarray(
            v_slab[llo:lhi, plo - page_lo:phi - page_lo]).tobytes()
        chunks.append(KVChunk(
            stream_id=meta.stream_id, seq=seq0 + i,
            layer_lo=llo, layer_hi=lhi, page_lo=plo, page_hi=phi,
            k_bytes=kb, v_bytes=vb,
            checksum=payload_checksum(kb, vb),
        ))
    return chunks


def bundle_to_frames(meta: StreamMeta, k_data: np.ndarray,
                     v_data: np.ndarray, first_token: int,
                     layer_split: int = 0) -> List[Frame]:
    """Whole-bundle → frame list (meta, chunks, first token, fin) — the
    replay/retransmit source and the contract-test generator.
    ``layer_split`` 0 means one chunk for all layers per page group."""
    split = layer_split or meta.layers
    chunks: List[KVChunk] = []
    for plo in range(0, meta.n_pages):
        chunks.extend(slab_to_chunks(
            meta, k_data[:, plo:plo + 1], v_data[:, plo:plo + 1],
            plo, len(chunks), split))
    return ([meta] + list(chunks)
            + [StreamFirstToken(meta.stream_id, first_token),
               StreamFin(meta.stream_id, n_chunks=len(chunks))])


class ChunkAssembler:
    """Host-side reassembly of a chunk stream into full ``[L, n_pages,
    ...]`` K/V arrays, tolerant of reordering and duplicate delivery.

    Not thread-safe by itself — the owning receiver serializes feeds.
    ``coverage_complete()`` is the admission predicate: every (layer,
    page) cell seen at least once. All of this is host memory; the device
    page-table commit belongs to the engine loop thread.
    """

    def __init__(self, meta: StreamMeta):
        self.meta = meta
        dt = host_dtype(meta.dtype)
        self.k = np.zeros(meta.k_shape(), dt)
        self.v = np.zeros(meta.v_shape(), dt)
        # Per-cell arrival map [L, n_pages] — duplicates simply rewrite.
        self._have = np.zeros((meta.layers, meta.n_pages), bool)
        self.first_token: Optional[int] = None
        self.fin: Optional[StreamFin] = None
        self.chunks_seen = 0
        self.dup_chunks = 0
        self.reordered_chunks = 0
        self.bytes_seen = 0
        self._max_seq = -1
        # (layer_lo, layer_hi, page_lo, page_hi) cells already applied —
        # the "new for the page table" delta the committer drains.
        self._uncommitted: List[Tuple[int, int, int, int]] = []

    def feed(self, frame: Frame) -> None:
        if isinstance(frame, StreamMeta):
            return  # receiver constructed us from it
        if isinstance(frame, StreamFirstToken):
            self.first_token = int(frame.first_token)
            return
        if isinstance(frame, StreamFin):
            self.fin = frame
            return
        ch: KVChunk = frame
        m = self.meta
        if not (0 <= ch.layer_lo < ch.layer_hi <= m.layers
                and 0 <= ch.page_lo < ch.page_hi <= m.n_pages):
            raise StreamError(
                f"chunk range out of bounds: layers [{ch.layer_lo},"
                f"{ch.layer_hi}) pages [{ch.page_lo},{ch.page_hi}) for "
                f"meta L={m.layers} n_pages={m.n_pages}")
        dt = host_dtype(m.dtype)
        kshape = (ch.layer_hi - ch.layer_lo, ch.page_hi - ch.page_lo) \
            + tuple(m.k_page_shape)
        vshape = (ch.layer_hi - ch.layer_lo, ch.page_hi - ch.page_lo) \
            + tuple(m.v_page_shape)
        if (len(ch.k_bytes) != int(np.prod(kshape)) * dt.itemsize
                or len(ch.v_bytes) != int(np.prod(vshape)) * dt.itemsize):
            raise StreamError(
                f"chunk payload size mismatch for range layers "
                f"[{ch.layer_lo},{ch.layer_hi}) pages "
                f"[{ch.page_lo},{ch.page_hi})")
        if self._have[ch.layer_lo:ch.layer_hi,
                      ch.page_lo:ch.page_hi].all():
            # Retransmit of cells already committed — tolerated, but a
            # degrading link retransmits before it truncates: count it.
            self.dup_chunks += 1
            REGISTRY.inc(obs_names.KVT_CHUNKS_DUPLICATE_TOTAL)
            return
        if ch.seq < self._max_seq:
            # Arrived after a higher seq (duplicates excluded above):
            # the link is reordering — visible before it corrupts.
            self.reordered_chunks += 1
            REGISTRY.inc(obs_names.KVT_CHUNKS_REORDERED_TOTAL)
        self._max_seq = max(self._max_seq, ch.seq)
        if ch.checksum is not None \
                and payload_checksum(ch.k_bytes, ch.v_bytes) != ch.checksum:
            # Verified BEFORE the bytes touch the assembly buffers: a
            # corrupt payload never becomes committable KV. The error
            # rides the receiver's structured-failure surface, so the
            # router replays the whole stream token-exact (bundle
            # fallback) — never a wedge, never silent corruption.
            REGISTRY.inc(obs_names.KVT_INTEGRITY_FAILURES_TOTAL,
                         surface="chunk")
            raise KVIntegrityError(
                f"chunk seq={ch.seq} layers [{ch.layer_lo},{ch.layer_hi}) "
                f"pages [{ch.page_lo},{ch.page_hi}) failed its payload "
                f"checksum — corrupted in flight")
        self.k[ch.layer_lo:ch.layer_hi, ch.page_lo:ch.page_hi] = \
            np.frombuffer(ch.k_bytes, dt).reshape(kshape)
        self.v[ch.layer_lo:ch.layer_hi, ch.page_lo:ch.page_hi] = \
            np.frombuffer(ch.v_bytes, dt).reshape(vshape)
        self._have[ch.layer_lo:ch.layer_hi, ch.page_lo:ch.page_hi] = True
        self.chunks_seen += 1
        self.bytes_seen += ch.nbytes
        self._uncommitted.append(ch.key())

    def coverage_complete(self) -> bool:
        return bool(self._have.all())

    def layer_coverage(self) -> int:
        """Number of LEADING layers with every page cell covered — the
        layer-sliced admission watermark. Chunks are published layer-
        ordered within a page group (``plan_chunks``), so on an in-order
        link this grows monotonically front-to-back; on a lossy/reordered
        link it is simply the honest prefix."""
        full = self._have.all(axis=1)           # [L]
        return int(np.cumprod(full).sum())

    def ready(self) -> bool:
        """Admission predicate: full coverage + the prefill-sampled first
        token. Deliberately independent of FIN."""
        return self.coverage_complete() and self.first_token is not None

    def ready_layers(self, min_layers: int) -> bool:
        """Layer-sliced admission predicate: the first ``min_layers``
        layers fully covered + the first token — the Mooncake-style
        layer-ordered arrival finally pays off (decode's layer 0 can
        start while layer L-1 is still on the wire)."""
        return (self.first_token is not None
                and self.layer_coverage() >= min_layers)

    def drain_uncommitted(self) -> List[Tuple[int, int, int, int]]:
        out, self._uncommitted = self._uncommitted, []
        return out

    def check_closed(self) -> None:
        """After FIN: raise a structured error on truncation/abort instead
        of letting a half-stream read as a wedge."""
        if self.fin is None:
            return
        if self.fin.aborted:
            raise StreamError(self.fin.error or "stream aborted by sender")
        if not self.coverage_complete():
            missing = int((~self._have).sum())
            raise StreamError(
                f"stream closed with {missing} uncovered (layer, page) "
                f"cells — truncated transfer")


# ---- cluster prefix keys -----------------------------------------------


def prefix_keys(tokens: List[int], page_size: int) -> List[str]:
    """Stable page-aligned prefix keys: a hash CHAIN, one key per full
    page, key_i covering tokens[0:(i+1)*page_size]. sha1-based so every
    process (any PYTHONHASHSEED) derives identical keys — the cluster
    directory's join key."""
    out = []
    h = hashlib.sha1()
    n = (len(tokens) // page_size) * page_size
    for i in range(0, n, page_size):
        h.update(np.asarray(tokens[i:i + page_size], np.int64).tobytes())
        out.append(h.hexdigest()[:20])
        h = hashlib.sha1(out[-1].encode())
    return out
