"""KV payload checksums and cluster prefix keys
(``rbg_tpu/kvtransfer/chunks.py``; the chunk model of a streamed
prefill→decode handoff comes with PD serving).

Everything here is numpy/stdlib only: the wire processes import it
before an engine exists.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import List

import numpy as np


def payload_checksum(k_bytes: bytes, v_bytes: bytes) -> int:
    """CRC32 over the concatenated K+V payload — cheap enough to run on
    every chunk/page, strong enough to catch the bit flips and torn
    writes partitioned links actually produce (not an adversarial MAC)."""
    return zlib.crc32(v_bytes, zlib.crc32(k_bytes))


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
