"""Measured link rates (``rbg_tpu/kvtransfer/transport.py``'s
``LinkStats``; the transports themselves come with PD serving).

The router's transfer-cost scoring reads measured rates, never
configured hopes: every transfer reports its observed rate here
(``rbg_kvtransfer_link_bytes_per_s``).
"""

from __future__ import annotations

from typing import Dict, Optional

from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_lock

class LinkStats:
    """Measured per-link throughput (EWMA over real transfers). Keyed by
    an arbitrary peer/transport label; thread-safe leaf state."""

    ALPHA = 0.3
    MIN_SAMPLE_BYTES = 1 << 12   # ignore tiny frames; latency dominates

    def __init__(self, transport: str):
        self.transport = transport
        self._lock = named_lock("kvtransfer.linkstats")
        self._rate: Dict[str, float] = {}  # guarded_by[kvtransfer.linkstats]

    def observe(self, peer: str, nbytes: int, seconds: float) -> None:
        if seconds <= 0 or nbytes < self.MIN_SAMPLE_BYTES:
            return
        rate = nbytes / seconds
        with self._lock:
            prev = self._rate.get(peer)
            cur = rate if prev is None else \
                (1 - self.ALPHA) * prev + self.ALPHA * rate
            self._rate[peer] = cur
        REGISTRY.set_gauge(obs_names.KVT_LINK_RATE, cur,
                           transport=self.transport, peer=peer)

    def rate(self, peer: str, default: Optional[float] = None) -> Optional[float]:
        with self._lock:
            return self._rate.get(peer, default)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._rate)
