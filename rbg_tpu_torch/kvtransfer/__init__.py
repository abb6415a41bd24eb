"""KVCache-centric transfer plane (``rbg_tpu/kvtransfer``): chunked,
layer-overlapped prefill→decode KV streaming over an explicit transport
seam, the page checksums and the cluster-wide prefix directory the
router's cache-aware and transfer-cost-aware routing consults. The frames,
their wire form and the prefix keys equal ``rbg_tpu``'s byte for byte.
"""

from rbg_tpu_torch.kvtransfer.chunks import (ChunkAssembler, KVChunk,
                                             KVIntegrityError, StreamError,
                                             StreamFin, StreamFirstToken,
                                             StreamMeta, bundle_to_frames,
                                             payload_checksum, plan_chunks,
                                             prefix_keys, slab_to_chunks)
from rbg_tpu_torch.kvtransfer.directory import DirectoryClient, PrefixDirectory
from rbg_tpu_torch.kvtransfer.stream import KVStreamReceiver, StreamRegistry
from rbg_tpu_torch.kvtransfer.transport import (FakeICITransport,
                                                InProcTransport, LinkStats,
                                                SlowLossyTransport,
                                                TCPTransport, Transport,
                                                frame_from_wire, frame_to_wire)

__all__ = [
    "ChunkAssembler", "KVChunk", "KVIntegrityError", "StreamError",
    "StreamFin", "StreamFirstToken", "StreamMeta", "bundle_to_frames",
    "payload_checksum", "plan_chunks", "prefix_keys", "slab_to_chunks",
    "DirectoryClient", "PrefixDirectory",
    "KVStreamReceiver", "StreamRegistry",
    "FakeICITransport", "InProcTransport", "LinkStats",
    "SlowLossyTransport", "TCPTransport", "Transport",
    "frame_from_wire", "frame_to_wire",
]
