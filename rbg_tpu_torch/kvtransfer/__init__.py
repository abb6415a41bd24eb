"""The KV transfer plane's pieces the host KV tier and the router use:
``chunks.payload_checksum`` and ``chunks.prefix_keys`` (the page CRC and
the cluster directory's sha1 key chain, equal to ``rbg_tpu``'s bit for
bit) and ``transport.LinkStats`` (measured link rates). The chunk
streams, transports and the prefix directory come with PD serving."""

from rbg_tpu_torch.kvtransfer.chunks import payload_checksum, prefix_keys
from rbg_tpu_torch.kvtransfer.transport import LinkStats

__all__ = ["LinkStats", "payload_checksum", "prefix_keys"]
