"""A paced test link that makes layer-sliced PD admission certain, for
tests/test_torch_pd.py and tests/torch_tp_service_worker.py.

``HeldTailLink`` passes a stream's META, its first token and its chunks of
layers below ``admit_layers``, and holds the chunks of the layers past
them, and the FIN, until ``release()``; ``hold_tail(pair, link)`` makes a
``PDStreamPair``'s admission release them. So the decode side always sees
layer-k coverage without full coverage, whatever the host's load, and the
layer-sliced chain runs under a real transfer tail. Each new stream's META
holds again. Imports no JAX."""

import queue
import threading

from rbg_tpu_torch.kvtransfer.chunks import KVChunk, StreamFin, StreamMeta
from rbg_tpu_torch.kvtransfer.transport import FakeICITransport


class HeldTailLink(FakeICITransport):
    def __init__(self, admit_layers: int, bytes_per_s: float = 2e5,
                 latency_s: float = 0.0005):
        super().__init__(bytes_per_s=bytes_per_s, latency_s=latency_s)
        self.admit_layers = admit_layers
        self.holding = True
        self.held = []
        self._hold_lock = threading.Lock()
        # After a first release every frame goes, paced and in order, by
        # one thread: a frame sent later must not overtake the released
        # tail (the receiver stops at FIN).
        self._fifo = None

    def send_one(self, peer, frame):
        with self._hold_lock:
            if isinstance(frame, StreamMeta):
                self.holding = True
            tail = (isinstance(frame, StreamFin)
                    or (isinstance(frame, KVChunk)
                        and frame.layer_hi > self.admit_layers))
            if self.holding and tail:
                self.held.append((peer, frame))
                return
            if self._fifo is not None:
                self._fifo.put((peer, frame))
                return
        super().send_one(peer, frame)

    def release(self):
        """Queue the held tail behind nothing, for the link's sender thread:
        the decode side's layer-sliced chain runs under it."""
        with self._hold_lock:
            if self._fifo is None:
                self._fifo = queue.Queue()
                threading.Thread(target=self._send_fifo, daemon=True,
                                 name="held-tail").start()
            held, self.held, self.holding = self.held, [], False
            for item in held:
                self._fifo.put(item)

    def _send_fifo(self):
        while True:
            peer, frame = self._fifo.get()
            super().send_one(peer, frame)


def hold_tail(pair, link):
    """Release ``link``'s held tail when ``pair`` admits a row (layer-sliced
    or full), before the decode side waits on it."""
    for name in ("finalize_stream_layer_sliced", "finalize_stream"):
        real = getattr(pair.decode, name)

        def admitted(*a, _real=real, **kw):
            link.release()
            return _real(*a, **kw)

        setattr(pair.decode, name, admitted)
    return pair
