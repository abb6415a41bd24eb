"""The safetensors format, read and written here (no ``safetensors``
package needed).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the raw little-endian buffer;
offsets count from the buffer's start. The header is padded with spaces to
a multiple of 8 bytes, as the reference writer pads it.

Reading maps the file (``mmap``) and copies one tensor at a time to where
the caller wants it, so a 16 GB file is never held twice in host memory.
BF16 comes back as a ``torch.bfloat16`` view of the stored bits, never
through numpy floats. A sharded checkpoint's ``model.safetensors.index.json``
(``{"weight_map": {name: file}}``) is read by ``open_index``.

``read_slice`` copies out only part of a tensor (a rank's slice under a
mesh): per-dim ``(start, length)`` narrowings of the mapped bytes. A slice
that is contiguous in the file goes straight from the map to the target;
a strided one (a split of an inner dim) is gathered into one host staging
buffer a few leading indices at a time (one layer of a stacked ``[L, ...]``
tensor) and copied on from there, so the host stages at most that much.
Every read adds to ``READS``: the bytes copied out and the largest staging
buffer.

Writing takes a tensor, or a list of equal-shaped tensors that is written
as their stack (``[len, ...]``) one tensor at a time without building it.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}

# What the reads copied out of their maps (``bytes``), the tensors read and
# the largest host staging buffer a strided slice took (``staging_max``).
READS: Dict[str, int] = {"bytes": 0, "tensors": 0, "staging_max": 0}

Narrowing = Sequence[Optional[Tuple[int, int]]]


def reset_reads() -> None:
    for k in READS:
        READS[k] = 0

Writable = Union[torch.Tensor, Sequence[torch.Tensor]]


class SafeFile(Mapping):
    """One safetensors file, mapped: ``f[name]`` is that tensor, copied out
    of the map (to ``device`` when given at open, else a CPU tensor)."""

    def __init__(self, path: str, device=None):
        self.path, self.device = path, device
        self._file = open(path, "rb")
        (n,) = struct.unpack("<Q", self._file.read(8))
        header = json.loads(self._file.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self.header = header
        self._start = 8 + n
        size = os.path.getsize(path)
        self._map = (mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
                     if size > self._start else None)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.read_slice(name)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.header[name]["shape"])

    def dtype(self, name: str) -> Optional[torch.dtype]:
        return DTYPES.get(self.header[name]["dtype"])

    def read_slice(self, name: str, narrow: Optional[Narrowing] = None, device=None,
                   stage_bytes: Optional[int] = None) -> torch.Tensor:
        """Tensor ``name`` narrowed by ``narrow`` (per dim, None or
        ``(start, length)``; None: the whole tensor), copied out of the map
        into a tensor of its own on ``device`` (default: the file's). A
        strided slice is staged on the host in chunks of whole leading
        indices, each at most ``stage_bytes`` (at least one index; default
        one), on every device alike."""
        info = self.header[name]
        dtype = self.dtype(name)
        if dtype is None:
            raise TypeError(f"{self.path}: tensor {name!r} has dtype "
                            f"{info['dtype']}, which this reader does not take")
        device = torch.device(device if device is not None else self.device or "cpu")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        # The bytes as [*shape, itemsize] uint8: any data offset views, so a
        # misaligned writer's tensor costs no whole-tensor copy.
        src = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._start + begin) if end > begin else \
            torch.empty(0, dtype=torch.uint8)
        src = src.view(*shape, dtype.itemsize)
        for dim, cut in enumerate(narrow or ()):
            if cut is not None:
                src = src.narrow(dim, *cut)
        out = torch.empty(src.shape[:-1], dtype=dtype, device=device)
        dst = out.reshape(-1).view(torch.uint8).view(src.shape)
        READS["bytes"] += dst.numel()
        READS["tensors"] += 1
        if src.is_contiguous():
            dst.copy_(src)
            return out
        row = max(1, dst[0].numel())
        step = max(1, (stage_bytes or row) // row)
        stage = None
        for i in range(0, len(dst), step):
            part = src[i:i + step]
            if part.is_contiguous():
                dst[i:i + step].copy_(part)
                continue
            if stage is None:
                stage = torch.empty((min(step, len(dst)), *dst.shape[1:]), dtype=torch.uint8)
                READS["staging_max"] = max(READS["staging_max"], stage.numel())
            n = len(part)
            stage[:n].copy_(part)
            dst[i:i + n].copy_(stage[:n])
        return out

    def __contains__(self, name) -> bool:      # the header's, not a read
        return name in self.header

    def __iter__(self) -> Iterator[str]:
        return iter(self.header)

    def __len__(self) -> int:
        return len(self.header)

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedFiles(Mapping):
    """The tensors of several files (a sharded checkpoint) as one mapping,
    each read from its own file on access."""

    def __init__(self, paths: Sequence[str], device=None):
        self.files = [SafeFile(p, device) for p in paths]
        self._where = {name: f for f in self.files for name in f.header}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name][name]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._where[name].shape(name)

    def dtype(self, name: str) -> Optional[torch.dtype]:
        return self._where[name].dtype(name)

    def read_slice(self, name: str, narrow: Optional[Narrowing] = None, device=None,
                   stage_bytes: Optional[int] = None) -> torch.Tensor:
        return self._where[name].read_slice(name, narrow, device, stage_bytes)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)

    def close(self):
        for f in self.files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_index(index_path: str, device=None) -> ShardedFiles:
    """A sharded checkpoint through its ``*.safetensors.index.json``."""
    with open(index_path) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    root = os.path.dirname(index_path)
    return ShardedFiles([os.path.join(root, name) for name in files], device)


def _parts(value: Writable):
    return list(value) if isinstance(value, (list, tuple)) else [value]


def save_file(tensors: Mapping[str, Writable], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` to ``path``; a list value is written as the stack
    of its tensors. Returns the bytes written. Tensors move to the host
    one at a time; the buffer holds the widest dtypes first, so every
    tensor starts aligned to its element size."""
    order = sorted(tensors, key=lambda k: -_parts(tensors[k])[0].element_size())
    header, offset = {}, 0
    for name in order:
        value = tensors[name]
        parts = _parts(value)
        first = parts[0]
        if any(p.shape != first.shape or p.dtype != first.dtype for p in parts):
            raise ValueError(f"{name}: stacked parts differ in shape or dtype")
        if first.dtype not in NAMES:
            raise TypeError(f"{name}: dtype {first.dtype} has no safetensors name")
        shape = ([len(parts)] if isinstance(value, (list, tuple)) else []) + list(first.shape)
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        header[name] = {"dtype": NAMES[first.dtype], "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            for p in _parts(tensors[name]):
                host = p.detach().to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
