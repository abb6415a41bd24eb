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

Writing takes a tensor, or a list of equal-shaped tensors that is written
as their stack (``[len, ...]``) one tensor at a time without building it.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Sequence, Union

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}

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
        info = self.header[name]
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"{self.path}: tensor {name!r} has dtype "
                            f"{info['dtype']}, which this reader does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=self.device)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._start + begin)
        if (self._start + begin) % dtype.itemsize:     # a misaligned writer's
            raw = raw.clone()
        t = raw.view(dtype).reshape(shape)
        return t.to(self.device, copy=True) if self.device is not None else t.clone()

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
