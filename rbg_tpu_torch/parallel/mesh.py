"""Device meshes over ``torch.distributed`` (``rbg_tpu/parallel/mesh.py``).

Axis convention, as the reference's:

* ``dp`` — data parallel (batch rows);
* ``sp`` — sequence parallel (ring attention, ``parallel/ring.py``);
* ``ep`` — expert parallel (MoE experts split across ranks);
* ``tp`` — tensor parallel (Megatron column/row splits), innermost.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with these dim
names. Where the reference takes the first ``dp·sp·ep·tp`` devices of a
longer list, a torch mesh spans the whole world, so a size that is not the
world's is refused. In one process, ``make_mesh()`` forms a world of one
itself (a TCP store on a free local port); a world of several ranks is the
caller's ``torch.distributed.init_process_group``. The backend follows the
device: ``nccl`` on the card, ``gloo`` when the caller asks for the CPU.
A CUDA mesh also runs over a gloo world the caller formed: gloo carries
CUDA tensors, staged through the host, so several ranks may share one
card (NCCL refuses two ranks on one device); such collectives say
nothing about NVLink. An nccl world is refused for a CPU mesh.

The pipeline (``parallel/pipeline.py``) takes a one-dim mesh named ``pp``,
as the reference's tests build ``Mesh(devices, ("pp",))``: ``pp`` is not
one of ``AXES`` there either.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("dp", "sp", "ep", "tp")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def device_type(device=None) -> str:
    """``cuda`` unless the caller asks for the CPU; without a card and
    without that request this raises, as every entry point of the port
    does."""
    if device is None:
        from rbg_tpu_torch.engine.config import resolve_device
        resolve_device(None)
        return "cuda"
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return kind


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ensure_world(kind: str, want: int) -> None:
    """Form a one-rank world on ``kind``'s backend when none exists (and
    ``want`` is 1); refuse a world whose backend cannot carry ``kind``'s
    tensors (nccl for the CPU)."""
    backend = _BACKENDS[kind]
    if not dist.is_initialized():
        if want != 1:
            raise ValueError(f"a mesh of {want} ranks needs torch.distributed "
                             f"initialised with {want} ranks first")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    have = dist.get_backend()
    if have != backend and not (kind == "cuda" and have == "gloo"):
        raise ValueError(f"the process group runs {have!r}; a {kind} mesh needs "
                         f"{backend!r}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1, device=None):
    """A ``DeviceMesh`` with dims (dp, sp, ep, tp), tp innermost, over the
    whole world (on ``device``'s type: the card unless the CPU is asked
    for)."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = device_type(device)
    want = dp * tp * sp * ep
    _ensure_world(kind, want)
    have = dist.get_world_size()
    if want != have:
        raise ValueError(f"mesh {dp}x{sp}x{ep}x{tp} needs {want} devices, have "
                         f"{have} (a torch mesh spans the whole world)")
    return init_device_mesh(kind, (dp, sp, ep, tp), mesh_dim_names=AXES)


def mesh_from_spec(spec: Dict[str, int], device=None):
    """A mesh from a ``{"dp": 2, "tp": 4}``-style spec (as the control
    plane's discovery config injects it)."""
    return make_mesh(dp=spec.get("dp", 1), tp=spec.get("tp", 1),
                     sp=spec.get("sp", 1), ep=spec.get("ep", 1), device=device)


def single_device_mesh(device=None):
    return make_mesh(dp=1, tp=1, sp=1, device=device)


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis``; 1 without a mesh or such a dim."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the axis is absent)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def neighbour(mesh, axis: str, step: int) -> int:
    """The global rank ``step`` places along ``axis`` from this one,
    wrapping around."""
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    return dist.get_global_rank(group, (axis_rank(mesh, axis) + step) % n)
