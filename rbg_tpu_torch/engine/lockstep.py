"""Serving loops over a mesh: one plan per loop iteration, decided by the
mesh's rank 0 (the leader) and replayed by every other rank (a follower).

An SPMD engine (``Engine(mesh=...)``) stays in step only while every rank
makes the same engine calls in the same order: the forward's collectives
pair up call by call. A serving loop decides its calls from a clock and
from arrival times (admission order and batch budget, deadline drops and
aborts, cancels, the join hint, which chunks of a KV stream have landed),
so a loop of its own on every rank would call differently on each.

So only the leader decides. Its loop runs the queue, the admission gates,
the deadlines, SLO judging and traces exactly as one rank does, applies
each decision to its own engine, and records the engine calls it made in
order (``record`` into ``Plan.ops``). Before its step it broadcasts the
plan; a follower replays the ops on its own engine, in order (``replay``),
then steps. The step's own collectives then run in the same order on
every rank. A follower holds no queue and makes no decision.

After each plan every rank says whether it could apply it (``agree``):
a follower whose replay gives another result than the leader's (another
request id, other pages) or fails says no, and then every rank raises
``LockstepError`` before any rank steps. A leader that faults sends a
"fault" plan, and every follower raises on it.

Plans travel as pickled bytes over a gloo group of their own (the whole
world: ``parallel.make_mesh`` spans it), on the loop thread, never on a
connection thread, with a bounded timeout (``PLAN_TIMEOUT_S``): a rank
that stops answering surfaces as an error on the others instead of a
wedge. An idle leader sends a heartbeat plan every ``HEARTBEAT_S``.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# An idle leader's heartbeat interval: far inside PLAN_TIMEOUT_S, and rare
# enough (one small broadcast) to cost an idle loop nothing.
HEARTBEAT_S = 2.0
# The longest a rank waits in the plan group for the others. It must
# outlast any wait a rank has there: a leader's host work between steps, a
# heartbeat, and a PD pair's wait for its stream (``recv_timeout``, 30 s by
# default). A rank that dies or wedges is then an error on the others.
PLAN_TIMEOUT_S = 120.0


class LockstepError(RuntimeError):
    """A rank cannot follow the leader's plan, or the leader faulted."""


@dataclasses.dataclass
class Plan:
    """One leader decision, in the order it was applied. ``kind``: "loop"
    (a serving loop's iteration: ``ops``, then ``join_hint``, then a step
    when ``step``), "embed" (an embeddings forward of the prompts in
    ``value``), "stop" (every loop exits), "fault" (the leader's loop
    ended on the error in ``value``), or a decision of a PD pair ("admit":
    ``value`` is the admission coverage; "window": ``value`` whether the
    next layer window of the layer-sliced chain runs)."""

    kind: str = "loop"
    ops: List[tuple] = dataclasses.field(default_factory=list)
    join_hint: bool = False
    step: bool = False
    value: Any = None


class Lockstep:
    """Plans from the mesh's rank 0 to its other ranks, and every rank's
    answer whether it could apply them."""

    def __init__(self, mesh, timeout: float = PLAN_TIMEOUT_S):
        self.size = mesh.size()
        if self.size != dist.get_world_size():
            raise ValueError(f"a lockstep over a mesh of {self.size} ranks in a world "
                             f"of {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.leader = self.rank == 0
        # Host bytes on a host group, whatever the mesh's backend.
        self._group = dist.new_group(backend="gloo",
                                     timeout=datetime.timedelta(seconds=timeout))
        # Plans sent or received, their bytes and the seconds spent in the
        # broadcasts and answers (a follower's include its wait for the
        # leader).
        self.plans = 0
        self.bytes = 0
        self.seconds = 0.0

    def _broadcast(self, data: bytes = b"") -> bytes:
        t0 = time.perf_counter()
        n = torch.tensor([len(data)], dtype=torch.int64)
        dist.broadcast(n, src=0, group=self._group)
        size = int(n.item())
        buf = None
        if size:
            buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if self.leader
                   else torch.empty(size, dtype=torch.uint8))
            dist.broadcast(buf, src=0, group=self._group)
        self.plans += 1
        self.bytes += size
        self.seconds += time.perf_counter() - t0
        if self.leader or buf is None:
            return data
        return buf.numpy().tobytes()

    def send(self, plan: Plan) -> None:
        if not self.leader:
            raise LockstepError("only the mesh's rank 0 sends plans")
        self._broadcast(pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL))

    def recv(self, kind: str = "") -> Plan:
        """The leader's next plan; with ``kind``, one of that kind or "stop"
        (anything else is a plan this follower cannot replay). A "fault"
        plan raises."""
        if self.leader:
            raise LockstepError("rank 0 leads; it receives no plans")
        plan = pickle.loads(self._broadcast())
        if plan.kind == "fault":
            raise LockstepError(f"rank 0's loop stopped on a fault: {plan.value}")
        if kind and plan.kind not in (kind, "stop"):
            raise LockstepError(f"expected a {kind!r} plan from rank 0, got {plan.kind!r}")
        return plan

    def agree(self, ok: bool = True) -> bool:
        """Every rank's answer to the last plan: whether all of them could
        apply it. Every rank calls it once after each plan it acts on."""
        t0 = time.perf_counter()
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._group)
        self.seconds += time.perf_counter() - t0
        return bool(flag.item())

    def stats(self) -> dict:
        return {"rank": self.rank, "plans": self.plans, "bytes": self.bytes,
                "seconds": self.seconds}


def of(mesh) -> Optional[Lockstep]:
    """A ``Lockstep`` over ``mesh``, or None for no mesh or a mesh of one
    rank (nothing to keep in step)."""
    if mesh is None or mesh.size() == 1:
        return None
    return Lockstep(mesh)


def raised(e: Exception) -> str:
    """A failed engine call as a plan records it: a follower's replay must
    fail the same way."""
    return f"raised {type(e).__name__}: {e}"


def expect(what: str, got, want) -> None:
    """A follower's check of one replayed call against the leader's."""
    if got != want:
        raise LockstepError(f"replayed {what} gave {got!r}; rank 0's gave {want!r}")


def _as_called(a):
    # Lists and arrays as they were at the call: the caller may change them
    # before the plan is sent (a stream's staging buffer is written again).
    if isinstance(a, list):
        return list(a)
    if isinstance(a, np.ndarray):
        return a.copy()
    return a


def record(ops: Optional[list], name: str, call: Callable, *args):
    """Run ``call(*args)`` and return its result, raising as it raised.
    Where ``ops`` is a leader's plan (not None), append ``(name, *args,
    result)``, the result of a raise being ``raised(e)``."""
    if ops is None:
        return call(*args)
    op = (name, *map(_as_called, args))
    try:
        out = call(*args)
    except Exception as e:
        ops.append(op + (raised(e),))
        raise
    ops.append(op + (_as_called(out),))
    return out


def replay(op: tuple, call: Callable) -> None:
    """A follower's replay of one recorded call: ``call`` on the recorded
    arguments must give the leader's result, or fail as it failed."""
    name, *args, want = op
    try:
        got = call(*args)
    except Exception as e:  # noqa: BLE001 — must fail as the leader's did
        got = raised(e)
    expect(name, got, want)
