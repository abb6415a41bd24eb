"""Opt-in runtime lock-order detector for the control plane.

The plane's correctness story leans on a handful of locks shared by
controllers, the store, the router, and the serving loop. A deadlock needs
two of them acquired in opposite orders on two threads — a bug class that
static analysis cannot fully prove absent (lock identity is dynamic) but a
runtime acquisition-order graph catches the first time the second order is
even *attempted*, long before the unlucky interleaving that wedges.

Usage: construct locks through :func:`named_lock` / :func:`named_rlock`
instead of ``threading.Lock()`` where the lock is shared across
subsystems. With ``RBG_LOCKTRACE`` unset (production default) these return
plain stdlib locks — zero overhead. With ``RBG_LOCKTRACE=1`` (tests, the
stress harness) they return :class:`TracedLock` wrappers that record every
held→acquiring edge in a global directed graph and assert it stays acyclic:

* a *new* edge A→B is checked for an existing path B⇝A; finding one means
  two call sites disagree on the order of A and B — report it NOW, as a
  raised :class:`LockOrderError` (``RBG_LOCKTRACE=1``) or a logged warning
  plus the ``rbg_locktrace_inversions_total`` counter
  (``RBG_LOCKTRACE=warn``);
* re-entrant acquires of the same (R)Lock add no edge;
* the graph is global and cumulative, so orders proven on different
  threads at different times still conflict.

The env var is read at *construction* time: set it before building the
ControlPlane / services under test (the stress harness does this for
``--locktrace``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Set

log = logging.getLogger("rbg_tpu_torch.locktrace")

ENV_VAR = "RBG_LOCKTRACE"
RACE_ENV_VAR = "RBG_RACETRACE"  # racetrace needs the held-lock stack too


def _env_mode(var: str) -> str:
    v = (os.environ.get(var) or "").strip().lower()
    if not v or v in ("0", "false", "off"):
        return ""
    return "warn" if v == "warn" else "raise"


def mode() -> str:
    """"" (disabled) | "raise" | "warn" — from the RBG_LOCKTRACE env var."""
    return _env_mode(ENV_VAR)


def enabled() -> bool:
    """Construct TracedLock wrappers? True when EITHER detector is armed:
    the racetrace guarded-access checker (utils/racetrace.py) asks "which
    named locks does this thread hold?" — answerable only if the locks
    maintain the per-thread held stack, i.e. are TracedLocks. Order-graph
    checking itself stays governed by RBG_LOCKTRACE alone."""
    return bool(mode()) or bool(_env_mode(RACE_ENV_VAR))


class LockOrderError(RuntimeError):
    """Two call sites acquire the same pair of locks in opposite orders."""


class _Graph:
    """Global acquisition-order graph: edge A→B = "B was acquired while A
    was held". Guarded by a plain (untraced) lock; never calls out while
    holding it except the cycle walk over its own edges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._inversions: List[str] = []

    def check_edge(self, held: str, acquiring: str) -> Optional[str]:
        """Record held→acquiring; return a description if it closes a cycle."""
        with self._lock:
            succ = self._edges.setdefault(held, set())
            if acquiring in succ:
                return None  # known-good order
            # Path acquiring ⇝ held already proven? Then held→acquiring
            # closes a cycle (the classic A→B / B→A inversion when the
            # path length is 1).
            path = self._find_path(acquiring, held)
            succ.add(acquiring)
            if path is None:
                return None
            desc = (f"lock order inversion: acquiring '{acquiring}' while "
                    f"holding '{held}', but the order "
                    f"{' -> '.join(path + [acquiring])} is already "
                    f"established")
            self._inversions.append(desc)
            return desc

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS src⇝dst over recorded edges; returns the node path or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def snapshot(self) -> Dict[str, List[str]]:
        with self._lock:
            return {a: sorted(bs) for a, bs in self._edges.items()}

    def inversions(self) -> List[str]:
        with self._lock:
            return list(self._inversions)

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._inversions.clear()


_GRAPH = _Graph()
_HELD = threading.local()  # per-thread stack of held TracedLock names


def _held_stack() -> List[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class TracedLock:
    """Named wrapper around a ``threading.Lock``/``RLock`` recording the
    acquisition-order graph. Same acquire/release/context-manager surface
    as the stdlib locks (the subset this codebase uses).

    Contract: release on the acquiring thread (every use here is a
    ``with`` block, which guarantees it). A cross-thread hand-off — legal
    for a plain ``threading.Lock`` — would leave the acquirer's held-stack
    stale and produce phantom order edges; don't build one from these."""

    def __init__(self, name: str, reentrant: bool = False,
                 strict: Optional[bool] = None):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # Order-graph checking is RBG_LOCKTRACE's; a lock traced only for
        # the racetrace held-stack records no edges and raises nothing.
        self._order_mode = mode()
        self._strict = (self._order_mode != "warn") if strict is None \
            else strict

    def _note_acquire(self) -> None:
        if not self._order_mode:
            return  # held-stack-only tracing (racetrace armed, locktrace off)
        stack = _held_stack()
        if self._reentrant and self.name in stack:
            return  # re-entrant re-acquire: no new ordering information
        for held in stack:
            if held == self.name:
                continue
            desc = _GRAPH.check_edge(held, self.name)
            if desc is not None:
                self._report(desc)

    def _report(self, desc: str) -> None:
        try:
            from rbg_tpu_torch.obs.metrics import REGISTRY
            from rbg_tpu_torch.obs.names import LOCKTRACE_INVERSIONS_TOTAL
            REGISTRY.inc(LOCKTRACE_INVERSIONS_TOTAL)
        except Exception:  # metrics must never mask the finding
            pass
        if self._strict:
            raise LockOrderError(desc)
        log.warning("%s", desc)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._note_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _held_stack()
        # Remove the innermost occurrence (out-of-order releases are legal
        # for stdlib locks, rare here; reentrancy pushes one entry per
        # acquire).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def named_lock(name: str):
    """A mutex participating in lock-order tracing when RBG_LOCKTRACE is
    set; a plain ``threading.Lock`` otherwise (zero overhead)."""
    if enabled():
        return TracedLock(name)
    return threading.Lock()


def named_rlock(name: str):
    """Re-entrant variant of :func:`named_lock`."""
    if enabled():
        return TracedLock(name, reentrant=True)
    return threading.RLock()


def named_condition(name: str):
    """A ``threading.Condition`` whose underlying mutex participates in
    tracing when armed (the workqueue's lock is a Condition — its guarded
    fields need the same held-stack visibility as plain named locks).
    Plain stdlib Condition otherwise — zero overhead."""
    if enabled():
        return threading.Condition(TracedLock(name))
    return threading.Condition()


def held_names() -> List[str]:
    """Names of the traced locks THIS thread currently holds, innermost
    last (the racetrace guarded-access checker's query)."""
    return list(_held_stack())


def snapshot() -> Dict[str, List[str]]:
    """The current acquisition-order graph (for reports/debugging)."""
    return _GRAPH.snapshot()


def inversions() -> List[str]:
    """Descriptions of every inversion observed so far."""
    return _GRAPH.inversions()


def reset() -> None:
    """Clear the global graph (test isolation)."""
    _GRAPH.reset()
