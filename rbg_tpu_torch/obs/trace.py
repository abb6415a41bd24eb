"""Request tracing for the serving path (``rbg_tpu/obs/trace.py``).

* :class:`Span`: trace_id / span_id / parent linkage, monotonic start and
  duration, attributes. The spans of one trace share a ``_TraceState``
  bounded at ``MAX_SPANS_PER_TRACE`` (overflow is counted).
* the ambient current span per thread (:func:`use_span`, :func:`current`,
  :func:`child`), so callees attach children without extra arguments;
* wire propagation: ``obj["trace"] = {"trace_id", "parent_id", "sampled"}``
  (:func:`inject`); :func:`from_wire` continues an incoming context, and
  joins the in-process state of a trace this process already holds;
* :class:`TraceSink` (``SINK``): recent and slowest finished traces, which
  the ``traces`` op returns.

Sampling is decided once, at ingress (``RBG_TRACE_SAMPLE``, default 1%).
With tracing off (``RBG_TRACE`` unset, the default) every entry point
returns the falsy ``NULL_SPAN``, whose methods are constants, so call
sites stay unconditional and cost nothing on the hot path.
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from typing import Dict, List, Optional

from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs.metrics import REGISTRY

MAX_SPANS_PER_TRACE = 128
MAX_ACTIVE_TRACES = 512


def _env_flag(var: str) -> bool:
    v = (os.environ.get(var) or "").strip().lower()
    return bool(v) and v not in ("0", "false", "off")


class _Config:
    def __init__(self):
        self.enabled = _env_flag("RBG_TRACE")
        try:
            self.sample = float(os.environ.get("RBG_TRACE_SAMPLE", "0.01"))
        except ValueError:
            self.sample = 0.01


_CFG = _Config()


def configure(enabled: Optional[bool] = None,
              sample: Optional[float] = None) -> None:
    """Arm tracing from code (tests); ``None`` leaves a knob unchanged."""
    if enabled is not None:
        _CFG.enabled = bool(enabled)
    if sample is not None:
        _CFG.sample = float(sample)


class _NullSpan:
    """Falsy no-op span: the disabled or unsampled path."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    sampled = False

    def __bool__(self):
        return False

    def child(self, name, **attrs):
        return self

    def end(self, **attrs):
        return None

    def wire(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class _TraceState:
    """The spans of one in-process trace (recorded from handler and loop
    threads alike)."""

    __slots__ = ("trace_id", "root", "spans", "dropped", "finalized", "lock")

    def __init__(self, trace_id: str, root: "Span"):
        self.trace_id = trace_id
        self.root = root
        self.spans: List[Span] = [root]
        self.dropped = 0
        self.finalized = False
        self.lock = threading.Lock()

    def add(self, span: "Span") -> bool:
        with self.lock:
            if self.finalized or len(self.spans) >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                REGISTRY.inc(names.TRACE_SPANS_DROPPED_TOTAL)
                return False
            self.spans.append(span)
            return True


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0",
                 "duration_s", "attrs", "_state")

    sampled = True

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 state: Optional[_TraceState], attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.duration_s: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self._state = state

    def child(self, name: str, **attrs) -> "Span | _NullSpan":
        state = self._state
        if state is None:
            return NULL_SPAN
        sp = Span(name, self.trace_id, self.span_id, state, attrs)
        if not state.add(sp):
            return NULL_SPAN           # per-trace bound hit: dropped, counted
        return sp

    def end(self, **attrs) -> None:
        """Idempotent: the first end wins."""
        if self.duration_s is not None:
            return
        self.duration_s = time.monotonic() - self.t0
        if attrs:
            self.attrs.update(attrs)
        state = self._state
        if state is not None and state.root is self:
            SINK._finalize(state)

    def wire(self) -> dict:
        """The context a downstream hop continues from."""
        return {"trace_id": self.trace_id, "parent_id": self.span_id,
                "sampled": True}

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


_AMBIENT = threading.local()


def _stack() -> list:
    st = getattr(_AMBIENT, "stack", None)
    if st is None:
        st = _AMBIENT.stack = []
    return st


def current() -> "Span | _NullSpan":
    st = getattr(_AMBIENT, "stack", None)
    return st[-1] if st else NULL_SPAN


class use_span:
    """``with use_span(sp):`` makes ``sp`` this thread's current span
    (``NULL_SPAN`` too, so call sites never branch on sampling)."""

    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        _stack().append(self._span)
        return self._span

    def __exit__(self, *exc):
        st = _stack()
        if st:
            st.pop()


def child(name: str, **attrs) -> "Span | _NullSpan":
    """Child of the current span (NULL when there is none)."""
    return current().child(name, **attrs)


def start_trace(name: str, sample: Optional[bool] = None,
                **attrs) -> "Span | _NullSpan":
    """Root span of a new trace; the sampling decision is made here
    (``sample=True`` forces it, ``None`` rolls the configured rate)."""
    if not _CFG.enabled:
        return NULL_SPAN
    if sample is None:
        sample = random.random() < _CFG.sample
    if not sample:
        return NULL_SPAN
    tid = uuid.uuid4().hex
    root = Span(name, tid, None, None, attrs)
    root._state = SINK._open(tid, root)
    return root


def from_wire(ctx, name: str, **attrs) -> "Span | _NullSpan":
    """Continue an incoming wire context (``obj["trace"]``); without a
    usable one this hop is the ingress (:func:`start_trace`)."""
    if not (isinstance(ctx, dict) and ctx.get("sampled")
            and ctx.get("trace_id")):
        return start_trace(name, **attrs)
    if not _CFG.enabled:
        return NULL_SPAN
    tid = str(ctx["trace_id"])
    parent = ctx.get("parent_id")
    parent = str(parent) if parent else None
    state = SINK._lookup(tid)
    if state is not None:
        sp = Span(name, tid, parent, state, attrs)
        if not state.add(sp):
            return NULL_SPAN
        return sp
    sp = Span(name, tid, parent, None, attrs)
    sp._state = SINK._open(tid, sp)
    return sp


def inject(obj: dict, span=None) -> dict:
    """Attach the (current or given) span's wire context to a request
    object in place; no-op when unsampled."""
    sp = span if span is not None else current()
    if sp:
        obj["trace"] = sp.wire()
    return obj


class TraceSink:
    """Finished traces in two bounded buffers, ``recent`` and ``slowest``
    (by root duration), plus the active traces; past ``MAX_ACTIVE_TRACES``
    the oldest active one is finalized as leaked."""

    def __init__(self, recent: int = 64, slowest: int = 16):
        self._lock = threading.Lock()
        self._recent_cap = recent
        self._slowest_cap = slowest
        self._recent: List[dict] = []
        self._slowest: List[dict] = []
        self._active: Dict[str, _TraceState] = {}

    def _open(self, trace_id: str, root: Span) -> _TraceState:
        state = _TraceState(trace_id, root)
        evict = None
        with self._lock:
            self._active[trace_id] = state
            if len(self._active) > MAX_ACTIVE_TRACES:
                oldest = next(iter(self._active))
                if oldest != trace_id:
                    evict = self._active.pop(oldest)
        if evict is not None:
            self._finalize(evict, leaked=True)
        return state

    def _lookup(self, trace_id: str) -> Optional[_TraceState]:
        with self._lock:
            return self._active.get(trace_id)

    def _finalize(self, state: _TraceState, leaked: bool = False) -> None:
        with state.lock:
            if state.finalized:
                return
            state.finalized = True
            spans = list(state.spans)
            dropped = state.dropped
        record = _record(state.trace_id, spans, dropped, leaked)
        REGISTRY.inc(names.TRACE_TRACES_TOTAL,
                     result=("leaked" if leaked else
                             "complete" if record["complete"] else
                             "incomplete"))
        with self._lock:
            self._active.pop(state.trace_id, None)
            self._recent.append(record)
            if len(self._recent) > self._recent_cap:
                del self._recent[0]
            self._slowest.append(record)
            self._slowest.sort(key=lambda r: -(r["duration_ms"] or 0.0))
            del self._slowest[self._slowest_cap:]

    def recent(self, n: int = 10) -> List[dict]:
        with self._lock:
            return list(self._recent[-n:])

    def slowest(self, n: int = 10) -> List[dict]:
        with self._lock:
            return list(self._slowest[:n])

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def snapshot(self, n: int = 10) -> dict:
        return {"recent": self.recent(n), "slowest": self.slowest(n),
                "active": self.active_count()}

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slowest.clear()
            self._active.clear()


SINK = TraceSink()


def _record(trace_id: str, spans: List[Span], dropped: int,
            leaked: bool) -> dict:
    """A finished trace as JSON. ``complete``: one rooted tree and every
    span ended."""
    root = spans[0]
    t0 = root.t0
    ids = {s.span_id for s in spans}
    local_roots = [s for s in spans
                   if s.parent_id is None or s.parent_id not in ids]
    out_spans = [{
        "name": s.name, "span_id": s.span_id, "parent_id": s.parent_id,
        "start_ms": round((s.t0 - t0) * 1000.0, 3),
        "duration_ms": (round(s.duration_s * 1000.0, 3)
                        if s.duration_s is not None else None),
        "attrs": dict(s.attrs),
    } for s in sorted(spans, key=lambda s: s.t0)]
    complete = (not leaked and len(local_roots) == 1
                and all(s.duration_s is not None for s in spans))
    return {
        "trace_id": trace_id,
        "root": root.name,
        "duration_ms": (round(root.duration_s * 1000.0, 3)
                        if root.duration_s is not None else None),
        "spans": out_spans,
        "dropped_spans": dropped,
        "complete": complete,
        "leaked": leaked,
    }


def waterfall(record: dict) -> List[str]:
    """One trace as indented lines: span, start offset, duration, attrs."""
    spans = record.get("spans") or []
    by_parent: Dict[Optional[str], List[dict]] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        parent = s["parent_id"] if s["parent_id"] in ids else None
        by_parent.setdefault(parent, []).append(s)
    lines = [f"trace {record.get('trace_id', '?')} "
             f"({record.get('duration_ms')} ms"
             f"{', INCOMPLETE' if not record.get('complete') else ''})"]

    def emit(parent: Optional[str], depth: int) -> None:
        for s in sorted(by_parent.get(parent, ()), key=lambda s: s["start_ms"]):
            attrs = " ".join(f"{k}={v}" for k, v in
                             sorted(s.get("attrs", {}).items()))
            dur = (f"{s['duration_ms']:.1f}ms"
                   if s["duration_ms"] is not None else "UNFINISHED")
            lines.append(f"{'  ' * depth}{s['name']:<22} "
                         f"+{s['start_ms']:.1f}ms {dur}"
                         + (f"  {attrs}" if attrs else ""))
            emit(s["span_id"], depth + 1)

    emit(None, 1)
    return lines


def traces_response(n) -> dict:
    """The ``traces`` op's reply: the sink's recent and slowest traces, the
    slowest one's waterfall, and the histogram exemplars. ``n`` is clamped
    to [1, 64]; malformed input reads as 10."""
    try:
        n = int(n)
    except (TypeError, ValueError):
        n = 10
    resp = SINK.snapshot(max(1, min(n, 64)))
    slowest = resp.get("slowest") or []
    resp["waterfall"] = waterfall(slowest[0]) if slowest else []
    resp["exemplars"] = REGISTRY.exemplars_snapshot()
    return resp
