"""In-process object store — the API-server equivalent.

Every cross-controller boundary in the reference is an API-server round trip
(SURVEY.md §3: watch → informer cache → reconcile → SSA patch); controllers
never call each other. We preserve exactly that discipline: controllers
communicate ONLY through this store (typed objects + watch events), which is
what makes each controller independently testable and the whole plane
restartable (level-triggered, state fully re-derivable — SURVEY.md §5
checkpoint/resume).

Semantics carried over: optimistic concurrency on resourceVersion, spec vs
status subresources (generation bumps only on spec change), owner-reference
cascade GC, label-selector + owner-uid indexed list (reference:
``pkg/utils/fieldindex``).
"""

from __future__ import annotations

import copy
import threading
import time
import uuid
from collections import OrderedDict, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from rbg_tpu_torch.api import serde
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.utils.locktrace import named_rlock
# The port has no racetrace: the reference's @_race_guard is left out.
from rbg_tpu_torch.api.constants import (
    LABEL_GROUP_NAME, LABEL_INSTANCE_NAME, LABEL_POD_GROUP,
)

Key = Tuple[str, str, str]  # (kind, namespace, name)


EVENT_NORMAL = "Normal"
EVENT_WARNING = "Warning"


class EventRecord(tuple):
    """One recorded control-plane event. Tuple-compatible with the legacy
    flat log — ``(time, object_ref, reason, message)`` unpacks and indexes
    exactly as before — with the k8s-recorder structure as attributes:
    ``type`` (Normal/Warning), ``count`` (dedup of repeated reasons), and
    ``first_time`` (the first occurrence this record aggregates)."""

    def __new__(cls, ts, ref, reason, message, type_=EVENT_NORMAL,
                count=1, first_ts=None):
        self = tuple.__new__(cls, (ts, ref, reason, message))
        self.type = type_
        self.count = count
        self.first_time = first_ts if first_ts is not None else ts
        return self

    @property
    def time(self):
        return self[0]

    @property
    def object_ref(self):
        return self[1]

    @property
    def reason(self):
        return self[2]

    @property
    def message(self):
        return self[3]

    def to_dict(self) -> dict:
        return {"time": self[0], "object": self[1], "type": self.type,
                "reason": self[2], "message": self[3], "count": self.count,
                "first_time": self.first_time}


class Conflict(Exception):
    """resourceVersion mismatch (optimistic concurrency failure)."""


class WatchExpired(Exception):
    """A ``watch(since_rv=...)`` resume point fell behind the bounded
    event log (the 410 Gone / etcd-compaction analog) — the caller must
    fall back to a full re-list before re-subscribing."""


class LeaseFenced(Exception):
    """A write carried a stale lease epoch — the structured refusal of
    the fencing-token protocol. The holder was deposed (a newer epoch was
    minted by a takeover) and its in-flight actuation must NOT land; the
    correct reaction is to stop actuating, never to retry the write."""

    def __init__(self, lease: str, stale_epoch: int, current_epoch: int,
                 holder: Optional[str] = None):
        self.lease = lease
        self.stale_epoch = stale_epoch
        self.current_epoch = current_epoch
        self.holder = holder
        super().__init__(
            f"lease {lease!r}: write fenced — epoch {stale_epoch} is stale "
            f"(current epoch {current_epoch}"
            + (f", held by {holder!r}" if holder else "") + ")")


class AlreadyExists(Exception):
    pass


class NotFound(Exception):
    pass


class Event:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"

    def __init__(self, type_: str, obj, old=None):
        self.type = type_
        self.object = obj
        self.old = old  # previous object on MODIFIED (predicate support)

    def __repr__(self):
        m = self.object.metadata
        return f"Event({self.type}, {self.object.kind}/{m.namespace}/{m.name})"


class _Watcher:
    """One subscription. ``buffer`` is non-None while the watcher is in
    its replay window (``watch(since_rv=...)``): live events landing
    during the replay are parked here and drained IN ORDER before the
    watcher goes live — the list→watch gap closes without ever
    dispatching under the store lock."""

    __slots__ = ("fn", "buffer")

    def __init__(self, fn, buffering: bool = False):
        self.fn = fn
        self.buffer: Optional[list] = [] if buffering else None


class Store:
    # Label keys served from an index by ``list(selector=...)`` (reference:
    # registered field indexes, ``pkg/utils/fieldindex/register.go``). A
    # selector containing one of these keys narrows candidates to the index
    # bucket instead of scanning every object of the kind.
    INDEXED_LABELS = (LABEL_GROUP_NAME, LABEL_INSTANCE_NAME, LABEL_POD_GROUP)

    def __init__(self):
        self._lock = named_rlock("runtime.store")
        self._objects: Dict[Key, object] = {}  # guarded_by[runtime.store]
        # kind -> keys  # guarded_by[runtime.store]
        self._kind_keys: Dict[str, set] = defaultdict(set)
        # (kind, label key, label value) -> keys  # guarded_by[runtime.store]
        self._label_index: Dict[Tuple[str, str, str], set] = defaultdict(set)
        # (kind, namespace, spec.group_name) -> keys — back-reference
        # index for group-scoped children that are neither owned nor
        # labeled (ScalingAdapter / CoordinatedPolicy reference their
        # group by spec field only). Serves list_for().
        # guarded_by[runtime.store]
        self._backref_index: Dict[Tuple[str, str, str], set] = \
            defaultdict(set)
        self._rv = 0  # guarded_by[runtime.store]
        # guarded_by[runtime.store]
        self._watchers: Dict[str, List[_Watcher]] = defaultdict(list)
        # Bounded event replay log: (rv, Event), rv strictly increasing
        # (hard deletes mint a fresh rv so DELETED is replayable and
        # orderable like any write). ``_log_floor`` is the newest rv the
        # log can no longer prove coverage past — resumes at or before it
        # raise WatchExpired.  # guarded_by[runtime.store]
        self._event_log: List[Tuple[int, Event]] = []
        self._log_floor = 0  # guarded_by[runtime.store]
        # owner uid -> keys  # guarded_by[runtime.store]
        self._owner_index: Dict[str, set] = defaultdict(set)
        # live object uids (O(1) owner-exists checks)  # guarded_by[runtime.store]
        self._uids: set = set()
        # kind -> write counter  # guarded_by[runtime.store]
        self._kind_version: Dict[str, int] = {}
        # Structured event recorder: ref -> OrderedDict keyed by
        # (type, reason, message) -> mutable record dict, LRU at both
        # levels (see record_event)  # guarded_by[runtime.store]
        self._events: "OrderedDict[str, OrderedDict]" = OrderedDict()
        # Leader leases: name -> {holder, epoch, expires} (monotonic-clock
        # expiry; epoch is the fencing token — bumps on every change of
        # holder, never reused)  # guarded_by[runtime.store]
        self._leases: Dict[str, dict] = {}

    # ---- helpers ----

    @staticmethod
    def key(obj) -> Key:
        return (obj.kind, obj.metadata.namespace, obj.metadata.name)

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def kind_version(self, kind: str) -> int:
        """Monotone counter bumped on every write to ``kind`` — an O(1)
        cache-invalidation fingerprint (e.g. the discovery plane's node-map
        cache; reference analog: informer resourceVersion watermarks)."""
        with self._lock:
            return self._kind_version.get(kind, 0)

    def _bump_kind(self, kind: str) -> None:
        self._kind_version[kind] = self._kind_version.get(kind, 0) + 1

    @staticmethod
    def _backref_group(obj) -> Optional[str]:
        """The spec back-reference a group-scoped child carries (the
        ``fieldindex`` analog for ``spec.group_name``)."""
        gn = getattr(getattr(obj, "spec", None), "group_name", None)
        return gn or None

    def _index_add(self, k: Key, obj) -> None:
        """Register a NEW key in all secondary indexes (lock held)."""
        self._kind_keys[k[0]].add(k)
        self._uids.add(obj.metadata.uid)
        for ref in obj.metadata.owner_references:
            self._owner_index[ref.uid].add(k)
        labels = obj.metadata.labels
        for lk in self.INDEXED_LABELS:
            lv = labels.get(lk)
            if lv is not None:
                self._label_index[(k[0], lk, lv)].add(k)
        gn = self._backref_group(obj)
        if gn is not None:
            self._backref_index[(k[0], k[1], gn)].add(k)

    def _index_remove(self, k: Key, obj) -> None:
        """Drop a key from all secondary indexes, pruning empty buckets —
        per-instance label values are unique, so leaked empty sets would
        grow without bound under steady churn (lock held)."""
        self._kind_keys[k[0]].discard(k)
        self._uids.discard(obj.metadata.uid)
        for ref in obj.metadata.owner_references:
            bucket = self._owner_index.get(ref.uid)
            if bucket is not None:
                bucket.discard(k)
                if not bucket:
                    del self._owner_index[ref.uid]
        labels = obj.metadata.labels
        for lk in self.INDEXED_LABELS:
            lv = labels.get(lk)
            if lv is not None:
                bucket = self._label_index.get((k[0], lk, lv))
                if bucket is not None:
                    bucket.discard(k)
                    if not bucket:
                        del self._label_index[(k[0], lk, lv)]
        gn = self._backref_group(obj)
        if gn is not None:
            bucket = self._backref_index.get((k[0], k[1], gn))
            if bucket is not None:
                bucket.discard(k)
                if not bucket:
                    del self._backref_index[(k[0], k[1], gn)]

    def _reindex(self, k: Key, old, new) -> None:
        """Refresh indexes after a replace (labels/owners may differ)."""
        if (old.metadata.labels != new.metadata.labels
                or old.metadata.owner_references != new.metadata.owner_references
                or old.metadata.uid != new.metadata.uid
                or self._backref_group(old) != self._backref_group(new)):
            self._index_remove(k, old)
            self._index_add(k, new)

    # Replay-log bound: at fleet scale (10k nodes / 100k pods) the log is
    # a ring, not a history — a resumer further behind than this re-lists.
    WATCH_LOG_MAX = 8192

    def _log_event(self, ev: Event) -> None:
        """Append to the replay log (store lock held). Caller guarantees
        ``ev.object.metadata.resource_version`` was minted for this event
        (hard deletes included), so log order == rv order."""
        self._event_log.append((ev.object.metadata.resource_version, ev))
        if len(self._event_log) > self.WATCH_LOG_MAX:
            drop = max(1, self.WATCH_LOG_MAX // 4)
            self._log_floor = self._event_log[drop - 1][0]
            del self._event_log[:drop]

    def current_rv(self) -> int:
        """The store's global write watermark. Snapshot this BEFORE a
        list to later resume a watch gap-free (``watch(since_rv=...)``),
        or before a reconcile body to know which queued trigger versions
        that reconcile's store reads already cover."""
        with self._lock:
            return self._rv

    # ---- leader leases + write fencing ----
    #
    # The coordination primitive for control-plane HA (runtime/ha.py): a
    # named lease grants one holder a TTL'd leadership term identified by
    # a monotone EPOCH — the fencing token. Writes stamped with the epoch
    # (``fence=(lease, epoch)`` on any write method) are validated under
    # the store lock in the same critical section that commits them, so a
    # deposed leader's in-flight actuation is refused atomically — never
    # a check-then-write race. Clocks are injectable (``now=``) so the
    # failover drills and fencing tests run on scripted time.

    def acquire_lease(self, name: str, holder: str, ttl_s: float,
                      now: Optional[float] = None) -> Optional[int]:
        """Try to take (or renew) the lease. Returns the fencing epoch on
        success, None while another live holder owns it. A new holder —
        first acquisition, expired lease, or graceful release — mints a
        FRESH epoch; re-acquisition by the current holder keeps its epoch
        (a renewal, not a term change)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                lease = {"holder": holder, "epoch": 1, "expires": t + ttl_s}
                self._leases[name] = lease
                return lease["epoch"]
            if lease["holder"] == holder:
                lease["expires"] = t + ttl_s
                return lease["epoch"]
            if lease["expires"] > t:
                return None
            lease["holder"] = holder
            lease["epoch"] += 1
            lease["expires"] = t + ttl_s
            return lease["epoch"]

    def renew_lease(self, name: str, holder: str, epoch: int, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        """Extend the lease iff ``holder`` still owns ``epoch``. A False
        return means deposed (a takeover minted a newer epoch) — the
        caller must stop acting as leader immediately."""
        t = time.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(name)
            if (lease is None or lease["holder"] != holder
                    or lease["epoch"] != epoch):
                return False
            lease["expires"] = t + ttl_s
            return True

    def release_lease(self, name: str, holder: str, epoch: int,
                      now: Optional[float] = None) -> bool:
        """Graceful handover: expire the lease NOW so a standby acquires
        without waiting out the TTL. Only the current (holder, epoch) may
        release; the epoch survives so stale writes stay fenced."""
        t = time.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(name)
            if (lease is None or lease["holder"] != holder
                    or lease["epoch"] != epoch):
                return False
            lease["expires"] = t
            return True

    def lease_info(self, name: str,
                   now: Optional[float] = None) -> Optional[dict]:
        t = time.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                return None
            return {"holder": lease["holder"], "epoch": lease["epoch"],
                    "expires_in_s": lease["expires"] - t}

    def _check_fence_locked(self, fence) -> None:
        """Validate a write's fencing stamp (store lock held). Refusal is
        by EPOCH only — expiry alone never fences: a leader briefly late
        on renewal is still the unique holder until someone else actually
        takes over (and bumps the epoch)."""
        name, epoch = fence
        lease = self._leases.get(name)
        cur = lease["epoch"] if lease is not None else 0
        if lease is None or cur != epoch:
            REGISTRY.inc(obs_names.PLANE_FENCED_WRITES_TOTAL, lease=name)
            raise LeaseFenced(
                name, epoch, cur,
                holder=lease["holder"] if lease is not None else None)

    def _notify(self, ev: Event):
        # Snapshot subscribers under lock; dispatch outside to avoid
        # deadlocks. Watchers still inside their replay window buffer the
        # event instead (drained in order before they go live).
        with self._lock:
            subs = []
            for w in (list(self._watchers.get(ev.object.kind, ()))
                      + list(self._watchers.get("*", ()))):
                if w.buffer is not None:
                    w.buffer.append(ev)
                else:
                    subs.append(w.fn)
        # The event carries the stored object WITHOUT copying (the
        # no-deepcopy informer, ``pkg/utils/client/no_deepcopy_lister.go``):
        # update/mutate always insert fresh objects, never mutate in place,
        # so a handler holding this reference observes a frozen snapshot.
        # Handlers MUST treat event objects as read-only; per-watcher
        # deepcopies of every pod event dominated burst throughput.
        kind = ev.object.kind
        REGISTRY.inc(obs_names.WATCH_EVENTS_TOTAL, kind=kind, type=ev.type)
        if subs:
            REGISTRY.inc(obs_names.WATCH_DELIVERIES_TOTAL, float(len(subs)),
                         kind=kind)
        t0 = time.perf_counter()
        for fn in subs:
            try:
                fn(ev)
            except Exception:  # watcher bugs must not poison the store
                import traceback
                traceback.print_exc()
        # Delivery lag: synchronous fan-out means every subscriber's
        # handler time lands between the write and the NEXT write on this
        # thread — the curve the watch/informer refactor must bend.
        REGISTRY.observe(obs_names.WATCH_DISPATCH_SECONDS,
                         time.perf_counter() - t0, kind=kind)

    # ---- watch ----

    def watch(self, kind: str, handler: Callable[[Event], None],
              since_rv: Optional[int] = None) -> None:
        """Subscribe to events for ``kind`` ("*" = all kinds).

        ``since_rv``: resume watermark — replay every retained event for
        ``kind`` with rv > since_rv to ``handler`` (synchronously, on this
        thread) before going live, with NO gap: events published while the
        replay runs are buffered and drained in order. This is the
        reflector re-subscription path — a subscriber that snapshotted
        ``current_rv()`` before a list can register afterwards without
        losing the writes that landed in between. Raises ``WatchExpired``
        when the bounded log no longer covers ``since_rv`` (caller must
        re-list, then subscribe from the fresh watermark)."""
        if since_rv is None:
            with self._lock:
                self._watchers[kind].append(_Watcher(handler))
            return
        w = _Watcher(handler, buffering=True)
        with self._lock:
            if since_rv < self._log_floor:
                raise WatchExpired(
                    f"resume rv {since_rv} predates log floor "
                    f"{self._log_floor}")
            replay = [ev for rv, ev in self._event_log
                      if rv > since_rv
                      and (kind == "*" or ev.object.kind == kind)]
            self._watchers[kind].append(w)
        while True:
            for ev in replay:
                REGISTRY.inc(obs_names.WATCH_REPLAYS_TOTAL,
                             kind=ev.object.kind)
                try:
                    handler(ev)
                except Exception:  # parity with _notify: never poison
                    import traceback
                    traceback.print_exc()
            with self._lock:
                if not w.buffer:
                    w.buffer = None  # live: future events dispatch directly
                    return
                replay, w.buffer = w.buffer, []

    # ---- CRUD ----

    def create(self, obj, fence=None):
        obj = copy.deepcopy(obj)
        m = obj.metadata
        with self._lock:
            if fence is not None:
                self._check_fence_locked(fence)
            k = self.key(obj)
            if k in self._objects:
                raise AlreadyExists(f"{k} already exists")
            # Foreground-GC invariant: a controller owner must exist at
            # creation. Otherwise a reconcile working from a stale copy of a
            # deleted owner can create a child AFTER the cascade GC ran — an
            # immortal orphan that squats its name (the k8s GC would collect
            # it; our cascade is synchronous, so reject instead).
            ref = m.controller_owner()
            if ref is not None:
                if ref.uid not in self._uids:
                    raise NotFound(
                        f"{k}: controller owner {ref.kind}/{ref.name} "
                        f"(uid {ref.uid}) no longer exists")
            m.uid = m.uid or uuid.uuid4().hex[:12]
            m.resource_version = self._next_rv()
            m.generation = 1
            m.creation_timestamp = m.creation_timestamp or time.time()
            self._objects[k] = obj
            self._index_add(k, obj)
            self._bump_kind(k[0])
            ev = Event(Event.ADDED, obj)
            self._log_event(ev)
        self._notify(ev)
        return copy.deepcopy(obj)

    def get(self, kind: str, namespace: str, name: str, copy_: bool = True):
        """``copy_=False`` returns the live object WITHOUT copying — strictly
        read-only use (reference analog: the no-deepcopy cache lister,
        ``pkg/utils/client/no_deepcopy_lister.go``, added for exactly this
        hot-path cost). Mutating a no-copy result corrupts the store."""
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                return None
            return copy.deepcopy(obj) if copy_ else obj

    def must_get(self, kind: str, namespace: str, name: str):
        obj = self.get(kind, namespace, name)
        if obj is None:
            raise NotFound(f"{kind}/{namespace}/{name}")
        return obj

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        selector: Optional[Dict[str, str]] = None,
        owner_uid: Optional[str] = None,
        copy_: bool = True,
    ) -> list:
        """``copy_=False``: no-deepcopy list for read-only hot paths (see
        ``get``)."""
        with self._lock:
            if owner_uid is not None:
                keys = [k for k in self._owner_index.get(owner_uid, ()) if k[0] == kind]
            elif selector:
                # Serve from the narrowest label-index bucket available.
                keys = None
                for lk, lv in selector.items():
                    if lk in self.INDEXED_LABELS:
                        bucket = self._label_index.get((kind, lk, lv), ())
                        if keys is None or len(bucket) < len(keys):
                            keys = bucket
                if keys is None:
                    keys = self._kind_keys.get(kind, ())
                keys = list(keys)
            else:
                keys = list(self._kind_keys.get(kind, ()))
            out = []
            for k in keys:
                o = self._objects.get(k)
                if o is None:
                    continue
                if namespace is not None and o.metadata.namespace != namespace:
                    continue
                if selector:
                    labels = o.metadata.labels
                    if any(labels.get(lk) != lv for lk, lv in selector.items()):
                        continue
                out.append(copy.deepcopy(o) if copy_ else o)
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out

    def list_for(self, kind: str, parent, copy_: bool = True) -> list:
        """All ``kind`` objects attached to ``parent`` — the
        per-reconcile child listing, served ENTIRELY from secondary
        indexes: the owner-reference index, the group-name label index,
        and the ``spec.group_name`` back-reference index. A controller
        that previously did ``list(kind, namespace=ns)`` + a group filter
        paid a full kind scan (plus a deepcopy per object) on every
        reconcile — at 5 k-node fleets that scan IS the reconcile-latency
        tail. The label/back-reference buckets only apply when ``parent``
        is the group object itself (their values name a RoleBasedGroup);
        for any other parent kind the owner index alone answers.

        ``copy_=False``: no-deepcopy results, read-only by contract (see
        ``get``)."""
        m = parent.metadata
        with self._lock:
            keys = {k for k in self._owner_index.get(m.uid, ())
                    if k[0] == kind}
            if parent.kind == "RoleBasedGroup":
                keys.update(self._label_index.get(
                    (kind, LABEL_GROUP_NAME, m.name), ()))
                keys.update(self._backref_index.get(
                    (kind, m.namespace, m.name), ()))
            out = []
            for k in keys:
                o = self._objects.get(k)
                if o is None or o.metadata.namespace != m.namespace:
                    # The label bucket is not namespace-scoped: a
                    # same-name group in another namespace contributes
                    # keys this filter drops.
                    continue
                out.append(copy.deepcopy(o) if copy_ else o)
        out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        return out

    def _spec_changed(self, old, new) -> bool:
        for attr in ("spec", "template", "data", "selector", "labels", "node_name",
                     "affinity", "revision", "role_hashes", "init_containers",
                     "containers", "volumes", "tpu", "capacity_pods", "address",
                     "leader_only", "unschedulable", "disruption",
                     "disruption_deadline"):
            if hasattr(new, attr):
                if serde.to_dict(getattr(old, attr, None)) != serde.to_dict(getattr(new, attr)):
                    return True
        return False

    def update(self, obj, _owned: bool = False, fence=None):
        """Full update with optimistic concurrency; bumps generation on spec
        change. Status is carried over from the stored object — use
        update_status for the status subresource.

        ``_owned=True`` (internal, mutate path): ``obj`` is already a
        private copy the store may take ownership of, and the RETURN value
        is the stored object itself — read-only by contract. This cuts the
        per-write deepcopy count from 3 to 1, which dominated the
        control-plane profile under a 100-group burst."""
        if not _owned:
            obj = copy.deepcopy(obj)
        with self._lock:
            if fence is not None:
                self._check_fence_locked(fence)
            k = self.key(obj)
            cur = self._objects.get(k)
            if cur is None:
                raise NotFound(str(k))
            if obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(f"{k}: rv {obj.metadata.resource_version} != {cur.metadata.resource_version}")
            if hasattr(cur, "status"):
                # SHARE cur's status (no deepcopy): stored snapshots are
                # never mutated in place, so consecutive snapshots may alias
                # unchanged sub-objects.
                obj.status = cur.status
            if self._spec_changed(cur, obj):
                obj.metadata.generation = cur.metadata.generation + 1
            else:
                obj.metadata.generation = cur.metadata.generation
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.uid = cur.metadata.uid
            obj.metadata.creation_timestamp = cur.metadata.creation_timestamp
            obj.metadata.deletion_timestamp = cur.metadata.deletion_timestamp
            self._objects[k] = obj
            self._reindex(k, cur, obj)
            self._bump_kind(k[0])
            ev = Event(Event.MODIFIED, obj, old=cur)
            self._log_event(ev)
        self._notify(ev)
        return obj if _owned else copy.deepcopy(obj)

    def update_status(self, obj, _owned: bool = False, fence=None):
        """Status-subresource update (no generation bump). Spec always
        comes from the STORED object — spec edits on ``obj`` are discarded.
        ``_owned``: see ``update``."""
        with self._lock:
            if fence is not None:
                self._check_fence_locked(fence)
            k = self.key(obj)
            cur = self._objects.get(k)
            if cur is None:
                raise NotFound(str(k))
            if obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(f"{k} status: rv mismatch")
            # Shallow-copy the stored object (spec/labels alias the frozen
            # snapshot), fresh metadata for the rv bump, new status only.
            new = copy.copy(cur)
            new.metadata = copy.copy(cur.metadata)
            new.status = obj.status if _owned else copy.deepcopy(obj.status)
            new.metadata.resource_version = self._next_rv()
            self._objects[k] = new
            self._bump_kind(k[0])
            ev = Event(Event.MODIFIED, new, old=cur)
            self._log_event(ev)
        self._notify(ev)
        return new if _owned else copy.deepcopy(new)

    def mutate(self, kind: str, namespace: str, name: str, fn, status: bool = False,
               retries: int = 8, fence=None):
        """Read-modify-write with conflict retry (the SSA-patch equivalent:
        reference controllers use server-side apply; our single-writer-per-
        field discipline plus this retry loop gives the same convergence).

        Contract: the RETURN value is the stored snapshot — read-only; and
        under ``status=True`` the fn must only touch ``obj.status`` (spec
        edits are discarded, as with the k8s status subresource)."""
        for _ in range(retries):
            obj = self.get(kind, namespace, name)
            if obj is None:
                raise NotFound(f"{kind}/{namespace}/{name}")
            res = fn(obj)
            if res is False:
                if fence is not None:
                    # A no-op is still an ACTUATION DECISION: a deposed
                    # leader must learn it is deposed here, not keep
                    # cycling "already done" against a state machine the
                    # new leader is advancing.
                    with self._lock:
                        self._check_fence_locked(fence)
                return obj  # no-op
            try:
                if status:
                    return self.update_status(obj, _owned=True, fence=fence)
                return self.update(obj, _owned=True, fence=fence)
            except Conflict:
                continue
        raise Conflict(f"{kind}/{namespace}/{name}: retries exhausted")

    def delete(self, kind: str, namespace: str, name: str, grace: bool = False,
               fence=None):
        """Delete an object. grace=True only marks deletionTimestamp (the
        executor finalizes via finalize_delete); grace=False removes now.
        Owned objects are cascade-deleted (k8s GC equivalent)."""
        with self._lock:
            if fence is not None:
                self._check_fence_locked(fence)
            k = (kind, namespace, name)
            cur = self._objects.get(k)
            if cur is None:
                return None
            if grace and cur.metadata.deletion_timestamp is None:
                orig = cur
                cur = copy.deepcopy(cur)
                cur.metadata.deletion_timestamp = time.time()
                cur.metadata.resource_version = self._next_rv()
                self._objects[k] = cur
                ev = Event(Event.MODIFIED, cur, old=orig)
            else:
                del self._objects[k]
                self._index_remove(k, cur)
                # Mint a fresh rv for the DELETED event (etcd assigns a
                # mod-revision to deletes too): the tombstone must order
                # AFTER every prior write so rv-watermark consumers (the
                # workqueue dedup, watch-resume replay) can never treat a
                # delete as already-covered stale state. Shallow-copy so
                # earlier MODIFIED events' aliased snapshot keeps its rv.
                cur = copy.copy(cur)
                cur.metadata = copy.copy(cur.metadata)
                cur.metadata.resource_version = self._next_rv()
                ev = Event(Event.DELETED, cur)
            self._bump_kind(kind)
            self._log_event(ev)
        self._notify(ev)
        if ev.type == Event.DELETED:
            self._gc_owned(cur.metadata.uid)
        return copy.deepcopy(cur)

    def finalize_delete(self, kind: str, namespace: str, name: str):
        return self.delete(kind, namespace, name, grace=False)

    def _gc_owned(self, owner_uid: str):
        with self._lock:
            keys = list(self._owner_index.pop(owner_uid, ()))
        for kind, ns, name in keys:
            self.delete(kind, ns, name)

    # ---- persistence (etcd-snapshot equivalent) ----

    # Snapshot schema version. Bump ONLY for structural changes that lenient
    # parsing + field defaults can't absorb; add a migration fn to
    # _SNAPSHOT_MIGRATIONS for each bump (docs/architecture.md §5).
    # Schema 2 (this release): role ``stateful`` bool → ``identity`` string
    # — lenient parse of an old file would silently DROP ``stateful: false``
    # and default every role to ordinal, which is exactly the class of
    # misparse the schema number exists to catch.
    SNAPSHOT_SCHEMA = 2
    _SNAPSHOT_MIGRATIONS: dict = {}   # {from_schema: fn(data_dict) -> data_dict}

    def snapshot(self) -> dict:
        """Serializable snapshot of every object + the rv counter.
        Serialization runs OUTSIDE the lock (stored objects are never mutated
        in place — update/mutate always insert fresh copies), so periodic
        saves don't stall controller CRUD."""
        from rbg_tpu_torch.api import serde
        with self._lock:
            rv = self._rv
            objects = list(self._objects.values())
        return {"schema": self.SNAPSHOT_SCHEMA, "rv": rv,
                "objects": [serde.to_dict(o) for o in objects]}

    def load_snapshot(self, data: dict) -> int:
        """Restore objects from a snapshot into an empty store. Watches fire
        no events (controllers do their initial LIST sync on start).
        Parsing is LENIENT (snapshots outlive code both ways: a newer
        release's extra fields must not crash-loop a rollback), after
        running any schema migrations forward."""
        from rbg_tpu_torch.api import parse_manifest
        schema = int(data.get("schema", 1))
        if schema > self.SNAPSHOT_SCHEMA:
            # A schema bump marks a structural change lenient parsing CANNOT
            # absorb — loading a newer-schema file must be an explicit
            # error, not a silent misparse.
            raise ValueError(
                f"state-file schema {schema} is newer than this release's "
                f"{self.SNAPSHOT_SCHEMA}; upgrade the binary or restore an "
                f"older snapshot")
        while schema < self.SNAPSHOT_SCHEMA:
            migrate = self._SNAPSHOT_MIGRATIONS.get(schema)
            if migrate is None:
                raise ValueError(
                    f"state-file schema {schema} has no migration to "
                    f"{self.SNAPSHOT_SCHEMA}")
            data = migrate(data)
            schema += 1
        count = 0
        with self._lock:
            self._rv = max(self._rv, int(data.get("rv", 0)))
            for doc in data.get("objects", []):
                obj = parse_manifest(doc, lenient=True)
                k = self.key(obj)
                if k in self._objects:
                    continue
                self._objects[k] = obj
                self._index_add(k, obj)
                count += 1
        return count

    # ---- event recorder (k8s Events equivalent) ----

    # Retention bounds. Per-object: a chatty controller repeating reasons
    # against one object can never evict another object's history (the
    # old flat log's 2000→1000 truncation did exactly that). Per-plane:
    # the ref LRU bounds total memory under unbounded object churn.
    MAX_EVENTS_PER_OBJECT = 64
    MAX_EVENT_OBJECTS = 4096

    @staticmethod
    def _event_ref(obj) -> str:
        return f"{obj.kind}/{obj.metadata.namespace}/{obj.metadata.name}"

    def record_event(self, obj, reason: str, message: str,
                     type_: str = EVENT_NORMAL):
        """K8s-style recorder: events carry a type (Normal/Warning) and a
        reason, index by object ref, and count-dedup — re-recording the
        same (type, reason, message) against the same object bumps the
        existing record's count/last-time instead of appending."""
        ref = self._event_ref(obj)
        now = time.time()
        dedup_key = (type_, reason, message)
        deduped = evicted = 0
        with self._lock:
            bucket = self._events.get(ref)
            if bucket is None:
                bucket = self._events[ref] = OrderedDict()
            else:
                self._events.move_to_end(ref)
            rec = bucket.get(dedup_key)
            if rec is not None:
                rec["count"] += 1
                rec["ts"] = now
                bucket.move_to_end(dedup_key)
                deduped = 1
            else:
                bucket[dedup_key] = {"ts": now, "first_ts": now, "count": 1,
                                     "type": type_, "reason": reason,
                                     "message": message}
                if len(bucket) > self.MAX_EVENTS_PER_OBJECT:
                    _, old = bucket.popitem(last=False)
                    evicted += old["count"]
            if len(self._events) > self.MAX_EVENT_OBJECTS:
                _, old_bucket = self._events.popitem(last=False)
                evicted += sum(r["count"] for r in old_bucket.values())
            # Publish INSIDE the lock (the registry lock is a plain leaf,
            # no ordering hazard): two concurrent recorders could
            # otherwise commit the objects gauge out of order and park a
            # stale value, and a live reader could see recorded/evicted
            # counters that don't yet reconcile (the events_accounted
            # contract) — the same race the PR-8 pool gauges fixed.
            REGISTRY.inc(obs_names.EVENTS_RECORDED_TOTAL, type=type_)
            if deduped:
                REGISTRY.inc(obs_names.EVENTS_DEDUPED_TOTAL)
            if evicted:
                REGISTRY.inc(obs_names.EVENTS_EVICTED_TOTAL, float(evicted))
            REGISTRY.set_gauge(obs_names.EVENTS_OBJECTS,
                               float(len(self._events)))

    def events_for(self, obj=None, reason: Optional[str] = None,
                   event_type: Optional[str] = None,
                   since: Optional[float] = None,
                   limit: Optional[int] = None,
                   ref: Optional[str] = None) -> List[EventRecord]:
        """Structured event timeline, oldest-first by last occurrence.
        ``obj`` (or a raw ``ref`` string — events outlive their object,
        the post-mortem case) narrows to one object's bucket (O(1) index
        lookup, not a scan); ``reason``/``event_type`` filter exactly;
        ``since`` is an absolute ``time.time()`` lower bound; ``limit``
        keeps the NEWEST records. Records are tuple-compatible with the
        legacy flat log. Filtering happens in the single pass under the
        lock — only matching records are materialized (records are
        mutated in place by dedup, so reading them outside the lock
        would tear)."""
        out = []
        with self._lock:
            if obj is not None:
                ref = self._event_ref(obj)
            if ref is not None:
                items = [(ref, self._events.get(ref) or {})]
            else:
                items = self._events.items()
            for r, bucket in items:
                for rec in bucket.values():
                    if reason is not None and rec["reason"] != reason:
                        continue
                    if event_type is not None and rec["type"] != event_type:
                        continue
                    if since is not None and rec["ts"] < since:
                        continue
                    out.append(EventRecord(
                        rec["ts"], r, rec["reason"], rec["message"],
                        type_=rec["type"], count=rec["count"],
                        first_ts=rec["first_ts"]))
        out.sort(key=lambda e: e[0])
        if limit is not None and limit > 0:
            out = out[-limit:]
        return out

    def event_stats(self) -> dict:
        """Recorder accounting: objects tracked, live records, and the
        total occurrence count they carry (with the evicted counter this
        reconciles against ``rbg_events_recorded_total`` — the fleet
        drill's ``events_accounted`` invariant)."""
        with self._lock:
            objects = len(self._events)
            records = sum(len(b) for b in self._events.values())
            total = sum(r["count"] for b in self._events.values()
                        for r in b.values())
        return {"objects": objects, "records": records,
                "total_count": total}


# ---- registered snapshot migrations (rbg_tpu/api/conversions.py) ----

from rbg_tpu_torch.api.conversions import migrate_snapshot_v1 as _migrate_v1  # noqa: E402

Store._SNAPSHOT_MIGRATIONS[1] = _migrate_v1
