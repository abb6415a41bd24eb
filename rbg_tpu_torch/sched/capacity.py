"""Incremental scheduler state: free capacity, slice occupancy, exclusive
topology — maintained from store watch events instead of rescanned per
placement decision.

Reference analog: the informer-cache + no-deepcopy-lister hot path the Go
controllers schedule against (``pkg/utils/client/no_deepcopy_lister.go``) —
kube-scheduler itself keeps exactly this kind of incremental NodeInfo cache.
Our ``_place`` used to list every pod and node per decision (O(pods) per pod
placed), which made a 30-group create burst scheduler-backlog-bound
(docs/benchmarks.md; VERDICT r1 item 6).

Consistency model: contributions are keyed by pod UID and *replaced* (never
incremented), and each carries the pod's resourceVersion — a replace only
applies when it is not older than what the cache holds, so both duplicate
AND reordered deliveries (``_notify`` dispatches outside the store lock)
converge on the newest state; DELETED is terminal and always applies. The
scheduler is the single binder (workers=1) and applies its own binds to the
cache synchronously via the same path, so a plan never double-books ahead
of the watch event. A periodic ``rebuild`` (wired to the controller resync)
backstops any residual drift.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.utils.locktrace import named_lock, named_rlock
# The port has no racetrace: the reference's @_race_guard is left out.

# A pod's footprint in the cache: (node, is_tpu_slice_pod, excl) where
# excl = (topology_key, domain, group) or None.
_Contrib = Tuple[str, bool, Optional[Tuple[str, str, str]]]


def _pod_contrib(pod, nodes) -> Optional[_Contrib]:
    """The cache footprint of one pod; None when it holds no capacity."""
    if not pod.node_name or not pod.active:
        return None
    tpu = pod.template.scheduler_hints.get("tpu-slice") == "true"
    excl = None
    key = pod.metadata.annotations.get(C.ANN_EXCLUSIVE_TOPOLOGY)
    grp = pod.metadata.labels.get(C.LABEL_GROUP_NAME)
    if key and grp:
        node = nodes.get(pod.node_name)
        if node is not None:
            excl = (key, node.labels.get(key, ""), grp)
    return (pod.node_name, tpu, excl)


class CapacityCache:
    def __init__(self, store):
        self.store = store
        self._lock = named_rlock("sched.capacity_cache")
        self._nodes: Dict[str, object] = {}  # guarded_by[sched.capacity_cache]
        # node -> bound active pods  # guarded_by[sched.capacity_cache]
        self._bound: Dict[str, int] = {}
        # node -> bound slice pods  # guarded_by[sched.capacity_cache]
        self._tpu_bound: Dict[str, int] = {}
        # (topo key, domain) -> {group: pod count}  # guarded_by[sched.capacity_cache]
        self._excl: Dict[Tuple[str, str], Dict[str, int]] = {}
        # pod uid -> (resource_version, footprint); rv None = tombstone
        # (terminal delete — late pre-delete events for the uid are dropped)
        # guarded_by[sched.capacity_cache]
        self._contrib: Dict[str, Tuple[Optional[int], Optional[_Contrib]]] = {}
        # Tombstones that already survived one rebuild (dropped on the next).
        # guarded_by[sched.capacity_cache]
        self._aged_tombstones: set = set()
        # ---- topology-sharded feasibility index (event-maintained) ----
        # Every structure below is recomputed incrementally by wrapping
        # each node/bound/tpu_bound mutation in _unindex_node/_index_node,
        # so `_place` can prune whole slices and argmax free capacity
        # without touching the full node list.
        # slice_id -> node names of the slice  # guarded_by[sched.capacity_cache]
        self._slices: Dict[str, set] = {}
        # slice_id -> hosts that could take a NEW slice pod right now
        # (schedulable, free>0, no slice pod bound) — an UPPER bound on
        # any pod-filtered host count, so pruning shards below the gang
        # size is exact.  # guarded_by[sched.capacity_cache]
        self._slice_placeable: Dict[str, int] = {}
        # free-pod-count -> names of placeable nodes (schedulable, free>0)
        # — the singles-path argmax index.  # guarded_by[sched.capacity_cache]
        self._free_buckets: Dict[int, set] = {}
        # name -> tombstone rv of a DELETED node (hard deletes mint a
        # fresh rv, so any event older than the tombstone is stale).
        # Cleared on rebuild.  # guarded_by[sched.capacity_cache]
        self._node_tombstones: Dict[str, int] = {}
        self._started = False

    # ---- lifecycle ----

    def start(self):
        if self._started:
            return
        self._started = True
        # List-then-watch with a resume watermark: snapshot the store rv,
        # build from the list, then subscribe replaying everything after
        # the snapshot — a write landing between the list and the watch
        # registration is REPLAYED, never dropped (the rv-ordered _apply
        # makes redelivery of already-listed state a no-op). WatchExpired
        # (bounded log outran the gap) falls back to live-watch + a second
        # rebuild, which covers the gap by re-listing.
        from rbg_tpu_torch.runtime.store import WatchExpired
        rv0 = self.store.current_rv()
        self.rebuild()
        expired = False
        for kind, fn in (("Pod", self._on_pod), ("Node", self._on_node)):
            try:
                self.store.watch(kind, fn, since_rv=rv0)
            except WatchExpired:
                self.store.watch(kind, fn)
                expired = True
        if expired:
            self.rebuild()

    def rebuild(self):
        """Full resync from the store (drift backstop; also initial build)."""
        with self._lock:
            self._nodes = {n.metadata.name: n
                           for n in self.store.list("Node", copy_=False)}
            pods = self.store.list("Pod", copy_=False)
            # Carry delete tombstones for ONE extra rebuild cycle: event
            # dispatch happens outside the store lock, so a delayed
            # pre-delete MODIFIED event can arrive after this rebuild and
            # would otherwise resurrect the deleted pod's footprint
            # (transiently under-reporting free capacity until the next
            # resync). Tombstones that already survived a cycle are dropped.
            live = {p.metadata.uid for p in pods}
            keep = {uid for uid, (rv, _) in self._contrib.items()
                    if rv is None} - self._aged_tombstones - live
            self._aged_tombstones = set(keep)
            self._bound.clear()
            self._tpu_bound.clear()
            self._excl.clear()
            self._contrib.clear()
            self._slices.clear()
            self._slice_placeable.clear()
            self._free_buckets.clear()
            self._node_tombstones.clear()
            for name in self._nodes:
                self._index_node(name)
            for uid in keep:
                self._contrib[uid] = (None, None)
            for pod in pods:
                self._apply(pod.metadata.uid, pod.metadata.resource_version,
                            _pod_contrib(pod, self._nodes))

    # ---- event maintenance ----

    def _on_pod(self, ev):
        from rbg_tpu_torch.runtime.store import Event
        pod = ev.object
        with self._lock:
            if ev.type == Event.DELETED:
                self._apply(pod.metadata.uid, None, None)  # terminal
            else:
                self._apply(pod.metadata.uid, pod.metadata.resource_version,
                            _pod_contrib(pod, self._nodes))

    def _on_node(self, ev):
        from rbg_tpu_torch.runtime.store import Event
        node = ev.object
        with self._lock:
            name = node.metadata.name
            rv = node.metadata.resource_version
            # Same rv ordering discipline _apply enforces for pods:
            # _notify dispatches outside the store lock and the
            # watch-resume replay path deliberately redelivers, so a
            # late-dispatched OLDER node event must never overwrite
            # newer cached state (a stale "uncordoned" snapshot landing
            # after the cordon would hand the sharded scan a node the
            # store says is unschedulable).
            cur = self._nodes.get(name)
            tomb = self._node_tombstones.get(name)
            if tomb is not None:
                if rv <= tomb:
                    return  # pre-delete stragglers of a deleted node
                self._node_tombstones.pop(name, None)  # genuine re-create
            if (ev.type != Event.DELETED and cur is not None
                    and rv < cur.metadata.resource_version):
                return
            if ev.type == Event.DELETED:
                self._node_tombstones[name] = rv
                self._unindex_node(name)
                old = self._nodes.pop(name, None)
                if old is not None and old.tpu.slice_id:
                    members = self._slices.get(old.tpu.slice_id)
                    if members is not None:
                        members.discard(name)
                        if not members:
                            del self._slices[old.tpu.slice_id]
                return
            old = self._nodes.get(name)
            self._unindex_node(name)
            if (old is not None and old.tpu.slice_id
                    and old.tpu.slice_id != node.tpu.slice_id):
                members = self._slices.get(old.tpu.slice_id)
                if members is not None:
                    members.discard(name)
                    if not members:
                        del self._slices[old.tpu.slice_id]
            self._nodes[name] = node
            self._index_node(name)
            # Topology labels are immutable by convention on TPU nodepools,
            # but if one DOES change, re-derive the exclusive-topology
            # domains of pods bound to this node so existing footprints
            # don't pin the old domain until the next pod event / resync.
            if old is not None and getattr(old, "labels", {}) != node.labels:
                self._refresh_excl_on_node(node)

    def _refresh_excl_on_node(self, node):
        """Recompute (key, domain) exclusive footprints of pods on ``node``
        after a label change. The footprint tuple carries everything needed
        (topology key + group); only the domain value is re-read."""
        for uid, (rv, contrib) in list(self._contrib.items()):
            if rv is None or contrib is None:
                continue
            name, tpu, excl = contrib
            if name != node.metadata.name or excl is None:
                continue
            key, _old_domain, grp = excl
            new_excl = (key, node.labels.get(key, ""), grp)
            if new_excl != excl:
                self._remove_footprint(contrib)
                new_contrib = (name, tpu, new_excl)
                self._contrib[uid] = (rv, new_contrib)
                self._add_footprint(new_contrib)

    def _apply(self, uid: str, rv: Optional[int], contrib: Optional[_Contrib]):
        """Replace a pod's footprint iff ``rv`` is not older than what we
        hold (rv None = terminal delete, always wins; a later stale event
        for a deleted uid hits the tombstone and is dropped)."""
        cur = self._contrib.get(uid)
        if cur is not None:
            cur_rv, cur_contrib = cur
            if rv is not None:
                if cur_rv is None:
                    return  # deleted — ignore late pre-delete events
                if rv < cur_rv:
                    return  # older than current state
            self._remove_footprint(cur_contrib)
        elif rv is None:
            return  # delete of a pod we never accounted
        self._contrib[uid] = (rv, contrib if rv is not None else None)
        if rv is not None:
            self._add_footprint(contrib)

    def _remove_footprint(self, contrib: Optional[_Contrib]):
        if contrib is None:
            return
        node, tpu, excl = contrib
        self._unindex_node(node)
        self._bound[node] = self._bound.get(node, 1) - 1
        if self._bound[node] <= 0:
            del self._bound[node]
        if tpu:
            self._tpu_bound[node] = self._tpu_bound.get(node, 1) - 1
            if self._tpu_bound[node] <= 0:
                del self._tpu_bound[node]
        if excl is not None:
            key, domain, grp = excl
            owners = self._excl.get((key, domain))
            if owners is not None:
                owners[grp] = owners.get(grp, 1) - 1
                if owners[grp] <= 0:
                    owners.pop(grp, None)
                if not owners:
                    self._excl.pop((key, domain), None)
        self._index_node(node)

    def _add_footprint(self, contrib: Optional[_Contrib]):
        if contrib is None:
            return
        node, tpu, excl = contrib
        self._unindex_node(node)
        self._bound[node] = self._bound.get(node, 0) + 1
        if tpu:
            self._tpu_bound[node] = self._tpu_bound.get(node, 0) + 1
        if excl is not None:
            key, domain, grp = excl
            owners = self._excl.setdefault((key, domain), {})
            owners[grp] = owners.get(grp, 0) + 1
        self._index_node(node)

    # ---- shard-index maintenance (lock held by every caller) ----

    def _index_node(self, name: str) -> None:
        """(Re-)derive one node's index contribution from the CURRENT
        maps. Callers bracket every mutation of ``_nodes``/``_bound``/
        ``_tpu_bound`` with _unindex_node(old state) → mutate →
        _index_node(new state), so contributions never drift."""
        node = self._nodes.get(name)
        if node is None:
            return
        sid = node.tpu.slice_id
        if sid:
            self._slices.setdefault(sid, set()).add(name)
        free = node.capacity_pods - self._bound.get(name, 0)
        if not node.schedulable or free <= 0:
            return
        self._free_buckets.setdefault(free, set()).add(name)
        if sid and name not in self._tpu_bound:
            self._slice_placeable[sid] = self._slice_placeable.get(sid, 0) + 1

    def _unindex_node(self, name: str) -> None:
        node = self._nodes.get(name)
        if node is None:
            return
        free = node.capacity_pods - self._bound.get(name, 0)
        if not node.schedulable or free <= 0:
            return
        bucket = self._free_buckets.get(free)
        if bucket is not None:
            bucket.discard(name)
            if not bucket:
                del self._free_buckets[free]
        sid = node.tpu.slice_id
        if sid and name not in self._tpu_bound:
            n = self._slice_placeable.get(sid, 0) - 1
            if n > 0:
                self._slice_placeable[sid] = n
            else:
                self._slice_placeable.pop(sid, None)

    def apply_bind(self, pod):
        """Synchronously account a bind this scheduler just committed (pod
        already carries node_name), so the next plan in the same burst sees
        it before the watch event lands."""
        with self._lock:
            self._apply(pod.metadata.uid, pod.metadata.resource_version,
                        _pod_contrib(pod, self._nodes))

    # ---- plan-time views (plan-local scratch copies, O(nodes)) ----

    def ready_nodes(self) -> List[object]:
        """Bind candidates: ready AND schedulable — a cordoned or
        disrupted (maintenance/preempted) host keeps its bound-pod
        accounting but must never receive a NEW bind."""
        with self._lock:
            return [n for n in self._nodes.values() if n.schedulable]

    def free_view(self) -> Dict[str, int]:
        with self._lock:
            return {name: n.capacity_pods - self._bound.get(name, 0)
                    for name, n in self._nodes.items()}

    def tpu_used_view(self) -> Set[str]:
        with self._lock:
            return set(self._tpu_bound)

    def excl_view(self) -> Dict[Tuple[str, str], str]:
        """(key, domain) -> owning group. At most one owner by scheduler
        invariant; if a transient overlap exists, any owner blocks others."""
        with self._lock:
            return {kd: next(iter(owners))
                    for kd, owners in self._excl.items() if owners}

    # ---- sharded-scan views (the event-maintained feasibility index) ----

    def node(self, name: str):
        with self._lock:
            return self._nodes.get(name)

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def free_of(self, name: str, default: int = 0) -> int:
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return default
            return node.capacity_pods - self._bound.get(name, 0)

    def is_tpu_used(self, name: str) -> bool:
        with self._lock:
            return name in self._tpu_bound

    def placeable_nodes(self) -> List[object]:
        """Schedulable nodes with free capacity (the only nodes a single
        placement can pick) — from the bucket index, NOT a full-node
        scan."""
        with self._lock:
            return [self._nodes[n] for bucket in self._free_buckets.values()
                    for n in bucket if n in self._nodes]

    def gang_shards(self, need: int) -> Tuple[List[Tuple[str, List[object]]], int]:
        """Slices whose placeable-host UPPER BOUND can fit a gang of
        ``need`` hosts, with their schedulable member nodes; plus the
        count of shards pruned. Pruning is exact: the bound counts hosts
        by schedulable/free/slice-pod state only, and every pod-specific
        filter the scan applies afterwards can only REMOVE hosts."""
        with self._lock:
            out = []
            for sid, count in self._slice_placeable.items():
                if count < need:
                    continue
                hosts = [self._nodes[n] for n in self._slices.get(sid, ())
                         if n in self._nodes]
                out.append((sid, [n for n in hosts if n.schedulable]))
            skipped = len(self._slices) - len(out)
            return out, skipped

    def best_plain_node(self, exclude) -> Optional[Tuple[str, int]]:
        """Argmax over placeable nodes by (free capacity, then lexico-
        graphically smallest name), skipping ``exclude`` — the fast path
        for a pod with no selector/affinity/chip/exclusivity constraints.
        Returns (name, free) or None."""
        with self._lock:
            for free in sorted(self._free_buckets, reverse=True):
                names = self._free_buckets[free]
                inter = (exclude & names) if exclude else None
                cand = names if not inter else names - inter
                if cand:
                    return min(cand), free
            return None

    def nodes_in_slices(self, slice_ids) -> set:
        with self._lock:
            out = set()
            for sid in slice_ids:
                out |= self._slices.get(sid, set())
            return out


class SparePool:
    """Warm-spare slice reservation: N fully-idle standby slices held back
    per topology so disruption recovery is BIND-time, not provision-time.

    Mooncake / "Taming the Chaos" argument (PAPERS.md): group-level
    recovery must have somewhere to recover INTO — re-provisioning a
    multi-host slice after a preemption is minutes, re-binding onto a
    reserved warm slice is milliseconds. The pool is a *soft* reservation:
    the scheduler steers ordinary gangs away from reserved slices, but
    when nothing else fits it raids the pool rather than wedging a gang
    Pending (capacity starvation must degrade, not deadlock).

    ``take`` consumes a spare (disruption controller granting it to a
    migrating/recovering instance); ``replenish`` re-reserves idle
    eligible slices up to the target, called from the scheduler's resync
    and after every take — "replenished in the background"."""

    def __init__(self, per_topology: int = 0):
        self.per_topology = per_topology  # guarded_by[sched.spare_pool]
        self._lock = named_lock("sched.spare_pool")
        # slice_id -> topology  # guarded_by[sched.spare_pool]
        self._reserved: Dict[str, str] = {}
        # gauge zeroing on drain  # guarded_by[sched.spare_pool]
        self._known_topos: Set[str] = set()
        # Slices taken but not yet occupied: a grant's target stays idle
        # until the recovering gang binds, and replenish must not
        # re-reserve it in that window (that would silently revoke the
        # grant — the scheduler would then treat the target as held back).
        # guarded_by[sched.spare_pool]
        self._granted: Set[str] = set()

    def configure(self, per_topology: int) -> None:
        with self._lock:
            self.per_topology = per_topology

    def reserved_slices(self) -> Set[str]:
        with self._lock:
            return set(self._reserved)

    def held_slices(self) -> Set[str]:
        """Slices the scheduler must steer ordinary gangs away from:
        reserved spares PLUS granted-but-not-yet-bound targets — a
        recovering gang's granted slice sits idle through its whole
        warmup leg, and emptiest-first ordering would otherwise hand it
        to the next ordinary gang created in that window."""
        with self._lock:
            return set(self._reserved) | set(self._granted)

    def is_reserved(self, slice_id: str) -> bool:
        with self._lock:
            return slice_id in self._reserved

    def available(self, topology: Optional[str] = None) -> int:
        """Reserved spares a ``take`` could grant right now (peek, never
        consumes). The autoscaler reads this to report how much of a
        scale-up is bind-time instant vs provision-bound."""
        with self._lock:
            return sum(1 for t in self._reserved.values()
                       if topology is None or t == topology)

    def depth(self) -> Dict[str, int]:
        """topology -> reserved spare count (the pool-depth gauge)."""
        out: Dict[str, int] = {}
        with self._lock:
            for topo in self._reserved.values():
                out[topo] = out.get(topo, 0) + 1
        return out

    def take(self, topology: Optional[str] = None,
             slice_id: Optional[str] = None) -> Optional[str]:
        """Consume one spare (by topology, or a specific slice when the
        scheduler raids the pool). Returns the slice id or None."""
        from rbg_tpu_torch.obs import names
        from rbg_tpu_torch.obs.metrics import REGISTRY
        with self._lock:
            if slice_id is not None:
                if self._reserved.pop(slice_id, None) is None:
                    return None
                taken = slice_id
            else:
                taken = next((s for s, t in sorted(self._reserved.items())
                              if topology is None or t == topology), None)
                if taken is None:
                    return None
                del self._reserved[taken]
            self._granted.add(taken)
        REGISTRY.inc(names.DISRUPTION_SPARES_CONSUMED_TOTAL)
        self._export_depth()
        return taken

    def replenish(self, store) -> None:
        """Re-reserve idle slices up to ``per_topology`` per topology.
        Eligible: every host ready, schedulable, undisrupted; no active
        pod bound to any host; not already reserved."""
        with self._lock:
            # One consistent target for this pass (configure() can race).
            target = self.per_topology
        if target <= 0:
            return
        by_slice: Dict[str, list] = {}
        for n in store.list("Node", copy_=False):
            if n.tpu.slice_id:
                by_slice.setdefault(n.tpu.slice_id, []).append(n)
        occupied = set()
        occupied_gang = set()
        for p in store.list("Pod", copy_=False):
            if p.node_name and p.active:
                occupied.add(p.node_name)
                if p.template.scheduler_hints.get("tpu-slice") == "true":
                    occupied_gang.add(p.node_name)
        # Slice ids still referenced as a PENDING recovery target by some
        # instance: their grants hold probation even with nothing bound
        # yet. A binding is only STALE — the grant was bypassed and must
        # not pin probation forever — when its instance observably runs
        # on a different slice that is HEALTHY: mid-migration the status
        # still names the old (disrupted/cordoned) slice the gang is
        # fleeing, and that must keep the grant alive.
        healthy = {sid: all(n.schedulable for n in hosts)
                   for sid, hosts in by_slice.items()}
        referenced = set()
        for inst in store.list("RoleInstance", copy_=False):
            sid = inst.metadata.annotations.get(C.ANN_SLICE_BINDING)
            if not sid:
                continue
            cur = inst.status.slice_id
            if not cur or cur == sid or not healthy.get(cur, False):
                referenced.add(sid)

        def eligible(hosts) -> bool:
            return (all(n.schedulable for n in hosts)
                    and not any(n.metadata.name in occupied for n in hosts))

        with self._lock:
            # Drop reservations whose slices stopped being spares: a pod
            # landed there (capacity-starved single placement binds
            # WITHOUT take()), or the slice got cordoned/disrupted/
            # removed. Without this the pool overcounts forever and a
            # later take() grants a slice the gang cannot fit on.
            for sid in list(self._reserved):
                hosts = by_slice.get(sid)
                if hosts is None or not eligible(hosts):
                    del self._reserved[sid]
            # A granted slice leaves probation once its GANG actually
            # bound (warmup pods occupying it first don't count — the
            # grant is still pending), the slice vanished, or no instance
            # references it anymore (grant abandoned mid-recovery) —
            # otherwise a cancelled migration would leak the slice out of
            # the re-reservable pool forever.
            for sid in list(self._granted):
                hosts = by_slice.get(sid)
                if (hosts is None
                        or any(n.metadata.name in occupied_gang
                               for n in hosts)
                        or sid not in referenced):
                    self._granted.discard(sid)
            counts: Dict[str, int] = {}
            for topo in self._reserved.values():
                counts[topo] = counts.get(topo, 0) + 1
            for sid, hosts in sorted(by_slice.items()):
                if sid in self._reserved or sid in self._granted:
                    continue
                topo = hosts[0].tpu.slice_topology
                if counts.get(topo, 0) >= target:
                    continue
                if not eligible(hosts):
                    continue
                self._reserved[sid] = topo
                counts[topo] = counts.get(topo, 0) + 1
        self._export_depth()

    def _export_depth(self) -> None:
        from rbg_tpu_torch.obs import names
        from rbg_tpu_torch.obs.metrics import REGISTRY
        depth = self.depth()
        with self._lock:
            self._known_topos |= set(depth)
            topos = set(self._known_topos)
        for topo in topos:
            REGISTRY.set_gauge(names.DISRUPTION_SPARE_POOL_DEPTH,
                               float(depth.get(topo, 0)), topology=topo)


def grant_spares_for_role(store, spares, ns: str, group: str, role: str,
                          slice_topology: Optional[str],
                          on_grant=None) -> int:
    """Bind-time warm-up shared by the autoscaler and the topology
    controller: steer UNBOUND pending instances of (group, role) onto
    reserved spare slices (the PR-3 grant seam), then replenish so the
    pool does not stay shallow — and so any take whose bind was lost
    returns to the re-reservable set. Returns the grants that LANDED;
    ``on_grant(inst, slice_id)`` runs once per landed grant (metrics /
    events stay caller-owned)."""
    from rbg_tpu_torch.runtime.store import Conflict, NotFound
    took = granted = 0
    for inst in store.list("RoleInstance", namespace=ns,
                           selector={C.LABEL_GROUP_NAME: group,
                                     C.LABEL_ROLE_NAME: role},
                           copy_=False):
        if (inst.metadata.annotations.get(C.ANN_SLICE_BINDING)
                or inst.status.slice_id):
            continue
        target = spares.take(topology=slice_topology)
        if target is None:
            break   # pool dry — still replenish below for what landed
        took += 1
        bound = {"v": False}

        def fn(i, target=target):
            bound["v"] = False  # reset: mutate retries re-run fn
            if i.metadata.annotations.get(C.ANN_SLICE_BINDING):
                return False
            i.metadata.annotations[C.ANN_SLICE_BINDING] = target
            bound["v"] = True
            return True

        try:
            store.mutate("RoleInstance", ns, inst.metadata.name, fn)
        except (NotFound, Conflict):
            continue   # replenish reclaims the unreferenced grant
        if not bound["v"]:
            # Someone bound the instance between the pre-check and the
            # mutate (scheduler, disruption grant) — the taken spare
            # references nothing; replenish below reclaims it.
            continue
        granted += 1
        if on_grant is not None:
            on_grant(inst, target)
    if took:
        try:
            spares.replenish(store)
        except Exception:
            pass
    return granted
