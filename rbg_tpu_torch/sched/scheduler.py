"""TPU-topology-aware scheduler.

The reference delegates placement to kube-scheduler and expresses intent via
PodGroup CRs + pod (anti-)affinity (``pkg/scheduler``, ``pod_reconciler.go:
160-242``). This framework OWNS placement — the TPU-first replacement for the
README's "NVLink > PCIe > RDMA > VPC" affinity ladder is an explicit
ICI > DCN ladder over slice topology:

1. **Slice atomicity** — a multi-host role instance (one JAX program) must
   occupy hosts of exactly ONE slice (one ICI domain), one pod per host,
   worker_index-aligned so JAX process ids match the physical ring order.
2. **Gang all-or-nothing** — a PodGroup binds only when every member can bind
   (TPU slices are provisioned whole; partial placement deadlocks capacity).
3. **Exclusive topology** — at most one group per topology domain when
   requested (reference: exclusive-topology, ``pod_reconciler.go:160-221``).
4. **Warm affinity** — prefer nodes/slices recorded by the node-binding store
   (in-place scheduling, reference KEP-351) so restarted instances return to
   hosts with warm HBM/XLA caches.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.obs import names as obs_names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.runtime.controller import Controller, Result, Watch
from rbg_tpu_torch.runtime.store import EVENT_WARNING, NotFound, Store


def _unscheduled(ev) -> bool:
    return True  # level-triggered; reconcile re-checks everything


class _FreeOverlay:
    """Plan-local free-capacity view for the sharded scan: reads fall
    through to the incremental cache, writes (the plan's own in-flight
    binds) stay local — no per-plan O(nodes) dict copy."""

    __slots__ = ("cap", "local")

    def __init__(self, cap):
        self.cap = cap
        self.local: Dict[str, int] = {}

    def get(self, name: str, default: int = 0) -> int:
        v = self.local.get(name)
        return v if v is not None else self.cap.free_of(name, default)

    def __getitem__(self, name: str) -> int:
        return self.get(name, 0)

    def __setitem__(self, name: str, value: int) -> None:
        self.local[name] = value

    def touched(self) -> set:
        return set(self.local)


class _TpuUsedOverlay:
    """Plan-local slice-pod-occupancy view (same contract as
    _FreeOverlay: cache fallthrough reads, local adds)."""

    __slots__ = ("cap", "local")

    def __init__(self, cap):
        self.cap = cap
        self.local: set = set()

    def __contains__(self, name: str) -> bool:
        return name in self.local or self.cap.is_tpu_used(name)

    def add(self, name: str) -> None:
        self.local.add(name)


class SchedulerController(Controller):
    name = "scheduler"
    # Single worker: placement decisions are serialized (as in kube-scheduler's
    # one scheduling loop) so concurrent plans can never double-book a host.
    workers = 1
    # Faster drift backstop than the controller default: an unbound
    # pod with no wake-up event is a stranded gang; scheduler sweeps are
    # cheap (bound pods return in one store.get). 30 s is the LEGACY
    # cadence (the A/B baseline); event-carried mode demotes the sweep to
    # a 60 s drift backstop that skips keys the event path already
    # reconciled since the last tick.
    resync_period = 30.0
    backstop_period = 60.0
    # Topology-sharded feasibility scan (the event-maintained capacity
    # index): prunes whole slices before visiting a host and serves the
    # singles path from the free-capacity buckets. False = the reference
    # full-scan path (bit-identical placements by contract; the
    # equivalence suite and the fleet A/B run both).
    use_sharded = True

    def __init__(self, store: Store, node_binding=None, spares=None):
        super().__init__(store)
        self.node_binding = node_binding  # rbg_tpu_torch.sched.binding.NodeBindingStore
        from rbg_tpu_torch.sched.capacity import CapacityCache, SparePool
        self.cap = CapacityCache(store)
        # Warm-spare reservation (disruption recovery lands here bind-time).
        self.spares = spares if spares is not None else SparePool(0)

    def start(self):
        # Build the capacity cache BEFORE watches/workers start so the first
        # reconcile never sees an empty view.
        self.cap.start()
        self.spares.replenish(self.store)
        super().start()

    def _enqueue_all(self, backstop: bool = False):
        """One pass over pods — NOT the base class's per-watch sweep: the
        Node watch's mapper lists every pod per node, which makes the
        generic sweep O(nodes × pods) at fleet scale. Every key a node
        event could map to is a pod key, so one pod list covers both
        watches. Backstop ticks skip keys the event path already
        reconciled since the last tick (satellite fix: a healthy event
        path does zero backstop work)."""
        recent = self._recent_snapshot() if backstop else frozenset()
        enq = skip = 0
        for p in self.store.list("Pod", namespace=None, copy_=False):
            key = (p.metadata.namespace, p.metadata.name)
            if key in recent:
                skip += 1
                continue
            enq += 1
            self.queue.add(key, version=p.metadata.resource_version)
        if backstop:
            if enq:
                REGISTRY.inc(obs_names.RESYNC_BACKSTOP_ENQUEUED_TOTAL,
                             float(enq), controller=self.name)
            if skip:
                REGISTRY.inc(obs_names.RESYNC_BACKSTOP_SKIPPED_TOTAL,
                             float(skip), controller=self.name)

    def _resync_loop(self):
        # Piggyback the drift-backstop rebuild on the controller resync
        # (event-wait so stop() exits promptly, as in the base class).
        while not self._stop_event.wait(self._effective_resync_period()):
            try:
                self.spares.replenish(self.store)
            except Exception:
                import logging
                logging.getLogger("rbg_tpu_torch.sched").warning(
                    "spare-pool replenish failed", exc_info=True)
            try:
                self.cap.rebuild()
            except Exception:
                # Loud failure (round-1 policy): a persistently failing
                # rebuild would otherwise silently disable the drift
                # backstop forever.
                import logging
                logging.getLogger("rbg_tpu_torch.sched").warning(
                    "capacity rebuild failed (drift backstop skipped this "
                    "cycle)", exc_info=True)
            # Outside the try: the periodic re-enqueue must still happen
            # when the rebuild fails.
            try:
                self._enqueue_all(backstop=True)
            except Exception:
                import logging
                logging.getLogger("rbg_tpu_torch.sched").warning(
                    "scheduler resync enqueue failed", exc_info=True)

    def watches(self) -> List[Watch]:
        from rbg_tpu_torch.runtime.controller import own_keys
        return [
            Watch("Pod", own_keys),
            # Node changes can unblock pending pods — re-enqueue all pending.
            Watch("Node", lambda obj: [
                (p.metadata.namespace, p.metadata.name)
                for p in self.store.list("Pod", copy_=False)
                if not p.node_name and p.active
            ]),
        ]

    # ---- reconcile ----

    def reconcile(self, store: Store, key) -> Optional[Result]:
        ns, name = key
        pod = store.get("Pod", ns, name, copy_=False)
        if pod is None or pod.node_name or not pod.active:
            return None

        group = pod.metadata.labels.get(C.LABEL_POD_GROUP)
        if group:
            return self._schedule_gang(store, ns, group)
        plan = self._place(store, [pod])
        if plan is None:
            store.record_event(pod, "FailedScheduling", "no feasible node",
                               type_=EVENT_WARNING)
            return Result(requeue_after=0.2)
        self._bind(store, plan)
        return None

    def _schedule_gang(self, store: Store, ns: str, group: str) -> Optional[Result]:
        pods = [
            p for p in store.list("Pod", namespace=ns, selector={C.LABEL_POD_GROUP: group})
            if p.active
        ]
        pg = store.get("PodGroup", ns, group)
        min_member = pg.spec.min_member if pg else len(pods)
        if len(pods) < min_member:
            return Result(requeue_after=0.2)  # members still being created
        unbound = [p for p in pods if not p.node_name]
        if not unbound:
            self._mark_pg(store, ns, group, pods)
            return None
        plan = self._place(store, unbound)
        if plan is None:
            if pods:
                store.record_event(pods[0], "FailedGangScheduling",
                                   f"group {group}: cannot place {len(unbound)} pods atomically",
                                   type_=EVENT_WARNING)
            return Result(requeue_after=0.3)
        self._bind(store, plan)
        self._mark_pg(store, ns, group, pods)
        return None

    def _mark_pg(self, store, ns, group, pods):
        pg = store.get("PodGroup", ns, group)
        if pg is None:
            return
        bound = sum(1 for p in store.list("Pod", namespace=ns,
                                          selector={C.LABEL_POD_GROUP: group})
                    if p.node_name)

        def fn(g):
            phase = "Scheduled" if bound >= g.spec.min_member else "Pending"
            if (g.status.phase, g.status.scheduled) == (phase, bound):
                return False
            g.status.phase, g.status.scheduled = phase, bound
            return True

        try:
            store.mutate("PodGroup", ns, group, fn, status=True)
        except NotFound:
            pass  # gang object deleted concurrently — nothing to mark
        # Conflict (after retries) and real faults propagate: the worker
        # backoff-retries and counts the error (review finding r1#4 — a
        # silent drop here wedged gang status forever).

    # ---- placement core ----

    def _place(self, store: Store, pods: List) -> Optional[Dict[Tuple[str, str], str]]:
        """Compute {(ns, pod): node} for all pods or None (all-or-nothing).
        All aggregates come from the incremental CapacityCache. The
        default path is the topology-SHARDED scan (`use_sharded`): gang
        placement visits only slices whose free-capacity upper bound fits
        the gang, and plain singles resolve from the free-bucket argmax —
        bit-identical placements to the reference full scan (the
        equivalence suite drills both paths on seeded fleets)."""
        t0 = time.perf_counter()
        try:
            return self._place_inner(store, pods, sharded=self.use_sharded)
        finally:
            REGISTRY.observe(obs_names.SCHED_FEASIBILITY_SCAN_SECONDS,
                             time.perf_counter() - t0)

    def _place_inner(self, store: Store, pods: List,
                     sharded: bool = False) -> Optional[Dict[Tuple[str, str], str]]:
        if sharded:
            if self.cap.node_count() == 0:
                return None
            nodes = None  # host iteration comes from the shard index
            free = _FreeOverlay(self.cap)
            tpu_used = _TpuUsedOverlay(self.cap)
        else:
            nodes = self.cap.ready_nodes()
            if not nodes:
                return None
            free = self.cap.free_view()
            # TPU hosts are chip-exclusive: one slice pod per host.
            tpu_used = self.cap.tpu_used_view()
        excl = self.cap.excl_view()

        plan: Dict[Tuple[str, str], str] = {}
        # Slice-atomic groups first (hardest constraints), then singles.
        # Multi-slice (MEGASCALE) instances split into one sub-gang per
        # slice ordinal — ICI within a sub-gang, DCN across ordinals.
        by_instance = collections.defaultdict(list)
        singles = []
        for p in pods:
            inst = p.metadata.labels.get(C.LABEL_INSTANCE_NAME)
            if inst and p.template.scheduler_hints.get("tpu-slice") == "true":
                ordinal = p.metadata.labels.get(C.LABEL_SLICE_ORDINAL, "0")
                by_instance[(p.metadata.namespace, inst, ordinal)].append(p)
            else:
                singles.append(p)

        plan_slices: Dict[Tuple[str, str], Dict[str, str]] = {}
        for key_, group in sorted(by_instance.items(), key=lambda kv: -len(kv[1])):
            if not self._place_slice_group(store, group, nodes, free, excl,
                                           plan, tpu_used, plan_slices):
                return None
        for p in sorted(singles, key=lambda p: p.metadata.name):
            node = self._pick_single(p, nodes, free, excl)
            if node is None:
                return None
            plan[(p.metadata.namespace, p.metadata.name)] = node
            free[node] -= 1
        return plan

    def _gang_hosts(self, need: int) -> List:
        """Sharded gang host source: only slices whose placeable-host
        upper bound fits the gang; pruned shards are counted, never
        visited."""
        cands, skipped = self.cap.gang_shards(need)
        if cands:
            REGISTRY.inc(obs_names.SCHED_SHARD_SCANS_TOTAL,
                         float(len(cands)))
        if skipped > 0:
            REGISTRY.inc(obs_names.SCHED_SHARD_SKIPS_TOTAL, float(skipped))
        return [n for _, hosts in cands for n in hosts]

    def _place_slice_group(self, store, group, nodes, free, excl, plan,
                           tpu_used, plan_slices) -> bool:
        """Place (the unbound remainder of) a multi-host slice instance: one
        ICI domain, one pod per host, worker_index == JAX process id when
        possible. Sibling pods of the instance may already be bound (partial
        gang, controller restart) — their slice pins the choice and their
        hosts are off-limits."""
        ns = group[0].metadata.namespace
        inst = group[0].metadata.labels.get(C.LABEL_INSTANCE_NAME, "")
        ordinal = group[0].metadata.labels.get(C.LABEL_SLICE_ORDINAL, "0")
        need = len(group)
        if nodes is not None:
            node_by = {n.metadata.name: n for n in nodes}
            lookup = node_by.get
        else:
            # Sharded path: resolve sibling hosts from the cache, with
            # the same schedulable membership the legacy ready-node map
            # had — an unschedulable sibling host must stay invisible
            # here exactly as it was invisible in ready_nodes().
            def lookup(name):
                n = self.cap.node(name)
                return n if n is not None and n.schedulable else None
        # Siblings share the RoleInstance controller-owner — the owner-uid
        # index makes this O(gang) instead of an O(namespace) label scan.
        ref = group[0].metadata.controller_owner()
        all_siblings = [
            p for p in (store.list("Pod", namespace=ns, owner_uid=ref.uid,
                                   copy_=False) if ref is not None else [])
            if p.node_name and p.active
        ]
        siblings = [p for p in all_siblings
                    if p.metadata.labels.get(C.LABEL_SLICE_ORDINAL, "0") == ordinal]
        taken = {p.node_name for p in siblings}
        # Other ordinals' slices are forbidden: MEGASCALE sub-gangs must
        # occupy DISTINCT ICI domains (DCN between them) even when one big
        # physical slice could fit several sub-gangs.
        forbidden_slices = set()
        for p in all_siblings:
            if p.metadata.labels.get(C.LABEL_SLICE_ORDINAL, "0") != ordinal:
                n = lookup(p.node_name)
                if n is not None and n.tpu.slice_id:
                    forbidden_slices.add(n.tpu.slice_id)
        key_ = (ns, inst)
        for other_ordinal, sid in plan_slices.get(key_, {}).items():
            if other_ordinal != ordinal:
                forbidden_slices.add(sid)
        sibling_slice = ""
        for p in siblings:
            n = lookup(p.node_name)
            if n is not None and n.tpu.slice_id:
                sibling_slice = n.tpu.slice_id
                break

        group = sorted(
            group, key=lambda p: int(p.metadata.labels.get(C.LABEL_COMPONENT_INDEX, "0"))
        )
        slices = collections.defaultdict(list)
        for n in (nodes if nodes is not None else self._gang_hosts(need)):
            name = n.metadata.name
            if (n.tpu.slice_id and n.tpu.slice_id not in forbidden_slices
                    and self._node_ok(group[0], n, excl)
                    # Required affinity (avoid labels, Required-mode warm
                    # binding) filters slice hosts too — instance-level
                    # terms are identical across the gang, so group[0]
                    # stands for all (same convention as _node_ok above).
                    and self._required_affinity_ok(group[0], n)
                    and free[name] > 0 and name not in taken and name not in tpu_used):
                slices[n.tpu.slice_id].append(n)

        preferred = sibling_slice or group[0].metadata.annotations.get(C.ANN_SLICE_BINDING, "")
        # Also consult the warm node-binding store.
        if not preferred and self.node_binding is not None:
            preferred = self.node_binding.preferred_slice(group[0]) or ""

        # Warm-spare steering: reserved spares AND granted-but-unbound
        # targets are held back for disruption recovery. An explicitly-
        # bound preferred slice is always honored (candidates() yields it
        # regardless) — that is exactly how the granted gang itself gets
        # onto its held target.
        reserved = self.spares.held_slices()

        def candidates(include_reserved: bool):
            if preferred in slices:
                yield preferred, slices[preferred]
            if sibling_slice:
                return  # bound siblings pin the ICI domain — no other slice is legal
            # Emptiest-first (slice id breaks ties deterministically so
            # the sharded and reference scans order identically): keep
            # fragmentation low, leave room for big gangs.
            for sid, hosts in sorted(slices.items(),
                                     key=lambda kv: (-len(kv[1]), kv[0])):
                if sid != preferred and (include_reserved
                                         or sid not in reserved):
                    yield sid, hosts

        # Pass 1 avoids the spare pool; pass 2 raids it — a gang stuck
        # Pending forever is worse than a thinner spare pool.
        for include_reserved in (False, True) if reserved else (False,):
            for sid, hosts in candidates(include_reserved):
                if len(hosts) < need:
                    continue
                if sid in reserved:
                    self.spares.take(slice_id=sid)
                hosts = sorted(hosts, key=lambda n: n.tpu.worker_index)
                # Align worker_index to component index when the slice is
                # exactly sized; otherwise take the first `need` free hosts
                # in ring order.
                for p, n in zip(group, hosts[:need]):
                    plan[(p.metadata.namespace, p.metadata.name)] = n.metadata.name
                    free[n.metadata.name] -= 1
                    tpu_used.add(n.metadata.name)
                plan_slices.setdefault(key_, {})[ordinal] = sid
                return True
        return False

    @staticmethod
    def _term_satisfied(term, n) -> bool:
        val = n.metadata.name if term.key == "name" else n.labels.get(term.key)
        if term.operator == "In":
            return val in term.values
        if term.operator == "NotIn":
            return val not in term.values
        if term.operator == "Exists":
            return val is not None
        if term.operator == "DoesNotExist":
            return val is None
        return True

    def _required_affinity_ok(self, pod, n) -> bool:
        return all(self._term_satisfied(t, n)
                   for t in pod.affinity if t.required)

    def _pick_single(self, pod, nodes, free, excl) -> Optional[str]:
        """Single-pod placement dispatch: the reference full scan when a
        node list was materialized (legacy path), otherwise the shard
        index — free-bucket argmax for unconstrained pods, an indexed
        scan over only-placeable nodes for everything else."""
        if nodes is not None:
            return self._pick_node(pod, nodes, free, excl)
        if self._plain_pod(pod) and not self.spares.held_slices():
            return self._pick_plain_fast(free)
        return self._pick_node(pod, self.cap.placeable_nodes(), free, excl)

    @staticmethod
    def _plain_pod(pod) -> bool:
        """No selector, no affinity terms, no chip demand, no exclusive
        topology: every placeable node qualifies and scores exactly its
        free capacity — the bucket argmax IS the full scan's answer."""
        if pod.template.node_selector or pod.affinity:
            return False
        if (pod.template.containers
                and pod.template.containers[0].resources.tpu_chips):
            return False
        return not pod.metadata.annotations.get(C.ANN_EXCLUSIVE_TOPOLOGY)

    def _pick_plain_fast(self, free: "_FreeOverlay") -> Optional[str]:
        """(max free, then min name) over placeable nodes: the bucket
        index answers for untouched nodes; nodes this plan already bound
        onto are re-scored at their overlay value."""
        touched = free.touched()
        best = self.cap.best_plain_node(touched)
        b_name, b_free = best if best is not None else (None, 0)
        for name in touched:
            f = free[name]
            if f <= 0:
                continue
            n = self.cap.node(name)
            if n is None or not n.schedulable:
                continue
            if (b_name is None or f > b_free
                    or (f == b_free and name < b_name)):
                b_name, b_free = name, f
        return b_name

    def _pick_node(self, pod, nodes, free, excl) -> Optional[str]:
        best, best_score = None, None
        reserved = self.spares.held_slices()
        for n in nodes:
            name = n.metadata.name
            if free.get(name, 0) <= 0 or not self._node_ok(pod, n, excl):
                continue
            # Required affinity filters candidates; preferred terms score.
            if not self._required_affinity_ok(pod, n):
                continue
            score = free[name]
            # Spare-pool hosts sort last: a single pod landing on a warm
            # spare makes that slice non-idle (gone from the pool on the
            # next replenish) — only use one when nothing else fits.
            if n.tpu.slice_id and n.tpu.slice_id in reserved:
                score -= 10_000_000
            for term in pod.affinity:
                if not term.required and self._term_satisfied(term, n):
                    score += 1000 * term.weight
            # Name breaks score ties so the sharded scan (which visits
            # nodes in index order, not list order) picks identically.
            if (best_score is None or score > best_score
                    or (score == best_score and name < best)):
                best, best_score = name, score
        return best

    def _node_ok(self, pod, node, excl) -> bool:
        for k, v in pod.template.node_selector.items():
            if node.labels.get(k) != v:
                return False
        if pod.template.containers and pod.template.containers[0].resources.tpu_chips:
            if node.tpu.chips < pod.template.containers[0].resources.tpu_chips:
                return False
        topo_key = pod.metadata.annotations.get(C.ANN_EXCLUSIVE_TOPOLOGY)
        if topo_key:
            domain = node.labels.get(topo_key, "")
            owner = excl.get((topo_key, domain))
            mine = pod.metadata.labels.get(C.LABEL_GROUP_NAME)
            if owner is not None and owner != mine:
                return False
        return True

    def _bind(self, store: Store, plan: Dict[Tuple[str, str], str]):
        """Commit a placement plan. A pod deleted mid-plan is skipped (its
        replacement re-schedules); any OTHER failure propagates so the
        worker retries visibly — a silently dropped binding would strand a
        gang half-placed (review finding r1#4). Partial binds are safe:
        ``_place_slice_group`` re-places the unbound remainder around bound
        siblings on the next pass."""
        for (ns, name), node in plan.items():
            def fn(p, node=node):
                if p.node_name:
                    return False
                p.node_name = node
                return True

            try:
                obj = store.mutate("Pod", ns, name, fn)
            except NotFound:
                # Usually the pod was deleted mid-plan (skip; its
                # replacement re-schedules). But a RACED NotFound can leave
                # a live pod unbound with no event to wake us — re-queue it
                # instead of waiting out the resync backstop.
                if store.get("Pod", ns, name, copy_=False) is not None:
                    self.queue.add((ns, name))
                continue
            # Account the bind immediately: the next plan in this burst
            # must not see the capacity as still free.
            if obj is not None and obj.node_name:
                self.cap.apply_bind(obj)
                REGISTRY.inc(obs_names.SCHED_BINDS_TOTAL)
