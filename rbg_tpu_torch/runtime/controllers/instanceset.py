"""RoleInstanceSet controller — stateful + stateless instance engines.

Reference analog: inventory #10-12 (``roleinstanceset_controller.go`` routing
to ``statefulmode``/``statelessmode``). Stateful mode (the TPU default —
ordered identity == stable JAX process topology) manages ordinals 0..n-1 with
partition/maxUnavailable rolling updates; stateless mode manages random-id
instances CloneSet-style with specified-delete.
"""

from __future__ import annotations

import random
import string
import time
from typing import List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api import serde
from rbg_tpu_torch.api.instance import (
    ControllerRevision, InstanceTemplate, RoleInstance, RoleInstanceSpec,
)
from rbg_tpu_torch.api.group import RestartPolicyConfig
from rbg_tpu_torch.api.meta import Condition, get_condition, owner_ref, set_condition
from rbg_tpu_torch.runtime.controller import Controller, Result, Watch, own_keys, owner_keys
from rbg_tpu_torch.runtime.controllers import stateful_update as su
from rbg_tpu_torch.runtime.store import AlreadyExists, Store
from rbg_tpu_torch.utils import spec_hash

ANN_SPECIFIED_DELETE = f"{C.DOMAIN}/specified-delete"


def _ordinal(set_name: str, inst_name: str) -> int:
    """Parse ``{set}-{ordinal}`` (reference: stateful_instance_set_utils.go:41-65)."""
    suffix = inst_name[len(set_name) + 1:]
    try:
        return int(suffix)
    except ValueError:
        return -1


def _rand_id(n: int = 5) -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def update_revision_of(ris) -> str:
    return spec_hash({
        "instance": serde.to_dict(ris.spec.instance),
        "restart": serde.to_dict(ris.spec.restart_policy),
    })


def instance_ready(inst: RoleInstance) -> bool:
    return su.is_ready(inst)   # single readiness predicate, planner-shared


class RoleInstanceSetController(Controller):
    name = "roleinstanceset"

    def __init__(self, store: Store, ports=None):
        super().__init__(store)
        self.ports = ports
        # Per-set stable-unhealthy observation state (keyed by set UID so a
        # delete-and-recreate of the set starts fresh).
        self._observers = {}

    def watches(self) -> List[Watch]:
        from rbg_tpu_torch.runtime.controller import spec_change
        return [
            Watch("RoleInstanceSet", own_keys, predicate=spec_change),
            # 20ms coalescing window: N instances' status flips → one set
            # reconcile (see group.py watches).
            Watch("RoleInstance", owner_keys("RoleInstanceSet"), delay=0.02),
        ]

    def reconcile(self, store: Store, key) -> Optional[Result]:
        ns, name = key
        ris = store.get("RoleInstanceSet", ns, name, copy_=False)
        if ris is None or ris.metadata.deletion_timestamp is not None:
            return None

        revision = update_revision_of(ris)
        if self.ports is not None:
            _, changed = self.ports.ensure_role_ports(ris)
            if changed:
                ris = store.get("RoleInstanceSet", ns, name, copy_=False)  # new annotations
                if ris is None or ris.metadata.deletion_timestamp is not None:
                    return None
        instances = [
            i for i in store.list_for("RoleInstance", ris, copy_=False)
            if i.metadata.deletion_timestamp is None
        ]

        if ris.spec.stateful:
            requeue = self._sync_stateful(store, ris, instances, revision)
        else:
            requeue = self._sync_stateless(store, ris, instances, revision)

        self._update_status(store, ris, revision)
        return Result(requeue_after=requeue) if requeue is not None else None

    # ---- stateful: ordered ordinals + surge-aware rolling update ----
    # Planning lives in stateful_update.plan_stateful (pure, table-tested);
    # this method executes the plan against the store.

    def _observer(self, ris) -> su.HealthObserver:
        uid = ris.metadata.uid
        obs = self._observers.get(uid)
        if obs is None:
            obs = self._observers[uid] = su.HealthObserver()
            # Opportunistic GC of observers for deleted sets.
            live = {r.metadata.uid for r in self.store.list(
                "RoleInstanceSet", namespace=None, copy_=False)}
            for k in [k for k in self._observers if k not in live]:
                del self._observers[k]
        return obs

    def _sync_stateful(self, store, ris, instances, revision):
        ns, name = ris.metadata.namespace, ris.metadata.name
        current_rev = ris.status.current_revision or revision
        self._ensure_ris_revision(store, ris, revision)

        plan = su.plan_stateful(
            ris, instances, current_rev, revision, self._observer(ris),
            lambda i: _ordinal(name, i.metadata.name))

        for iname, ordinal, rev in plan.create:
            self._create_instance(store, ris, iname, ordinal, rev)
        for iname in plan.condemn:
            store.delete("RoleInstance", ns, iname)
        for act in plan.updates:
            inst = store.get("RoleInstance", ns, act.name)
            if inst is None:
                continue
            if self._try_inplace(store, ris, inst, revision):
                continue
            store.delete("RoleInstance", ns, act.name)
        return plan.requeue_after

    # ---- stateless: random ids, specified-delete, revision-sorted update ----

    def _sync_stateless(self, store, ris, instances, revision):
        ns, name = ris.metadata.namespace, ris.metadata.name
        n = ris.spec.replicas

        # PreparingDelete lifecycle (reference: statelessmode lifecycle
        # states, constants.go:75-80): instances slated for deletion drain
        # first; they are excluded from replica accounting so a replacement
        # spins up while the condemned one finishes in-flight work.
        def _is_draining(i):
            return (i.metadata.annotations.get(C.ANN_LIFECYCLE_STATE)
                    == C.LIFECYCLE_PREPARING_DELETE)

        draining = [i for i in instances if _is_draining(i)]
        active = [i for i in instances if not _is_draining(i)]
        drain_requeue = self._progress_draining(store, ris, draining)

        # specified-delete first (reference: statelessmode lifecycle)
        for inst in list(active):
            if inst.metadata.annotations.get(ANN_SPECIFIED_DELETE) == "true":
                self._begin_delete(store, ris, inst)
                active.remove(inst)

        diff = n - len(active)
        if diff > 0:
            # Resurrect draining instances before creating new ones
            # (reference: preparingDelete → Normal recovery on scale-up) —
            # a drained-but-alive worker returns to service instantly, no
            # cold start. Ready and newest first.
            def res_key(i):
                return (not instance_ready(i), -i.metadata.creation_timestamp)
            for inst in sorted(draining, key=res_key):
                if diff <= 0:
                    break
                if inst.metadata.annotations.get(ANN_SPECIFIED_DELETE) == "true":
                    continue  # explicitly condemned — never resurrect
                if inst.metadata.labels.get(C.LABEL_REVISION_NAME) != revision:
                    continue  # condemned BY the rollout — resurrecting it
                    # would loop condemn/resurrect forever; a fresh instance
                    # at the update revision replaces it instead
                if self._cancel_delete(store, inst):
                    draining.remove(inst)
                    active.append(inst)
                    diff -= 1
            existing = {i.metadata.name for i in instances}
            for _ in range(diff):
                iname = f"{name}-{_rand_id()}"
                while iname in existing:
                    iname = f"{name}-{_rand_id()}"
                existing.add(iname)
                self._create_instance(store, ris, iname, -1, revision)
        elif diff < 0:
            # delete preference: not-ready first, then outdated, then
            # lowest scale-down cost (the autoscaler stamps observed
            # in-flight streams — the emptiest instance drains first;
            # unstamped instances read as 0, preserving the old order),
            # then newest.
            def key(i):
                try:
                    cost = float(i.metadata.annotations.get(
                        C.ANN_SCALE_DOWN_COST) or 0.0)
                except ValueError:
                    cost = 0.0
                return (
                    instance_ready(i),
                    i.metadata.labels.get(C.LABEL_REVISION_NAME) == revision,
                    cost,
                    -i.metadata.creation_timestamp,
                )

            for inst in sorted(active, key=key)[: -diff]:
                self._begin_delete(store, ris, inst)
                active.remove(inst)

        # update: replace outdated within budget. paused freezes update
        # progress (scale & specified-delete above still apply); the budget
        # counts AVAILABILITY (ready past min_ready_seconds), so a
        # just-ready instance doesn't license another replacement. When a
        # ready-but-young instance holds the budget, requeue for the moment
        # its maturation window expires — no store event marks that instant.
        ru = ris.spec.rolling_update
        if ru.paused:
            # paused freezes the UPDATE only — drain deadlines still fire
            # (dropping the requeue left drained instances holding slice
            # capacity until the resync backstop).
            return drain_requeue
        now = time.time()
        unavailable = 0
        soonest: Optional[float] = None
        for i in active:
            avail, wait = su.is_available(i, ru.min_ready_seconds, now)
            if not avail:
                unavailable += 1
                if wait > 0 and (soonest is None or wait < soonest):
                    soonest = wait
        from rbg_tpu_torch.api import intstr
        max_unavail = intstr.resolve(ru.max_unavailable, ris.spec.replicas,
                                     round_up=False, name="maxUnavailable")
        if isinstance(ru.max_unavailable, str):
            # Percent forms round DOWN but floor at 1 so the rollout can
            # always progress (sts_reconciler.go percent convention); an
            # explicit int 0 stays a deliberate freeze.
            max_unavail = max(1, max_unavail)
        budget = max(0, max_unavail - unavailable)
        outdated = [i for i in active
                    if i.metadata.labels.get(C.LABEL_REVISION_NAME) != revision]
        for inst in outdated:
            if budget <= 0:
                break
            if self._try_inplace(store, ris, inst, revision):
                budget -= 1
                continue
            self._begin_delete(store, ris, inst)
            budget -= 1
        waits = [w for w in (drain_requeue,) if w is not None]
        if outdated and budget <= 0 and soonest is not None:
            waits.append(max(0.05, soonest))
        return min(waits) if waits else None

    # ---- preparingDelete lifecycle (reference: statelessmode
    # constants.go:75-80 + sync/scale.go specified-delete/lifecycle) ----

    def _begin_delete(self, store, ris, inst):
        """Condemn an instance. With a drain window it enters
        PreparingDelete (kept serving, excluded from replica accounting,
        pods annotated so engines stop accepting new work); without one it
        dies immediately."""
        ns = inst.metadata.namespace
        drain = float(getattr(ris.spec, "drain_seconds", 0.0) or 0.0)
        if drain <= 0:
            store.delete("RoleInstance", ns, inst.metadata.name)
            return
        deadline = time.time() + drain

        def fn(i):
            ann = i.metadata.annotations
            if ann.get(C.ANN_LIFECYCLE_STATE) == C.LIFECYCLE_PREPARING_DELETE:
                return False
            ann[C.ANN_LIFECYCLE_STATE] = C.LIFECYCLE_PREPARING_DELETE
            ann[C.ANN_DRAIN_DEADLINE] = f"{deadline:.3f}"
            # A stale ack from a PREVIOUS drain cycle (agent raced the
            # resurrection) must not void this fresh window.
            ann.pop(C.ANN_DRAIN_COMPLETE, None)
            return True

        from rbg_tpu_torch.runtime.store import NotFound
        try:
            store.mutate("RoleInstance", ns, inst.metadata.name, fn)
        except NotFound:
            return
        # Drain signal to the engines: annotate the live pods (the engine
        # process / drain agent watches this and stops taking new work).
        for pod in store.list("Pod", namespace=ns, owner_uid=inst.metadata.uid):
            def mark(p):
                if p.metadata.annotations.get(C.ANN_LIFECYCLE_STATE) == \
                        C.LIFECYCLE_PREPARING_DELETE:
                    return False
                p.metadata.annotations[C.ANN_LIFECYCLE_STATE] = \
                    C.LIFECYCLE_PREPARING_DELETE
                return True
            try:
                store.mutate("Pod", ns, pod.metadata.name, mark)
            except NotFound:
                pass
        store.record_event(inst, "PreparingDelete",
                           f"draining up to {drain:.0f}s before deletion")

    def _cancel_delete(self, store, inst) -> bool:
        """Resurrect a draining instance (scale-up reclaimed it). Returns
        False when the instance already acked drain-complete — its engine
        stopped taking work; a fresh instance replaces it instead."""
        ns = inst.metadata.namespace
        from rbg_tpu_torch.runtime.store import NotFound

        def fn(i):
            ann = i.metadata.annotations
            if ann.get(C.ANN_DRAIN_COMPLETE) == "true":
                return False
            changed = False
            for k in (C.ANN_LIFECYCLE_STATE, C.ANN_DRAIN_DEADLINE):
                if k in ann:
                    del ann[k]
                    changed = True
            return changed

        try:
            obj = store.mutate("RoleInstance", ns, inst.metadata.name, fn)
        except NotFound:
            return False
        if obj.metadata.annotations.get(C.ANN_DRAIN_COMPLETE) == "true":
            return False
        for pod in store.list("Pod", namespace=ns, owner_uid=inst.metadata.uid):
            def unmark(p):
                if C.ANN_LIFECYCLE_STATE not in p.metadata.annotations:
                    return False
                del p.metadata.annotations[C.ANN_LIFECYCLE_STATE]
                return True
            try:
                store.mutate("Pod", ns, pod.metadata.name, unmark)
            except NotFound:
                pass
        store.record_event(inst, "DeleteCancelled",
                           "scale-up reclaimed draining instance")
        return True

    def _progress_draining(self, store, ris, draining) -> Optional[float]:
        """Delete drained instances (agent ack or deadline); requeue for the
        soonest pending deadline."""
        now = time.time()
        soonest: Optional[float] = None
        for inst in draining:
            ann = inst.metadata.annotations
            try:
                deadline = float(ann.get(C.ANN_DRAIN_DEADLINE) or 0.0)
            except ValueError:
                deadline = 0.0
            if ann.get(C.ANN_DRAIN_COMPLETE) == "true" or now >= deadline:
                store.delete("RoleInstance", inst.metadata.namespace,
                             inst.metadata.name)
            else:
                wait = max(0.05, deadline - now)
                soonest = wait if soonest is None else min(soonest, wait)
        return soonest

    def _try_inplace(self, store, ris, inst, revision) -> bool:
        """Image-only changes update pods in place (no recreation).
        Reference: pkg/inplace (inventory #15). Wired in M6; returns False
        when ineligible so callers fall back to recreate."""
        if not ris.spec.rolling_update.in_place_if_possible:
            return False
        try:
            from rbg_tpu_torch.inplace.update import try_inplace_update
        except ImportError:
            return False
        return try_inplace_update(store, ris, inst, revision)

    # ---- RIS-level revision snapshots ----
    # Partition-pinned ordinals must be (re)created at the CURRENT revision's
    # spec, not the updated one — the reference applies the stored
    # ControllerRevision (``newVersionedInstance``/``ApplyRevision``,
    # stateful_instance_set_control.go:330-432). We keep a snapshot object
    # per live revision, owned by the set, and GC the rest.

    def _rev_name(self, ris, revision: str) -> str:
        return f"{ris.metadata.name}-rev-{revision[:10]}"

    def _ensure_ris_revision(self, store, ris, revision):
        ns = ris.metadata.namespace
        name = self._rev_name(ris, revision)
        if store.get("ControllerRevision", ns, name, copy_=False) is None:
            rev = ControllerRevision()
            rev.metadata.name = name
            rev.metadata.namespace = ns
            rev.metadata.labels = {C.LABEL_REVISION_NAME: revision}
            rev.metadata.owner_references = [owner_ref(ris)]
            rev.data = {
                "instance": serde.to_dict(ris.spec.instance),
                "restart": serde.to_dict(ris.spec.restart_policy),
            }
            try:
                store.create(rev)
            except AlreadyExists:
                pass
        # GC snapshots for revisions that are neither current nor update.
        keep = {revision, ris.status.current_revision}
        for obj in store.list("ControllerRevision", namespace=ns,
                              owner_uid=ris.metadata.uid):
            if obj.metadata.labels.get(C.LABEL_REVISION_NAME) not in keep:
                store.delete("ControllerRevision", ns, obj.metadata.name)

    def _revision_spec(self, store, ris, revision):
        """(InstanceTemplate, RestartPolicyConfig, actual_revision) for
        ``revision`` — from the stored snapshot when it differs from the
        in-spec (update) revision. When no snapshot survives (controller
        upgrade mid-rollout, GC race) we fall back to the update spec and
        report the UPDATE revision so the instance's label matches the spec
        it actually runs — a mislabeled pinned ordinal would never be
        reconciled (ords below partition are not update targets)."""
        import copy

        update_rev = update_revision_of(ris)
        if revision != update_rev:
            snap = store.get("ControllerRevision", ris.metadata.namespace,
                             self._rev_name(ris, revision), copy_=False)
            if snap is not None:
                return (serde.from_dict(InstanceTemplate, snap.data["instance"],
                                         lenient=True),
                        serde.from_dict(RestartPolicyConfig, snap.data["restart"],
                                        lenient=True),
                        revision)
        return (copy.deepcopy(ris.spec.instance),
                copy.deepcopy(ris.spec.restart_policy),
                update_rev)

    def _create_instance(self, store, ris, iname, index, revision):
        template, restart, revision = self._revision_spec(store, ris, revision)
        inst = RoleInstance()
        inst.metadata.name = iname
        inst.metadata.namespace = ris.metadata.namespace
        inst.metadata.labels = dict(ris.metadata.labels)
        inst.metadata.labels[C.LABEL_REVISION_NAME] = revision
        if index >= 0:
            inst.metadata.labels[C.LABEL_INSTANCE_INDEX] = str(index)
        inst.metadata.annotations = dict(ris.metadata.annotations)
        inst.metadata.owner_references = [owner_ref(ris)]
        inst.spec = RoleInstanceSpec(
            instance=template,
            restart_policy=restart,
            index=index,
        )
        try:
            store.create(inst)
        except AlreadyExists:
            pass

    # ---- status rollup (reference: roleinstanceset_types.go:160-206) ----

    def _update_status(self, store, ris, revision):
        ns, name = ris.metadata.namespace, ris.metadata.name
        # Read-only rollup: the indexed no-copy listing (list_for) — the
        # per-reconcile deepcopy of every instance was pure waste here.
        instances = [
            i for i in store.list_for("RoleInstance", ris, copy_=False)
            if i.metadata.deletion_timestamp is None
        ]
        now = time.time()

        # For stateful sets every counter is BASE-scoped (ordinals <
        # spec.replicas): surge instances are transient rollout scaffolding,
        # and every downstream consumer — the group Ready rollup, the
        # coordinated-rollout skew math (updated_ready drives partitions),
        # the scaling progression gate — means "serving base capacity".
        # Counting surge would let a rollout with max_surge report
        # updated_ready > 0 while zero base ordinals run the new revision,
        # opening sibling roles' partitions beyond the skew bound.
        n = ris.spec.replicas
        if ris.spec.stateful:
            by_ord = {}
            for i in instances:
                o = _ordinal(name, i.metadata.name)
                if o >= 0:
                    by_ord[o] = i
            counted = [by_ord[o] for o in range(n) if o in by_ord]
            current_rev = ris.status.current_revision or revision
            topo = su.compute_topology(ris, by_ord, current_rev, revision)
            advance = su.should_advance_current_revision(ris, by_ord, topo, revision)
            # Steady state: every base ordinal present and ready. Mid-rollout
            # the Ready condition is CAPACITY-based — a surge instance holds
            # ordinal 1's capacity while it is replaced, so total ready
            # in-range instances >= replicas keeps the set (and the group
            # rollup above it) Ready through a zero-disruption surge rollout.
            live_ready = sum(
                1 for o in range(topo.end_ordinal)
                if o in by_ord and instance_ready(by_ord[o]))
            is_ready_now = (
                (len(counted) == n and all(instance_ready(i) for i in counted))
                or (topo.in_rollout and live_ready >= n))
        else:
            # Draining (PreparingDelete) instances are excluded: their
            # capacity is already replaced and they vanish on drain ack.
            counted = [i for i in instances
                       if i.metadata.annotations.get(C.ANN_LIFECYCLE_STATE)
                       != C.LIFECYCLE_PREPARING_DELETE]
            is_ready_now = (len(counted) == n
                            and all(instance_ready(i) for i in counted))
        total = len(counted)
        ready = sum(1 for i in counted if instance_ready(i))
        updated = sum(1 for i in counted
                      if i.metadata.labels.get(C.LABEL_REVISION_NAME) == revision)
        updated_ready = sum(
            1 for i in counted
            if i.metadata.labels.get(C.LABEL_REVISION_NAME) == revision and instance_ready(i)
        )
        if not ris.spec.stateful:
            advance = updated == total and total > 0
        count_by_rev = {}
        for i in counted:
            rev = i.metadata.labels.get(C.LABEL_REVISION_NAME, "")
            count_by_rev[rev] = count_by_rev.get(rev, 0) + 1

        def fn(r):
            s = r.status
            want_current = s.current_revision
            if not want_current:
                want_current = revision      # initialize history
            elif advance:
                want_current = revision
            # Count against the revision we are about to persist — counting
            # the pre-advance revision would record current_replicas=0 on
            # the very pass that advances, with no event to correct it.
            current_count = count_by_rev.get(want_current, 0)
            new = (total, ready, updated, updated_ready, current_count,
                   revision, r.metadata.generation)
            cur = (s.replicas, s.ready_replicas, s.updated_replicas,
                   s.updated_ready_replicas, s.current_replicas,
                   s.update_revision, s.observed_generation)
            cond_changed = set_condition(
                s.conditions,
                Condition(type=C.COND_READY,
                          status="True" if is_ready_now else "False",
                          reason="AllInstancesReady" if is_ready_now else "Progressing"),
                now,
            )
            if new == cur and not cond_changed and want_current == s.current_revision:
                return False
            (s.replicas, s.ready_replicas, s.updated_replicas,
             s.updated_ready_replicas, s.current_replicas,
             s.update_revision, s.observed_generation) = new
            s.current_revision = want_current
            return True

        store.mutate("RoleInstanceSet", ns, name, fn, status=True)
