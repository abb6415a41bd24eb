"""RoleInstance controller — the pod-gang engine.

Reference analog: inventory #13 (``pkg/reconciler/roleinstance``, 3.5k LoC):
one RoleInstance = a gang of pods; creates/deletes pods, runs the restart
policy with exponential backoff, aggregates readiness, injects identity.

TPU specifics: a leader-worker instance is one JAX program across the hosts of
one slice — pods carry slice scheduler hints, JAX coordinator env
(process_id == component index == slice worker_index), and warm-node affinity
from the NodeBindingStore. Atomic slice recovery (SURVEY.md §7 hard parts): a
failed host recreates the WHOLE instance, and the slice-binding annotation
steers it back onto the same ICI domain.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.group import PatternType, RestartPolicy
from rbg_tpu_torch.api.instance import ComponentStatus, ReadyPolicy, RoleInstance
from rbg_tpu_torch.api.meta import Condition, owner_ref, set_condition
from rbg_tpu_torch.api.pod import Pod
from rbg_tpu_torch.api.policy import PodGroup, PodGroupSpec
from rbg_tpu_torch.runtime.controller import (
    Controller, Result, Watch, own_keys, owner_keys,
)
from rbg_tpu_torch.runtime.store import EVENT_WARNING, AlreadyExists, Store


def desired_pods(inst: RoleInstance) -> List[Tuple[str, str, int, int, object]]:
    """[(pod_name, component, component_id, component_index, template)].
    Naming per reference Appendix B (``instance_utils.go:76-89``):
    standalone → ``{instance}``; leaderWorker → ``{instance}-{i}`` (leader 0);
    components → ``{instance}-{component}-{i}``."""
    name = inst.metadata.name
    it = inst.spec.instance
    if it.pattern == PatternType.STANDALONE:
        return [(name, "", 0, 0, it.template)]
    if it.pattern == PatternType.LEADER_WORKER:
        from rbg_tpu_torch.api.group import per_slice_size
        lw = it.leader_worker
        n_slices = max(1, it.tpu.num_slices) if it.tpu else 1
        size = per_slice_size(lw, it.tpu) * n_slices
        out = []
        for i in range(size):
            tmpl = it.template
            if lw is not None:
                if i == 0 and lw.leader_template is not None:
                    tmpl = lw.leader_template
                elif i > 0 and lw.worker_template is not None:
                    tmpl = lw.worker_template
            out.append((f"{name}-{i}", "leader" if i == 0 else "worker", i, i, tmpl))
        return out
    out = []
    idx = 0
    for comp in it.components:
        for i in range(comp.size):
            out.append((f"{name}-{comp.name}-{i}", comp.name, i, idx,
                        comp.template or it.template))
            idx += 1
    return out


class RoleInstanceController(Controller):
    name = "roleinstance"

    def __init__(self, store: Store, node_binding=None, ports=None):
        super().__init__(store)
        self.node_binding = node_binding
        self.ports = ports

    def watches(self) -> List[Watch]:
        from rbg_tpu_torch.runtime.controller import spec_change
        return [
            Watch("RoleInstance", own_keys, predicate=spec_change),
            # 10ms coalescing window: a multi-host gang's pods flip ready
            # within ms of each other — fold them into one reconcile.
            Watch("Pod", owner_keys("RoleInstance"), delay=0.01),
        ]

    # Cap for resumed crash-loop damping: 8 charges of the jittered
    # exponential already sit at the delay ceiling; seeding higher only
    # delays legitimate recovery.
    SEED_BACKOFF_CAP = 8

    def seed_backoff(self, store: Store) -> None:
        """Pre-charge per-key ERROR-retry damping from observed pod
        restart counts (minus the restarts an in-place update
        legitimately caused) when resuming over an existing store. Scope:
        this damps the workqueue's error-retry schedule for keys that
        FAIL to reconcile during the resume window (conflict storms,
        transient store errors around a crash-looping gang); it is
        cleared by the first clean reconcile, as any error backoff is.
        The restart-cycle pacing itself (delay between gang recreations)
        lives in inst.status.restart_count/last_restart_time and already
        survives restarts on its own."""
        from rbg_tpu_torch.inplace.update import expected_restarts
        worst: dict = {}
        for p in store.list("Pod", copy_=False):
            ref = p.metadata.controller_owner()
            if ref is None or ref.kind != "RoleInstance":
                continue
            allowed = expected_restarts(p) or {}
            if p.status.container_restarts:
                n = sum(max(0, c - allowed.get(name, 0))
                        for name, c in p.status.container_restarts.items())
            else:
                n = max(0, p.status.restart_count - sum(allowed.values()))
            if n > 0:
                key = (p.metadata.namespace, ref.name)
                worst[key] = max(worst.get(key, 0), n)
        for inst in store.list("RoleInstance", copy_=False):
            key = (inst.metadata.namespace, inst.metadata.name)
            n = max(worst.get(key, 0), inst.status.restart_count)
            if n > 0:
                self.backoff.seed(key, min(n, self.SEED_BACKOFF_CAP))

    def reconcile(self, store: Store, key) -> Optional[Result]:
        ns, name = key
        inst = store.get("RoleInstance", ns, name, copy_=False)
        if inst is None or inst.metadata.deletion_timestamp is not None:
            return None

        pods = store.list("Pod", namespace=ns, owner_uid=inst.metadata.uid,
                          copy_=False)
        active = [p for p in pods if p.active]
        desired = desired_pods(inst)

        # Record warm bindings for running pods.
        if self.node_binding is not None:
            for p in active:
                if p.running_ready and p.node_name:
                    node = store.get("Node", "default", p.node_name, copy_=False)
                    if node is not None:
                        self.node_binding.record(
                            p, node, annotations=inst.metadata.annotations)
                        if node.tpu.slice_id and inst.status.slice_id != node.tpu.slice_id:
                            # Continue the reconcile with the fresh stored
                            # snapshot — `inst` was fetched copy_=False and
                            # stored snapshots are never mutated in place.
                            inst = store.mutate(
                                "RoleInstance", ns, name,
                                lambda i, s=node.tpu.slice_id: setattr(i.status, "slice_id", s) or True,
                                status=True,
                            )

        # ---- restart policy state machine (reference: §3.5) ----
        res = self._handle_restarts(store, inst, pods, desired)
        if res is not None:
            return res

        # ---- in-place update progression: deferred image patches after the
        # grace/drain window, InPlaceUpdateReady completion on backend ack
        # (reference: pkg/inplace readiness machinery) ----
        from rbg_tpu_torch.inplace.update import progress_inplace_updates
        inplace_delay = progress_inplace_updates(store, inst, pods, desired)

        # ---- scale/create: converge pod set ----
        self._ensure_pod_group(store, inst, desired)
        pg_name = self._pod_group_name(inst, desired)
        self._adopt_orphans(store, inst, desired)
        # Re-list: adoption may have just brought pods under our owner uid.
        pods = store.list("Pod", namespace=ns, owner_uid=inst.metadata.uid,
                          copy_=False)
        active = [p for p in pods if p.active]
        existing = {p.metadata.name for p in active}
        wanted = {n for (n, *_rest) in desired}
        startable = self._startable(inst, active)
        created_all = True
        for pod_name, comp, cid, cidx, tmpl in desired:
            if pod_name not in existing:
                if startable is not None and (comp or "main") not in startable:
                    created_all = False  # gated by component startAfter ordering
                    continue
                self._create_pod(store, inst, pod_name, comp, cid, cidx, tmpl,
                                 len(desired), pg_name)
        gated_deletion = self._delete_surplus(store, inst, active, wanted)
        # Level-1 inactive-pod handling (keps/inactive-pod-handling): a
        # Failed pod (Evicted, UnexpectedAdmissionError, ...) squats its
        # fixed name and blocks the replacement — delete it so the next
        # reconcile recreates it. Applies under EVERY restart policy: with
        # RecreateInstance, reaching this point means the failure was
        # excluded from the gang-restart trigger (Ignore annotation) or the
        # cycle already ran — pod-level replacement is the remaining fix.
        # Succeeded (normal completion) pods are left alone.
        for p in pods:
            if p.status.phase == "Failed" and p.metadata.deletion_timestamp is None:
                store.record_event(
                    inst, "ReplacingFailedPod",
                    f"pod {p.metadata.name} inactive "
                    f"({p.inactive_reason or 'Failed'}); deleting so the "
                    f"fixed-name replacement can be created",
                    type_=EVENT_WARNING)
                store.delete("Pod", ns, p.metadata.name)
        # Replace Succeeded pods only under policy None (legacy behavior for
        # run-to-completion mains that should restart).
        if inst.spec.restart_policy.policy == RestartPolicy.NONE:
            for p in pods:
                if (p.status.phase == "Succeeded"
                        and p.metadata.deletion_timestamp is None):
                    store.delete("Pod", ns, p.metadata.name)

        status_res = self._update_status(store, inst, desired)
        if not created_all or gated_deletion:
            return Result(requeue_after=0.1)  # revisit once ordering gates open
        # Combine requeue sources: the soonest deadline wins (a status-side
        # requeue must not mask a pending grace-window patch, or vice versa).
        delays = [r.requeue_after for r in (status_res,) if r is not None
                  and r.requeue_after is not None]
        if inplace_delay is not None:
            delays.append(inplace_delay)
        if delays:
            return Result(requeue_after=min(delays))
        return status_res

    def _delete_surplus(self, store, inst, active, wanted) -> bool:
        """Delete pods not in the desired set. CustomComponents roles tear
        down in deletion order (KEP-173: reverse start order unless
        deleteAfter overrides), one component stage at a time. Returns True
        while later stages are still gated."""
        ns = inst.metadata.namespace
        surplus = [p for p in active if p.metadata.name not in wanted]
        if not surplus:
            return False
        it = inst.spec.instance
        if it.pattern == PatternType.CUSTOM_COMPONENTS and len(it.components) > 1:
            from rbg_tpu_torch.discovery.component_discovery import deletion_order
            order = deletion_order(it.components)
            pos = {n: i for i, n in enumerate(order)}
            key = lambda p: pos.get(
                p.metadata.labels.get(C.LABEL_COMPONENT_NAME, ""), len(order))
            stage = min(key(p) for p in surplus)
            for p in surplus:
                if key(p) == stage:
                    store.delete("Pod", ns, p.metadata.name, grace=True)
            return any(key(p) != stage for p in surplus)
        for p in surplus:
            store.delete("Pod", ns, p.metadata.name, grace=True)
        return False

    def _startable(self, inst, active):
        """Component startup gating (KEP-173). None = no gating (not a
        customComponents instance)."""
        from rbg_tpu_torch.api.group import PatternType as PT
        if inst.spec.instance.pattern != PT.CUSTOM_COMPONENTS:
            return None
        from rbg_tpu_torch.discovery.component_discovery import startable_components
        ready_by_comp = {}
        for comp in inst.spec.instance.components:
            ready = sum(
                1 for p in active
                if p.metadata.labels.get(C.LABEL_COMPONENT_NAME) == comp.name
                and p.running_ready
            )
            ready_by_comp[comp.name] = (ready, comp.size)
        return startable_components(inst, ready_by_comp)

    # ---- restart machinery ----

    def _restart_triggered(self, inst, pods, desired) -> bool:
        """Trigger on terminal (Failed) pods or in-pod container restarts —
        terminal pods are no longer 'active', so scan ALL owned pods.

        Restart counts are compared against the per-container baselines the
        in-place updater records (reference: container-restart baselines,
        ``sync/instance_scale.go:542-607``): a container the update swapped
        is allowed exactly one expected restart; anything beyond — or any
        restart of an untouched container — is a real failure."""
        if inst.spec.restart_policy.policy == RestartPolicy.NONE:
            return False
        from rbg_tpu_torch.inplace.update import expected_restarts
        ignored = set()
        for (pn, comp, _cid, _cidx, tmpl) in desired:
            if tmpl and tmpl.annotations.get(C.ANN_RESTART_TRIGGER_POLICY) == "Ignore":
                ignored.add(pn)
        for p in pods:
            if p.metadata.name in ignored or p.metadata.deletion_timestamp is not None:
                continue
            if p.status.phase == "Failed":
                return True
            allowed = expected_restarts(p) or {}
            if p.status.container_restarts:
                if any(n > allowed.get(c, 0)
                       for c, n in p.status.container_restarts.items()):
                    return True
            elif p.status.restart_count > sum(allowed.values()):
                return True
        return False

    def _handle_restarts(self, store, inst, pods, desired) -> Optional[Result]:
        ns, name = inst.metadata.namespace, inst.metadata.name
        rp = inst.spec.restart_policy
        restarting = inst.status.phase == "Restarting"

        if restarting:
            if pods:
                # still tearing down (terminating pods included)
                for p in pods:
                    if p.metadata.deletion_timestamp is None:
                        store.delete("Pod", ns, p.metadata.name, grace=True)
                return Result(requeue_after=0.05)
            # teardown complete → leave Restarting; normal path recreates pods
            store.mutate("RoleInstance", ns, name,
                         lambda i: setattr(i.status, "phase", "Pending") or True,
                         status=True)
            return Result(requeue_after=0)

        if not self._restart_triggered(inst, pods, desired):
            return None

        now = time.time()
        n = inst.status.restart_count
        last = inst.status.last_restart_time
        if last and (now - last) > rp.window_seconds:
            n = 0  # decay: stable for a full window resets the backoff
        delay = min(rp.base_delay_seconds * (2 ** max(0, n - 1)), rp.max_delay_seconds) if n > 0 else 0.0
        if last and now < last + delay:
            return Result(requeue_after=(last + delay) - now)

        def fn(i):
            if i.status.phase == "Restarting":
                return False  # concurrent worker already started the cycle
            i.status.phase = "Restarting"
            i.status.restart_count = n + 1
            i.status.last_restart_time = now
            set_condition(i.status.conditions,
                          Condition(type=C.COND_RESTART_IN_PROGRESS, status="True",
                                    reason="PodFailure"), now)
            return True

        store.mutate("RoleInstance", ns, name, fn, status=True)
        store.record_event(inst, "Restarting",
                           f"recreating pod gang (restart #{n + 1})",
                           type_=EVENT_WARNING)
        for p in pods:
            if p.metadata.deletion_timestamp is None:
                store.delete("Pod", ns, p.metadata.name, grace=True)
        return Result(requeue_after=0.05)

    # ---- pod construction ----

    def _adopt_orphans(self, store, inst, desired):
        """Ref-manager adoption (reference: statelessmode/utils/ref_manager.go
        + statefulmode/instance_ref_manager.go): a pod bearing one of OUR
        desired names whose controller owner no longer exists is adopted —
        it keeps running (warm slice) and its owner ref moves to us. Without
        this, such an orphan squats the name forever (we can neither create
        nor count it)."""
        ns = inst.metadata.namespace
        from rbg_tpu_torch.runtime.store import NotFound
        for (pod_name, *_rest) in desired:
            pod = store.get("Pod", ns, pod_name, copy_=False)
            if pod is None:
                continue
            ref = pod.metadata.controller_owner()
            if ref is not None and ref.uid == inst.metadata.uid:
                continue  # already ours
            if ref is not None:
                # Liveness check for ANY controller kind — a pod owned by a
                # live Warmup (or anything else) is never ours to hijack.
                owner = store.get(ref.kind, ns, ref.name, copy_=False)
                if owner is not None and owner.metadata.uid == ref.uid:
                    continue

            def fn(p):
                p.metadata.owner_references = [owner_ref(inst)]
                p.metadata.labels[C.LABEL_INSTANCE_NAME] = inst.metadata.name
                return True

            try:
                store.mutate("Pod", ns, pod_name, fn)
                store.record_event(inst, "AdoptedPod",
                                   f"adopted orphaned pod {pod_name}")
            except NotFound:
                pass  # deleted concurrently — nothing to adopt
            # Conflict propagates: the worker's backoff retries visibly.

    def _staged_start(self, inst) -> bool:
        """Component startAfter ordering implies staged start — incompatible
        with an all-pods gang (the gang would wait for gated pods forever)."""
        if inst.spec.instance.pattern != PatternType.CUSTOM_COMPONENTS:
            return False
        from rbg_tpu_torch.discovery.component_discovery import staged_start
        return staged_start(inst.spec.instance.components)

    def _ensure_pod_group(self, store, inst, desired):
        """Per-instance gang (slice atomicity) unless a group-level pod-group
        is designated via annotation."""
        if inst.metadata.annotations.get(C.ANN_GANG_SCHEDULING):
            return  # group-level PodGroup managed by the group controller
        if len(desired) <= 1 or self._staged_start(inst):
            return
        ns, name = inst.metadata.namespace, inst.metadata.name
        if store.get("PodGroup", ns, name) is None:
            pg = PodGroup()
            pg.metadata.name = name
            pg.metadata.namespace = ns
            pg.metadata.owner_references = [owner_ref(inst)]
            pg.spec = PodGroupSpec(
                min_member=len(desired),
                group_name=inst.metadata.labels.get(C.LABEL_GROUP_NAME, ""),
            )
            try:
                store.create(pg)
            except AlreadyExists:
                pass

    def _pod_group_name(self, inst, desired) -> str:
        # Staged start always opts out of gangs — even an explicit group-level
        # gang would deadlock on pods the ordering engine withholds.
        if self._staged_start(inst):
            return ""
        explicit = inst.metadata.annotations.get(C.ANN_GANG_SCHEDULING, "")
        if explicit:
            return explicit
        return inst.metadata.name if len(desired) > 1 else ""

    def _create_pod(self, store, inst, pod_name, comp, cid, cidx, tmpl,
                    gang_size, pg_name=""):
        import copy

        ns = inst.metadata.namespace
        labels = dict(inst.metadata.labels)
        labels.update({
            C.LABEL_INSTANCE_NAME: inst.metadata.name,
            C.LABEL_COMPONENT_NAME: comp or "main",
            C.LABEL_COMPONENT_ID: str(cid),
            C.LABEL_COMPONENT_INDEX: str(cidx),
        })
        if inst.spec.index >= 0:
            labels[C.LABEL_INSTANCE_INDEX] = str(inst.spec.index)
        it_spec = inst.spec.instance
        if it_spec.tpu is not None and it_spec.tpu.num_slices > 1:
            from rbg_tpu_torch.api.group import per_slice_size
            per = per_slice_size(it_spec.leader_worker, it_spec.tpu)
            labels[C.LABEL_SLICE_ORDINAL] = str(cidx // per)
        if pg_name:
            labels[C.LABEL_POD_GROUP] = pg_name

        pod = Pod()
        pod.metadata.name = pod_name
        pod.metadata.namespace = ns
        pod.metadata.labels = labels
        pod.metadata.annotations = dict(inst.metadata.annotations)
        pod.metadata.annotations.update(tmpl.annotations if tmpl else {})
        pod.metadata.owner_references = [owner_ref(inst)]
        pod.template = copy.deepcopy(tmpl) if tmpl else None
        if pod.template is None:
            from rbg_tpu_torch.api.pod import PodTemplate
            pod.template = PodTemplate()
        # COPY, not alias: deepcopy preserves intra-object aliasing, so a
        # shared dict would make every metadata-label stamp (e.g. the
        # in-place revision label) also a template change — a spurious
        # generation bump that relaunches the process for a label edit.
        pod.template.labels = dict(labels)

        it = inst.spec.instance
        if it.pattern == PatternType.LEADER_WORKER and (it.tpu is not None):
            pod.template.scheduler_hints["tpu-slice"] = "true"

        # identity + JAX rendezvous envs (discovery plane adds topology config)
        from rbg_tpu_torch.discovery.env_builder import build_env
        env = build_env(inst, pod_name, comp or "main", cidx, gang_size)
        if it.pattern == PatternType.CUSTOM_COMPONENTS:
            from rbg_tpu_torch.discovery.component_discovery import component_discovery_env
            env.extend(component_discovery_env(store, inst, comp or "main"))
        for c in pod.template.containers:
            have = {e.name for e in c.env}
            c.env.extend(e for e in env if e.name not in have)

        # engine-runtime profile sidecars + overrides (inventory #19)
        from rbg_tpu_torch.discovery.sidecar_builder import apply_engine_runtime
        apply_engine_runtime(store, it.engine_runtime, pod, ns)

        if self.ports is not None:
            self.ports.inject_pod_ports(inst, pod)

        if self.node_binding is not None:
            ann = inst.metadata.annotations
            pod.affinity.extend(self.node_binding.affinity_terms(
                pod, annotations=ann))
            slice_id = (self.node_binding.preferred_slice(pod, annotations=ann)
                        or inst.status.slice_id)
            if slice_id:
                pod.metadata.annotations[C.ANN_SLICE_BINDING] = slice_id

        try:
            store.create(pod)
        except AlreadyExists:
            pass

    # ---- status ----

    def _update_status(self, store, inst, desired) -> Optional[Result]:
        ns, name = inst.metadata.namespace, inst.metadata.name
        pods = {p.metadata.name: p for p in store.list("Pod", namespace=ns,
                                                       owner_uid=inst.metadata.uid)}
        comps = {}
        for pod_name, comp, _cid, _cidx, _tmpl in desired:
            comp = comp or "main"
            st = comps.setdefault(comp, ComponentStatus(name=comp))
            st.size += 1
            p = pods.get(pod_name)
            if p is not None and p.active:
                if p.node_name:
                    st.scheduled += 1
                if p.running_ready:
                    st.ready += 1

        all_ready = all(c.ready == c.size for c in comps.values()) and bool(comps)
        ready = all_ready or inst.spec.instance.ready_policy == ReadyPolicy.NONE
        now = time.time()

        def fn(i):
            changed = False
            new_comps = sorted(comps.values(), key=lambda c: c.name)
            from rbg_tpu_torch.api import serde
            if serde.to_dict(i.status.components) != serde.to_dict(new_comps):
                i.status.components = new_comps
                changed = True
            phase = "Running" if ready else ("Pending" if i.status.phase != "Restarting" else i.status.phase)
            if i.status.phase != phase:
                i.status.phase = phase
                changed = True
            if set_condition(i.status.conditions,
                             Condition(type=C.COND_ALL_PODS_READY,
                                       status="True" if all_ready else "False",
                                       reason="PodsReady" if all_ready else "WaitingForPods"),
                             now):
                changed = True
            if set_condition(i.status.conditions,
                             Condition(type=C.COND_READY,
                                       status="True" if ready else "False",
                                       reason="Ready" if ready else "NotReady"),
                             now):
                changed = True
            if i.status.observed_revision != i.metadata.labels.get(C.LABEL_REVISION_NAME, ""):
                i.status.observed_revision = i.metadata.labels.get(C.LABEL_REVISION_NAME, "")
                changed = True
            return changed

        store.mutate("RoleInstance", ns, name, fn, status=True)
        return None
