"""RoleBasedGroup controller — the root orchestrator.

Reference analog: inventory #6 (``rolebasedgroup_controller.go``, the 9-step
reconcile of SURVEY.md §3.2): precheck → revisions → discovery config →
role statuses → coordination → gang PodGroup → roles in dependency order →
orphan cleanup. Anti-flicker status propagation per Appendix C.
"""

from __future__ import annotations

import time
from typing import List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api import serde
from rbg_tpu_torch.api.group import RoleBasedGroup, RoleSpec, RoleStatus
from rbg_tpu_torch.api.instance import ControllerRevision
from rbg_tpu_torch.api.meta import Condition, owner_ref, set_condition
from rbg_tpu_torch.api.pod import Service
from rbg_tpu_torch.api.policy import PodGroup, PodGroupSpec
from rbg_tpu_torch.api.validation import ValidationError, validate_group
from rbg_tpu_torch.coordination.dependency import dependencies_ready, sort_roles
from rbg_tpu_torch.runtime.controller import (
    Controller, Result, Watch, own_keys, owner_keys,
)
from rbg_tpu_torch.runtime.store import EVENT_WARNING, AlreadyExists, Conflict, NotFound, Store
from rbg_tpu_torch.utils import spec_hash

REVISION_HISTORY_LIMIT = 10


class RoleBasedGroupController(Controller):
    name = "rolebasedgroup"

    def __init__(self, store: Store, node_binding=None):
        super().__init__(store)
        self.node_binding = node_binding

    def watches(self) -> List[Watch]:
        def adapter_keys(obj):
            if obj.kind == "ScalingAdapter" and obj.spec.group_name:
                return [(obj.metadata.namespace, obj.spec.group_name)]
            return []

        def policy_keys(obj):
            if obj.kind == "CoordinatedPolicy" and obj.spec.group_name:
                return [(obj.metadata.namespace, obj.spec.group_name)]
            return []

        from rbg_tpu_torch.runtime import workload as workload_registry
        from rbg_tpu_torch.runtime.controller import spec_change
        out = [
            Watch("RoleBasedGroup", own_keys, predicate=spec_change),
            Watch("ScalingAdapter", adapter_keys),
            Watch("CoordinatedPolicy", policy_keys),
        ]
        # Child-workload watches come from the backend registry (reference:
        # dynamic CRD watch :1598-1621) — the native RIS watch included.
        seen = {w.kind for w in out}
        for backend in workload_registry.backends():
            for w in backend.watches():
                if w.kind not in seen:
                    seen.add(w.kind)
                    out.append(w)
        return out

    def reconcile(self, store: Store, key) -> Optional[Result]:
        ns, name = key
        rbg = store.get("RoleBasedGroup", ns, name)
        if rbg is None:
            # Hard delete: the DELETED event lands here with the object gone
            # — warm bindings must still be evicted (keyed by group name;
            # a no-op for groups that never had any).
            if self.node_binding is not None:
                self.node_binding.evict_group(name, namespace=ns)
            return None
        if rbg.metadata.deletion_timestamp is not None:
            if self.node_binding is not None:
                self.node_binding.evict_group(rbg.metadata.name, namespace=ns)
            return None

        # 1. precheck / admission (incl. per-kind backend validation —
        #    reference: per-workload Validate in preCheck :277)
        from rbg_tpu_torch.runtime import workload as workload_registry
        try:
            validate_group(rbg)
            for role in rbg.spec.roles:
                try:
                    backend = workload_registry.resolve(role.workload)
                except KeyError as e:
                    raise ValidationError(e.args[0])
                backend.validate(store, rbg, role)
        except ValidationError as e:
            store.record_event(rbg, "ValidationFailed", str(e),
                               type_=EVENT_WARNING)
            self._set_group_condition(store, rbg, False, "ValidationFailed", str(e))
            return None

        # 2. scaling-adapter replica overrides (autoscaler wins over spec drift;
        #    reference: applyRBGSAReplicasOverride :846) + KEP-29 auto-create
        from rbg_tpu_torch.runtime.controllers.scalingadapter import ensure_auto_adapters
        ensure_auto_adapters(store, rbg)
        rbg = self._apply_scaling_overrides(store, rbg)
        if rbg is None:
            return None  # deleted while applying overrides

        # 3. revisions
        revision_name, role_hashes = self._ensure_revision(store, rbg)

        # 4. role statuses FIRST (fresh readiness gates both the dependency
        #    walk and the coordination clamp)
        rbg = self._update_role_statuses(store, rbg, role_hashes)

        # 5. coordination policy: maxSkew-clamped scaling targets + rolling
        #    update partitions, computed from the status refreshed above
        # Indexed child listing (list_for): the old full-kind scan + group
        # filter was the reconcile-latency tail at 5k-node fleets.
        policies = store.list_for("CoordinatedPolicy", rbg)
        role_targets = self._coordination_targets(rbg, policies)
        role_partitions = self._coordination_partitions(store, rbg, policies,
                                                        role_hashes)
        clamped = any(
            role_targets.get(r.name, r.replicas) < r.replicas
            for r in rbg.spec.roles
        ) or any(p > 0 for p in role_partitions.values())

        # 6. group-level gang PodGroup
        gang = rbg.metadata.annotations.get(C.ANN_GANG_SCHEDULING) == "true"
        if gang:
            self._ensure_pod_group(store, rbg, role_targets)

        # 6b. topology discovery ConfigMap (reference step 5, :397)
        try:
            from rbg_tpu_torch.discovery.config_builder import reconcile_topology_configmap
            reconcile_topology_configmap(store, rbg)
        except Exception as e:  # best-effort, but never silently
            import logging
            logging.getLogger("rbg_tpu_torch.runtime").warning(
                "topology configmap for %s/%s failed: %s",
                ns, name, e, exc_info=True)
            store.record_event(rbg, "DiscoveryConfigFailed", str(e),
                               type_=EVENT_WARNING)

        # 7. roles in dependency order
        levels = sort_roles(rbg.spec.roles)
        blocked = []
        for level in levels:
            for role in level:
                if dependencies_ready(rbg, role):
                    self._reconcile_role(
                        store, rbg, role, role_hashes[role.name],
                        role_targets.get(role.name, role.replicas), gang,
                        partition=role_partitions.get(role.name),
                    )
                else:
                    blocked.append(role.name)

        # 8. orphan cleanup
        self._cleanup_orphans(store, rbg)

        if blocked or clamped:
            # Dependencies or coordination gates still closing. The RIS
            # status watch drives the real progression; this requeue is a
            # lost-event backstop only, so keep it coarse — at 0.2s a
            # 100-group burst spent a third of its reconciles polling here.
            return Result(requeue_after=0.5)
        return None

    # ---- revisions (reference: utils/revision_utils.go + KEP-31) ----

    def _ensure_revision(self, store, rbg):
        role_hashes = {r.name: spec_hash(r) for r in rbg.spec.roles}
        rev_hash = spec_hash({"roles": sorted(role_hashes.items())})
        rev_name = f"{rbg.metadata.name}-{rev_hash}"
        ns = rbg.metadata.namespace
        if store.get("ControllerRevision", ns, rev_name, copy_=False) is None:
            revs = store.list("ControllerRevision", namespace=ns,
                              owner_uid=rbg.metadata.uid)
            rev = ControllerRevision()
            rev.metadata.name = rev_name
            rev.metadata.namespace = ns
            rev.metadata.labels = {C.LABEL_GROUP_NAME: rbg.metadata.name}
            rev.metadata.owner_references = [owner_ref(rbg)]
            rev.revision = max((r.revision for r in revs), default=0) + 1
            rev.data = serde.to_dict(rbg.spec)
            rev.role_hashes = role_hashes
            try:
                store.create(rev)
            except AlreadyExists:
                pass
            # prune history beyond limit (oldest first)
            revs = sorted(
                store.list("ControllerRevision", namespace=ns, owner_uid=rbg.metadata.uid),
                key=lambda r: r.revision,
            )
            for old in revs[:-REVISION_HISTORY_LIMIT]:
                store.delete("ControllerRevision", ns, old.metadata.name)
        if rbg.status.current_revision != rev_name:
            store.mutate(
                "RoleBasedGroup", ns, rbg.metadata.name,
                lambda g: setattr(g.status, "current_revision", rev_name) or True,
                status=True,
            )
            rbg.status.current_revision = rev_name
        return rev_name, role_hashes

    # ---- scaling adapter overrides ----

    def _apply_scaling_overrides(self, store, rbg):
        adapters = [
            a for a in store.list_for("ScalingAdapter", rbg, copy_=False)
            if a.spec.replicas is not None and a.status.phase == "Bound"
        ]
        if not adapters:
            return rbg
        changed = False
        for a in adapters:
            role = rbg.spec.role(a.spec.role_name)
            if role is not None and role.replicas != a.spec.replicas:
                role.replicas = a.spec.replicas
                changed = True
        if changed:
            try:
                rbg = store.update(rbg)
            except Conflict:
                # Someone else moved the spec — re-read; the next pass
                # re-applies the adapter override over the fresh object.
                rbg = store.get("RoleBasedGroup", rbg.metadata.namespace,
                                rbg.metadata.name)
            except NotFound:
                return None  # group deleted concurrently — caller bails
        return rbg

    # ---- coordination (maxSkew clamp; full engine in coordination/scaling) ----

    def _coordination_partitions(self, store, rbg, policies, role_hashes):
        """Per-role rolling-update partition overrides from
        CoordinatedRollingUpdate policies (maxSkew-bounded rollout)."""
        ru_policies = [p for p in policies if p.spec.rolling_update is not None]
        if not ru_policies:
            return {}
        from rbg_tpu_torch.coordination.rollout import rollout_partitions
        from rbg_tpu_torch.runtime import workload as workload_registry
        policy_roles = set()
        for p in ru_policies:
            policy_roles.update(p.spec.rolling_update.roles)
        updated = {}
        for role in rbg.spec.roles:
            if role.name not in policy_roles:
                continue
            try:
                backend = workload_registry.resolve(role.workload)
            except KeyError:
                updated[role.name] = 0
                continue
            updated[role.name] = backend.rollout_progress(
                store, rbg, role, role_hashes.get(role.name, ""))
        out = {}
        for p in ru_policies:
            out.update(rollout_partitions(rbg, p.spec.rolling_update, updated))
        return out

    def _coordination_targets(self, rbg, policies):
        targets = {r.name: r.replicas for r in rbg.spec.roles}
        scaling = [p for p in policies if p.spec.scaling is not None]
        if not scaling:
            return targets
        from rbg_tpu_torch.coordination.scaling import clamp_targets
        for p in scaling:
            targets = clamp_targets(rbg, p.spec.scaling, targets)
        return targets

    # ---- gang ----

    def _ensure_pod_group(self, store, rbg, role_targets):
        # Count only roles whose dependencies are satisfied AND that are not
        # internally staged (component startAfter): withheld pods would
        # deadlock the gang (scheduler waits for min_member pods that are
        # never created). Gang semantics apply per dependency level.
        from rbg_tpu_torch.discovery.component_discovery import staged_start
        total = sum(
            role_targets.get(r.name, r.replicas) * r.gang_size()
            for r in rbg.spec.roles
            if dependencies_ready(rbg, r) and not staged_start(r.components)
        )
        ns, name = rbg.metadata.namespace, rbg.metadata.name
        pg = store.get("PodGroup", ns, name, copy_=False)
        if pg is None:
            pg = PodGroup()
            pg.metadata.name = name
            pg.metadata.namespace = ns
            pg.metadata.owner_references = [owner_ref(rbg)]
            pg.spec = PodGroupSpec(min_member=total, group_name=name)
            try:
                store.create(pg)
            except AlreadyExists:
                pass
        elif pg.spec.min_member != total:
            def fn(g):
                g.spec.min_member = total
                return True
            store.mutate("PodGroup", ns, name, fn)

    # ---- per-role workload reconcile (strategy seam: inventory #23) ----

    def _reconcile_role(self, store, rbg, role: RoleSpec, role_hash: str,
                        replicas: int, gang: bool, partition=None):
        from rbg_tpu_torch.runtime import workload as workload_registry
        self._ensure_service(store, rbg, role)
        role = self._resolve_template(store, rbg, role)
        workload_registry.resolve(role.workload).reconcile_role(
            store, rbg, role, role_hash, replicas, gang, partition=partition)

    def _resolve_template(self, store, rbg, role: RoleSpec) -> RoleSpec:
        """KEP-8: roles may reference a shared RoleTemplate."""
        if not role.template_ref:
            return role
        import copy
        tmpl = store.get("RoleTemplate", rbg.metadata.namespace, role.template_ref)
        if tmpl is None:
            store.record_event(rbg, "MissingRoleTemplate",
                               f"role {role.name}: RoleTemplate {role.template_ref} not found",
                               type_=EVENT_WARNING)
            return role
        role = copy.deepcopy(role)
        if not role.template.containers:
            role.template = copy.deepcopy(tmpl.template)
        return role

    def _ensure_service(self, store, rbg, role: RoleSpec):
        from rbg_tpu_torch.api.group import SUBDOMAIN_UNIQUE_PER_REPLICA
        ns = rbg.metadata.namespace
        leader_only = role.service_selection == "LeaderOnly"
        if (role.network is not None and role.network.subdomain_policy
                == SUBDOMAIN_UNIQUE_PER_REPLICA):
            # KEP-275 UniquePerReplica: one headless service PER
            # RoleInstance, named after the instance; the shared role
            # service is removed in steady state (orphan cleanup drops it
            # since it's no longer in the valid set).
            for inst in store.list(
                    "RoleInstance", namespace=ns,
                    selector={C.LABEL_GROUP_NAME: rbg.metadata.name,
                              C.LABEL_ROLE_NAME: role.name},
                    copy_=False):
                self._ensure_one_service(
                    store, rbg, role, inst.metadata.name,
                    selector={C.LABEL_INSTANCE_NAME: inst.metadata.name},
                    leader_only=leader_only)
            return
        self._ensure_one_service(
            store, rbg, role, C.service_name(rbg.metadata.name, role.name),
            selector={C.LABEL_GROUP_NAME: rbg.metadata.name,
                      C.LABEL_ROLE_NAME: role.name},
            leader_only=leader_only)

    def _ensure_one_service(self, store, rbg, role, sname: str,
                            selector: dict, leader_only: bool):
        ns = rbg.metadata.namespace
        cur = store.get("Service", ns, sname, copy_=False)
        if cur is not None:
            if cur.leader_only != leader_only:
                def fn(s):
                    s.leader_only = leader_only
                    return True
                store.mutate("Service", ns, sname, fn)
            return
        svc = Service()
        svc.metadata.name = sname
        svc.metadata.namespace = ns
        svc.metadata.labels = {
            C.LABEL_GROUP_NAME: rbg.metadata.name,
            C.LABEL_ROLE_NAME: role.name,
        }
        svc.metadata.owner_references = [owner_ref(rbg)]
        svc.selector = dict(selector)
        svc.leader_only = leader_only
        try:
            store.create(svc)
        except AlreadyExists:
            pass

    # ---- status aggregation (Appendix C, anti-flicker :57-81) ----

    def _update_role_statuses(self, store, rbg, role_hashes):
        from rbg_tpu_torch.runtime import workload as workload_registry
        ns = rbg.metadata.namespace
        new_roles: List[RoleStatus] = []
        for role in rbg.spec.roles:
            prev = rbg.status.role(role.name)
            try:
                backend = workload_registry.resolve(role.workload)
            except KeyError:
                new_roles.append(prev or RoleStatus(name=role.name))
                continue
            new_roles.append(backend.construct_role_status(
                store, rbg, role, role_hashes.get(role.name, ""), prev))

        ready = all(st.ready for st in new_roles) \
            and len(new_roles) == len(rbg.spec.roles)
        now = time.time()

        def fn(g):
            changed = False
            # dataclasses.asdict, NOT serde.to_dict: the derived `ready`
            # flag is __serde_skip__'d from the wire format but a
            # ready-only flip must still be written to the store.
            import dataclasses as _dc
            if ([_dc.asdict(r) for r in g.status.roles]
                    != [_dc.asdict(r) for r in new_roles]):
                g.status.roles = new_roles
                changed = True
            if g.status.observed_generation != g.metadata.generation:
                g.status.observed_generation = g.metadata.generation
                changed = True
            if set_condition(
                g.status.conditions,
                Condition(type=C.COND_READY, status="True" if ready else "False",
                          reason="AllRolesReady" if ready else "Progressing"),
                now,
            ):
                changed = True
            return changed

        updated = store.mutate("RoleBasedGroup", ns, rbg.metadata.name, fn, status=True)
        return updated

    def _set_group_condition(self, store, rbg, ready: bool, reason: str, msg: str):
        def fn(g):
            return set_condition(
                g.status.conditions,
                Condition(type=C.COND_READY, status="True" if ready else "False",
                          reason=reason, message=msg[:500]),
                time.time(),
            )
        store.mutate("RoleBasedGroup", rbg.metadata.namespace, rbg.metadata.name,
                     fn, status=True)

    # ---- orphans ----

    def _cleanup_orphans(self, store, rbg):
        from rbg_tpu_torch.runtime import workload as workload_registry
        ns = rbg.metadata.namespace
        from rbg_tpu_torch.api.group import SUBDOMAIN_UNIQUE_PER_REPLICA
        valid_s = set()
        for r in rbg.spec.roles:
            if (r.network is not None and r.network.subdomain_policy
                    == SUBDOMAIN_UNIQUE_PER_REPLICA):
                # Per-instance services are valid; the shared role service
                # is NOT (KEP-275: removed in steady state).
                valid_s.update(
                    i.metadata.name for i in store.list(
                        "RoleInstance", namespace=ns,
                        selector={C.LABEL_GROUP_NAME: rbg.metadata.name,
                                  C.LABEL_ROLE_NAME: r.name},
                        copy_=False))
            else:
                valid_s.add(C.service_name(rbg.metadata.name, r.name))
        # Fan the sweep across every registered backend, each keeping only
        # the children of roles routed to IT: a role whose workload KIND
        # changed leaves an orphan in the old backend's store.
        for backend in workload_registry.backends():
            valid_w = {
                C.workload_name(rbg.metadata.name, r.name)
                for r in rbg.spec.roles
                if (r.workload or workload_registry.DEFAULT_KIND) == backend.kind
            }
            backend.cleanup_orphans(store, rbg, valid_w)
        for svc in store.list("Service", namespace=ns, owner_uid=rbg.metadata.uid):
            if svc.metadata.name not in valid_s:
                store.delete("Service", ns, svc.metadata.name)
