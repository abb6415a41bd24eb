"""Pluggable workload backends — the strategy seam behind each role.

Reference analog: inventory #23, ``pkg/reconciler/workload_reconciler.go:34-69``
— the ``WorkloadReconciler`` interface (Validate / Reconciler /
ConstructRoleStatus / CheckWorkloadReady / CleanupOrphanedWorkloads) plus the
``NewWorkloadReconciler`` factory keyed on the role's workload kind, and the
dynamic CRD watch that lets new kinds attach without editing the group
controller (``rolebasedgroup_controller.go:1598-1621``).

TPU-first redesign: the reference's Deployment/STS/LWS strategies collapse
into the native InstanceSet's stateful/stateless modes (docs/architecture.md),
so the registry ships with ONE built-in backend — but the seam is real:
``register()`` attaches any external kind (a Kueue-managed batch workload, a
vendor operator bridge) and the group controller routes through ``resolve()``
only, never naming a concrete backend.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

from rbg_tpu_torch.api.group import RoleSpec, RoleStatus

DEFAULT_KIND = "RoleInstanceSet"


class WorkloadBackend(abc.ABC):
    """One per workload kind. Stateless: every method receives the store."""

    #: registry key, matched against ``RoleSpec.workload``
    kind: str = ""

    def validate(self, store, rbg, role: RoleSpec) -> None:
        """Raise ``rbg_tpu_torch.api.validation.ValidationError`` on a role this
        backend cannot run (reference: WorkloadReconciler.Validate)."""

    def watches(self):
        """Extra ``Watch`` entries the group controller needs so events on
        this backend's children re-trigger the owning group (reference:
        the dynamic CRD watch, ``rolebasedgroup_controller.go:1598-1621``).
        Consulted when the group controller is registered with a Manager —
        register backends before starting the plane."""
        return []

    @abc.abstractmethod
    def reconcile_role(self, store, rbg, role: RoleSpec, role_hash: str,
                       replicas: int, gang: bool,
                       partition: Optional[int] = None) -> None:
        """Create/update the child workload for this role (reference:
        WorkloadReconciler.Reconciler)."""

    @abc.abstractmethod
    def construct_role_status(self, store, rbg, role: RoleSpec,
                              role_hash: str,
                              prev: Optional[RoleStatus]) -> RoleStatus:
        """Roll the child workload up into a RoleStatus; return ``prev``
        (or an empty status) when the child hasn't observed the latest spec
        — the anti-flicker contract of Appendix C (reference:
        ConstructRoleStatus + ``pkg/reconciler/common.go:57-81``)."""

    @abc.abstractmethod
    def cleanup_orphans(self, store, rbg, valid_names: set) -> None:
        """Delete child workloads owned by ``rbg`` that no longer correspond
        to a role routed to this backend (reference:
        CleanupOrphanedWorkloads)."""

    def rollout_progress(self, store, rbg, role: RoleSpec,
                         role_hash: str) -> int:
        """Updated-AND-ready replica count at revision ``role_hash`` — feeds
        the coordinated rolling-update skew math. The default derives from
        ``construct_role_status``; counts at any OTHER revision read as 0 so
        a child that hasn't received the new template can't look 100%
        updated and open every partition. Backends whose child may not exist
        yet should override and return ``role.replicas`` in that case (it
        will be created at the new revision — don't hold siblings back)."""
        st = self.construct_role_status(store, rbg, role, role_hash, None)
        if st.observed_revision != role_hash:
            return 0
        return st.updated_ready_replicas


_REGISTRY: Dict[str, WorkloadBackend] = {}


def register(backend: WorkloadBackend) -> WorkloadBackend:
    """Attach a workload kind. Later registrations win (test override)."""
    if not backend.kind:
        raise ValueError("backend.kind must be set")
    _REGISTRY[backend.kind] = backend
    return backend


def unregister(kind: str) -> None:
    _REGISTRY.pop(kind, None)


def resolve(kind: str) -> WorkloadBackend:
    """Factory lookup (reference: NewWorkloadReconciler :54-69). Unknown
    kinds raise KeyError — surfaced by the group controller as a
    ValidationFailed condition, the analog of the reference's unsupported-
    workload-type error."""
    b = _REGISTRY.get(kind or DEFAULT_KIND)
    if b is None:
        raise KeyError(f"no workload backend registered for kind {kind!r}")
    return b


def backends():
    """All registered backends (orphan sweep fans out across every kind)."""
    return list(_REGISTRY.values())


# ---- built-in: the native InstanceSet (stateful + stateless modes) ----


class InstanceSetBackend(WorkloadBackend):
    """Routes a role to a native RoleInstanceSet (inventory #10-13)."""

    kind = DEFAULT_KIND

    def watches(self):
        from rbg_tpu_torch.runtime.controller import Watch, owner_keys
        # Coalesced: every instance/pod status flip bubbles up as a RIS
        # status write; a 20ms window folds a whole gang's flips into one
        # group reconcile (the fan-out is the plane's hottest path).
        return [Watch("RoleInstanceSet", owner_keys("RoleBasedGroup"),
                      delay=0.02)]

    def reconcile_role(self, store, rbg, role, role_hash, replicas, gang,
                       partition=None):
        import copy as _copy

        from rbg_tpu_torch.api import constants as C
        from rbg_tpu_torch.api import serde
        from rbg_tpu_torch.api.instance import (
            InstanceTemplate, RoleInstanceSet, RoleInstanceSetSpec,
        )
        from rbg_tpu_torch.api.meta import owner_ref
        from rbg_tpu_torch.runtime.store import AlreadyExists

        ns = rbg.metadata.namespace
        wname = C.workload_name(rbg.metadata.name, role.name)
        labels = {
            C.LABEL_GROUP_NAME: rbg.metadata.name,
            C.LABEL_ROLE_NAME: role.name,
            C.role_revision_label(role.name): role_hash,
        }
        annotations = {}
        if gang:
            annotations[C.ANN_GANG_SCHEDULING] = rbg.metadata.name
        # Role-scoped config annotations win over group-scoped defaults
        # (e.g. per-role in-place-scheduling mode/avoid labels, KEP-351).
        for source in (role.template.annotations, rbg.metadata.annotations):
            for k, v in source.items():
                if k.startswith(C.DOMAIN) and k != C.ANN_GANG_SCHEDULING:
                    annotations.setdefault(k, v)

        rolling = _copy.deepcopy(role.rolling_update)
        if partition is not None:
            # Coordinated rollout TIGHTENS the partition (reference:
            # calculateNextRollingTarget :1374 → RIS partition); a user's
            # explicit canary hold is never released by the skew math.
            rolling.partition = max(partition, role.rolling_update.partition)
        desired_spec = RoleInstanceSetSpec(
            replicas=replicas,
            identity=role.identity,
            instance=InstanceTemplate(
                pattern=role.pattern,
                template=role.template,
                leader_worker=role.leader_worker,
                components=role.components,
                tpu=role.tpu,
                engine_runtime=role.engine_runtime,
            ),
            restart_policy=role.restart_policy,
            rolling_update=rolling,
            selector=dict(labels),
            drain_seconds=role.drain_seconds,
        )

        cur = store.get("RoleInstanceSet", ns, wname, copy_=False)
        if cur is None:
            ris = RoleInstanceSet()
            ris.metadata.name = wname
            ris.metadata.namespace = ns
            ris.metadata.labels = labels
            ris.metadata.annotations = annotations
            ris.metadata.owner_references = [owner_ref(rbg)]
            ris.spec = desired_spec
            try:
                store.create(ris)
            except AlreadyExists:
                pass
            return
        # semantic-equality update (reference: comparators in each
        # reconciler). Controller-managed annotations (port allocations,
        # Appendix E) are copied forward, never wiped by a spec sync.
        managed = {C.ANN_ALLOCATED_PORTS}
        cur_ann = {k: v for k, v in cur.metadata.annotations.items()
                   if k not in managed}
        if (serde.to_dict(cur.spec) != serde.to_dict(desired_spec)
                or cur.metadata.labels != labels
                or cur_ann != annotations):
            def fn(r):
                r.spec = desired_spec
                r.metadata.labels = labels
                keep = {k: v for k, v in r.metadata.annotations.items()
                        if k in managed}
                r.metadata.annotations = {**annotations, **keep}
                return True
            store.mutate("RoleInstanceSet", ns, wname, fn)

    def construct_role_status(self, store, rbg, role, role_hash, prev):
        from rbg_tpu_torch.api import constants as C
        from rbg_tpu_torch.api.meta import get_condition

        ns = rbg.metadata.namespace
        wname = C.workload_name(rbg.metadata.name, role.name)
        ris = store.get("RoleInstanceSet", ns, wname, copy_=False)
        if ris is None:
            return prev or RoleStatus(name=role.name)
        if (ris.status.observed_generation < ris.metadata.generation
                and prev is not None):
            # child controller hasn't observed the latest spec — keep
            # last-known status (anti-flicker)
            return prev
        if (ris.metadata.labels.get(C.role_revision_label(role.name))
                != role_hash):
            # The RIS hasn't RECEIVED the new template yet (the group
            # reconcile pushes it after statuses): claiming the new
            # observed_revision now would make the group look "ready at the
            # new revision" for a window before any pod moved — fleet-level
            # rollout staging (GroupSet max_unavailable) would tear through
            # every cell inside that window. With no prev to fall back on
            # (e.g. an external backend's default rollout_progress passes
            # prev=None), report empty rather than stamping role_hash onto
            # the OLD revision's counters.
            return prev if prev is not None else RoleStatus(name=role.name)
        ris_ready = get_condition(ris.status.conditions, C.COND_READY)
        return RoleStatus(
            name=role.name,
            replicas=ris.status.replicas,
            ready_replicas=ris.status.ready_replicas,
            updated_replicas=ris.status.updated_replicas,
            updated_ready_replicas=ris.status.updated_ready_replicas,
            observed_revision=role_hash,
            # Role readiness = the child's Ready CONDITION (capacity-aware
            # during surge rollouts, when counter equality briefly flips
            # False even though serving capacity never dips) AND the child's
            # spec having reached the role's desired replicas — a
            # coordination-clamped RIS is Ready at its *interim* target and
            # must not make the group Ready early.
            ready=(ris_ready is not None and ris_ready.status == "True"
                   and ris.spec.replicas == role.replicas),
        )

    def cleanup_orphans(self, store, rbg, valid_names):
        ns = rbg.metadata.namespace
        for ris in store.list("RoleInstanceSet", namespace=ns,
                              owner_uid=rbg.metadata.uid):
            if ris.metadata.name not in valid_names:
                store.delete("RoleInstanceSet", ns, ris.metadata.name)

    def rollout_progress(self, store, rbg, role, role_hash):
        from rbg_tpu_torch.api import constants as C
        ns = rbg.metadata.namespace
        ris = store.get("RoleInstanceSet", ns,
                        C.workload_name(rbg.metadata.name, role.name),
                        copy_=False)
        if ris is None:
            # No workload yet: it will be created at the new revision —
            # treat as fully updated so it doesn't hold others back.
            return role.replicas
        if (ris.metadata.labels.get(C.role_revision_label(role.name))
                != role_hash):
            # RIS hasn't received the new template yet — its updated
            # counters refer to the OLD revision and would read as 100%
            # (letting the first reconcile open every partition).
            return 0
        return ris.status.updated_ready_replicas


register(InstanceSetBackend())
