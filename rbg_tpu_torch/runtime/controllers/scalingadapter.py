"""ScalingAdapter controller — the HPA bridge.

Reference analog: inventory #8 (``rolebasedgroupscalingadapter_controller.go``):
an external autoscaler writes ``spec.replicas`` on the adapter (the ``scale``
subresource); this controller binds the adapter to its (group, role) target
and the group controller writes the override through to the role
(``_apply_scaling_overrides``). Auto-creation from ``role.scaling_adapter``
(KEP-29) also lives here.
"""

from __future__ import annotations

from typing import List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.meta import owner_ref
from rbg_tpu_torch.api.policy import ScalingAdapter, ScalingAdapterSpec
from rbg_tpu_torch.runtime.controller import Controller, Result, Watch, own_keys
from rbg_tpu_torch.runtime.store import AlreadyExists, Store


def adapter_name(group: str, role: str) -> str:
    return f"{group}-{role}-scaling-adapter"[:C.MAX_NAME_LEN].rstrip("-")


class ScalingAdapterController(Controller):
    name = "scalingadapter"

    def watches(self) -> List[Watch]:
        def group_to_adapters(obj):
            if obj.kind != "RoleBasedGroup":
                return []
            ns = obj.metadata.namespace
            return [(ns, a.metadata.name)
                    for a in self.store.list_for("ScalingAdapter", obj,
                                                 copy_=False)]

        return [
            Watch("ScalingAdapter", own_keys),
            Watch("RoleBasedGroup", group_to_adapters),
        ]

    def reconcile(self, store: Store, key) -> Optional[Result]:
        ns, name = key
        sa = store.get("ScalingAdapter", ns, name)
        if sa is None or sa.metadata.deletion_timestamp is not None:
            return None
        rbg = store.get("RoleBasedGroup", ns, sa.spec.group_name)
        role = rbg.spec.role(sa.spec.role_name) if rbg is not None else None
        bound = role is not None

        # Clamp external writes into [min, max] if configured.
        if bound and sa.spec.replicas is not None:
            lo, hi = sa.spec.min_replicas, sa.spec.max_replicas
            clamped = sa.spec.replicas
            if hi > 0:
                clamped = min(clamped, hi)
            clamped = max(clamped, lo)
            if clamped != sa.spec.replicas:
                def fix(a, v=clamped):
                    a.spec.replicas = v
                    return True
                store.mutate("ScalingAdapter", ns, name, fix)

        st = rbg.status.role(sa.spec.role_name) if bound else None

        def fn(a):
            phase = "Bound" if bound else "NotBound"
            replicas = st.replicas if st is not None else 0
            if (a.status.phase, a.status.replicas) == (phase, replicas):
                return False
            a.status.phase = phase
            a.status.replicas = replicas
            a.status.selector = (
                f"{C.LABEL_GROUP_NAME}={sa.spec.group_name},"
                f"{C.LABEL_ROLE_NAME}={sa.spec.role_name}")
            return True

        store.mutate("ScalingAdapter", ns, name, fn, status=True)
        return None


def ensure_auto_adapters(store: Store, rbg) -> None:
    """KEP-29: create adapters for roles with ``scaling_adapter.enabled``.
    Called from the group controller."""
    ns = rbg.metadata.namespace
    for role in rbg.spec.roles:
        hook = role.scaling_adapter
        if hook is None or not hook.enabled:
            continue
        name = adapter_name(rbg.metadata.name, role.name)
        if store.get("ScalingAdapter", ns, name) is not None:
            continue
        sa = ScalingAdapter()
        sa.metadata.name = name
        sa.metadata.namespace = ns
        sa.metadata.labels = {C.LABEL_GROUP_NAME: rbg.metadata.name,
                              C.LABEL_ROLE_NAME: role.name}
        sa.metadata.owner_references = [owner_ref(rbg)]
        sa.spec = ScalingAdapterSpec(
            group_name=rbg.metadata.name, role_name=role.name,
            min_replicas=hook.min_replicas, max_replicas=hook.max_replicas,
        )
        try:
            store.create(sa)
        except AlreadyExists:
            pass
