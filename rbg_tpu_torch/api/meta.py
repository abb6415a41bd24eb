"""Object metadata — the identity/ownership model every resource shares.

Reference analog: ``metav1.ObjectMeta`` usage throughout
``api/workloads/v1alpha2``; we keep only the fields the control plane
actually exercises (name/namespace/uid/labels/annotations/ownerRefs/
resourceVersion/generation/deletion).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = True


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    owner_references: List[OwnerReference] = dataclasses.field(default_factory=list)
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None

    __serde_keep__ = ("name",)

    def controller_owner(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None

    def owned_by(self, obj) -> bool:
        return any(r.uid == obj.metadata.uid for r in self.owner_references)


def owner_ref(obj, controller: bool = True) -> OwnerReference:
    return OwnerReference(
        kind=obj.kind, name=obj.metadata.name, uid=obj.metadata.uid,
        controller=controller,
    )


@dataclasses.dataclass
class Condition:
    """Status condition (k8s metav1.Condition shape)."""

    type: str = ""
    status: str = "Unknown"  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0

    __serde_keep__ = ("type", "status")


def set_condition(conditions: List[Condition], cond: Condition, now: float) -> bool:
    """Upsert a condition; preserves lastTransitionTime when status unchanged.
    Returns True if anything changed. (Reference analog: meta.SetStatusCondition
    semantics used across controllers.)"""
    for i, c in enumerate(conditions):
        if c.type == cond.type:
            if (c.status, c.reason, c.message) == (cond.status, cond.reason, cond.message):
                return False
            cond.last_transition_time = now if c.status != cond.status else c.last_transition_time
            conditions[i] = cond
            return True
    cond.last_transition_time = now
    conditions.append(cond)
    return True


def get_condition(conditions: List[Condition], type_: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == type_:
            return c
    return None
