"""Policy / adapter / warmup / profile resources.

Reference analogs: ``coordinatedpolicy_types.go:24-152`` (inventory #22),
``rolebasedgroupscalingadapter_types.go`` (#8),
``rolebasedgroupwarmup_types.go:34-249`` (#9),
``clusterengineruntimeprofile_types.go`` (#19).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from rbg_tpu_torch.api.meta import Condition, ObjectMeta
from rbg_tpu_torch.api.pod import Container, PodTemplate


class ProgressionGate(str, enum.Enum):
    ORDER_SCHEDULED = "OrderScheduled"
    ORDER_READY = "OrderReady"


@dataclasses.dataclass
class CoordinatedScaling:
    """maxSkew-bounded multi-role scaling: roles in ``roles`` scale together,
    never diverging more than maxSkew percent in progress."""

    roles: List[str] = dataclasses.field(default_factory=list)
    max_skew_percent: int = 10
    gate: ProgressionGate = ProgressionGate.ORDER_READY


@dataclasses.dataclass
class CoordinatedRollingUpdate:
    roles: List[str] = dataclasses.field(default_factory=list)
    max_skew_percent: int = 10


@dataclasses.dataclass
class CoordinatedPolicySpec:
    group_name: str = ""
    scaling: Optional[CoordinatedScaling] = None
    rolling_update: Optional[CoordinatedRollingUpdate] = None


@dataclasses.dataclass
class CoordinatedPolicy:
    kind: str = "CoordinatedPolicy"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: CoordinatedPolicySpec = dataclasses.field(default_factory=CoordinatedPolicySpec)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class ScalingAdapterSpec:
    """HPA bridge: an external autoscaler drives ``replicas`` here; the
    controller writes it through to the target role."""

    group_name: str = ""
    role_name: str = ""
    replicas: Optional[int] = None
    min_replicas: int = 0
    max_replicas: int = 0


@dataclasses.dataclass
class ScalingAdapterStatus:
    phase: str = "NotBound"     # Bound | NotBound
    replicas: int = 0
    selector: str = ""

    __serde_keep__ = ("phase",)


@dataclasses.dataclass
class ScalingAdapter:
    kind: str = "ScalingAdapter"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: ScalingAdapterSpec = dataclasses.field(default_factory=ScalingAdapterSpec)
    status: ScalingAdapterStatus = dataclasses.field(default_factory=ScalingAdapterStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class ImagePreload:
    """Pull these images onto the node ahead of time (reference:
    ``ImagePreloadAction``, ``rolebasedgroupwarmup_types.go:34-45``)."""

    images: List[str] = dataclasses.field(default_factory=list)
    pull_secrets: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WarmupActions:
    """What to run on each target node: per-image pull containers and/or
    user containers (reference: ``WarmupActions`` / ``CustomizedAction``,
    types ``:47-75``; container construction ``buildWarmupPod:535``)."""

    image_preload: Optional[ImagePreload] = None
    containers: List[Container] = dataclasses.field(default_factory=list)
    volumes: List[str] = dataclasses.field(default_factory=list)

    @property
    def empty(self) -> bool:
        return (self.image_preload is None and not self.containers
                and not self.volumes)


@dataclasses.dataclass
class WarmupTarget:
    nodes: List[str] = dataclasses.field(default_factory=list)  # explicit
    # Or: nodes selected by labels (reference TargetNodes.NodeSelector).
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    group_name: str = ""        # or: nodes discovered from a group's pods
    # With group_name: per-ROLE actions — each node gets the union of the
    # actions of the roles whose pods it hosts (reference
    # TargetRoleBasedGroup.Roles, types ``:96-110``). Empty = spec.actions
    # on every node of the group.
    roles: Dict[str, WarmupActions] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WarmupSpec:
    """Node warmup jobs: image preload / cache priming per node before a
    group lands (reference: #9). On TPU the canonical use is XLA compile-cache
    priming and model-weight prefetch to hosts of the target slice."""

    target: WarmupTarget = dataclasses.field(default_factory=WarmupTarget)
    # Actions for node-targeted warmups (and the group default when
    # target.roles is empty).
    actions: WarmupActions = dataclasses.field(default_factory=WarmupActions)
    # Legacy single-template form (pre-actions API): used verbatim when no
    # actions are given anywhere.
    template: PodTemplate = dataclasses.field(default_factory=PodTemplate)
    parallelism: int = 4
    max_failed_nodes: int = 0
    backoff_limit: int = 3
    timeout_seconds: float = 600.0
    ttl_seconds_after_finished: float = 300.0


@dataclasses.dataclass
class WarmupStatus:
    phase: str = "Pending"      # Pending | Running | Succeeded | Failed
    desired_nodes: int = 0
    succeeded_nodes: int = 0
    failed_nodes: int = 0
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    completion_time: float = 0.0

    __serde_keep__ = ("phase",)


@dataclasses.dataclass
class Warmup:
    kind: str = "Warmup"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: WarmupSpec = dataclasses.field(default_factory=WarmupSpec)
    status: WarmupStatus = dataclasses.field(default_factory=WarmupStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class PodGroupSpec:
    """Gang scheduling: all-or-nothing placement of min_member pods.

    Reference analog: ``pkg/scheduler/podgroup_manager.go:64-78`` (PodGroup CR
    for scheduler-plugins / Volcano, MinMember = total pods in group,
    ``helper.go:69-85``). On TPU, the gang is the slice: a multi-host role
    instance must acquire all hosts of one ICI domain atomically or none.
    """

    min_member: int = 1
    group_name: str = ""        # owning RoleBasedGroup
    queue: str = ""
    priority: int = 0


@dataclasses.dataclass
class PodGroupStatus:
    phase: str = "Pending"      # Pending | Scheduled
    scheduled: int = 0

    __serde_keep__ = ("phase",)


@dataclasses.dataclass
class PodGroup:
    kind: str = "PodGroup"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: PodGroupSpec = dataclasses.field(default_factory=PodGroupSpec)
    status: PodGroupStatus = dataclasses.field(default_factory=PodGroupStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class EngineRuntimeProfile:
    """Cluster-scoped bundle of sidecar/init containers + volumes injected
    into role pods (reference: #19, ``sidecar_builder.go:47-158``)."""

    kind: str = "EngineRuntimeProfile"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    init_containers: List[Container] = dataclasses.field(default_factory=list)
    containers: List[Container] = dataclasses.field(default_factory=list)
    volumes: List[str] = dataclasses.field(default_factory=list)

    __serde_keep__ = ("kind", "metadata")
