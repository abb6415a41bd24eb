"""RoleInstanceSet / RoleInstance — the native workload engine's resources.

Reference analog: inventory #10-13 — ``roleinstanceset_types.go`` /
``roleinstance_types.go`` (KEP-30 InstanceSet). One RoleInstance = a *gang of
pods* (a whole multi-host TPU slice for leader-worker roles); the set manages
N instances with ordered (stateful) or random (stateless) identity.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from rbg_tpu_torch.api.group import (
    ComponentSpec, EngineRuntimeRef, IdentityMode, LeaderWorkerSpec,
    PatternType, RestartPolicyConfig, RollingUpdate, TpuSpec,
)
from rbg_tpu_torch.api.meta import Condition, ObjectMeta
from rbg_tpu_torch.api.pod import PodTemplate


class ReadyPolicy(str, enum.Enum):
    ALL_PODS_READY = "AllPodReady"
    NONE = "None"


@dataclasses.dataclass
class InstanceTemplate:
    """What one instance looks like: pattern + templates + placement."""

    pattern: PatternType = PatternType.STANDALONE
    template: PodTemplate = dataclasses.field(default_factory=PodTemplate)
    leader_worker: Optional[LeaderWorkerSpec] = None
    components: List[ComponentSpec] = dataclasses.field(default_factory=list)
    tpu: Optional[TpuSpec] = None
    ready_policy: ReadyPolicy = ReadyPolicy.ALL_PODS_READY
    engine_runtime: Optional["EngineRuntimeRef"] = None


@dataclasses.dataclass
class RoleInstanceSetSpec:
    replicas: int = 1
    identity: IdentityMode = IdentityMode.ORDINAL
    instance: InstanceTemplate = dataclasses.field(default_factory=InstanceTemplate)
    restart_policy: RestartPolicyConfig = dataclasses.field(default_factory=RestartPolicyConfig)
    rolling_update: RollingUpdate = dataclasses.field(default_factory=RollingUpdate)
    selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    # PreparingDelete drain window for stateless scale-down (0 = immediate).
    drain_seconds: float = 0.0

    @property
    def stateful(self) -> bool:
        """Derived from ``identity`` (kept for call-site readability)."""
        return self.identity != IdentityMode.RANDOM


@dataclasses.dataclass
class RoleInstanceSetStatus:
    """Rollup counters (reference: ``roleinstanceset_types.go:160-206``)."""

    observed_generation: int = 0
    replicas: int = 0
    ready_replicas: int = 0
    updated_replicas: int = 0
    updated_ready_replicas: int = 0
    current_replicas: int = 0       # instances still at current_revision
    current_revision: str = ""
    update_revision: str = ""
    conditions: List[Condition] = dataclasses.field(default_factory=list)

    @property
    def expected_updated_replicas(self) -> int:
        return self.replicas


@dataclasses.dataclass
class RoleInstanceSet:
    kind: str = "RoleInstanceSet"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: RoleInstanceSetSpec = dataclasses.field(default_factory=RoleInstanceSetSpec)
    status: RoleInstanceSetStatus = dataclasses.field(default_factory=RoleInstanceSetStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class ComponentStatus:
    """Per-component counters (reference: ``roleinstance_types.go:181-202``)."""

    name: str = ""
    size: int = 0
    ready: int = 0
    scheduled: int = 0

    __serde_keep__ = ("name",)


@dataclasses.dataclass
class RoleInstanceSpec:
    instance: InstanceTemplate = dataclasses.field(default_factory=InstanceTemplate)
    restart_policy: RestartPolicyConfig = dataclasses.field(default_factory=RestartPolicyConfig)
    index: int = -1             # ordinal for stateful instances; -1 stateless
    # Drain window for in-place updates, propagated from the set's
    # rollingUpdate.graceSeconds when an update is recorded (the pod-level
    # convergence loop needs it without reaching back to the RIS).
    inplace_grace_seconds: float = 0.0


@dataclasses.dataclass
class RoleInstanceStatus:
    phase: str = "Pending"      # Pending | Running | Restarting | Deleting
    components: List[ComponentStatus] = dataclasses.field(default_factory=list)
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    restart_count: int = 0
    last_restart_time: float = 0.0
    observed_revision: str = ""
    slice_id: str = ""          # TPU slice this instance is bound to

    __serde_keep__ = ("phase",)


@dataclasses.dataclass
class RoleInstance:
    kind: str = "RoleInstance"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: RoleInstanceSpec = dataclasses.field(default_factory=RoleInstanceSpec)
    status: RoleInstanceStatus = dataclasses.field(default_factory=RoleInstanceStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class ControllerRevision:
    """Immutable snapshot of a spec for rollout history/undo (reference:
    ``pkg/utils/revision_utils.go:50-403`` + KEP-31)."""

    kind: str = "ControllerRevision"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    revision: int = 0
    data: dict = dataclasses.field(default_factory=dict)   # serialized spec
    role_hashes: Dict[str, str] = dataclasses.field(default_factory=dict)

    __serde_keep__ = ("kind", "metadata", "revision")
