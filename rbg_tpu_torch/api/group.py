"""RoleBasedGroup — the root resource: a list of coordinated roles.

Reference analog: ``api/workloads/v1alpha2/rolebasedgroup_types.go`` (inventory
#1): ``RoleSpec`` (:203), patterns standalone/leaderWorker/customComponents
(:300-312, :335, :368-433), ``RestartPolicyConfig`` backoff (:164-187),
``EngineRuntime`` hook (:392-402). TPU-first change: ``leaderWorkerPattern.size``
(how many GPU nodes form one model instance) becomes ``TpuSpec.slice_topology``
— one role replica = one multi-host TPU slice, and the plane derives the gang
size from the topology instead of asking for a raw count.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from rbg_tpu_torch.api.intstr import IntOrStr
from rbg_tpu_torch.api.meta import Condition, ObjectMeta
from rbg_tpu_torch.api.pod import PodTemplate


class PatternType(str, enum.Enum):
    STANDALONE = "standalone"
    LEADER_WORKER = "leaderWorker"
    CUSTOM_COMPONENTS = "customComponents"


class IdentityMode(str, enum.Enum):
    """Instance identity discipline (v1alpha2 rename of the v1alpha1 bool
    ``stateful``, converted in api/conversions.py). Enum-typed so admission
    strict-parse rejects misspellings ("Random", "stateless") instead of
    silently running the role ordinal."""

    ORDINAL = "ordinal"   # stable {set}-{i} names, slice-pinned placement
    RANDOM = "random"     # CloneSet-like unordered instances


@dataclasses.dataclass
class ComponentSpec:
    """One component of a customComponents role (reference: :368-433 +
    KEP-173): heterogeneous intra-role groups (router + worker + cache)."""

    name: str = ""
    size: int = 1
    template: Optional[PodTemplate] = None
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LeaderWorkerSpec:
    """Leader + N-1 workers per role instance. ``size`` may be omitted for TPU
    roles — it is then derived from tpu.slice_topology (hosts per slice)."""

    size: int = 0
    leader_template: Optional[PodTemplate] = None  # defaults to role template
    worker_template: Optional[PodTemplate] = None


@dataclasses.dataclass
class TpuSpec:
    """First-class TPU placement request for a role.

    Replaces the reference's GPU-implicit knobs (BASELINE.json north star):
    one role replica occupies one ``slice_topology`` slice of ``accelerator``
    chips; the plane gang-places its hosts into a single ICI domain and
    injects the JAX coordinator + mesh coordinates (rbg_tpu_torch.discovery).
    """

    accelerator: str = ""       # v5e | v5p | v6e ...
    slice_topology: str = ""    # e.g. "2x4" (chips); hosts derived per accel
    chips_per_host: int = 4
    # Multi-slice (MEGASCALE) role: one instance spans num_slices slices —
    # ICI within each slice, DCN across them. The plane places one sub-gang
    # per slice and injects the MEGASCALE_* env contract.
    num_slices: int = 1

    @property
    def total_chips(self) -> int:
        if not self.slice_topology:
            return 0
        n = 1
        for part in self.slice_topology.lower().split("x"):
            n *= int(part)
        return n

    @property
    def num_hosts(self) -> int:
        chips = self.total_chips
        if chips == 0:
            return 0
        return max(1, chips // max(1, self.chips_per_host))


def per_slice_size(leader_worker, tpu) -> int:
    """Pods per slice sub-gang of a leaderWorker role: explicit
    ``leader_worker.size`` wins, else derived from the slice topology.
    The ONE definition shared by gang sizing, pod naming, slice-ordinal
    labeling and MEGASCALE env math — these must never diverge."""
    if leader_worker is not None and leader_worker.size:
        return leader_worker.size
    if tpu is not None and tpu.num_hosts:
        return tpu.num_hosts
    return 1


class RestartPolicy(str, enum.Enum):
    NONE = "None"
    RECREATE_INSTANCE_ON_POD_RESTART = "RecreateRoleInstanceOnPodRestart"
    RECREATE_GROUP_ON_POD_RESTART = "RecreateGroupOnPodRestart"


@dataclasses.dataclass
class RestartPolicyConfig:
    """Restart policy + exponential backoff (reference: :164-187; backoff math
    ``min(base·2^(n-1), max)`` in ``sync/instance_scale.go:482-506``)."""

    policy: RestartPolicy = RestartPolicy.RECREATE_INSTANCE_ON_POD_RESTART
    base_delay_seconds: float = 1.0
    max_delay_seconds: float = 300.0
    window_seconds: float = 600.0   # restart-count decay window


@dataclasses.dataclass
class RollingUpdate:
    """Rolling update knobs (reference: RIS update strategy,
    ``roleinstanceset_reconciler.go:231-252``). ``max_unavailable`` and
    ``max_surge`` accept an int or a percent string ("25%"), scaled
    against role replicas with K8s rounding (surge up, unavailable down —
    ``api/intstr.py``; reference ``sts_reconciler.go:198-449``)."""

    max_unavailable: IntOrStr = 1
    max_surge: IntOrStr = 0
    partition: int = 0
    in_place_if_possible: bool = True
    # Freeze rollout progress mid-flight; existing surge is preserved
    # (reference: UpdateStrategy.Paused, computeTopology paused branch).
    paused: bool = False
    # Seconds an instance must be Ready before it counts as available for
    # the rolling-update budget (reference: getMinReadySeconds).
    min_ready_seconds: int = 0
    # In-place update drain window: the pod sits InPlaceUpdateReady=False
    # for this long BEFORE its images are patched, so routers/endpoints can
    # drain it (reference: InPlaceUpdateStrategy.GracePeriodSeconds,
    # ``inplace_update.go:258-283``).
    grace_seconds: float = 0.0


@dataclasses.dataclass
class ScalingAdapterHook:
    """Auto-create a ScalingAdapter for this role (reference: KEP-29,
    ``rolebasedgroup_controller.go:896-953``)."""

    enabled: bool = False
    min_replicas: int = 0
    max_replicas: int = 0


@dataclasses.dataclass
class EngineRuntimeRef:
    """Reference to an EngineRuntimeProfile + per-container overrides
    (reference: ``rolebasedgroup_types.go:392-402``)."""

    profile_name: str = ""
    container_args: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    container_env: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)


SUBDOMAIN_SHARED = "Shared"
SUBDOMAIN_UNIQUE_PER_REPLICA = "UniquePerReplica"


@dataclasses.dataclass
class NetworkConfig:
    """Per-role network policy (KEP-275, ``keps/275-enhance-network``).

    ``Shared`` (default): one headless service for the whole role —
    ``{pod}.s-{group}-{role}``. ``UniquePerReplica``: one headless service
    PER RoleInstance, named after the instance (``{pod}.{instance}``); the
    shared role service is removed in steady state. UniquePerReplica
    requires the leaderWorker pattern (stable per-replica identity) —
    rejected at admission otherwise, never silently downgraded."""

    subdomain_policy: str = SUBDOMAIN_SHARED


@dataclasses.dataclass
class RoleSpec:
    name: str = ""
    replicas: int = 1
    dependencies: List[str] = dataclasses.field(default_factory=list)
    pattern: PatternType = PatternType.STANDALONE
    leader_worker: Optional[LeaderWorkerSpec] = None
    components: List[ComponentSpec] = dataclasses.field(default_factory=list)
    template: PodTemplate = dataclasses.field(default_factory=PodTemplate)
    template_ref: str = ""      # RoleTemplate name (KEP-8 yaml-dedup)
    tpu: Optional[TpuSpec] = None
    restart_policy: RestartPolicyConfig = dataclasses.field(default_factory=RestartPolicyConfig)
    rolling_update: RollingUpdate = dataclasses.field(default_factory=RollingUpdate)
    scaling_adapter: Optional[ScalingAdapterHook] = None
    engine_runtime: Optional[EngineRuntimeRef] = None
    identity: IdentityMode = IdentityMode.ORDINAL
    workload: str = "RoleInstanceSet"  # strategy selector (inventory #23)
    # Scale-down drain window (stateless mode): an instance slated for
    # deletion enters PreparingDelete and keeps serving in-flight work for
    # up to this long (or until a drain agent acks) before the pods die
    # (reference: statelessmode preparingDelete lifecycle,
    # ``api/workloads/constants/constants.go:75-80``).
    drain_seconds: float = 0.0
    # KEP-260 sharedServiceSelection: "All" exposes every pod through the
    # role service; "LeaderOnly" exposes only instance leaders (component
    # index 0) — routers then address one endpoint per multi-host instance.
    service_selection: str = "All"     # All | LeaderOnly
    # Role-level networking (KEP-275): how headless services map to the
    # role's replicas.
    network: Optional["NetworkConfig"] = None

    __serde_keep__ = ("name",)

    @property
    def stateful(self) -> bool:
        """Derived from ``identity`` (kept for call-site readability)."""
        return self.identity != IdentityMode.RANDOM

    def gang_size(self) -> int:
        """Pods per role instance."""
        if self.pattern == PatternType.LEADER_WORKER:
            return per_slice_size(self.leader_worker, self.tpu) * (
                max(1, self.tpu.num_slices) if self.tpu else 1)
        if self.pattern == PatternType.CUSTOM_COMPONENTS:
            return sum(c.size for c in self.components) or 1
        return 1


@dataclasses.dataclass
class RoleStatus:
    name: str = ""
    replicas: int = 0
    ready_replicas: int = 0
    updated_replicas: int = 0
    updated_ready_replicas: int = 0
    observed_revision: str = ""
    # Rolled up from the RoleInstanceSet's Ready condition (capacity-aware
    # during surge rollouts) rather than re-derived from the counters.
    # DERIVED state: recomputed by the first reconcile after a state-file
    # load, so it is excluded from serialization (__serde_skip__) — a
    # snapshot written by this release must still load on the previous,
    # strict-parsing one (schema-evolution Rule 1, docs/architecture.md §5).
    ready: bool = False

    __serde_keep__ = ("name", "replicas", "ready_replicas")
    __serde_skip__ = ("ready",)


@dataclasses.dataclass
class RoleBasedGroupSpec:
    roles: List[RoleSpec] = dataclasses.field(default_factory=list)

    def role(self, name: str) -> Optional[RoleSpec]:
        for r in self.roles:
            if r.name == name:
                return r
        return None


@dataclasses.dataclass
class RoleBasedGroupStatus:
    observed_generation: int = 0
    roles: List[RoleStatus] = dataclasses.field(default_factory=list)
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    current_revision: str = ""

    def role(self, name: str) -> Optional[RoleStatus]:
        for r in self.roles:
            if r.name == name:
                return r
        return None


@dataclasses.dataclass
class RoleBasedGroup:
    kind: str = "RoleBasedGroup"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: RoleBasedGroupSpec = dataclasses.field(default_factory=RoleBasedGroupSpec)
    status: RoleBasedGroupStatus = dataclasses.field(default_factory=RoleBasedGroupStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class GroupTemplate:
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: RoleBasedGroupSpec = dataclasses.field(default_factory=RoleBasedGroupSpec)


@dataclasses.dataclass
class RoleBasedGroupSetSpec:
    replicas: int = 1
    template: GroupTemplate = dataclasses.field(default_factory=GroupTemplate)
    # Fleet rollout staging: at most this many child groups (int or
    # percent of replicas, rounded down) may be unavailable (not Ready) at
    # once while template changes propagate.
    # <=0 = unbounded (update every drifted group simultaneously — the
    # reference's behavior, ``rolebasedgroupset_controller.go:168-177``);
    # the default of 1 rolls the fleet one cell at a time, each cell's own
    # rolling-update machinery staging its pods in turn.
    max_unavailable: IntOrStr = 1


@dataclasses.dataclass
class RoleBasedGroupSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    # In-range child groups whose spec/labels/annotations match the current
    # template (fleet-rollout progress counter).
    updated_replicas: int = 0
    observed_generation: int = 0


@dataclasses.dataclass
class RoleBasedGroupSet:
    """Replicated RBGs from a template (reference: inventory #7,
    ``rolebasedgroupset_controller.go``)."""

    kind: str = "RoleBasedGroupSet"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: RoleBasedGroupSetSpec = dataclasses.field(default_factory=RoleBasedGroupSetSpec)
    status: RoleBasedGroupSetStatus = dataclasses.field(default_factory=RoleBasedGroupSetStatus)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class RoleTemplate:
    """Reusable role template (KEP-8 reduce-yaml-duplication)."""

    kind: str = "RoleTemplate"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    template: PodTemplate = dataclasses.field(default_factory=PodTemplate)

    __serde_keep__ = ("kind", "metadata")
