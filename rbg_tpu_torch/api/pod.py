"""Pod / Node / Service resource model.

The control plane's smallest schedulable unit. On TPU, one Pod maps to one
*host* of a TPU slice (a v5e-64 slice = 16 hosts × 4 chips); a multi-host role
instance is a gang of Pods pinned to one slice's ICI domain.

Reference analog: corev1.Pod consumed throughout ``pkg/reconciler`` — here we
model only the surface the plane exercises (containers, env, ports, node
assignment, phase/conditions), which is also exactly what the local process
executor can honor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.meta import Condition, ObjectMeta


@dataclasses.dataclass
class EnvVar:
    name: str = ""
    value: str = ""


@dataclasses.dataclass
class Port:
    name: str = ""
    container_port: int = 0


@dataclasses.dataclass
class Resources:
    """Resource requests. ``tpu_chips`` is the TPU analog of the reference's
    GPU-implicit resources (``google.com/tpu`` in GKE terms)."""

    cpu: float = 0.0
    memory_gb: float = 0.0
    tpu_chips: int = 0


@dataclasses.dataclass
class Container:
    name: str = ""
    image: str = ""
    command: List[str] = dataclasses.field(default_factory=list)
    args: List[str] = dataclasses.field(default_factory=list)
    env: List[EnvVar] = dataclasses.field(default_factory=list)
    ports: List[Port] = dataclasses.field(default_factory=list)
    resources: Resources = dataclasses.field(default_factory=Resources)


@dataclasses.dataclass
class PodTemplate:
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    init_containers: List[Container] = dataclasses.field(default_factory=list)
    containers: List[Container] = dataclasses.field(default_factory=list)
    volumes: List[str] = dataclasses.field(default_factory=list)
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    scheduler_hints: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeAffinityTerm:
    """Preferred/required node affinity (reference analog: the nodeAffinity
    injection of in-place scheduling, ``sync/node_binding.go:276``)."""

    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = dataclasses.field(default_factory=list)
    required: bool = False
    weight: int = 1


@dataclasses.dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    # Machine-readable failure reason (reference analog: corev1 Pod
    # status.reason — "Evicted", "UnexpectedAdmissionError", ...; consumed
    # by the inactive-pod handling of keps/inactive-pod-handling).
    reason: str = ""
    ready: bool = False
    node_name: str = ""
    pod_ip: str = ""
    restart_count: int = 0
    container_restarts: Dict[str, int] = dataclasses.field(default_factory=dict)
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    observed_revision: str = ""
    start_time: float = 0.0

    __serde_keep__ = ("phase",)


@dataclasses.dataclass
class Pod:
    kind: str = "Pod"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    template: PodTemplate = dataclasses.field(default_factory=PodTemplate)
    node_name: str = ""          # scheduling result (binding)
    affinity: List[NodeAffinityTerm] = dataclasses.field(default_factory=list)
    status: PodStatus = dataclasses.field(default_factory=PodStatus)

    __serde_keep__ = ("kind", "metadata")

    @property
    def active(self) -> bool:
        """Active = not terminal and not terminating (reference analog:
        inactive-pod handling, keps/inactive-pod-handling)."""
        return (
            self.metadata.deletion_timestamp is None
            and self.status.phase not in ("Succeeded", "Failed")
        )

    @property
    def inactive_reason(self) -> str:
        """Why this pod is inactive (reference: GetPodInactiveReason,
        keps/inactive-pod-handling): Evicted / UnexpectedAdmissionError /
        the raw reason / the terminal phase / Terminating; empty = active."""
        if self.active:
            return ""
        if self.metadata.deletion_timestamp is not None:
            return "Terminating"
        if self.evicted:
            return "Evicted"
        if self.status.reason:
            return self.status.reason
        return self.status.phase  # Failed | Succeeded

    @property
    def evicted(self) -> bool:
        """Evicted by node pressure / disruption (reference: IsPodEvicted —
        Failed + reason Evicted or a DisruptionTarget condition)."""
        if self.status.phase != "Failed":
            return False
        if self.status.reason == "Evicted":
            return True
        return any(c.type == "DisruptionTarget" and c.status == "True"
                   for c in self.status.conditions)

    @property
    def inplace_update_pending(self) -> bool:
        """An in-place update readiness gate is held (reference analog: the
        InPlaceUpdateReady readinessGate, ``pkg/inplace/pod/readiness``)."""
        return any(c.type == C.COND_INPLACE_UPDATE_READY and c.status == "False"
                   for c in self.status.conditions)

    @property
    def running_ready(self) -> bool:
        return (self.active and self.status.phase == "Running"
                and self.status.ready and not self.inplace_update_pending)


@dataclasses.dataclass
class TpuNodeInfo:
    """TPU identity of a node (GKE analog: cloud.google.com/gke-tpu-topology
    and google.com/tpu labels; see SURVEY.md §7 step 5)."""

    accelerator: str = ""       # v5e | v5p | v4 ...
    slice_id: str = ""          # one ICI domain == one slice id
    slice_topology: str = ""    # e.g. "4x4"
    worker_index: int = 0       # host index within the slice
    chips: int = 0              # chips on this host
    mesh_coords: str = ""       # host coordinates within the slice, "x,y[,z]"


@dataclasses.dataclass
class Node:
    kind: str = "Node"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    tpu: TpuNodeInfo = dataclasses.field(default_factory=TpuNodeInfo)
    capacity_pods: int = 64
    ready: bool = True
    address: str = "127.0.0.1"
    # Disruption lifecycle (GKE analog: maintenance events + spot
    # preemption hit ALL hosts of a slice together — same ICI domain):
    # ``unschedulable`` is the cordon bit (kubectl cordon / spec.
    # unschedulable); ``disruption`` is "" | maintenance | preempted;
    # ``disruption_deadline`` (unix seconds) is the advance-notice window
    # end for maintenance — by then the slice must be released.
    unschedulable: bool = False
    disruption: str = ""
    disruption_deadline: float = 0.0

    __serde_keep__ = ("kind", "metadata")

    @property
    def schedulable(self) -> bool:
        return self.ready and not self.unschedulable and not self.disruption


@dataclasses.dataclass
class Service:
    """Headless-service equivalent: a stable DNS-ish name selecting pods.

    Reference analog: ``svc_reconciler.go:48-179``; per-instance FQDNs
    ``{workload}-{i}.{svc}`` are generated by discovery
    (``config_builder.go:117-138``).
    """

    kind: str = "Service"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    leader_only: bool = False   # sharedServiceSelection: LeaderOnly (KEP-260)

    __serde_keep__ = ("kind", "metadata")


@dataclasses.dataclass
class ConfigMap:
    """Key→string data bundle mounted into pods (discovery topology config;
    reference analog: corev1.ConfigMap written by
    ``pkg/discovery/config_builder.go``)."""

    kind: str = "ConfigMap"
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    data: Dict[str, str] = dataclasses.field(default_factory=dict)

    __serde_keep__ = ("kind", "metadata")
