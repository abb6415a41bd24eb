"""Label / annotation / env-var contracts — the per-object config plane.

Reference analog: ``api/workloads/constants`` (inventory #3,
``label.go:22-102``, ``annotation.go:22-228``, ``env.go:24-79``). Same role
here: labels ARE the data-plane contract (discovery reads them), annotations
are per-object feature flags, envs are what engines consume.

TPU-specific additions replace the GPU-era rendezvous contract
(``RBG_LWP_LEADER_ADDRESS`` consumed as torch ``--dist-init-addr``,
``env.go:56-68``) with the JAX distributed-init contract: coordinator
address, process index/count, slice topology, and mesh coordinates.
"""

DOMAIN = "rbg.tpu.x-k8s.io"

# ---- labels (identity; reference: label.go:22-102) ----
LABEL_GROUP_NAME = f"{DOMAIN}/group-name"
LABEL_ROLE_NAME = f"{DOMAIN}/role-name"
LABEL_GROUP_SET_NAME = f"{DOMAIN}/groupset-name"
LABEL_GROUP_SET_INDEX = f"{DOMAIN}/groupset-index"
LABEL_INSTANCE_NAME = f"{DOMAIN}/role-instance-name"
LABEL_INSTANCE_INDEX = f"{DOMAIN}/role-instance-index"
LABEL_COMPONENT_NAME = f"{DOMAIN}/component-name"
LABEL_COMPONENT_ID = f"{DOMAIN}/component-id"
LABEL_COMPONENT_INDEX = f"{DOMAIN}/component-index"
LABEL_SLICE_ORDINAL = f"{DOMAIN}/slice-ordinal"   # sub-gang id in multi-slice roles
LABEL_GROUP_REVISION = f"{DOMAIN}/group-revision"
LABEL_ROLE_REVISION_PREFIX = f"{DOMAIN}/role-revision-"
LABEL_REVISION_NAME = f"{DOMAIN}/revision-name"
LABEL_POD_GROUP = f"{DOMAIN}/pod-group"

# ---- annotations (feature flags; reference: annotation.go:22-228) ----
ANN_GANG_SCHEDULING = f"{DOMAIN}/gang-scheduling"        # "true"/"false"
ANN_EXCLUSIVE_TOPOLOGY = f"{DOMAIN}/exclusive-topology"  # topology key
ANN_INSTANCE_PATTERN = f"{DOMAIN}/role-instance-pattern"  # stateful|stateless
ANN_RESTART_TRIGGER_POLICY = f"{DOMAIN}/restart-trigger-policy"  # Ignore
# In-place scheduling (KEP-351; reference node_binding.go): mode is
# Preferred | Required | Disabled (our default when unset is Preferred —
# warm rebinding is the point of TPU slices; the reference defaults to off).
ANN_INPLACE_SCHEDULING = f"{DOMAIN}/in-place-scheduling"
# Pod | Component; unset = auto (stateful→Pod, stateless→Component,
# reference resolveGranularity, node_binding.go:191).
ANN_INPLACE_SCHEDULING_GRANULARITY = f"{DOMAIN}/in-place-scheduling-granularity"
# Comma-separated label keys → DoesNotExist node terms (avoid labels,
# node_binding.go:276 step 3).
ANN_INPLACE_SCHEDULING_AVOID = f"{DOMAIN}/in-place-scheduling-avoid"
ANN_PORT_ALLOCATOR = f"{DOMAIN}/port-allocator"          # JSON config
ANN_ALLOCATED_PORTS = f"{DOMAIN}/allocated-ports"        # JSON result
ANN_COMPONENT_DEPENDS_ON = f"{DOMAIN}/component-depends-on"  # JSON
ANN_SLICE_BINDING = f"{DOMAIN}/slice-binding"            # recorded slice id
# In-place update state on a Pod: JSON {revision, images, restarted,
# baselines, notReadyAt, grace} (reference analog: Kruise's
# apps.kruise.io/inplace-update-state, pkg/inplace inplace_update.go:223-316).
ANN_INPLACE_UPDATE_STATE = f"{DOMAIN}/inplace-update-state"
# PreparingDelete lifecycle (stateless scale-down drain; reference:
# statelessmode lifecycle states, constants.go:75-80): the instance keeps
# serving in-flight work until a drain agent acks (drain-complete=true) or
# the deadline passes, and may be resurrected by a scale-up.
ANN_LIFECYCLE_STATE = f"{DOMAIN}/lifecycle-state"    # PreparingDelete
ANN_DRAIN_DEADLINE = f"{DOMAIN}/drain-deadline"      # unix seconds
ANN_DRAIN_COMPLETE = f"{DOMAIN}/drain-complete"      # "true" from drain agent
LIFECYCLE_PREPARING_DELETE = "PreparingDelete"
ANN_DISCOVERY_CONFIG_MODE = f"{DOMAIN}/discovery-config-mode"  # legacy|refine

# ---- autoscaler contract (SLO-driven coordinated autoscaling) ----
# On a ScalingAdapter: the replica value the autoscaler last wrote. When
# spec.replicas differs from this stamp at the next evaluation, a FOREIGN
# writer (an external HPA, an operator) touched the adapter since our last
# write — the autoscaler backs off for one cycle and adopts the foreign
# value as its new baseline instead of silently clobbering it
# (last-writer-wins is how two controllers fight forever).
ANN_AUTOSCALE_LAST_WRITE = f"{DOMAIN}/autoscale-last-write"
# On a RoleInstance: scale-down preference stamped by the autoscaler from
# observed in-flight streams (lowest cost retired first — the k8s
# pod-deletion-cost analog). Consumed by the stateless instance engine's
# victim ordering; absent reads as 0.
ANN_SCALE_DOWN_COST = f"{DOMAIN}/scale-down-cost"

# ---- adaptive topology contract (aggregation <-> disaggregation) ----
# On a RoleBasedGroup, the runtime PD-shape state machine driven by the
# topology controller. Annotations are the ONLY persistent state — a
# plane restart resumes a mid-flight flip from them (same discipline as
# the migration state machine above).
ANN_TOPOLOGY_POSTURE = f"{DOMAIN}/topology-posture"    # unified|disagg
ANN_TOPOLOGY_STATE = f"{DOMAIN}/topology-state"        # Warming|CutOver|Draining
ANN_TOPOLOGY_TARGET = f"{DOMAIN}/topology-target"      # unified|disagg
ANN_TOPOLOGY_STARTED = f"{DOMAIN}/topology-flip-started"  # unix seconds
# Roles currently eligible for NEW traffic (JSON list) — the router
# candidacy set the cutover phase flips role-by-role.
ANN_TOPOLOGY_SERVING = f"{DOMAIN}/topology-serving-roles"

# ---- slice disruption lifecycle (GKE TPU failure domains) ----
# On a RoleInstance, the advance-notice migration state machine driven by
# the disruption controller: "" -> Warming -> CutOver -> (cleared).
ANN_MIGRATION_STATE = f"{DOMAIN}/migration-state"
ANN_MIGRATION_TARGET = f"{DOMAIN}/migration-target"    # target slice id
ANN_MIGRATION_FROM = f"{DOMAIN}/migration-from"        # source slice id
ANN_MIGRATION_DEADLINE = f"{DOMAIN}/migration-deadline"  # unix seconds
MIGRATION_WARMING = "Warming"
MIGRATION_CUTOVER = "CutOver"
# On a Node, stamped by the disruption controller once no active pod
# remains on a maintenance-pending slice: the slice is handed back to the
# infrastructure before its deadline (value = unix seconds of release).
ANN_MAINT_RELEASED = f"{DOMAIN}/maintenance-released"
# Marks a cordon the disruption controller itself placed ("disruption") —
# only those may be auto-lifted or kept sticky across node resyncs;
# operator cordons are never touched.
ANN_CORDONED_BY = f"{DOMAIN}/cordoned-by"
# Node disruption kinds (Node.disruption field / K8s node conditions).
DISRUPT_MAINTENANCE = "maintenance"   # advance notice, deadline attached
DISRUPT_PREEMPTED = "preempted"       # no-notice spot preemption
# Pod failure reasons the gang-recovery path recognizes.
REASON_PREEMPTED = "Preempted"        # host vanished under the pod
REASON_GANG_PREEMPTED = "GangPreempted"  # survivor killed by gang semantics

# ---- env vars injected into engine processes (reference: env.go:24-79) ----
ENV_GROUP_NAME = "RBG_GROUP_NAME"
ENV_ROLE_NAME = "RBG_ROLE_NAME"
ENV_ROLE_INDEX = "RBG_ROLE_INDEX"
ENV_ROLE_REPLICAS = "RBG_ROLE_REPLICAS"
ENV_COMPONENT_NAME = "RBG_COMPONENT_NAME"
ENV_CONFIG_PATH = "RBG_CONFIG_PATH"     # topology config mount path
ENV_POD_NAME = "RBG_POD_NAME"

# JAX distributed-init contract for multi-host slice roles. These replace the
# reference's leader-worker envs (RBG_LWP_LEADER_ADDRESS / RBG_LWP_WORKER_INDEX /
# RBG_LWP_GROUP_SIZE, env.go:56-68): engines call
# jax.distributed.initialize(coordinator_address, num_processes, process_id).
ENV_JAX_COORDINATOR = "RBG_JAX_COORDINATOR_ADDRESS"
ENV_JAX_NUM_PROCESSES = "RBG_JAX_NUM_PROCESSES"
ENV_JAX_PROCESS_ID = "RBG_JAX_PROCESS_ID"
ENV_TPU_SLICE_TOPOLOGY = "RBG_TPU_SLICE_TOPOLOGY"   # e.g. "2x4"
ENV_TPU_ACCELERATOR = "RBG_TPU_ACCELERATOR"         # e.g. "v5e"
ENV_TPU_MESH_COORDS = "RBG_TPU_MESH_COORDS"         # host coords in slice, "x,y"
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"  # multi-slice DCN
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
# Bumped on every gang restart cycle: a replacement gang must never join a
# stale coordinator incarnation mid-collective (the JAX coordinator treats a
# changed epoch as a fresh rendezvous namespace).
ENV_JAX_RESTART_EPOCH = "RBG_JAX_RESTART_EPOCH"

# ---- defaults ----
DISCOVERY_MOUNT_PATH = "/etc/rbg"
DISCOVERY_CONFIG_FILE = "config.yaml"
MAX_NAME_LEN = 63

# ---- condition types ----
COND_READY = "Ready"
COND_UPDATE_IN_PROGRESS = "UpdateInProgress"
COND_RESTART_IN_PROGRESS = "Restarting"
COND_ALL_PODS_READY = "AllPodsReady"
COND_INPLACE_UPDATE_READY = "InPlaceUpdateReady"


def workload_name(group: str, role: str) -> str:
    """Child workload name ``{group}-{role}`` truncated to 63 chars with
    trailing '-' trimmed (reference: helper.go:87-100)."""
    return f"{group}-{role}"[:MAX_NAME_LEN].rstrip("-")


def service_name(group: str, role: str) -> str:
    """Headless-service name ``s-{group}-{role}`` (DNS-1035: must not start
    with a digit — reference: helper.go:106-115)."""
    return f"s-{group}-{role}"[:MAX_NAME_LEN].rstrip("-")


def role_revision_label(role: str) -> str:
    return (LABEL_ROLE_REVISION_PREFIX + role)[:MAX_NAME_LEN]
