"""Env-var injection — the rendezvous half of service discovery.

Reference analog: ``pkg/discovery/env_builder.go:33-131`` (inventory #16):
identity envs (RBG_GROUP_NAME, RBG_ROLE_INDEX, ...) plus the leader-worker
rendezvous trio (RBG_LWP_LEADER_ADDRESS/WORKER_INDEX/GROUP_SIZE) that engines
consume as torch ``--dist-init-addr/--node-rank/--nnodes``.

TPU-first replacement: the trio becomes the **JAX distributed-init contract**
(coordinator address + process count/id), plus slice topology and mesh
coordinates, so engines can call::

    jax.distributed.initialize(
        os.environ["RBG_JAX_COORDINATOR_ADDRESS"],
        int(os.environ["RBG_JAX_NUM_PROCESSES"]),
        int(os.environ["RBG_JAX_PROCESS_ID"]))

Merge rule (reference: ``injector.go:183-246``): user-provided env wins; we
never clobber an existing name.
"""

from __future__ import annotations

from typing import List

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.group import PatternType
from rbg_tpu_torch.api.pod import EnvVar

JAX_COORDINATOR_PORT = 8476


def leader_address(inst, port: int = JAX_COORDINATOR_PORT) -> str:
    """Stable leader address ``{instance}-0.{service}:{port}`` (reference FQDN
    scheme ``{workload}-{i}.{headless-svc}``, ``config_builder.go:117-138``).
    The local executor resolves these names via the address registry."""
    group = inst.metadata.labels.get(C.LABEL_GROUP_NAME, "")
    role = inst.metadata.labels.get(C.LABEL_ROLE_NAME, "")
    svc = C.service_name(group, role)
    return f"{inst.metadata.name}-0.{svc}:{port}"


def build_env(inst, pod_name: str, component: str, process_id: int,
              gang_size: int) -> List[EnvVar]:
    labels = inst.metadata.labels
    group = labels.get(C.LABEL_GROUP_NAME, "")
    role = labels.get(C.LABEL_ROLE_NAME, "")
    env = [
        EnvVar(C.ENV_GROUP_NAME, group),
        EnvVar(C.ENV_ROLE_NAME, role),
        EnvVar(C.ENV_ROLE_INDEX, str(inst.spec.index) if inst.spec.index >= 0 else "0"),
        EnvVar(C.ENV_COMPONENT_NAME, component),
        EnvVar(C.ENV_POD_NAME, pod_name),
        EnvVar(C.ENV_CONFIG_PATH, f"{C.DISCOVERY_MOUNT_PATH}/{C.DISCOVERY_CONFIG_FILE}"),
    ]

    it = inst.spec.instance
    if it.pattern == PatternType.LEADER_WORKER:
        env += [
            EnvVar(C.ENV_JAX_COORDINATOR, leader_address(inst)),
            EnvVar(C.ENV_JAX_NUM_PROCESSES, str(gang_size)),
            EnvVar(C.ENV_JAX_PROCESS_ID, str(process_id)),
            # Fresh coordinator incarnation per gang-restart cycle: a
            # replacement gang recovering from a slice preemption must
            # rendezvous in a NEW namespace, never join the stale
            # collective of the incarnation it replaces.
            EnvVar(C.ENV_JAX_RESTART_EPOCH, str(inst.status.restart_count)),
        ]
    if it.tpu is not None:
        env += [
            EnvVar(C.ENV_TPU_SLICE_TOPOLOGY, it.tpu.slice_topology),
            EnvVar(C.ENV_TPU_ACCELERATOR, it.tpu.accelerator),
        ]
        if it.tpu.num_slices > 1:
            # Multi-slice: JAX/libtpu's MEGASCALE contract — one coordinator
            # for the whole job, slice id from the sub-gang ordinal.
            from rbg_tpu_torch.api.group import per_slice_size
            per = per_slice_size(it.leader_worker, it.tpu)
            env += [
                EnvVar(C.ENV_MEGASCALE_COORDINATOR,
                       leader_address(inst, port=JAX_COORDINATOR_PORT + 1)),
                EnvVar(C.ENV_MEGASCALE_NUM_SLICES, str(it.tpu.num_slices)),
                EnvVar(C.ENV_MEGASCALE_SLICE_ID, str(process_id // per)),
            ]
    return env
