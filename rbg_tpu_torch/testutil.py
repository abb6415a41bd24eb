"""Test fixtures: fake TPU fleets + manifest builders.

Reference analog: ``test/wrappers/v1alpha2/*`` builder fixtures +
``test/stress/templates.go`` kwok node templates (SURVEY.md §4). Nodes carry
the TPU identity labels a GKE TPU nodepool would
(slice id / topology / worker index).
"""

from __future__ import annotations

from typing import List

from rbg_tpu_torch.api.group import (
    LeaderWorkerSpec, PatternType, RoleBasedGroup, RoleSpec, TpuSpec,
)
from rbg_tpu_torch.api.pod import Container, Node, PodTemplate, TpuNodeInfo


def make_tpu_nodes(store, slices: int = 2, hosts_per_slice: int = 2,
                   accelerator: str = "v5e", chips_per_host: int = 4) -> List[Node]:
    """Create ``slices`` fake slices × ``hosts_per_slice`` hosts each."""
    out = []
    for s in range(slices):
        for h in range(hosts_per_slice):
            n = Node()
            n.metadata.name = f"slice-{s}-host-{h}"
            n.metadata.namespace = "default"
            sid = f"slice-{s}"
            n.labels = {
                "tpu-accelerator": accelerator,
                "tpu-slice": sid,
                "topology.rbg.tpu/block": f"block-{s // 4}",
            }
            n.tpu = TpuNodeInfo(
                accelerator=accelerator, slice_id=sid,
                slice_topology=f"{hosts_per_slice * chips_per_host // 2}x2",
                worker_index=h, chips=chips_per_host,
                mesh_coords=f"{h},0",
            )
            out.append(store.create(n))
    return out


def simple_container(name: str = "engine", image: str = "engine:v1",
                     args: List[str] = ()) -> Container:
    return Container(name=name, image=image, command=["serve"], args=list(args))


def simple_role(name: str, replicas: int = 1, dependencies=(),
                image: str = "engine:v1") -> RoleSpec:
    return RoleSpec(
        name=name, replicas=replicas, dependencies=list(dependencies),
        template=PodTemplate(containers=[simple_container(image=image)]),
    )


def tpu_leaderworker_role(name: str, replicas: int = 1, topology: str = "2x4",
                          accelerator: str = "v5e", image: str = "engine:v1",
                          chips_per_host: int = 4) -> RoleSpec:
    return RoleSpec(
        name=name, replicas=replicas,
        pattern=PatternType.LEADER_WORKER,
        leader_worker=LeaderWorkerSpec(),
        tpu=TpuSpec(accelerator=accelerator, slice_topology=topology,
                    chips_per_host=chips_per_host),
        template=PodTemplate(containers=[simple_container(image=image)]),
    )


def make_group(name: str, *roles: RoleSpec, namespace: str = "default",
               annotations=None) -> RoleBasedGroup:
    g = RoleBasedGroup()
    g.metadata.name = name
    g.metadata.namespace = namespace
    g.metadata.annotations = dict(annotations or {})
    g.spec.roles = list(roles)
    return g
