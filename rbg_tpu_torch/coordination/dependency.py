"""Role startup dependency DAG.

Reference analog: ``pkg/dependency`` (inventory #21): DFS topo-sort into
levels with cycle detection (``dependencyOrder:129-205``); a role is blocked
until every dependency role's workload is Ready (``CheckDependencyReady:94``).
Canonical use: router depends on prefill+decode; decode depends on KV-pool.
"""

from __future__ import annotations

from typing import Dict, List

from rbg_tpu_torch.api.group import RoleBasedGroup, RoleSpec


class DependencyCycle(Exception):
    pass


def sort_roles(roles: List[RoleSpec]) -> List[List[RoleSpec]]:
    """Topo-sort roles into dependency levels (level 0 = no deps). Roles in
    one level start in parallel; level N waits for level N-1's readiness."""
    by_name = {r.name: r for r in roles}
    for r in roles:
        for d in r.dependencies:
            if d not in by_name:
                raise ValueError(f"role {r.name!r} depends on unknown role {d!r}")

    depth: Dict[str, int] = {}
    visiting: set = set()

    def visit(name: str) -> int:
        if name in depth:
            return depth[name]
        if name in visiting:
            raise DependencyCycle(f"dependency cycle involving role {name!r}")
        visiting.add(name)
        d = 0
        for dep in by_name[name].dependencies:
            d = max(d, visit(dep) + 1)
        visiting.discard(name)
        depth[name] = d
        return d

    for r in roles:
        visit(r.name)
    levels: List[List[RoleSpec]] = [[] for _ in range(max(depth.values(), default=0) + 1)]
    for r in roles:
        levels[depth[r.name]].append(r)
    return levels


def dependencies_ready(group: RoleBasedGroup, role: RoleSpec) -> bool:
    """A dependency is ready when its rolled-up RoleStatus.ready flag is set.

    The flag (not raw counter equality) is deliberate: ready_replicas is
    base-scoped and briefly dips during a zero-disruption surge rollout
    while a surge instance holds the capacity — dependents must not flap."""
    for dep in role.dependencies:
        spec = group.spec.role(dep)
        st = group.status.role(dep)
        if spec is None:
            return False
        if spec.replicas == 0:
            continue
        if st is None or not st.ready:
            return False
    return True
