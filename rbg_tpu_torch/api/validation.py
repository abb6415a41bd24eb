"""Admission-style validation.

Reference analog: ``rolebasedgroup_admission.go:42-84`` +
``rolebasedgroup_validation.go:31-153`` (webhook validation). Here it runs at
the store boundary / controller entry instead of an HTTP webhook — same
checks, same failure surface (reject before any child object is created).
"""

from __future__ import annotations

import re
from typing import List

from rbg_tpu_torch.api.group import PatternType, RoleBasedGroup

_DNS_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


class ValidationError(Exception):
    def __init__(self, errors):
        if isinstance(errors, str):
            errors = [errors]
        self.errors = list(errors)
        super().__init__("; ".join(self.errors))


def validate_group(rbg: RoleBasedGroup) -> None:
    errs: List[str] = []
    if not rbg.metadata.name or not _DNS_RE.match(rbg.metadata.name):
        errs.append(f"metadata.name {rbg.metadata.name!r} must be DNS-1123")
    seen = set()
    names = {r.name for r in rbg.spec.roles}
    for i, role in enumerate(rbg.spec.roles):
        path = f"spec.roles[{i}]"
        if not role.name or not _DNS_RE.match(role.name):
            errs.append(f"{path}.name {role.name!r} must be DNS-1123")
        if role.name in seen:
            errs.append(f"{path}.name {role.name!r} duplicated")
        seen.add(role.name)
        if role.replicas < 0:
            errs.append(f"{path}.replicas must be >= 0")
        for d in role.dependencies:
            if d not in names:
                errs.append(f"{path} depends on unknown role {d!r}")
            if d == role.name:
                errs.append(f"{path} depends on itself")
        if role.pattern == PatternType.LEADER_WORKER:
            lw_size = role.leader_worker.size if role.leader_worker else 0
            if not lw_size and not (role.tpu and role.tpu.slice_topology):
                errs.append(f"{path}: leaderWorker needs leaderWorker.size or tpu.sliceTopology")
        if role.pattern == PatternType.CUSTOM_COMPONENTS and not role.components:
            errs.append(f"{path}: customComponents needs components")
        if role.tpu and role.tpu.slice_topology:
            if not re.match(r"^\d+(x\d+)*$", role.tpu.slice_topology):
                errs.append(f"{path}.tpu.sliceTopology {role.tpu.slice_topology!r} invalid")
        if role.network is not None:
            from rbg_tpu_torch.api.group import (SUBDOMAIN_SHARED,
                                           SUBDOMAIN_UNIQUE_PER_REPLICA)
            pol = role.network.subdomain_policy
            if pol not in (SUBDOMAIN_SHARED, SUBDOMAIN_UNIQUE_PER_REPLICA):
                errs.append(f"{path}.network.subdomainPolicy {pol!r} must be "
                            f"Shared or UniquePerReplica")
            elif (pol == SUBDOMAIN_UNIQUE_PER_REPLICA
                  and role.pattern != PatternType.LEADER_WORKER):
                # KEP-275 eligibility: only leaderWorker has the stable
                # per-replica identity per-instance services need. Reject,
                # never silently fall back.
                errs.append(f"{path}.network.subdomainPolicy UniquePerReplica "
                            f"requires pattern leaderWorker")
        from rbg_tpu_torch.api import intstr
        for knob in ("max_unavailable", "max_surge"):
            try:
                intstr.validate(getattr(role.rolling_update, knob),
                                f"{path}.rollingUpdate.{knob}")
            except ValueError as e:
                errs.append(str(e))
    if not rbg.spec.roles:
        errs.append("spec.roles must not be empty")
    # cycle check
    try:
        from rbg_tpu_torch.coordination.dependency import sort_roles
        sort_roles(rbg.spec.roles)
    except Exception as e:
        errs.append(str(e))
    if errs:
        raise ValidationError(errs)
