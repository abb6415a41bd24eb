"""Intra-role component discovery + startup/deletion ordering (KEP-173).

Reference analog: ``pkg/component-discovery`` (inventory #17, Appendix D):
annotation-declared dependencies on a component's pod template::

    rbg.tpu.x-k8s.io/component-depends-on: '{"startAfter": ["cache"]}'

* startAfter: the component's pods are created only after every listed
  component reports ReadyReplicas == Size.
* deleteAfter: overrides the default deletion order (reverse of start order).
* cycles: logged, fall back to parallel startup (never deadlock).

Intra-role discovery env: every component pod gets
``RBG_COMPONENT_{NAME}_ADDRESSES`` (comma-joined sibling addresses) for each
other component of the instance.
"""

from __future__ import annotations

import json
from typing import Dict, List, Set

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.pod import EnvVar


def parse_dependencies(components) -> Dict[str, dict]:
    """component name -> {"start_after": [...], "delete_after": [...]}."""
    out = {}
    for comp in components:
        tmpl = comp.template
        raw = (tmpl.annotations if tmpl else {}).get(C.ANN_COMPONENT_DEPENDS_ON, "")
        start_after, delete_after = [], []
        if raw:
            try:
                cfg = json.loads(raw)
                start_after = [d for d in cfg.get("startAfter", []) if isinstance(d, str)]
                delete_after = [d for d in cfg.get("deleteAfter", []) if isinstance(d, str)]
            except json.JSONDecodeError:
                pass
        out[comp.name] = {"start_after": start_after, "delete_after": delete_after}
    return out


def staged_start(components) -> bool:
    """True when any component declares startAfter — such roles start staged
    and therefore never participate in gang scheduling (a gang would wait
    forever for pods the ordering engine withholds)."""
    deps = parse_dependencies(components)
    return any(d["start_after"] for d in deps.values())


def has_cycle(deps: Dict[str, dict]) -> bool:
    state: Dict[str, int] = {}

    def visit(n: str) -> bool:
        if state.get(n) == 1:
            return True
        if state.get(n) == 2:
            return False
        state[n] = 1
        for d in deps.get(n, {}).get("start_after", ()):
            if d in deps and visit(d):
                return True
        state[n] = 2
        return False

    return any(visit(n) for n in deps)


def startable_components(inst, ready_by_component: Dict[str, tuple]) -> Set[str]:
    """Components whose startAfter deps are fully ready. ``ready_by_component``
    maps name -> (ready, size). Cycles → everything startable (parallel)."""
    comps = inst.spec.instance.components
    deps = parse_dependencies(comps)
    names = {c.name for c in comps}
    if has_cycle(deps):
        return names
    out = set()
    for c in comps:
        ok = True
        for d in deps[c.name]["start_after"]:
            if d not in names:
                continue
            ready, size = ready_by_component.get(d, (0, 0))
            # size 0 = component disabled → trivially satisfied
            if size > 0 and ready < size:
                ok = False
                break
        if ok:
            out.add(c.name)
    return out


def deletion_order(components) -> List[str]:
    """Reverse of start order unless deleteAfter overrides (union of both
    constraint sets; reference: BuildDeletionGates)."""
    deps = parse_dependencies(components)
    names = [c.name for c in components]
    if has_cycle(deps):
        return names
    # X startAfter Y  ⇒  X deleted before Y; plus explicit deleteAfter edges.
    before: Dict[str, Set[str]] = {n: set() for n in names}
    for n in names:
        for d in deps[n]["start_after"]:
            if d in before:
                before[n].add(d)   # delete n before d
        for d in deps[n]["delete_after"]:
            if d in before:
                before[d].add(n)   # n deleted after d ⇒ d before n... (d first)
    out: List[str] = []
    temp: Set[str] = set()

    def visit(n: str):
        if n in out or n in temp:
            return
        temp.add(n)
        for m in names:
            if n in before[m]:   # m must be deleted before n
                visit(m)
        temp.discard(n)
        out.append(n)

    for n in names:
        visit(n)
    return out


def component_discovery_env(store, inst, component: str) -> List[EnvVar]:
    """Sibling component addresses for CustomComponents instances."""
    ns = inst.metadata.namespace
    group = inst.metadata.labels.get(C.LABEL_GROUP_NAME, "")
    role = inst.metadata.labels.get(C.LABEL_ROLE_NAME, "")
    svc = C.service_name(group, role)
    env = []
    for comp in inst.spec.instance.components:
        if comp.name == component:
            continue
        addrs = [
            f"{inst.metadata.name}-{comp.name}-{i}.{svc}" for i in range(comp.size)
        ]
        key = "RBG_COMPONENT_" + comp.name.upper().replace("-", "_") + "_ADDRESSES"
        env.append(EnvVar(key, ",".join(addrs)))
    return env
