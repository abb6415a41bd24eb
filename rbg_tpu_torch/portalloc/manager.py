"""Port allocation manager: annotation-driven allocation + env injection.

Reference analog: Appendix E — config arrives as a JSON annotation on the pod
template (``{DOMAIN}/port-allocator``); allocations persist as annotations
keyed ``{port-name}`` (role scope, on the RoleInstanceSet) or
``{pod}.{port-name}`` (pod scope, on the RoleInstance) and are injected at
pod-create time as env + annotation (``manager.go:48-121``). Reuse across
updates/restarts = the persisted annotation is read back before allocating.
Release: role-scoped ports on RIS deletion, pod-scoped on instance deletion.

Config format::

    rbg.tpu.x-k8s.io/port-allocator: '[{"name": "dist", "scope": "role"}]'

Injected env: ``RBG_PORT_{NAME}`` (upper-cased, dashes → underscores).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.portalloc.allocator import PortAllocator
from rbg_tpu_torch.utils.locktrace import named_lock

# guarded_by[portalloc.manager]
_singleton: Optional["PortAllocatorService"] = None
_lock = named_lock("portalloc.manager")


def parse_port_config(annotations: Dict[str, str]) -> List[dict]:
    raw = (annotations or {}).get(C.ANN_PORT_ALLOCATOR, "")
    if not raw:
        return []
    try:
        cfg = json.loads(raw)
    except json.JSONDecodeError:
        return []
    out = []
    for item in cfg if isinstance(cfg, list) else []:
        name = item.get("name")
        if not name:
            continue
        out.append({"name": name, "scope": item.get("scope", "role")})
    return out


def role_port_requests(instance_template) -> List[dict]:
    """Role-scoped requests from EVERY pod template of the instance
    (standalone template, leader/worker variants, component templates)."""
    templates = [instance_template.template]
    lw = instance_template.leader_worker
    if lw is not None:
        templates += [lw.leader_template, lw.worker_template]
    templates += [c.template for c in instance_template.components]
    seen, out = set(), []
    for t in templates:
        if t is None:
            continue
        for req in parse_port_config(t.annotations):
            if req["scope"] == "role" and req["name"] not in seen:
                seen.add(req["name"])
                out.append(req)
    return out


def env_name(port_name: str) -> str:
    return "RBG_PORT_" + port_name.upper().replace("-", "_")


class PortAllocatorService:
    """Plane-scoped allocation service. Reseeds from persisted annotations,
    releases on workload deletion (reference: cluster singleton wired in
    ``cmd/rbgs/main.go:458``)."""

    def __init__(self, store, allocator: Optional[PortAllocator] = None):
        self.store = store
        self.allocator = allocator or PortAllocator()
        self._reseed()
        store.watch("RoleInstanceSet", self._on_delete)
        store.watch("RoleInstance", self._on_delete)

    def _reseed(self):
        for kind in ("RoleInstanceSet", "RoleInstance"):
            for obj in self.store.list(kind):
                for port in self._parse_allocated(obj.metadata.annotations).values():
                    self.allocator.reserve(port)

    @staticmethod
    def _parse_allocated(annotations) -> Dict[str, int]:
        raw = (annotations or {}).get(C.ANN_ALLOCATED_PORTS, "")
        if not raw:
            return {}
        try:
            return {k: int(v) for k, v in json.loads(raw).items()}
        except (json.JSONDecodeError, ValueError, AttributeError):
            return {}

    def _on_delete(self, ev):
        from rbg_tpu_torch.runtime.store import Event
        if ev.type == Event.DELETED:
            for port in self._parse_allocated(ev.object.metadata.annotations).values():
                self.allocator.release(port)

    def _ensure_ports(self, kind: str, ns: str, name: str,
                      requests: List[str], key_fn) -> Dict[str, int]:
        """Allocate missing ports and persist on the object's annotations.
        Race-safe: the merge runs inside the conflict-retried mutate, and
        allocations that lose (or never persist) are always released."""
        newly: Dict[str, int] = {}
        result: Dict[str, int] = {}

        def fn(obj):
            cur = self._parse_allocated(obj.metadata.annotations)
            changed = False
            for req_name in requests:
                key = key_fn(req_name)
                if key in cur:
                    continue
                if key not in newly:
                    port = self.allocator.allocate()
                    if port is None:
                        continue
                    newly[key] = port
                cur[key] = newly[key]
                changed = True
            result.clear()
            result.update(cur)
            if not changed:
                return False
            obj.metadata.annotations[C.ANN_ALLOCATED_PORTS] = json.dumps(
                cur, sort_keys=True)
            return True

        try:
            self.store.mutate(kind, ns, name, fn)
        finally:
            for key, port in newly.items():
                if result.get(key) != port:
                    self.allocator.release(port)  # lost the race / not persisted
        return result

    # ---- role-scoped allocation (instanceset reconcile path) ----

    def ensure_role_ports(self, ris):
        """Returns (allocations, changed)."""
        requests = [r["name"] for r in role_port_requests(ris.spec.instance)]
        if not requests:
            return {}, False
        before = self._parse_allocated(ris.metadata.annotations)
        result = self._ensure_ports("RoleInstanceSet", ris.metadata.namespace,
                                    ris.metadata.name, requests, lambda n: n)
        return result, result != before

    # ---- pod-scoped allocation + injection (instance reconcile path) ----

    def inject_pod_ports(self, inst, pod) -> None:
        """Inject role-scoped allocations (inherited from the RIS via instance
        annotations) and pod-scoped ones (persisted on the RoleInstance as
        ``{pod}.{name}`` so gang restarts reuse the same ports)."""
        from rbg_tpu_torch.api.pod import EnvVar

        pod_name = pod.metadata.name
        role_ports = {
            k: v for k, v in self._parse_allocated(inst.metadata.annotations).items()
            if "." not in k
        }
        if not role_ports:
            # Instance may predate the RIS allocation — read through to owner.
            ref = inst.metadata.controller_owner()
            if ref is not None and ref.kind == "RoleInstanceSet":
                ris = self.store.get("RoleInstanceSet", inst.metadata.namespace, ref.name)
                if ris is not None:
                    role_ports = self._parse_allocated(ris.metadata.annotations)

        pod_requests = [r["name"] for r in parse_port_config(pod.template.annotations)
                        if r["scope"] == "pod"]
        pod_ports: Dict[str, int] = {}
        if pod_requests:
            allocated = self._ensure_ports(
                "RoleInstance", inst.metadata.namespace, inst.metadata.name,
                pod_requests, lambda n: f"{pod_name}.{n}")
            pod_ports = {k.split(".", 1)[1]: v for k, v in allocated.items()
                         if k.startswith(pod_name + ".")}

        merged = {**role_ports, **pod_ports}
        if not merged:
            return
        pod.metadata.annotations[C.ANN_ALLOCATED_PORTS] = json.dumps(
            merged, sort_keys=True)
        env = [EnvVar(env_name(k), str(v)) for k, v in sorted(merged.items())]
        for c in pod.template.containers:
            have = {e.name for e in c.env}
            c.env.extend(e for e in env if e.name not in have)


def setup_port_allocator(store, start: int = 30000, range_: int = 5000) -> PortAllocatorService:
    """Install the plane-wide singleton (reference: SetupPortAllocator)."""
    global _singleton
    with _lock:
        _singleton = PortAllocatorService(store, PortAllocator(start, range_))
        return _singleton


def get_port_allocator() -> Optional[PortAllocatorService]:
    with _lock:
        return _singleton
