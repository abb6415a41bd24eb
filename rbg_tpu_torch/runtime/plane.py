"""ControlPlane — assembly of store + controllers + pod backend.

The ``main()`` equivalent (reference: ``cmd/rbgs/main.go:126``: scheme, cache,
controller registration, shared NodeBindingStore, health). Backends:

* ``fake``  — FakeKubelet walks pods to Ready (envtest/kwok equivalent)
* ``local`` — real subprocesses on this host (rbg_tpu_torch.runtime.executor)
* ``none``  — no pod backend (tests drive pod status manually)

The port's copy of ``rbg_tpu/runtime/plane.py`` leaves out, for later slices,
the disruption, groupset, warmup, autoscale and topology controllers and the
``k8s`` backend; it registers the group, instance-set, instance, scheduler
and scaling-adapter controllers.
"""

from __future__ import annotations

import time
from typing import Optional

from rbg_tpu_torch.runtime.controller import Manager
from rbg_tpu_torch.runtime.kubelet import FakeKubelet
from rbg_tpu_torch.runtime.store import Store
from rbg_tpu_torch.sched.binding import NodeBindingStore
from rbg_tpu_torch.sched.scheduler import SchedulerController


class ControlPlane:
    def __init__(self, store: Optional[Store] = None, backend: str = "fake",
                 ready_delay: float = 0.0, executor_env: Optional[dict] = None,
                 health_timeout: float = 120.0):
        if backend not in ("fake", "local", "none"):
            raise ValueError(f"backend must be fake, local or none, got {backend!r}")
        self.store = store or Store()
        self.manager = Manager(self.store)
        self.node_binding = NodeBindingStore(self.store)
        from rbg_tpu_torch.portalloc import PortAllocatorService
        self.ports = PortAllocatorService(self.store)
        # The scheduler's warm-spare pool holds none: the disruption
        # controller that reserves and grants spares is a later slice.
        from rbg_tpu_torch.sched.capacity import SparePool
        self.spares = SparePool(0)

        from rbg_tpu_torch.runtime.controllers.group import RoleBasedGroupController
        from rbg_tpu_torch.runtime.controllers.instance import RoleInstanceController
        from rbg_tpu_torch.runtime.controllers.instanceset import RoleInstanceSetController
        from rbg_tpu_torch.runtime.controllers.scalingadapter import ScalingAdapterController

        self.group_controller = self.manager.register(
            RoleBasedGroupController(self.store, self.node_binding))
        self.instanceset_controller = self.manager.register(
            RoleInstanceSetController(self.store, ports=self.ports))
        self.instance_controller = self.manager.register(
            RoleInstanceController(self.store, self.node_binding, ports=self.ports))
        self.scheduler = self.manager.register(
            SchedulerController(self.store, self.node_binding,
                                spares=self.spares))
        self.manager.register(ScalingAdapterController(self.store))

        self.kubelet = None
        if backend == "fake":
            self.kubelet = FakeKubelet(self.store, ready_delay=ready_delay)
        elif backend == "local":
            from rbg_tpu_torch.runtime.executor import LocalExecutor
            self.kubelet = LocalExecutor(self.store, extra_env=executor_env,
                                         health_timeout=health_timeout)

    # ---- lifecycle ----

    def start(self):
        self.node_binding.reseed(self.store)
        self.manager.start()
        if self.kubelet is not None:
            self.kubelet.start()
        return self

    def stop(self):
        if self.kubelet is not None:
            self.kubelet.stop()
        self.manager.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- convenience ----

    def apply(self, *objects):
        """Create-or-update (kubectl apply equivalent)."""
        out = []
        for obj in objects:
            cur = self.store.get(obj.kind, obj.metadata.namespace, obj.metadata.name)
            if cur is None:
                out.append(self.store.create(obj))
            else:
                obj.metadata.resource_version = cur.metadata.resource_version
                obj.metadata.uid = cur.metadata.uid
                out.append(self.store.update(obj))
        return out if len(out) != 1 else out[0]

    def wait_for(self, fn, timeout: float = 10.0, interval: float = 0.02,
                 desc: str = "condition"):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                v = fn()
            except Exception:
                v = None
            if v:
                return v
            time.sleep(interval)
        raise TimeoutError(f"timed out waiting for {desc}")

    def wait_group_ready(self, name: str, namespace: str = "default",
                         timeout: float = 30.0):
        from rbg_tpu_torch.api import constants as C
        from rbg_tpu_torch.api.meta import get_condition

        def check():
            g = self.store.get("RoleBasedGroup", namespace, name)
            if g is None:
                return None
            c = get_condition(g.status.conditions, C.COND_READY)
            return g if (c is not None and c.status == "True") else None

        return self.wait_for(check, timeout=timeout, desc=f"group {name} Ready")
