"""Pod lifecycle backends.

``FakeKubelet`` — the envtest/kwok equivalent (SURVEY.md §4: tests drive pod
status because no kubelet exists; the stress harness uses kwok fake nodes).
It watches Pods and walks scheduled ones to Running/Ready after a configurable
delay, with injectable failure hooks for chaos tests.

The real-process executor (``rbg_tpu_torch.runtime.executor``, M7) implements the
same contract by spawning actual engine processes on the TPU host.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.constants import DOMAIN as _DOMAIN
from rbg_tpu_torch.runtime.store import Conflict, Event, NotFound, Store
from rbg_tpu_torch.utils.locktrace import named_lock
# The port has no racetrace: the reference's @_race_guard is left out.


class FakeKubelet:
    """Moves scheduled pods through the lifecycle:
    Pending+node → Running(ready) after ``ready_delay``; honors graceful
    deletion by finalizing after ``terminate_delay``.
    """

    def __init__(
        self,
        store: Store,
        ready_delay: float = 0.0,
        terminate_delay: float = 0.0,
        fail_filter: Optional[Callable[[object], bool]] = None,
    ):
        self.store = store
        self.ready_delay = ready_delay
        self.terminate_delay = terminate_delay
        self.fail_filter = fail_filter
        # Pods matching hold_filter stay Pending (slow-start simulation)
        # until release_holds() clears the filter and re-walks them.
        self.hold_filter: Optional[Callable[[object], bool]] = None
        self._timers: list = []  # guarded_by[runtime.kubelet]
        self._lock = named_lock("runtime.kubelet")
        self._stopped = False  # guarded_by[runtime.kubelet]
        # Shared pool: a thread PER pod event melted create bursts.
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=4,
                                        thread_name_prefix="fakekubelet")

    def start(self):
        self.store.watch("Pod", self._on_event)
        # Adopt pods that already exist.
        for pod in self.store.list("Pod"):
            self._on_event(Event(Event.ADDED, pod))

    def stop(self):
        with self._lock:
            self._stopped = True
            for t in self._timers:
                t.cancel()
            self._timers.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _later(self, delay: float, fn, *args):
        with self._lock:
            if self._stopped:
                return
            if delay <= 0:
                self._pool.submit(fn, *args)
                return
            t = threading.Timer(delay, fn, args)
            t.daemon = True
            t.start()
            self._timers.append(t)
            if len(self._timers) > 256:
                self._timers = [x for x in self._timers if x.is_alive()]

    def _on_event(self, ev: Event):
        pod = ev.object
        if ev.type == Event.DELETED:
            return
        if pod.metadata.deletion_timestamp is not None:
            self._later(self.terminate_delay, self._finalize, Store.key(pod))
            return
        if pod.node_name and pod.status.phase == "Pending":
            if self.hold_filter is not None and self.hold_filter(pod):
                return
            if self.fail_filter is not None and self.fail_filter(pod):
                self._later(self.ready_delay, self._set_phase, Store.key(pod), "Failed")
            else:
                self._later(self.ready_delay, self._make_ready, Store.key(pod))
            return
        # In-place update ack: a Running pod whose images were patched gets
        # its updated containers "restarted" (counts bumped) and reports the
        # new revision — the envtest stand-in for a kubelet applying an
        # image-only pod update.
        if pod.status.phase == "Running":
            from rbg_tpu_torch.inplace.update import images_applied, load_state
            state = load_state(pod)
            if (state and state.get("revision")
                    and state["revision"] != pod.status.observed_revision
                    and images_applied(pod, state.get("images") or {})):
                self._later(self.ready_delay, self._ack_inplace, Store.key(pod))

    def _make_ready(self, key):
        kind, ns, name = key
        try:
            node = None
            pod = self.store.get(kind, ns, name, copy_=False)
            if pod is None or pod.metadata.deletion_timestamp is not None:
                return
            if pod.node_name:
                node = self.store.get("Node", "default", pod.node_name, copy_=False)

            run_to_completion = (
                pod.metadata.annotations.get(f"{_DOMAIN}/run-to-completion") == "true"
            )

            def fn(p):
                if p.status.phase != "Pending":
                    return False
                # Job-style pods (warmup) complete immediately in the fake.
                p.status.phase = "Succeeded" if run_to_completion else "Running"
                p.status.ready = not run_to_completion
                p.status.node_name = p.node_name
                p.status.pod_ip = node.address if node else "127.0.0.1"
                p.status.start_time = time.time()
                p.status.observed_revision = p.metadata.labels.get(
                    C.LABEL_REVISION_NAME, p.status.observed_revision)
                return True

            self.store.mutate(kind, ns, name, fn, status=True)
        except (NotFound, Conflict):
            pass  # pod vanished / raced — the fake has no retry loop

    def _ack_inplace(self, key):
        """Apply an in-place update at the node level: bump restart counts
        for the swapped containers and report the new revision."""
        kind, ns, name = key
        from rbg_tpu_torch.inplace.update import images_applied, load_state
        try:
            def fn(p):
                state = load_state(p)
                if (not state or p.status.phase != "Running"
                        or state.get("revision") == p.status.observed_revision
                        or not images_applied(p, state.get("images") or {})):
                    return False
                for c in state.get("restarted", []):
                    p.status.container_restarts[c] = (
                        p.status.container_restarts.get(c, 0) + 1)
                    p.status.restart_count += 1
                p.status.observed_revision = state["revision"]
                p.status.ready = True
                return True

            self.store.mutate(kind, ns, name, fn, status=True)
        except (NotFound, Conflict):
            pass

    def _set_phase(self, key, phase: str):
        kind, ns, name = key
        try:
            def fn(p):
                p.status.phase = phase
                p.status.ready = False
                return True

            self.store.mutate(kind, ns, name, fn, status=True)
        except (NotFound, Conflict):
            pass

    def _finalize(self, key):
        kind, ns, name = key
        try:
            self.store.finalize_delete(kind, ns, name)
        except (NotFound, Conflict):
            pass

    # ---- test helpers (drive status manually, envtest style) ----

    def release_holds(self):
        """Clear hold_filter and walk every held (still-Pending) pod."""
        self.hold_filter = None
        for pod in self.store.list("Pod"):
            self._on_event(Event(Event.ADDED, pod))

    def fail_pod(self, ns: str, name: str, reason: str = ""):
        def fn(p):
            p.status.phase = "Failed"
            p.status.ready = False
            if reason:
                p.status.reason = reason
            return True

        self.store.mutate("Pod", ns, name, fn, status=True)

    def evict_pod(self, ns: str, name: str):
        """Node-pressure eviction (keps/inactive-pod-handling story 1)."""
        self.fail_pod(ns, name, reason="Evicted")

    def restart_container(self, ns: str, name: str, container: str = "main"):
        def fn(p):
            p.status.container_restarts[container] = p.status.container_restarts.get(container, 0) + 1
            p.status.restart_count += 1
            return True

        self.store.mutate("Pod", ns, name, fn, status=True)
