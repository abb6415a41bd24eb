"""Node-binding store: warm-placement memory for in-place scheduling.

Reference analog: ``pkg/reconciler/roleinstance/sync/node_binding.go``
(inventory #14, KEP-351): an in-memory map of where a group's pods last ran
Running+Ready, injected as node affinity on recreation so pods return to
warm nodes. Reference-parity features:

* **Granularity** (``node_binding.go:191``): ``Pod`` — one binding per pod
  name (stateful sets: deterministic names reattach to their own node);
  ``Component`` — pods of a role+component share one accumulating node set
  (stateless: random names, any warm node of the component will do). Unset
  = auto: stateful (has the instance-index label) → Pod, else Component.
* **Mode** (``node_binding.go:276``): ``Preferred`` (weight-scored) or
  ``Required`` (hard constraint). Deviation from the reference: unset means
  Preferred here, not off — on TPU the warm host holds the XLA compile
  cache and staged weights, so warm rebinding is the default posture.
  ``Disabled`` opts out.
* **Avoid labels** (``:276`` step 3, ``foldIntoRequired:409``): annotation
  lists label keys; each becomes a REQUIRED DoesNotExist term. Our affinity
  model ANDs all required terms (no K8s OR-of-terms), so the reference's
  fold-into-every-term is the native semantic here.

TPU extension (SURVEY.md §7 "hard parts"): bindings also record **slice**
identity — a recovered multi-host instance must re-acquire the *same slice*
(same ICI domain) to reuse host-side HBM state and XLA caches.

Non-durable by design; reseeded from live pods after a controller restart
(reference: ``node_binding.go:200-204``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.pod import NodeAffinityTerm
from rbg_tpu_torch.utils.locktrace import named_lock
# The port has no racetrace: the reference's @_race_guard is left out.

GRANULARITY_POD = "Pod"
GRANULARITY_COMPONENT = "Component"
MODE_PREFERRED = "Preferred"
MODE_REQUIRED = "Required"
MODE_DISABLED = "Disabled"


def resolve_granularity(pod, annotations: Optional[dict] = None) -> str:
    """Reference ``resolveGranularity`` (``node_binding.go:191``): explicit
    annotation wins; else stateful pods (instance-index label) bind per-Pod
    and stateless per-Component."""
    g = (annotations or {}).get(C.ANN_INPLACE_SCHEDULING_GRANULARITY, "")
    if g in (GRANULARITY_POD, GRANULARITY_COMPONENT):
        return g
    if C.LABEL_INSTANCE_INDEX in pod.metadata.labels:
        return GRANULARITY_POD
    return GRANULARITY_COMPONENT


def avoid_terms(annotations: Optional[dict]) -> list:
    """DoesNotExist terms from the avoid annotation (comma-separated label
    keys). Always REQUIRED — ANDed with everything else."""
    raw = (annotations or {}).get(C.ANN_INPLACE_SCHEDULING_AVOID, "")
    out = []
    for key in raw.split(","):
        key = key.strip()
        if key:
            out.append(NodeAffinityTerm(key=key, operator="DoesNotExist",
                                        required=True))
    return out


class NodeBindingStore:
    def __init__(self, store=None):
        self._lock = named_lock("sched.node_binding")
        # scope key -> node names  # guarded_by[sched.node_binding]
        self._nodes: Dict[str, Set[str]] = {}
        # scope key -> slice id  # guarded_by[sched.node_binding]
        self._slices: Dict[str, str] = {}
        self._store = store

    @staticmethod
    def scope_key(pod, granularity: str) -> Optional[str]:
        """Reference ``buildKey`` (``node_binding.go:150-186``), namespace-
        qualified (same-named groups in other namespaces are isolated)."""
        grp = pod.metadata.labels.get(C.LABEL_GROUP_NAME, "")
        if not grp:
            return None
        base = f"{pod.metadata.namespace}/{grp}"
        if granularity == GRANULARITY_POD:
            return f"{base}/pod/{pod.metadata.name}"
        role = pod.metadata.labels.get(C.LABEL_ROLE_NAME, "")
        comp = pod.metadata.labels.get(C.LABEL_COMPONENT_NAME, "")
        if not role or not comp:
            return None
        return f"{base}/comp/{role}-{comp}"

    def record(self, pod, node, annotations: Optional[dict] = None) -> None:
        """Record a Running+Ready pod's placement."""
        if node is None:
            return
        key = self.scope_key(pod, resolve_granularity(pod, annotations))
        if key is None:
            return
        with self._lock:
            self._nodes.setdefault(key, set()).add(node.metadata.name)
            if node.tpu.slice_id:
                self._slices[key] = node.tpu.slice_id

    def preferred_nodes(self, pod, annotations: Optional[dict] = None) -> Set[str]:
        key = self.scope_key(pod, resolve_granularity(pod, annotations))
        with self._lock:
            return set(self._nodes.get(key, ())) if key else set()

    def preferred_slice(self, pod,
                        annotations: Optional[dict] = None) -> Optional[str]:
        key = self.scope_key(pod, resolve_granularity(pod, annotations))
        with self._lock:
            return self._slices.get(key) if key else None

    def affinity_terms(self, pod, annotations: Optional[dict] = None) -> list:
        """Warm-node affinity + avoid constraints for a pod about to be
        (re)created (reference ``InjectInPlaceScheduling``,
        ``node_binding.go:276``)."""
        mode = (annotations or {}).get(C.ANN_INPLACE_SCHEDULING,
                                       MODE_PREFERRED)
        if mode not in (MODE_PREFERRED, MODE_REQUIRED):
            return []           # Disabled / unrecognized: inject nothing
        # Exclusive-topology pods: the topology constraint owns placement
        # (reference step 2 — conflicting hard affinities would deadlock).
        if pod.metadata.annotations.get(C.ANN_EXCLUSIVE_TOPOLOGY):
            return []
        terms = avoid_terms(annotations)
        # Slice-gang pods skip per-node warm terms: their warm rebinding is
        # SLICE-granular (ANN_SLICE_BINDING steers the whole gang back to
        # its ICI domain). Per-pod required `name In [...]` terms would
        # diverge across the gang and strand it — the gang placer filters
        # hosts by instance-level terms only.
        if pod.template.scheduler_hints.get("tpu-slice") == "true":
            return terms
        nodes = self.preferred_nodes(pod, annotations)
        if nodes:
            terms.append(NodeAffinityTerm(
                key="name", operator="In", values=sorted(nodes),
                required=(mode == MODE_REQUIRED), weight=10))
        return terms

    def retarget_slice(self, old_slice: str, new_slice: str,
                       group: Optional[str] = None,
                       namespace: str = "default") -> None:
        """Disruption migration: rewrite warm bindings that point at
        ``old_slice`` to ``new_slice`` and drop the per-node memory that
        backed them (the old hosts are being vacated — steering a
        recreated pod back to them would fight the cordon). Scoped to one
        group when given, else every binding on the old slice."""
        prefix = f"{namespace}/{group}/" if group else None
        with self._lock:
            for k, sid in list(self._slices.items()):
                if sid != old_slice:
                    continue
                if prefix is not None and not k.startswith(prefix):
                    continue
                self._slices[k] = new_slice
                self._nodes.pop(k, None)

    def evict_group(self, group: str, namespace: str = "default") -> None:
        """Drop all bindings of a group (on group delete; reference:
        ``rolebasedgroup_controller.go:1024-1040``). Namespace-scoped."""
        prefix = f"{namespace}/{group}/"
        with self._lock:
            for k in [k for k in self._nodes if k.startswith(prefix)]:
                del self._nodes[k]
            for k in [k for k in self._slices if k.startswith(prefix)]:
                del self._slices[k]

    def reseed(self, store) -> None:
        """Rebuild from live Running+Ready pods (controller restart).
        Granularity auto-resolves from pod labels; explicit per-instance
        granularity annotations re-apply on the next reconcile's record."""
        nodes = {n.metadata.name: n for n in store.list("Node")}
        with self._lock:
            self._nodes.clear()
            self._slices.clear()
        for pod in store.list("Pod"):
            if pod.running_ready and pod.node_name in nodes:
                self.record(pod, nodes[pod.node_name])
