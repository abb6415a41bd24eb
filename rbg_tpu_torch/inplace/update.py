"""In-place update: image-only changes patch running pods without recreation.

Reference analog: ``pkg/inplace`` (inventory #15, Kruise-derived): the update
spec is computed as the diff of revisions; ONLY ``containers[x].image``
changes qualify (``inplace_update_defaults.go:76-95``) — anything else falls
back to recreate. On TPU this matters doubly: recreating a multi-host
instance tears down a whole slice gang and re-acquires it; an image-only
rollout keeps the slice, the HBM state, and the XLA compile cache warm.

Condition machinery (reference: ``inplace_update.go:223-316`` + readiness
gates in ``pkg/inplace/pod/readiness``):

* Starting an in-place update sets the pod condition
  ``InPlaceUpdateReady=False`` and records an update-state annotation with
  the target revision, the image map, and **per-container restart
  baselines** (the restart counts observed *before* the update).
* With a grace period (``rollingUpdate.graceSeconds``), the image patch is
  deferred: the pod first sits not-ready for the grace window so routers /
  endpoints drain it, then the images are applied
  (ref ``GracePeriodSeconds`` semantics in ``inplace_update.go:258-283``).
* The pod stays not-ready (``Pod.running_ready`` honors the condition as a
  readiness gate) until the node backend acknowledges the new revision
  (``status.observed_revision``) and reports ready again; the RoleInstance
  controller then flips the condition to ``True``.
* The baselines let the restart policy distinguish the *expected* container
  restart caused by the image swap from a crash
  (ref ``sync/instance_scale.go:542-607`` container-restart baselines) — an
  in-place update must never trip a full-gang (= full-slice) recreate.
"""

from __future__ import annotations

import copy
import json
import time
from typing import Dict, List, Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api import serde
from rbg_tpu_torch.api.meta import Condition, get_condition, set_condition
from rbg_tpu_torch.runtime.store import NotFound


def _normalize_images(it_dict: dict) -> dict:
    """Serialized instance template with every container image blanked."""
    d = copy.deepcopy(it_dict)

    def blank(tmpl):
        if not tmpl:
            return
        for c in tmpl.get("containers", []) + tmpl.get("initContainers", []):
            c["image"] = ""

    blank(d.get("template"))
    lw = d.get("leaderWorker") or {}
    blank(lw.get("leaderTemplate"))
    blank(lw.get("workerTemplate"))
    for comp in d.get("components", []):
        blank(comp.get("template"))
    return d


def image_only_diff(old_it, new_it) -> Optional[Dict[str, str]]:
    """If the two instance templates differ ONLY in container images, return
    {container name: new image}; else None."""
    old_d = serde.to_dict(old_it)
    new_d = serde.to_dict(new_it)
    if old_d == new_d:
        return {}
    if _normalize_images(old_d) != _normalize_images(new_d):
        return None
    images: Dict[str, str] = {}

    def collect(tmpl):
        if not tmpl:
            return
        for c in tmpl.get("containers", []) + tmpl.get("initContainers", []):
            if c.get("name") and c.get("image"):
                images[c["name"]] = c["image"]

    collect(new_d.get("template"))
    lw = new_d.get("leaderWorker") or {}
    collect(lw.get("leaderTemplate"))
    collect(lw.get("workerTemplate"))
    for comp in new_d.get("components", []):
        collect(comp.get("template"))
    return images


def _pod_containers(pod):
    return list(pod.template.containers) + list(pod.template.init_containers)


def _changed_containers(pod, images: Dict[str, str]) -> List[str]:
    """Containers on THIS pod whose image the update actually swaps (only
    these are expected to restart once)."""
    return [c.name for c in _pod_containers(pod)
            if c.name in images and c.image != images[c.name]]


def apply_images(pod, images: Dict[str, str], revision: str) -> bool:
    """Patch container images on the pod object; stamp the revision label."""
    changed = False
    for c in _pod_containers(pod):
        new_img = images.get(c.name)
        if new_img and c.image != new_img:
            c.image = new_img
            changed = True
    if changed or pod.metadata.labels.get(C.LABEL_REVISION_NAME) != revision:
        pod.metadata.labels[C.LABEL_REVISION_NAME] = revision
        changed = True
    return changed


def images_applied(pod, images: Dict[str, str]) -> bool:
    """True when every container named in the image map that exists on this
    pod already runs the target image."""
    return not _changed_containers(pod, images)


def load_state(pod) -> Optional[dict]:
    raw = pod.metadata.annotations.get(C.ANN_INPLACE_UPDATE_STATE)
    if not raw:
        return None
    try:
        state = json.loads(raw)
    except (ValueError, TypeError):
        return None
    return state if isinstance(state, dict) else None


def expected_restarts(pod) -> Optional[Dict[str, int]]:
    """Per-container allowed restart counts from the recorded baselines:
    ``baseline + 1`` for containers the in-place update swapped, ``baseline``
    for the rest. None when the pod has no in-place update history."""
    state = load_state(pod)
    if state is None:
        return None
    allowed: Dict[str, int] = {}
    restarted = set(state.get("restarted", []))
    for name, base in (state.get("baselines") or {}).items():
        try:
            allowed[name] = int(base) + (1 if name in restarted else 0)
        except (TypeError, ValueError):
            continue
    return allowed


def try_inplace_update(store, ris, inst, revision: str) -> bool:
    """Attempt an in-place update of ``inst`` to the RIS's current template.

    Only the RoleInstance itself is mutated here (spec + revision label).
    Pod staging/patching is **level-triggered** from the RoleInstance
    controller (``progress_inplace_updates``): any pod whose revision label
    lags the instance's gets converged there, so a crash or conflict at any
    point leaves a state the next reconcile repairs — there is no
    half-staged wedge (the label flip IS the durable intent record).
    Returns True when the update is eligible and recorded (no recreation).
    """
    images = image_only_diff(inst.spec.instance, ris.spec.instance)
    if images is None:
        return False  # structural change — recreate path

    ns = inst.metadata.namespace
    grace = float(getattr(ris.spec.rolling_update, "grace_seconds", 0.0) or 0.0)

    def fn(i):
        i.spec.instance = copy.deepcopy(ris.spec.instance)
        # The revision hash covers the restart policy too
        # (update_revision_of) — an in-place "update" that flipped only the
        # label would silently drop a restart-policy change forever.
        i.spec.restart_policy = copy.deepcopy(ris.spec.restart_policy)
        i.spec.inplace_grace_seconds = grace
        i.metadata.labels[C.LABEL_REVISION_NAME] = revision
        return True

    store.mutate("RoleInstance", ns, inst.metadata.name, fn)
    store.record_event(inst, "InPlaceUpdating",
                       f"updating images in place to revision {revision}")
    return True


def _target_images(tmpl) -> Dict[str, str]:
    if tmpl is None:
        return {}
    return {c.name: c.image
            for c in list(tmpl.containers) + list(tmpl.init_containers)
            if c.name and c.image}


def progress_inplace_updates(store, inst, pods, desired,
                             now: Optional[float] = None) -> Optional[float]:
    """Converge pods onto the instance's current revision in place; called
    from the RoleInstance reconcile with the ``desired_pods`` list.

    Per pod, by comparing the pod's revision label to the instance's:
    stage (gate ``InPlaceUpdateReady=False`` + record baselines), hold
    through the grace/drain window, patch images + label, then flip the
    gate once the node backend acks ``status.observed_revision``. Every
    step is idempotent and re-derivable, so partial progress (crash between
    mutates, conflict retries exhausted) self-heals on the next reconcile.
    Returns a requeue delay when a grace timer is pending (backend acks
    arrive as watch events)."""
    if now is None:
        now = time.time()
    ns = inst.metadata.namespace
    revision = inst.metadata.labels.get(C.LABEL_REVISION_NAME, "")
    targets = {name: tmpl for (name, _c, _i, _x, tmpl) in desired}
    grace = float(getattr(inst.spec, "inplace_grace_seconds", 0.0) or 0.0)
    delay: Optional[float] = None
    for pod in pods:
        pname = pod.metadata.name
        if pname not in targets or pod.metadata.deletion_timestamp is not None:
            continue  # surplus pods take the delete path
        cond = get_condition(pod.status.conditions, C.COND_INPLACE_UPDATE_READY)
        in_flight = cond is not None and cond.status == "False"
        pod_rev = pod.metadata.labels.get(C.LABEL_REVISION_NAME, "")
        if pod_rev == revision:
            if not in_flight:
                continue  # converged (history kept for baselines)
            # Images + label applied; wait for the backend ack, then release
            # the readiness gate.
            if (pod.status.observed_revision == revision
                    and pod.status.phase == "Running" and pod.status.ready):
                def done(p):
                    return set_condition(
                        p.status.conditions,
                        Condition(type=C.COND_INPLACE_UPDATE_READY,
                                  status="True",
                                  reason="InPlaceUpdateCompleted"),
                        now)

                try:
                    store.mutate("Pod", ns, pname, done, status=True)
                except NotFound:
                    continue
            continue

        # Pod lags the instance revision → in-place update in progress.
        images = _target_images(targets[pname])
        state = load_state(pod)
        if not _changed_containers(pod, images):
            # No container actually changes (restart-policy-only update, or
            # a rollback to images the pod already runs): nothing to drain,
            # nothing for the node backend to ack — stamp the label and
            # release any held gate NOW. Waiting for an observed_revision
            # ack would wedge forever on backends that only react to image
            # changes (the process executor restarts on generation bumps,
            # and a label-only patch doesn't bump the generation).
            try:
                store.mutate("Pod", ns, pname,
                             lambda p: apply_images(p, images, revision))
                if in_flight:
                    def release(p):
                        return set_condition(
                            p.status.conditions,
                            Condition(type=C.COND_INPLACE_UPDATE_READY,
                                      status="True",
                                      reason="NoContainerChange"),
                            now)
                    store.mutate("Pod", ns, pname, release, status=True)
            except NotFound:
                pass
            continue
        if not in_flight or state is None or state.get("revision") != revision:
            # (Re)stage: not-ready gate FIRST (a watcher must never see new
            # images on a ready pod), then record state. Restaging after a
            # partial crash or a newer revision landing mid-grace rewrites
            # the state against the pod's CURRENT images, so baselines and
            # the restart allowance stay truthful.
            def gate(p):
                return set_condition(
                    p.status.conditions,
                    Condition(type=C.COND_INPLACE_UPDATE_READY, status="False",
                              reason="StartInPlaceUpdate"),
                    now)

            def stage(p):
                st = {
                    "revision": revision,
                    "images": images,
                    "restarted": _changed_containers(p, images),
                    "baselines": {c.name: p.status.container_restarts.get(c.name, 0)
                                  for c in _pod_containers(p)},
                    "notReadyAt": now,
                    "grace": grace,
                }
                p.metadata.annotations[C.ANN_INPLACE_UPDATE_STATE] = json.dumps(
                    st, sort_keys=True)
                if grace <= 0:
                    apply_images(p, images, revision)
                return True

            try:
                store.mutate("Pod", ns, pname, gate, status=True)
                store.mutate("Pod", ns, pname, stage)
            except NotFound:
                continue  # deleted mid-update — scale path recreates
            if grace > 0:
                delay = grace if delay is None else min(delay, grace)
            continue

        # Staged and in grace: patch once the drain window elapses.
        at = float(state.get("notReadyAt", 0.0)) + float(state.get("grace", 0.0))
        if now < at:
            wait = at - now
            delay = wait if delay is None else min(delay, wait)
            continue
        try:
            store.mutate("Pod", ns, pname,
                         lambda p: apply_images(p, images, revision))
        except NotFound:
            continue
        # Backend restart/ack arrives as a pod status event.
    return delay
