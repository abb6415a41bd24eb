"""Stateful InstanceSet update engine — surge-aware rolling update planning.

Pure decision logic (no store access) so it is table-driven testable; the
RoleInstanceSetController executes the returned plan. Reference analog:
``pkg/reconciler/roleinstanceset/statefulmode/stateful_instance_set_control.go``
(:346-828 — the four-phase update pass) and
``stateful_instance_set_utils.go:488-592`` (computeTopology).

Semantics reproduced here:

* **Topology** — single source of truth for ordinal-range sizing.
  ``active_surge = min(max_surge, max(surge_needed, existing_valid_surge))``
  while base work remains, where ``surge_needed = healthy_old_in_base -
  max_unavailable``; stickiness drops once every base ordinal is at the
  update revision and healthy, so surge ramps down (ref ``:488-592``).
* **Budget** — ``effective_budget = max_unavailable + available_surge``;
  "free" targets (surge slots, terminating, *stably* unhealthy) do not
  consume it, costly (currently-available) targets do (ref ``:525-629``).
* **Stable-unhealthy window** — an instance must be observed unhealthy for
  ``STABLE_UNHEALTHY_SECONDS`` of consecutive time before it can be
  free-deleted, so transient status flap cannot cascade into deleting
  healthy replicas (ref ``:42-125``).
* **CurrentRevision advance guard** — multi-layer: in-rollout, partition
  fully consumed, prior persisted status concurrence, and every base
  ordinal observed at updateRev + healthy (ref ``:766-828``).

The repo's rolling-update knobs are plain ints (no percent strings); when
``max_surge == 0`` the unavailable budget is floored to 1 so the rollout
can always make progress (ref ``computeMaxUnavailable``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api import intstr
from rbg_tpu_torch.api.meta import get_condition

# Minimum CONSECUTIVE observed-unhealthy time before a base instance may be
# treated as "free" (cleanup-unhealthy semantics). Patched down in tests.
STABLE_UNHEALTHY_SECONDS = 10.0


def is_ready(inst) -> bool:
    c = get_condition(inst.status.conditions, C.COND_READY)
    return c is not None and c.status == "True"


def is_terminating(inst) -> bool:
    return inst.metadata.deletion_timestamp is not None


def is_available(inst, min_ready_seconds: int, now: float) -> Tuple[bool, float]:
    """Ready for at least ``min_ready_seconds``. Returns (available, wait):
    ``wait`` > 0 is the remaining window when ready-but-not-yet-available
    (reference: ``isInstanceRunningAndAvailable``)."""
    if not is_ready(inst) or is_terminating(inst):
        return False, 0.0
    if min_ready_seconds <= 0:
        return True, 0.0
    c = get_condition(inst.status.conditions, C.COND_READY)
    elapsed = now - c.last_transition_time
    if elapsed >= min_ready_seconds:
        return True, 0.0
    return False, min_ready_seconds - elapsed


def revision_of(inst) -> str:
    return inst.metadata.labels.get(C.LABEL_REVISION_NAME, "")


class HealthObserver:
    """Per-UID first-observed-unhealthy timestamps (ref ``:42-125``).

    ``observe`` is called once at the top of every reconcile with the full
    instance snapshot: healthy instances clear their entry (so flapping
    status can never accumulate the window), vanished UIDs are dropped (so
    the map cannot grow across delete-and-recreate cycles).
    """

    def __init__(self):
        self._since: Dict[str, float] = {}

    def observe(self, instances, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        live = set()
        for inst in instances:
            uid = inst.metadata.uid
            if not uid:
                continue
            live.add(uid)
            if is_ready(inst):
                self._since.pop(uid, None)
            else:
                self._since.setdefault(uid, now)
        for uid in [u for u in self._since if u not in live]:
            del self._since[uid]

    def stably_unhealthy(self, inst, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        first = self._since.get(inst.metadata.uid)
        return first is not None and (now - first) >= STABLE_UNHEALTHY_SECONDS

    def unhealthy_wait(self, inst, now: Optional[float] = None) -> Optional[float]:
        """Seconds until ``inst`` becomes stably unhealthy (None if healthy)."""
        now = time.time() if now is None else now
        first = self._since.get(inst.metadata.uid)
        if first is None:
            return None
        return max(0.0, STABLE_UNHEALTHY_SECONDS - (now - first))


@dataclasses.dataclass
class Topology:
    """Ordinal-range sizing for one reconcile (ref ``topology`` struct)."""

    replicas: int = 0
    end_ordinal: int = 0        # in-range ords are [0, end_ordinal)
    surge_start: int = 0        # == replicas
    partition: int = 0
    max_unavailable: int = 0
    max_surge: int = 0
    active_surge: int = 0
    in_rollout: bool = False


@dataclasses.dataclass
class UpdateAction:
    """One target to move to the update revision this pass."""

    name: str
    ordinal: int
    is_surge_slot: bool
    is_free: bool


@dataclasses.dataclass
class Plan:
    """What the controller should do this reconcile."""

    topology: Topology = dataclasses.field(default_factory=Topology)
    create: List[Tuple[str, int, str]] = dataclasses.field(default_factory=list)
    #        (name, ordinal, revision)
    condemn: List[str] = dataclasses.field(default_factory=list)
    updates: List[UpdateAction] = dataclasses.field(default_factory=list)
    requeue_after: Optional[float] = None

    def merge_requeue(self, after: Optional[float]) -> None:
        if after is None:
            return
        if self.requeue_after is None or after < self.requeue_after:
            self.requeue_after = max(0.05, after)


def _healthy_old_in_base(by_ord, topo: Topology, update_rev: str) -> int:
    """Ords in [partition, replicas) healthy at a non-update revision
    (ref ``countHealthyOldInBase``)."""
    n = 0
    for o in range(topo.partition, topo.replicas):
        inst = by_ord.get(o)
        if inst is None or revision_of(inst) == update_rev:
            continue
        if is_ready(inst) and not is_terminating(inst):
            n += 1
    return n


def _existing_valid_surge(by_ord, topo: Topology, update_rev: str) -> int:
    """Surge ords already at update revision and not terminating — the
    stickiness floor (ref ``countExistingValidSurge``). Stale-revision surge
    is NOT counted; it falls out of range and gets condemned."""
    n = 0
    for o in range(topo.replicas, topo.replicas + topo.max_surge):
        inst = by_ord.get(o)
        if inst is not None and revision_of(inst) == update_rev \
                and not is_terminating(inst):
            n += 1
    return n


def _all_base_at_update_rev_healthy(by_ord, topo: Topology, update_rev: str) -> bool:
    """Every ord in [partition, replicas) present, at updateRev, ready, not
    terminating (ref ``allBaseAtUpdateRevHealthy``)."""
    for o in range(topo.partition, topo.replicas):
        inst = by_ord.get(o)
        if inst is None or revision_of(inst) != update_rev:
            return False
        if not is_ready(inst) or is_terminating(inst):
            return False
    return True


def compute_topology(ris, by_ord, current_rev: str, update_rev: str) -> Topology:
    """Single source of truth for ordinal-range sizing
    (ref ``computeTopology``, ``stateful_instance_set_utils.go:488-592``)."""
    ru = ris.spec.rolling_update
    t = Topology(replicas=ris.spec.replicas)
    t.surge_start = t.replicas
    t.end_ordinal = t.replicas
    t.max_surge = max(0, intstr.resolve(ru.max_surge, t.replicas,
                                        round_up=True, name="maxSurge"))
    t.max_unavailable = max(0, intstr.resolve(
        ru.max_unavailable, t.replicas, round_up=False,
        name="maxUnavailable"))
    if t.max_surge == 0 and t.max_unavailable < 1:
        t.max_unavailable = 1   # rollout must be able to make progress
    t.partition = min(max(0, ru.partition), t.replicas)
    # A rollout is in progress when the revisions disagree OR a base
    # instance sits at a stale revision while current == update — the
    # rollback-to-current-mid-rollout case (undo before the advance guard
    # fired): instances at the abandoned intermediate revision must still
    # be walked back, or the set wedges with no event to wake it.
    stale_in_base = any(
        o in by_ord and revision_of(by_ord[o]) != update_rev
        for o in range(t.partition, t.replicas)
    )
    t.in_rollout = (current_rev != update_rev or stale_in_base) and not ru.paused

    if t.max_surge == 0:
        return t
    if not t.in_rollout:
        # Paused mid-rollout: freeze existing surge in place (instance
        # startup is a whole TPU slice — never throw it away on pause).
        if ru.paused and current_rev != update_rev:
            existing = min(_existing_valid_surge(by_ord, t, update_rev),
                           t.max_surge)
            t.active_surge = existing
            t.end_ordinal = t.replicas + existing
        return t

    surge_needed = max(0, _healthy_old_in_base(by_ord, t, update_rev)
                       - t.max_unavailable)
    active = surge_needed
    if not _all_base_at_update_rev_healthy(by_ord, t, update_rev):
        # Stickiness: keep already-allocated surge alive while base work
        # remains, so we don't thrash create→condemn as healthy-old shrinks.
        active = max(active, _existing_valid_surge(by_ord, t, update_rev))
    t.active_surge = min(active, t.max_surge)
    t.end_ordinal = t.replicas + t.active_surge
    return t


def _available_surge(by_ord, topo: Topology, update_rev: str,
                     min_ready: int, now: float) -> Tuple[int, Optional[float]]:
    """Surge slots that provide a REAL availability buffer: at updateRev and
    AVAILABLE (ready for min_ready_seconds — a just-ready engine that crashes
    in its first minute must not have licensed a base delete). Returns
    (count, soonest wait until a ready-but-young surge matures).
    Ref ``countAvailableSurge``."""
    n = 0
    soonest: Optional[float] = None
    for o in range(topo.surge_start, topo.end_ordinal):
        inst = by_ord.get(o)
        if inst is None or revision_of(inst) != update_rev:
            continue
        avail, wait = is_available(inst, min_ready, now)
        if avail:
            n += 1
        elif wait > 0 and (soonest is None or wait < soonest):
            soonest = wait
    return n, soonest


def plan_stateful(ris, instances, current_rev: str, update_rev: str,
                  observer: HealthObserver, ordinal_fn,
                  now: Optional[float] = None) -> Plan:
    """Compute one reconcile's worth of actions (phases A–C of ref
    ``updateStatefulInstanceSet``; phase D — status/advance — is
    :func:`should_advance_current_revision` + the controller's status write).
    """
    now = time.time() if now is None else now
    observer.observe(instances, now)
    name = ris.metadata.name

    by_ord = {}
    for inst in instances:
        o = ordinal_fn(inst)
        if o >= 0:
            by_ord[o] = inst

    topo = compute_topology(ris, by_ord, current_rev, update_rev)
    plan = Plan(topology=topo)

    # ---- Phase B: scale & identity. In-range slots [0, end_ordinal) are
    # populated; everything else (incl. stale surge) is condemned, highest
    # ordinal first (ref :408-472).
    #
    # PAUSED mid-rollout changes both halves: missing BASE ordinals are
    # recreated at the CURRENT (known-good) revision — pause exists to stop
    # the new revision from spreading, and a node failure must not smuggle
    # it in — while the surge range is frozen as-is: no new surge creates
    # (they'd be update-revision instances) and no condemns inside
    # [replicas, replicas+max_surge) (a gapped surge range must not delete
    # a live, ready surge instance just to re-number it).
    paused_mid_rollout = (ris.spec.rolling_update.paused
                          and current_rev != update_rev)
    create_end = topo.replicas if paused_mid_rollout else topo.end_ordinal
    for o in range(create_end):
        if o not in by_ord:
            rev = current_rev if (o < topo.partition or paused_mid_rollout) \
                else update_rev
            plan.create.append((f"{name}-{o}", o, rev))
    condemn_start = (topo.replicas + topo.max_surge) if paused_mid_rollout \
        else topo.end_ordinal
    for o in sorted((o for o in by_ord if o >= condemn_start), reverse=True):
        plan.condemn.append(by_ord[o].metadata.name)

    if not topo.in_rollout:
        return plan

    # ---- Phase C: progress rolling update (ref progressUpdate :553-629).
    min_ready = ris.spec.rolling_update.min_ready_seconds
    available_surge, surge_wait = _available_surge(
        by_ord, topo, update_rev, min_ready, now)
    plan.merge_requeue(surge_wait)
    effective_budget = topo.max_unavailable + available_surge

    base_unavail = set()
    for o in range(topo.replicas):
        inst = by_ord.get(o)
        if inst is None:
            # Slot is empty (mid delete-and-recreate): the reference's
            # Phase B populates it with a fresh in-memory instance which
            # collectBaseUnavailable then counts — an empty base slot is
            # definitionally unavailable and must hold budget hostage.
            base_unavail.add(f"{name}-{o}")
            continue
        avail, wait = is_available(inst, min_ready, now)
        if not avail:
            base_unavail.add(inst.metadata.name)
            if wait > 0:
                plan.merge_requeue(wait)

    # Targets: in-range ords [partition, end_ordinal) not at updateRev,
    # highest ordinal first — surge slots recycle before base chips away.
    targets = [by_ord[o] for o in range(topo.partition, topo.end_ordinal)
               if o in by_ord and revision_of(by_ord[o]) != update_rev]
    targets.sort(key=lambda i: -ordinal_fn(i))

    # Reference budget accounting (:587-627): the initial unavailable count
    # is FIXED for the pass; each costly update adds one on top.
    initial_base_unavail = len(base_unavail)
    newly_unavail = 0
    for inst in targets:
        o = ordinal_fn(inst)
        is_surge_slot = o >= topo.replicas
        stably = observer.stably_unhealthy(inst, now)
        is_free = is_surge_slot or is_terminating(inst) or stably
        if not is_free and initial_base_unavail + newly_unavail >= effective_budget:
            # Budget exhausted for COSTLY targets. If this target is
            # unhealthy but not yet STABLY unhealthy, time will free it —
            # requeue for that window. Keep scanning (deliberate deviation
            # from the reference's early return): a FREE lower-ordinal
            # target must still be processed, or a stably-unhealthy base
            # instance that holds the whole budget hostage is never
            # replaced and the rollout wedges with no wake-up event.
            wait = observer.unhealthy_wait(inst, now)
            if wait is not None:
                plan.merge_requeue(wait)
            continue
        if is_terminating(inst):
            continue
        plan.updates.append(UpdateAction(
            name=inst.metadata.name, ordinal=o,
            is_surge_slot=is_surge_slot, is_free=is_free))
        if not is_free:
            newly_unavail += 1
    return plan


def should_advance_current_revision(ris, by_ord, topo: Topology,
                                    update_rev: str) -> bool:
    """Phase D advance guard (ref ``shouldAdvanceCurrentRevision`` :766-828):

    ① actually in a rollout; ② partition fully consumed; ③ the PRIOR
    persisted status already named updateRev and counted
    ``updated >= replicas - partition`` (so the observation survived one
    full reconcile cycle); ④ every base ordinal observed at updateRev,
    ready, not terminating.
    """
    if not topo.in_rollout:
        return False
    if topo.partition > 0:
        return False
    if ris.status.update_revision != update_rev:
        return False
    # partition is always 0 past guard ② — the persisted concurrence must
    # cover the full base.
    if ris.status.updated_replicas < topo.replicas:
        return False
    return _all_base_at_update_rev_healthy(by_ord, topo, update_rev)
