"""Coordinated scaling: maxSkew-bounded multi-role progression.

Reference analog: ``pkg/coordination/coordinationscaling`` (inventory #22,
``CalculateTargetReplicas:70-190``) + the skew bound ``a/b − x/d ≤ s/100``
from the coordinated rolling-update math
(``rolebasedgroup_controller.go:1470-1499``).

Semantics: the roles named in the policy scale toward their spec targets
together — no role's progress ratio may exceed the slowest role's by more
than maxSkew percent. Progress is gated on the chosen gate (scheduled vs
ready counts). The slowest role(s) always get +1 so the group can never
deadlock. Canonical TPU use: prefill and decode pools of a PD-disagg service
growing in lockstep so KV-transfer capacity stays balanced.
"""

from __future__ import annotations

from math import floor
from typing import Dict

from rbg_tpu_torch.api.group import RoleBasedGroup
from rbg_tpu_torch.api.policy import CoordinatedScaling, ProgressionGate


def clamp_targets(rbg: RoleBasedGroup, policy: CoordinatedScaling,
                  targets: Dict[str, int]) -> Dict[str, int]:
    """Clamp per-role replica targets so coordinated roles advance in step.

    ``targets`` maps role → desired replicas (spec or autoscaler override);
    returns a new map with coordinated roles possibly reduced for this
    reconcile round (level-triggered: as progress lands, later rounds raise
    them further).
    """
    roles = [r for r in policy.roles if rbg.spec.role(r) is not None]
    if len(roles) < 2:
        return targets

    def progress(role: str) -> int:
        st = rbg.status.role(role)
        if st is None:
            return 0
        return (st.ready_replicas if policy.gate == ProgressionGate.ORDER_READY
                else st.replicas)

    ratios = {}
    for r in roles:
        t = targets.get(r, 0)
        ratios[r] = 1.0 if t <= 0 else min(1.0, progress(r) / t)
    min_ratio = min(ratios.values())
    skew = policy.max_skew_percent / 100.0

    out = dict(targets)
    for r in roles:
        t = targets.get(r, 0)
        if t <= 0:
            continue
        cap = floor(t * (min_ratio + skew))
        if ratios[r] <= min_ratio:
            # Slowest role(s): always allowed one step beyond current
            # progress — the no-deadlock guarantee.
            cap = max(cap, progress(r) + 1)
        out[r] = max(0, min(t, cap))
    return out
