"""Coordinated rolling update: maxSkew-bounded multi-role rollout.

Reference analog: the coordinated-RU math inlined in the RBG controller
(``rolebasedgroup_controller.go:1234-1499``): per-role partitions are derived
so the fastest role's updated-ratio never exceeds the slowest's by more than
``maxSkew`` percent (``a/b − x/d ≤ s/100``, :1470-1499), with the slowest
role always allowed one step (no deadlock). Canonical TPU use: prefill and
decode pools of a PD-disagg service rolling to a new engine image in
lockstep, so KV-transfer compatibility windows stay bounded.

The knob driven here is the RIS ``rolling_update.partition``: ordinals below
the partition stay on the old revision, so ``allowed_updated = replicas −
partition``.
"""

from __future__ import annotations

from math import floor
from typing import Dict

from rbg_tpu_torch.api.group import RoleBasedGroup
from rbg_tpu_torch.api.policy import CoordinatedRollingUpdate


def rollout_partitions(rbg: RoleBasedGroup, policy: CoordinatedRollingUpdate,
                       updated: Dict[str, int]) -> Dict[str, int]:
    """Compute per-role partitions for this reconcile round.

    ``updated`` maps role → currently updated-AND-ready replicas. Returns
    role → partition (0 = fully open). Level-triggered: as updates land,
    later rounds lower the partitions further.
    """
    roles = [r for r in policy.roles if rbg.spec.role(r) is not None]
    if len(roles) < 2:
        return {}

    ratios = {}
    for name in roles:
        n = rbg.spec.role(name).replicas
        ratios[name] = 1.0 if n <= 0 else min(1.0, updated.get(name, 0) / n)
    min_ratio = min(ratios.values())
    skew = policy.max_skew_percent / 100.0

    out: Dict[str, int] = {}
    for name in roles:
        n = rbg.spec.role(name).replicas
        if n <= 0:
            out[name] = 0
            continue
        allowed = floor(n * (min_ratio + skew))
        if ratios[name] <= min_ratio:
            # Slowest role(s) always get one more step — no deadlock.
            allowed = max(allowed, updated.get(name, 0) + 1)
        allowed = min(n, allowed)
        out[name] = max(0, n - allowed)
    return out
