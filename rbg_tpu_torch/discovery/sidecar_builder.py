"""EngineRuntimeProfile injection: sidecars + per-role container overrides.

Reference analog: ``pkg/discovery/sidecar_builder.go:47-158`` (inventory #19):
a cluster-scoped profile of init/sidecar containers + volumes is merged into
role pods; the role's ``engineRuntime`` hook may override container args/env.
Canonical TPU uses: a metrics-scraper sidecar, a KV-transfer proxy
(Mooncake-equivalent), or a libtpu health prober.
"""

from __future__ import annotations

import copy

from rbg_tpu_torch.api.pod import EnvVar


def apply_engine_runtime(store, engine_runtime, pod, namespace: str) -> None:
    """Merge the referenced profile + overrides into ``pod.template``."""
    if engine_runtime is None or not engine_runtime.profile_name:
        return
    profile = (store.get("EngineRuntimeProfile", namespace, engine_runtime.profile_name)
               or store.get("EngineRuntimeProfile", "default", engine_runtime.profile_name))
    if profile is not None:
        have = {c.name for c in pod.template.containers}
        have_init = {c.name for c in pod.template.init_containers}
        pod.template.init_containers.extend(
            copy.deepcopy(c) for c in profile.init_containers if c.name not in have_init
        )
        pod.template.containers.extend(
            copy.deepcopy(c) for c in profile.containers if c.name not in have
        )
        for v in profile.volumes:
            if v not in pod.template.volumes:
                pod.template.volumes.append(v)

    # Per-role overrides apply to any container by name (profile or template).
    for c in pod.template.containers:
        extra_args = engine_runtime.container_args.get(c.name)
        if extra_args:
            c.args = list(c.args) + [a for a in extra_args if a not in c.args]
        extra_env = engine_runtime.container_env.get(c.name)
        if extra_env:
            have_env = {e.name for e in c.env}
            c.env.extend(EnvVar(k, v) for k, v in sorted(extra_env.items())
                         if k not in have_env)
