"""Live API conversions (reference analog: inventory #2,
``api/workloads/v1alpha1/rolebasedgroup_conversion.go:1-598`` hub-spoke
conversion + ``tools/crd-upgrade``).

v1alpha1 → v1alpha2 (shipped this release): the boolean ``stateful`` on role
specs became the string ``identity: "ordinal" | "random"`` — the old name
conflated the identity discipline with storage semantics the plane never
had, and a closed bool left no room for future disciplines (e.g. a
slice-affine-but-renameable mode). The conversion is exact and lossless:
``stateful: true`` (and absent) → ``"ordinal"``, ``false`` → ``"random"``.

Snapshot files carry the same shape inside ``objects`` (plus
ControllerRevision payloads holding serialized group specs), migrated by
``SNAPSHOT_MIGRATIONS[1]`` on load — both registries are exercised by
committed old-format fixtures in ``tests/fixtures/``.
"""

from __future__ import annotations


def _convert_role(role: dict) -> dict:
    role = dict(role)
    if "identity" not in role:
        stateful = role.get("stateful", True)
        role["identity"] = "ordinal" if stateful else "random"
    role.pop("stateful", None)
    return role


def _convert_group_spec(spec: dict) -> dict:
    spec = dict(spec)
    if isinstance(spec.get("roles"), list):
        spec["roles"] = [_convert_role(r) for r in spec["roles"]
                         if isinstance(r, dict)]
    return spec


def v1alpha1_to_v1alpha2(doc: dict) -> dict:
    """Convert one v1alpha1 manifest/stored-object dict to v1alpha2."""
    from rbg_tpu_torch.api import API_GROUP

    doc = dict(doc)
    kind = doc.get("kind")
    spec = doc.get("spec")
    if kind == "RoleBasedGroup" and isinstance(spec, dict):
        doc["spec"] = _convert_group_spec(spec)
    elif kind == "RoleBasedGroupSet" and isinstance(spec, dict):
        spec = dict(spec)
        tmpl = spec.get("template")
        if isinstance(tmpl, dict) and isinstance(tmpl.get("spec"), dict):
            tmpl = dict(tmpl)
            tmpl["spec"] = _convert_group_spec(tmpl["spec"])
            spec["template"] = tmpl
        doc["spec"] = spec
    elif kind == "RoleInstanceSet" and isinstance(spec, dict):
        spec = dict(spec)
        if "identity" not in spec:
            spec["identity"] = ("ordinal" if spec.get("stateful", True)
                                else "random")
        spec.pop("stateful", None)
        doc["spec"] = spec
    elif kind == "ControllerRevision" and isinstance(doc.get("data"), dict):
        # Revision payloads hold a serialized RoleBasedGroupSpec — an undo
        # to a pre-upgrade revision must re-apply cleanly.
        doc["data"] = _convert_group_spec(doc["data"])
    if doc.get("apiVersion"):
        doc["apiVersion"] = f"{API_GROUP}/v1alpha2"
    return doc


def migrate_snapshot_v1(data: dict) -> dict:
    """Snapshot schema 1 → 2: stored objects predate the identity rename.
    (Objects in snapshots carry no apiVersion — the schema number versions
    the whole file.)"""
    data = dict(data)
    data["objects"] = [v1alpha1_to_v1alpha2(o) if isinstance(o, dict) else o
                       for o in data.get("objects", [])]
    data["schema"] = 2
    return data
