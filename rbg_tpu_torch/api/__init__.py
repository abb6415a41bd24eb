"""Resource model (the CRD-equivalent API surface). See SURVEY.md §2 #1-3."""

from rbg_tpu_torch.api import constants
from rbg_tpu_torch.api.group import (
    ComponentSpec, EngineRuntimeRef, GroupTemplate, IdentityMode,
    LeaderWorkerSpec,
    PatternType, RestartPolicy, RestartPolicyConfig, RoleBasedGroup,
    RoleBasedGroupSet, RoleBasedGroupSetSpec, RoleBasedGroupSpec,
    RoleBasedGroupStatus, RoleSpec, RoleStatus, RoleTemplate, RollingUpdate,
    ScalingAdapterHook, TpuSpec,
)
from rbg_tpu_torch.api.instance import (
    ComponentStatus, ControllerRevision, InstanceTemplate, ReadyPolicy,
    RoleInstance, RoleInstanceSet, RoleInstanceSetSpec, RoleInstanceSetStatus,
    RoleInstanceSpec, RoleInstanceStatus,
)
from rbg_tpu_torch.api.meta import (
    Condition, ObjectMeta, OwnerReference, get_condition, owner_ref,
    set_condition,
)
from rbg_tpu_torch.api.pod import (
    ConfigMap, Container, EnvVar, Node, NodeAffinityTerm, Pod, PodStatus,
    PodTemplate, Port, Resources, Service, TpuNodeInfo,
)
from rbg_tpu_torch.api.policy import (
    CoordinatedPolicy, CoordinatedPolicySpec, CoordinatedRollingUpdate,
    CoordinatedScaling, EngineRuntimeProfile, PodGroup, PodGroupSpec,
    PodGroupStatus, ProgressionGate, ScalingAdapter, ScalingAdapterSpec,
    ScalingAdapterStatus, Warmup, WarmupSpec, WarmupStatus, WarmupTarget,
)
from rbg_tpu_torch.api.serde import from_dict, load_yaml_docs, to_dict, to_yaml

KINDS = {
    cls.__name__: cls
    for cls in (
        RoleBasedGroup, RoleBasedGroupSet, RoleInstanceSet, RoleInstance,
        ControllerRevision, CoordinatedPolicy, ScalingAdapter, Warmup,
        EngineRuntimeProfile, RoleTemplate, Pod, Node, Service, ConfigMap,
        PodGroup,
    )
}


API_GROUP = "rbg.tpu.x-k8s.io"
API_VERSION = f"{API_GROUP}/v1alpha2"

# apiVersion -> converter(dict) -> dict at a NEWER apiVersion. The hub-spoke
# conversion-webhook analog (reference:
# ``api/workloads/v1alpha1/rolebasedgroup_conversion.go``), collapsed to
# pure dict->dict functions run at admission: an old manifest is converted
# forward until it reaches API_VERSION, then parsed strictly. Register a
# converter here when a release renames/restructures the manifest schema
# (docs/architecture.md §5 rule 2). v1alpha1 manifests (bool ``stateful``)
# convert live — see rbg_tpu/api/conversions.py.
MANIFEST_CONVERSIONS: dict = {}


def _register_conversions():
    from rbg_tpu_torch.api import conversions
    MANIFEST_CONVERSIONS[f"{API_GROUP}/v1alpha1"] = (
        conversions.v1alpha1_to_v1alpha2)


_register_conversions()


def convert_manifest(doc: dict) -> dict:
    """Run the registered conversion chain until ``doc`` is at API_VERSION.
    A manifest with no apiVersion is taken as current (additive-with-
    defaults evolution needs no conversion)."""
    ver = doc.get("apiVersion") or API_VERSION
    seen = set()
    while ver != API_VERSION:
        conv = MANIFEST_CONVERSIONS.get(ver)
        if conv is None or ver in seen:
            raise KeyError(
                f"unsupported apiVersion {ver!r} (no conversion to "
                f"{API_VERSION})")
        seen.add(ver)
        doc = conv(dict(doc))
        ver = doc.get("apiVersion") or API_VERSION
    return doc


def parse_manifest(doc: dict, *, lenient: bool = False):
    """Build a typed resource from a parsed YAML document (kind-dispatched).
    ``lenient`` is for durable-storage reads (see serde.from_dict)."""
    doc = convert_manifest(doc)
    kind = doc.get("kind")
    if kind not in KINDS:
        raise KeyError(f"unknown kind {kind!r}; known: {sorted(KINDS)}")
    if "apiVersion" in doc:
        doc = {k: v for k, v in doc.items() if k != "apiVersion"}
    return from_dict(KINDS[kind], doc, lenient=lenient)
