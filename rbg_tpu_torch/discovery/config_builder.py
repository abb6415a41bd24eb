"""Cluster topology ConfigMap — the signature discovery feature.

Reference analog: ``pkg/discovery/config_builder.go`` (inventory #16): a
``config.yaml`` with the full group/role/instance address+port topology,
mounted at ``/etc/rbg`` in every stateful role's pods, so engines can discover
each other without templating.

TPU-first extension (BASELINE.json north star): each instance additionally
carries its **slice id, slice topology, per-host mesh coordinates, and the
JAX coordinator address** — the engine-side mesh can be constructed straight
from this file (``rbg_tpu_torch.parallel.mesh_from_spec``), and routers can make
ICI/DCN-aware decisions (prefer KV transfer within a superpod block).

The port writes the document with its own block-style emitter
(``dump_yaml``), which gives ``yaml.safe_dump(doc, sort_keys=False)``'s text
for this document's shapes, so the plane runs where PyYAML is not
installed. ``load_cluster_config`` keeps a lazy ``import yaml``.
"""

from __future__ import annotations

import re
from typing import Optional

from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.pod import ConfigMap
from rbg_tpu_torch.api.meta import owner_ref
from rbg_tpu_torch.runtime.store import AlreadyExists
from rbg_tpu_torch.discovery.env_builder import JAX_COORDINATOR_PORT


# Node-map cache keyed on the store's Node write counter: nodes are read on
# EVERY group reconcile but change rarely; rebuilding an O(fleet) dict per
# reconcile dominated create-burst profiles. WeakKey so test stores die.
import weakref

_node_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _node_map(store) -> dict:
    ver = store.kind_version("Node")
    cached = _node_cache.get(store)
    if cached is not None and cached[0] == ver:
        return cached[1]
    nodes = {n.metadata.name: n for n in store.list("Node", copy_=False)}
    _node_cache[store] = (ver, nodes)
    return nodes


def build_cluster_config(store, rbg) -> dict:
    """Build the ClusterConfig document (reference schema
    ``config_builder.go:54-75``, FQDNs ``:117-138``)."""
    ns = rbg.metadata.namespace
    nodes = _node_map(store)
    from rbg_tpu_torch.api.group import SUBDOMAIN_UNIQUE_PER_REPLICA
    roles_out = []
    for role in rbg.spec.roles:
        svc = C.service_name(rbg.metadata.name, role.name)
        unique_subdomain = (role.network is not None
                            and role.network.subdomain_policy
                            == SUBDOMAIN_UNIQUE_PER_REPLICA)
        wname = C.workload_name(rbg.metadata.name, role.name)
        instances_out = []
        instances = store.list(
            "RoleInstance", namespace=ns,
            selector={C.LABEL_GROUP_NAME: rbg.metadata.name,
                      C.LABEL_ROLE_NAME: role.name},
            copy_=False,
        )
        for inst in sorted(instances, key=lambda i: i.metadata.name):
            # KEP-275 UniquePerReplica: the pod's subdomain IS the
            # instance's own headless service.
            subdomain = inst.metadata.name if unique_subdomain else svc
            pods = sorted(
                store.list("Pod", namespace=ns,
                           selector={C.LABEL_INSTANCE_NAME: inst.metadata.name},
                           copy_=False),
                key=lambda p: int(p.metadata.labels.get(C.LABEL_COMPONENT_INDEX, "0")),
            )
            hosts = []
            for p in pods:
                node = nodes.get(p.node_name)
                hosts.append({
                    "pod": p.metadata.name,
                    "address": f"{p.metadata.name}.{subdomain}",
                    "ip": p.status.pod_ip,
                    "processId": int(p.metadata.labels.get(C.LABEL_COMPONENT_INDEX, "0")),
                    "node": p.node_name,
                    "meshCoords": node.tpu.mesh_coords if node else "",
                })
            entry = {
                "name": inst.metadata.name,
                "index": inst.spec.index,
                "sliceId": inst.status.slice_id,
                "subdomain": subdomain,
                "hosts": hosts,
            }
            if role.tpu is not None:
                entry["coordinator"] = (f"{inst.metadata.name}-0.{subdomain}"
                                        f":{JAX_COORDINATOR_PORT}")
                entry["sliceTopology"] = role.tpu.slice_topology
                entry["accelerator"] = role.tpu.accelerator
            instances_out.append(entry)
        roles_out.append({
            "name": role.name,
            "replicas": role.replicas,
            "service": svc,
            "workload": wname,
            "instances": instances_out,
        })
    return {
        "group": rbg.metadata.name,
        "namespace": ns,
        "roles": roles_out,
    }


def topology_configmap_name(group: str) -> str:
    return f"{group}-topology"[:C.MAX_NAME_LEN]


# Per-group cache of the last built topology: the YAML dump is the hot cost
# of the group reconcile, and topologies only change on pod/instance churn.
_topology_cache: dict = {}


def reconcile_topology_configmap(store, rbg) -> Optional[ConfigMap]:
    """Create/update the topology ConfigMap (SSA-equivalent: semantic diff)."""
    ns = rbg.metadata.namespace
    name = topology_configmap_name(rbg.metadata.name)
    doc = build_cluster_config(store, rbg)
    cached = _topology_cache.get((ns, name))
    if cached is not None and cached[0] == doc:
        data = cached[1]
    else:
        data = dump_yaml(doc)
        _topology_cache[(ns, name)] = (doc, data)
        if len(_topology_cache) > 4096:
            _topology_cache.clear()
    cur = store.get("ConfigMap", ns, name, copy_=False)
    if cur is None:
        cm = ConfigMap()
        cm.metadata.name = name
        cm.metadata.namespace = ns
        cm.metadata.labels = {C.LABEL_GROUP_NAME: rbg.metadata.name}
        cm.metadata.owner_references = [owner_ref(rbg)]
        cm.data = {C.DISCOVERY_CONFIG_FILE: data}
        try:
            return store.create(cm)
        except AlreadyExists:
            return None  # concurrent reconcile won the create — benign
    if cur.data.get(C.DISCOVERY_CONFIG_FILE) != data:
        def fn(c):
            c.data[C.DISCOVERY_CONFIG_FILE] = data
            return True
        return store.mutate("ConfigMap", ns, name, fn)
    return None  # unchanged; never hand out the live no-copy store object


def load_cluster_config(text: str) -> dict:
    import yaml
    return yaml.safe_load(text)


# Plain scalars that YAML 1.1's implicit resolvers (PyYAML's) would read as
# something other than a string: those are single-quoted.
_IMPLICIT = re.compile(r"""^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | ~|null|Null|NULL|<<|=
  | [-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+
      |[1-9][0-9_]*(?::[0-5]?[0-9])+)
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
  | \.[0-9_]+(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
  | [-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
  | [0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*
)$""", re.X)


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    plain = (s and s == s.strip() and not _IMPLICIT.match(s)
             and s[0] not in ",[]{}#&*!|>'\"%@`"
             and not (s[0] in "-?:" and s[1:2] in ("", " "))
             and ": " not in s and " #" not in s and not s.endswith(":")
             and s.isprintable())
    return s if plain else "'" + s.replace("'", "''") + "'"


def _emit(v, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            if isinstance(x, dict) and x:
                out.append(f"{pad}{_scalar(k)}:")
                _emit(x, indent + 2, out)
            elif isinstance(x, list) and x:
                out.append(f"{pad}{_scalar(k)}:")
                _emit(x, indent, out)     # block sequences sit at the key's indent
            else:
                out.append(f"{pad}{_scalar(k)}: {_inline(x)}")
    else:
        for x in v:
            if isinstance(x, (dict, list)) and x:
                sub: list = []
                _emit(x, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(x)}")


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump_yaml(doc: dict) -> str:
    """Block-style YAML of a tree of dicts, lists and scalars, as
    ``yaml.safe_dump(doc, sort_keys=False)`` writes it (keys in order, no
    line folding: the topology's strings hold no spaces)."""
    out: list = []
    _emit(doc, 0, out)
    return "\n".join(out) + "\n"
