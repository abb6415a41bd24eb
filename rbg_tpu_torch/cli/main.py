"""``python -m rbg_tpu_torch.cli.main`` — the port's control-plane CLI: the
``validate`` and ``apply`` commands of ``rbg_tpu/cli/controlplane.py``.

``apply -f FILE --backend fake|local`` boots an in-process plane, applies
the manifests, waits for each group to be Ready and prints its status;
``validate -f FILE`` is offline admission. Manifests are YAML, read with
PyYAML (imported only here). ``serve``, ``status`` and the admin wire are
later slices.
"""

from __future__ import annotations

import argparse
import sys


def _load(path: str):
    from rbg_tpu_torch.api import load_yaml_docs, parse_manifest

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        print(f"error: cannot read {path}: {e.strerror}", file=sys.stderr)
        raise SystemExit(1)
    return [parse_manifest(d) for d in load_yaml_docs(text)]


def cmd_validate(args) -> int:
    from rbg_tpu_torch.api.validation import ValidationError, validate_group

    objs = _load(args.file)
    rc = 0
    for o in objs:
        if o.kind == "RoleBasedGroup":
            try:
                validate_group(o)
                print(f"{o.kind}/{o.metadata.name}: OK")
            except ValidationError as e:
                rc = 1
                for err in e.errors:
                    print(f"{o.kind}/{o.metadata.name}: INVALID: {err}")
        else:
            print(f"{o.kind}/{o.metadata.name}: parsed")
    return rc


def cmd_apply(args) -> int:
    from rbg_tpu_torch.runtime.plane import ControlPlane
    from rbg_tpu_torch.testutil import make_tpu_nodes

    objs = _load(args.file)
    plane = ControlPlane(backend=args.backend)
    if args.backend == "fake":
        make_tpu_nodes(plane.store, slices=args.slices, hosts_per_slice=args.hosts)
    else:
        # One Node for this host, as the reference's ``serve`` makes for
        # its local backend (its ``apply`` made none, so no pod bound).
        from rbg_tpu_torch.api.pod import Node
        node = Node()
        node.metadata.name = "localhost"
        plane.store.create(node)
    with plane:
        for o in objs:
            plane.apply(o)
            print(f"applied {o.kind}/{o.metadata.name}")
        rc = 0
        for o in objs:
            if o.kind != "RoleBasedGroup":
                continue
            try:
                plane.wait_group_ready(o.metadata.name, o.metadata.namespace,
                                       timeout=args.timeout)
                print(f"group {o.metadata.name}: Ready")
            except TimeoutError:
                rc = 1
                print(f"group {o.metadata.name}: NOT ready within {args.timeout}s")
            _print_status(plane, o.metadata.namespace, o.metadata.name)
            if args.verbose:
                _print_detail(plane, o.metadata.namespace, o.metadata.name)
        return rc


def _print_detail(plane, ns: str, name: str) -> None:
    from rbg_tpu_torch.api import constants as C
    from rbg_tpu_torch.discovery.config_builder import topology_configmap_name

    pods = plane.store.list("Pod", namespace=ns, selector={C.LABEL_GROUP_NAME: name})
    for p in sorted(pods, key=lambda p: p.metadata.name):
        print(f"  env [{p.metadata.name}]:")
        for c in p.template.containers:
            for e in c.env:
                if e.name.startswith(("RBG_", "MEGASCALE_")):
                    print(f"    {e.name}={e.value}")
    cm = plane.store.get("ConfigMap", ns, topology_configmap_name(name))
    if cm is not None:
        print("  topology config.yaml:")
        for line in cm.data.get(C.DISCOVERY_CONFIG_FILE, "").splitlines():
            print(f"    {line}")


def _print_status(plane, ns: str, name: str) -> None:
    from rbg_tpu_torch.api import constants as C

    g = plane.store.get("RoleBasedGroup", ns, name)
    if g is None:
        print(f"  group {name}: not found", file=sys.stderr)
        return
    print(f"  {'ROLE':<12} {'READY':<8} {'UPDATED':<8}")
    for st in g.status.roles:
        spec = g.spec.role(st.name)
        want = spec.replicas if spec else "?"
        print(f"  {st.name:<12} {st.ready_replicas}/{want:<6} {st.updated_replicas:<8}")
    pods = plane.store.list("Pod", namespace=ns,
                            selector={C.LABEL_GROUP_NAME: name})
    nodes = {n.metadata.name: n for n in plane.store.list("Node")}
    for p in sorted(pods, key=lambda p: p.metadata.name):
        slice_id = ""
        if p.node_name and p.node_name in nodes:
            slice_id = nodes[p.node_name].tpu.slice_id
        print(f"    pod {p.metadata.name:<28} {p.status.phase:<9} "
              f"node={p.node_name or '<pending>'} {('slice=' + slice_id) if slice_id else ''}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rbg-tpu-torch",
        description="role-based group control plane (local path)")
    sub = parser.add_subparsers(dest="cmd")
    ap = sub.add_parser("apply", help="apply manifests to an in-process plane and wait")
    ap.add_argument("-f", "--file", required=True, help="YAML manifest file")
    ap.add_argument("--backend", default="fake", choices=["fake", "local"])
    ap.add_argument("--slices", type=int, default=2, help="fake TPU slices")
    ap.add_argument("--hosts", type=int, default=2, help="hosts per fake slice")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print injected envs and the topology config")
    ap.set_defaults(func=cmd_apply)
    vp = sub.add_parser("validate", help="validate manifests offline")
    vp.add_argument("-f", "--file", required=True)
    vp.set_defaults(func=cmd_validate)

    args = parser.parse_args(argv)
    if hasattr(args, "func"):
        return args.func(args)
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
