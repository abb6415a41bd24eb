"""The port's control plane (``rbg_tpu_torch`` api / runtime / sched /
discovery / coordination / portalloc / inplace) against ``rbg_tpu``'s, on
the ``fake`` backend: the same scripted scenarios run on both planes, and
every object in each store must serialize equal after normalising uids,
resource versions, times and the random instance-name suffixes. Then the
port's CLI (``validate``, ``apply --backend fake``) against the
reference's on every example manifest, and the topology ConfigMap's
emitter against PyYAML.
"""

import contextlib
import importlib
import io
import json
import re
import time
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("rbg_tpu", "rbg_tpu_torch")
SETTLE_S = 1.0            # the store's resource version unchanged this long
TIMEOUT_S = 30.0


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def plane_of(pkg, monkeypatch):
    """A fake-backend plane over two 2-host slices, with the random
    instance-name suffixes recorded so they can be normalised."""
    iset = mod(pkg, "runtime.controllers.instanceset")
    made = []
    real = iset._rand_id

    def rand_id(n=5):
        made.append(real(n))
        return made[-1]

    monkeypatch.setattr(iset, "_rand_id", rand_id)
    p = mod(pkg, "runtime.plane").ControlPlane(backend="fake")
    mod(pkg, "testutil").make_tpu_nodes(p.store, slices=2, hosts_per_slice=2)
    p.rand_ids = made
    with p:
        yield p


def settle(p):
    """Wait until no controller has written for SETTLE_S and none has a
    key queued."""
    deadline = time.monotonic() + TIMEOUT_S
    rv, since = p.store.current_rv(), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now = p.store.current_rv()
        if now != rv or any(len(c.queue) for c in p.manager.controllers):
            rv, since = now, time.monotonic()
        elif time.monotonic() - since >= SETTLE_S:
            return
    raise TimeoutError("the plane never settled")


_TIME_KEY = re.compile(r"(?i)(time|timestamp)$")
# Which free host a pod lands on depends on the order the scheduler sees
# the pods, in both planes: node names and slice ids read as "<node>" and
# "<slice>" (so a bound pod still differs from an unbound one), the mesh
# coordinates a host carries are dropped, and each plane's placement is
# held to its rules (``placement``) instead.


def normalise(obj, rand_ids, places):
    if isinstance(obj, dict):
        return {k: normalise(v, rand_ids, places) for k, v in obj.items()
                if k not in ("uid", "resourceVersion", "meshCoords")
                and not _TIME_KEY.search(k)}
    if isinstance(obj, list):
        return [normalise(v, rand_ids, places) for v in obj]
    if isinstance(obj, str):
        if obj in places:
            return places[obj]
        for r in rand_ids:
            obj = obj.replace(f"-{r}", "-<rand>")
    return obj


def placement(p):
    """Every pod bound, and an instance's pods on one slice, one per host."""
    nodes = {n.metadata.name: n for n in p.store.list("Node")}
    by_inst = {}
    for x in active_pods(p):
        by_inst.setdefault(x.metadata.owner_references[0].name, []).append(x)
    ok = all(x.node_name in nodes for xs in by_inst.values() for x in xs)
    for xs in by_inst.values():
        ok &= len({nodes[x.node_name].tpu.slice_id for x in xs}) == 1
        ok &= len({x.node_name for x in xs}) == len(xs)
    return ok


def caught_up(objs):
    """Every object's status observed its latest spec."""
    return all(o["status"]["observedGeneration"] == o["metadata"].get("generation")
               for o in objs if "observedGeneration" in o.get("status", {}))


def dump(p):
    settle(p)
    objs = p.store.snapshot()["objects"]
    assert caught_up(objs)
    for o in objs:
        # A generation counts the spec writes an object took: how many
        # intermediate states the controllers saw (replicas stepping up,
        # each topology change) depends on timing, in both planes.
        o["metadata"].pop("generation", None)
        o.get("status", {}).pop("observedGeneration", None)
        if o.get("kind") == "ConfigMap":
            o["data"] = {k: yaml.safe_load(v) for k, v in o["data"].items()}
    places = {}
    for n in p.store.list("Node"):
        places[n.metadata.name] = "<node>"
        places[n.tpu.slice_id] = "<slice>"
    return sorted(json.dumps(normalise(o, p.rand_ids, places), sort_keys=True)
                  for o in objs)


def edit_group(p, name, fn):
    """A user's spec edit, retried on a conflict with a controller's write."""
    def edit(g):
        fn(g)
        return True
    p.store.mutate("RoleBasedGroup", "default", name, edit)


def active_pods(p):
    return [x for x in p.store.list("Pod", namespace="default") if x.active]


# ---- scenarios (shapes of tests/test_controlplane.py, test_discovery.py,
# test_coordination.py, test_stateful_update.py, test_fault_handling.py) ----

def single_role(p, pkg):
    tu = mod(pkg, "testutil")
    p.apply(tu.make_group("demo", tu.simple_role("server", replicas=2)))
    p.wait_group_ready("demo", timeout=TIMEOUT_S)
    return {}


def pd_group(p, pkg):
    """prefill and decode, and a router that depends on both: the router's
    pod is created only after both engines' pods are Ready."""
    tu = mod(pkg, "testutil")
    ready = {}

    def on_pod(ev):
        pod = ev.object
        role = pod.metadata.labels.get(mod(pkg, "api.constants").LABEL_ROLE_NAME)
        if pod.running_ready and role not in ready:
            ready[role] = time.time()

    p.store.watch("Pod", on_pod)
    p.apply(tu.make_group(
        "pd", tu.simple_role("prefill"), tu.simple_role("decode"),
        tu.simple_role("router", dependencies=["prefill", "decode"])))
    p.wait_group_ready("pd", timeout=TIMEOUT_S)
    settle(p)
    order = sorted(ready, key=ready.get)
    C = mod(pkg, "api.constants")
    router = [x for x in active_pods(p) if x.metadata.labels[C.LABEL_ROLE_NAME] == "router"]
    created_after = router[0].metadata.creation_timestamp >= max(
        ready["prefill"], ready["decode"])
    return {"engines_ready_first": sorted(order[:2]), "last_ready": order[2],
            "router_created_after_engines_ready": created_after}


def leader_worker(p, pkg):
    tu = mod(pkg, "testutil")
    C = mod(pkg, "api.constants")
    p.apply(tu.make_group("tp", tu.tpu_leaderworker_role("serve", replicas=2,
                                                         topology="2x4")))
    p.wait_group_ready("tp", timeout=TIMEOUT_S)
    settle(p)
    env = {x.metadata.name: [(e.name, e.value) for e in x.template.containers[0].env]
           for x in active_pods(p)}
    return {"env": env, "coordinator_in_every_pod":
            all(C.ENV_JAX_COORDINATOR in dict(v) for v in env.values())}


def scale_up_down(p, pkg):
    tu = mod(pkg, "testutil")
    C = mod(pkg, "api.constants")
    p.apply(tu.make_group("s", tu.simple_role("server", replicas=1)))
    p.wait_group_ready("s", timeout=TIMEOUT_S)
    counts = []
    for n in (3, 1):
        edit_group(p, "s", lambda g: setattr(g.spec.roles[0], "replicas", n))
        p.wait_for(lambda: len(active_pods(p)) == n, timeout=TIMEOUT_S,
                   desc=f"scale to {n}")
        p.wait_group_ready("s", timeout=TIMEOUT_S)
        counts.append(len(active_pods(p)))
    return {"counts": counts, "survivor": active_pods(p)[0].metadata.labels[
        C.LABEL_INSTANCE_INDEX]}


def scale_random_identity(p, pkg):
    """Unordered (random-name) instances: scale 1 → 3 → 2."""
    tu = mod(pkg, "testutil")
    role = tu.simple_role("server", replicas=1)
    role.identity = mod(pkg, "api.group").IdentityMode.RANDOM
    p.apply(tu.make_group("r", role))
    p.wait_group_ready("r", timeout=TIMEOUT_S)
    for n in (3, 2):
        edit_group(p, "r", lambda g: setattr(g.spec.roles[0], "replicas", n))
        p.wait_for(lambda: len(active_pods(p)) == n
                   and all(x.running_ready for x in active_pods(p)),
                   timeout=TIMEOUT_S, desc=f"scale to {n}")
        p.wait_group_ready("r", timeout=TIMEOUT_S)
    return {"pods": len(active_pods(p))}


def rolling_update(p, pkg):
    G = mod(pkg, "api.group")
    tu = mod(pkg, "testutil")
    role = tu.simple_role("server", replicas=3)
    role.rolling_update = G.RollingUpdate(max_unavailable=1, in_place_if_possible=False)
    p.apply(tu.make_group("u", role))
    p.wait_group_ready("u", timeout=TIMEOUT_S)
    old = {x.metadata.name: x.metadata.uid for x in active_pods(p)}
    edit_group(p, "u", lambda g: setattr(g.spec.roles[0].template.containers[0],
                                         "image", "engine:v2"))

    def done():
        pods = active_pods(p)
        ris = p.store.get("RoleInstanceSet", "default", "u-server")
        return (len(pods) == 3 and ris.status.updated_ready_replicas == 3
                and all(x.template.containers[0].image == "engine:v2"
                        and x.running_ready for x in pods))

    p.wait_for(done, timeout=TIMEOUT_S, desc="rolling update")
    p.wait_group_ready("u", timeout=TIMEOUT_S)
    return {"recreated": all(x.metadata.uid != old.get(x.metadata.name)
                             for x in active_pods(p))}


def failed_pod_recreated(p, pkg):
    G = mod(pkg, "api.group")
    tu = mod(pkg, "testutil")
    role = tu.simple_role("server", replicas=1)
    role.restart_policy = G.RestartPolicyConfig(base_delay_seconds=0.05,
                                                max_delay_seconds=1.0)
    p.apply(tu.make_group("f", role))
    p.wait_group_ready("f", timeout=TIMEOUT_S)
    uid0 = active_pods(p)[0].metadata.uid
    p.kubelet.fail_pod("default", active_pods(p)[0].metadata.name)
    p.wait_for(lambda: (active_pods(p) and active_pods(p)[0].metadata.uid != uid0
                        and active_pods(p)[0].running_ready),
               timeout=TIMEOUT_S, desc="pod recreated")
    p.wait_group_ready("f", timeout=TIMEOUT_S)
    settle(p)
    inst = p.store.list("RoleInstance", namespace="default")[0]
    return {"restart_count": inst.status.restart_count}


SCENARIOS = {
    "single_role": single_role,
    "pd_group": pd_group,
    "leader_worker": leader_worker,
    "scale_up_down": scale_up_down,
    "scale_random_identity": scale_random_identity,
    "rolling_update": rolling_update,
    "failed_pod_recreated": failed_pod_recreated,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fake_backend_parity(name, monkeypatch):
    out = {}
    for pkg in PKGS:
        with plane_of(pkg, monkeypatch) as p:
            facts = SCENARIOS[name](p, pkg)
            objs = dump(p)
            facts["placement_ok"] = placement(p)
            out[pkg] = (facts, objs)
    (ref_facts, ref_objs), (facts, objs) = out["rbg_tpu"], out["rbg_tpu_torch"]
    assert facts == ref_facts
    assert facts["placement_ok"] is True
    assert len(objs) == len(ref_objs)
    assert objs == ref_objs
    if name == "pd_group":
        assert facts["router_created_after_engines_ready"] is True
        assert facts["last_ready"] == "router"
    if name == "failed_pod_recreated":
        assert facts["restart_count"] == 1


# ---- the CLI ----

EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.yaml"))


def cli_lines(pkg, argv):
    main = mod(pkg, "cli.main").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    # Pod names of random-identity roles carry random suffixes, and which
    # free host a pod lands on follows the scheduler's order (as in dump());
    # nothing in these lines is a time.
    text = re.sub(r"-[a-z0-9]{5}(?=[-\s.]|$)", "-<rand>", buf.getvalue(), flags=re.M)
    text = re.sub(r"slice-\d+-host-\d+", "<node>", text)
    text = re.sub(r"slice-\d+", "<slice>", text)
    return rc, text.splitlines()


# kv-pool-components' custom components reach Ready after ~18 s of
# backoff, and what its status shows at that moment depends on timing in
# the reference itself: for it, ``apply`` compares the lines that report
# what was applied.
RACY_STATUS = {"kv-pool-components.yaml"}


@pytest.mark.parametrize("example", EXAMPLES)
@pytest.mark.parametrize("cmd", ["validate", "apply"])
def test_cli_matches_reference(example, cmd):
    argv = [cmd, "-f", str(ROOT / "examples" / example)]
    racy = cmd == "apply" and example in RACY_STATUS
    if cmd == "apply":
        # Four 4-host slices hold every example (agg-multihost's 4x4 gangs
        # among them). No ``-v``: the topology ConfigMap it prints may
        # trail the Ready moment by a reconcile in either plane
        # (test_fake_backend_parity compares it once the plane settles).
        argv += ["--backend", "fake", "--slices", "4", "--hosts", "4",
                 "--timeout", "2" if racy else "30"]
    ref_rc, ref = cli_lines("rbg_tpu", argv)
    rc, got = cli_lines("rbg_tpu_torch", argv)
    if racy:
        ref = [x for x in ref if x.startswith("applied ")]
        got = [x for x in got if x.startswith("applied ")]
    else:
        assert rc == ref_rc
    assert got == ref
    assert got


# ---- the topology ConfigMap's emitter ----

@pytest.mark.parametrize("doc", [
    {"group": "g", "namespace": "default", "roles": [
        {"name": "r", "replicas": 0, "service": "s-g-r", "workload": "g-r",
         "instances": []}]},
    {"a": None, "b": True, "c": "1", "d": "on", "e": "12:30", "f": "", "g": "-x",
     "h": "-", "i": [[1, 2], [], {"x": "y"}], "j": {}, "k": "2024-01-01",
     "l": "0x1f", "m": "1e3", "n": ".5", "o": "x'y", "p": "#x", "q": "a:",
     "r": "x-0.s-g-r:8476", "s": "0,0", "t": "?a", "u": "- x", "v": 3},
])
def test_topology_emitter_matches_pyyaml(doc):
    from rbg_tpu_torch.discovery.config_builder import dump_yaml
    assert dump_yaml(doc) == yaml.safe_dump(doc, sort_keys=False)
