"""The port's control plane on the ``local`` backend, at ``tiny`` on the
CPU: a RoleBasedGroup of prefill, decode and router roles applied to
``rbg_tpu_torch``'s ``ControlPlane(backend="local")`` launches
``python -m rbg_tpu_torch.engine.server`` (``--device cpu``) and
``python -m rbg_tpu_torch.engine.router`` as processes with the injected
env; the router's pod is created only after both engines are Ready; a
generate request through it gives the tokens of ``rbg_tpu``'s in-process
engine and of the port's on the same weights, before and after the decode
pod's process is killed and the restart policy relaunches it. Then the
server's side of the env contract (``RBG_SERVE_PORT``, ``RBG_PORT_SERVE``,
``RBG_MODEL``).
"""

import contextlib
import io
import os
import signal
import time

import jax
import numpy as np

from rbg_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu_torch.api import constants as C
from rbg_tpu_torch.api.group import RestartPolicyConfig, RoleSpec
from rbg_tpu_torch.api.pod import Container, Node, PodTemplate
from rbg_tpu_torch.engine.protocol import request_obj
from rbg_tpu_torch.engine.server import parse_args, serve_port
from rbg_tpu_torch.models.checkpoint import save_checkpoint
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.runtime.plane import ControlPlane
from rbg_tpu_torch.testutil import make_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(page_size=8, num_pages=128, max_batch=4, max_seq_len=128,
            prefill_chunk=16)
FLAGS = ["--device", "cpu", "--model", "tiny", "--page-size", "8",
         "--num-pages", "128", "--max-seq-len", "128", "--max-batch", "4",
         "--prefill-chunk", "16"]
PROMPT = list(range(1, 13))
NEW = 6
READY_S = 120.0


def engine_role(mode, ckpt):
    return RoleSpec(
        name=mode, replicas=1,
        restart_policy=RestartPolicyConfig(base_delay_seconds=0.05,
                                           max_delay_seconds=1.0),
        template=PodTemplate(containers=[Container(
            name="engine", command=["python", "-m", "rbg_tpu_torch.engine.server"],
            args=["--mode", mode, "--checkpoint-path", ckpt] + FLAGS)]))


def router_role():
    """The router relays whole KV bundles (``--kv-stream off``), so the KV
    crosses it and its ``kv_bytes_routed`` counts them."""
    return RoleSpec(
        name="router", replicas=1, dependencies=["prefill", "decode"],
        template=PodTemplate(containers=[Container(
            name="router", command=["python", "-m", "rbg_tpu_torch.engine.router"],
            args=["--kv-stream", "off"])]))


def pods_by_role(plane):
    return {p.metadata.labels[C.LABEL_ROLE_NAME]: p
            for p in plane.store.list("Pod", namespace="default") if p.active}


def logs(plane):
    out = []
    for name in sorted(p.metadata.name for p in plane.store.list("Pod")):
        try:
            with open(plane.kubelet.log_path(name), "rb") as f:
                out.append(f"--- {name}\n" + f.read().decode(errors="replace")[-1500:])
        except OSError:
            pass
    return "\n".join(out)


def generate(addr):
    r = request_obj(addr, {"op": "generate", "prompt": PROMPT,
                           "max_new_tokens": NEW}, timeout=120)
    assert "error" not in r, r
    return r["tokens"]


def test_local_backend_serves_tiny_group_and_recovers(tmp_path):
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"), "cpu")
    ckpt = str(tmp_path / "tiny")
    save_checkpoint(ckpt, tp)
    want = JEngine(JConfig(model="tiny", use_pallas="never", **BASE),
                   params=jp).generate([PROMPT], JSampling(max_new_tokens=NEW))[0]
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    port_want = Engine(EngineConfig(model="tiny", device="cpu", **BASE),
                       params=tp).generate([PROMPT], SamplingParams(max_new_tokens=NEW))[0]
    assert port_want == want

    env = {k: None for k in os.environ if k.startswith("RBG_")}
    env["PYTHONPATH"] = ROOT
    plane = ControlPlane(backend="local", executor_env=env, health_timeout=READY_S)
    node = Node()
    node.metadata.name = "localhost"
    plane.store.create(node)
    ready = {}

    def on_pod(ev):
        p = ev.object
        role = p.metadata.labels.get(C.LABEL_ROLE_NAME)
        if p.running_ready and role not in ready:
            ready[role] = time.time()

    plane.store.watch("Pod", on_pod)
    with plane:
        try:
            plane.apply(make_group("pd", engine_role("prefill", ckpt),
                                   engine_role("decode", ckpt), router_role()))
            plane.wait_group_ready("pd", timeout=READY_S)
            pods = pods_by_role(plane)
            assert set(pods) == {"prefill", "decode", "router"}
            assert pods["router"].metadata.creation_timestamp >= max(
                ready["prefill"], ready["decode"])
            for role in ("prefill", "decode"):
                port = plane.kubelet.port_of("default", pods[role].metadata.name)
                h = request_obj(f"127.0.0.1:{port}", {"op": "health"}, timeout=10)
                assert h["ok"] and h["mode"] == role and h["device"] == "cpu"
            raddr = "127.0.0.1:%d" % plane.kubelet.port_of(
                "default", pods["router"].metadata.name)
            h = request_obj(raddr, {"op": "health"}, timeout=10)
            assert h["ok"] and h["pd"] is True
            assert generate(raddr) == want
            m = request_obj(raddr, {"op": "health"}, timeout=10)["metrics"]
            assert m["pd_requests"] == 1 and m["kv_bytes_routed"] > 0
            assert m["kv_stream_routed"] == 0

            # Crash recovery: the decode pod's process dies, the plane marks
            # the pod Failed, the restart policy recreates it and the group
            # is Ready again, serving the same tokens.
            old = pods["decode"]
            os.kill(plane.kubelet.pid_of("default", old.metadata.name), signal.SIGKILL)

            def relaunched():
                p = pods_by_role(plane).get("decode")
                return p is not None and p.metadata.uid != old.metadata.uid \
                    and p.running_ready

            plane.wait_for(relaunched, timeout=READY_S, desc="decode relaunched")
            plane.wait_group_ready("pd", timeout=READY_S)
            inst = plane.store.get("RoleInstance", "default",
                                   old.metadata.labels[C.LABEL_INSTANCE_NAME])
            # One relaunch, counted once.
            assert inst.status.restart_count == 1
            with open(plane.kubelet.log_path(old.metadata.name)) as f:
                assert f.read().count("engine ready mode=decode") == 2
            assert generate(raddr) == want
        except BaseException:
            print(logs(plane))
            raise


def test_stale_teardown_leaves_a_recreated_pod_alone(tmp_path):
    """The teardown that a deleted pod's DELETED event starts can run after
    the restart policy has recreated the pod under its name: it must leave
    the new pod's process, registry entry, status and object alone, and
    the new pod's own teardown must still take them."""
    import subprocess
    import sys

    from rbg_tpu_torch.api.pod import Pod
    from rbg_tpu_torch.runtime.executor import LocalExecutor
    from rbg_tpu_torch.runtime.store import Store

    store = Store()
    ex = LocalExecutor(store, workdir=str(tmp_path))
    pod = Pod()
    pod.metadata.name = "pd-decode-0"
    pod.status.phase = "Running"
    new = store.create(pod)
    key = ("default", "pd-decode-0")
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with ex._lock:
            ex._procs[key], ex._ports[key], ex._uids[key] = proc, 1234, new.metadata.uid
        ex._register(new, 1234)
        ex._teardown(key, "uid-of-the-deleted-pod")
        ex._set_status(key, "Failed", ready=False, uid="uid-of-the-deleted-pod")
        assert proc.poll() is None and ex.pid_of(*key) == proc.pid
        assert ex.port_of(*key) == 1234 and len(ex.registry()) == 1
        got = store.get("Pod", *key)
        assert got.metadata.uid == new.metadata.uid and got.status.phase == "Running"
        ex._teardown(key, new.metadata.uid)
        assert proc.wait(timeout=10) is not None
        assert ex.pid_of(*key) is None and ex.registry() == {}
        assert store.get("Pod", *key) is None
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_applies_the_cpu_manifest_on_the_local_backend():
    """``python -m rbg_tpu_torch.cli.main apply -f
    rbg_tpu_torch/examples/pd-disagg-cpu.yaml --backend local``: the group
    comes up Ready on one Node, localhost, with every pod Running."""
    from rbg_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["apply", "-f", os.path.join(ROOT, "rbg_tpu_torch", "examples",
                                               "pd-disagg-cpu.yaml"),
                   "--backend", "local", "--timeout", str(READY_S)])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and "group pd-cpu: Ready" in lines, lines
    pods = [x for x in lines if x.strip().startswith("pod ")]
    assert len(pods) == 3 and all("Running" in x and "node=localhost" in x
                                  for x in pods), pods


def test_server_binds_the_control_planes_port(monkeypatch):
    for k in ("RBG_SERVE_PORT", "RBG_PORT_SERVE", "RBG_MODEL"):
        monkeypatch.delenv(k, raising=False)
    args = parse_args(["--port", "9123"])
    assert serve_port(args) == 9123 and args.model == "tiny"
    monkeypatch.setenv("RBG_PORT_SERVE", "9200")
    assert serve_port(args) == 9200
    monkeypatch.setenv("RBG_SERVE_PORT", "9300")
    assert serve_port(args) == 9300
    monkeypatch.setenv("RBG_MODEL", "tiny-mla")
    assert parse_args([]).model == "tiny-mla"
    assert parse_args(["--model", "tiny"]).model == "tiny"
