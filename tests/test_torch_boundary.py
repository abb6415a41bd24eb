"""The port's package boundary, checked in fresh interpreters (this test
process has JAX loaded by tests/conftest.py): importing every
rbg_tpu_torch module (the control plane's api, runtime, sched, discovery,
coordination, portalloc and cli.main among them), chip_smoke.py, the
scripts the gloo tests spawn as ranks and every module the GPU check's
stage payloads import loads neither JAX nor any rbg_tpu module, and the entry points (the engine, the PD pairs, the train step
and the mesh) refuse to run without a card unless asked for the CPU (the
router and the kv pool server, which run no model, start without one; the
stress drills' command line refuses to start without one unless given
``--device cpu``)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import rbg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rbg_tpu_torch.__path__, "rbg_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
sys.path.insert(0, "tests")
import torch_parallel_worker, torch_tp_serving_worker, torch_tp_service_worker  # the ranks' scripts
import torch_checkpoint_tp_worker
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "rbg_tpu"
             or m.startswith("rbg_tpu."))
assert len(names) >= 15, names
assert {"rbg_tpu_torch.engine.grammar", "rbg_tpu_torch.engine.http_frontend",
        "rbg_tpu_torch.engine.router", "rbg_tpu_torch.engine.routertier",
        "rbg_tpu_torch.engine.kvtier", "rbg_tpu_torch.engine.kvpool",
        "rbg_tpu_torch.utils.locktrace", "rbg_tpu_torch.engine.pd",
        "rbg_tpu_torch.kvtransfer.chunks", "rbg_tpu_torch.kvtransfer.transport",
        "rbg_tpu_torch.kvtransfer.stream", "rbg_tpu_torch.kvtransfer.directory",
        "rbg_tpu_torch.utils.tlsutil", "rbg_tpu_torch.models.checkpoint",
        "rbg_tpu_torch.models.training", "rbg_tpu_torch.models.safetensors_io",
        "rbg_tpu_torch.parallel.mesh", "rbg_tpu_torch.parallel.sharding",
        "rbg_tpu_torch.parallel.ring", "rbg_tpu_torch.parallel.pipeline",
        "rbg_tpu_torch.engine.rendezvous_check",
        "rbg_tpu_torch.engine.lockstep", "rbg_tpu_torch.cli.gpucheck",
        "rbg_tpu_torch.stress.harness", "rbg_tpu_torch.chaos.schedule",
        "rbg_tpu_torch.chaos.inject", "rbg_tpu_torch.ops.rows"} <= set(names)
control_plane = {"rbg_tpu_torch." + m for m in (
    "api.constants", "api.meta", "api.intstr", "api.pod", "api.group",
    "api.instance", "api.policy", "api.serde", "api.validation",
    "api.conversions", "runtime.store", "runtime.queue", "runtime.controller",
    "runtime.workload", "runtime.kubelet", "runtime.executor", "runtime.plane",
    "runtime.controllers.stateful_update", "runtime.controllers.instanceset",
    "runtime.controllers.instance", "runtime.controllers.scalingadapter",
    "runtime.controllers.group", "sched.binding", "sched.capacity",
    "sched.scheduler", "discovery.env_builder", "discovery.config_builder",
    "discovery.component_discovery", "discovery.sidecar_builder",
    "coordination.dependency", "coordination.rollout", "coordination.scaling",
    "portalloc.allocator", "portalloc.manager", "inplace.update",
    "utils.hashing", "cli.main", "testutil")}
assert control_plane <= set(names), sorted(control_plane - set(names))
assert not bad, bad
print("ok", len(names))
"""

NO_CARD = r"""
import torch
assert not torch.cuda.is_available()
from rbg_tpu_torch.engine.config import EngineConfig
from rbg_tpu_torch.engine.engine import Engine
try:
    Engine(EngineConfig())
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
else:
    raise SystemExit("Engine() ran without a card")
Engine(EngineConfig(), device="cpu")
from rbg_tpu_torch.engine.pd import PDPair, PDStreamPair
for cls in (PDPair, PDStreamPair):
    try:
        cls(EngineConfig())
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit(f"{cls.__name__}() ran without a card")
PDPair(EngineConfig(), device="cpu")
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.training import make_train_step
from rbg_tpu_torch.parallel import make_mesh
for name, fn in (("make_train_step", lambda **kw: make_train_step(get_config("tiny"), **kw)),
                 ("make_mesh", make_mesh)):
    try:
        fn()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit(f"{name}() ran without a card")
    fn(device="cpu")
print("ok")
"""


def _run(code, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    argv = list(args) if args else ["-c", code]
    return subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_rbg_tpu():
    r = _run(IMPORT_ALL)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-3000:]


def test_gpucheck_payloads_import_no_jax_and_no_rbg_tpu():
    """Every import statement of every stage payload, run in a fresh
    interpreter (the payloads themselves stop at their card check here)."""
    import ast
    import re

    from rbg_tpu_torch.cli import gpucheck

    imports = []
    for name, code in gpucheck.PAYLOADS.items():
        src = gpucheck._PRELUDE + code
        assert "jax" not in src and not re.search(r"\brbg_tpu\b(?!_torch)", src), name
        imports += [ast.unparse(n) for n in ast.walk(ast.parse(src))
                    if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert any("rbg_tpu_torch.ops.kernels.build" in i for i in imports)
    r = _run("\n".join(imports) + r"""
import sys
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "rbg_tpu" or m.startswith("rbg_tpu."))
assert not bad, bad
print("ok")
""")
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_control_plane_imports_no_torch_and_no_yaml():
    """The plane, its executor (and the wire it probes pods over) and the
    CLI load neither torch nor PyYAML (the card's machine has no PyYAML):
    a manifest's YAML is read only when the CLI reads one."""
    r = _run(r"""
import sys
import rbg_tpu_torch.runtime.plane, rbg_tpu_torch.runtime.executor
import rbg_tpu_torch.engine.protocol, rbg_tpu_torch.cli.main
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "yaml", "jax", "rbg_tpu"))
assert not bad, bad
print("ok")
""")
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_entry_points_need_a_card_unless_asked_for_cpu():
    r = _run(NO_CARD)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_router_help_runs_without_a_card():
    r = _run(None, "-m", "rbg_tpu_torch.engine.router", "--help")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--backends" in r.stdout and "--directory" in r.stdout


def test_pd_servers_need_a_card_and_the_pool_does_not():
    """``--mode prefill`` / ``--mode decode`` without ``--device`` exit non-zero
    on a machine without a card; the kv pool server, which runs no model,
    serves without one and imports no torch."""
    for mode in ("prefill", "decode"):
        r = _run(None, "-m", "rbg_tpu_torch.engine.server", "--mode", mode,
                 "--port", "0")
        assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-3000:]
    code = r"""
import sys, threading
from rbg_tpu_torch.engine import kvpool
from rbg_tpu_torch.engine.protocol import request_obj
srv = kvpool.KVPoolServer(("127.0.0.1", 0), kvpool.KVPoolStore(16))
threading.Thread(target=srv.serve_forever, daemon=True).start()
addr = f"127.0.0.1:{srv.server_address[1]}"
assert request_obj(addr, {"op": "health"}) == {"ok": True, "mode": "kvpool"}
assert "torch" not in sys.modules, "the pool server imported torch"
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    r = _run(None, "-m", "rbg_tpu_torch.engine.kvpool", "--help")
    assert r.returncode == 0 and "--page-size" in r.stdout, r.stderr[-3000:]


def test_stress_cli_needs_a_card_unless_asked_for_cpu():
    """Without ``--device`` the drills' command line exits 2 before building
    anything on a machine without a card; ``--help`` runs anywhere (the
    drills at ``--device cpu``: tests/test_torch_stress.py)."""
    r = _run(None, "-m", "rbg_tpu_torch.stress.harness", "--scenario", "partition")
    assert r.returncode == 2 and "no CUDA device" in r.stderr, r.stderr[-3000:]
    assert r.stdout == ""
    r = _run(None, "-m", "rbg_tpu_torch.stress.harness", "--help")
    assert r.returncode == 0 and "--kv-admit-layers" in r.stdout, r.stderr[-3000:]
