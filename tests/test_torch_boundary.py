"""The port's package boundary, checked in fresh interpreters (this test
process has JAX loaded by tests/conftest.py): importing every
rbg_tpu_torch module and chip_smoke.py loads neither JAX nor any rbg_tpu
module, and the entry points refuse to run without a card unless asked
for the CPU (the router, which runs no model, starts without one)."""

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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "rbg_tpu"
             or m.startswith("rbg_tpu."))
assert len(names) >= 15, names
assert {"rbg_tpu_torch.engine.grammar", "rbg_tpu_torch.engine.http_frontend",
        "rbg_tpu_torch.engine.router", "rbg_tpu_torch.engine.routertier",
        "rbg_tpu_torch.engine.kvtier", "rbg_tpu_torch.engine.kvpool",
        "rbg_tpu_torch.utils.locktrace"} <= set(names)
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


def test_entry_points_need_a_card_unless_asked_for_cpu():
    r = _run(NO_CARD)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_router_help_runs_without_a_card():
    r = _run(None, "-m", "rbg_tpu_torch.engine.router", "--help")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--backends" in r.stdout and "--directory" in r.stdout
