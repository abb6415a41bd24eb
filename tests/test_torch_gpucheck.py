"""The GPU check (rbg_tpu_torch/cli/gpucheck.py), the counterparts of
tests/test_tpucheck.py: the verdict's shape, a hung stage contained by its
timeout, a failed stage's stderr, and on a machine without a card the real
probe's exit 2 with every later stage skipped. The stages themselves run
only on the card (``python -m rbg_tpu_torch.cli.gpucheck`` there)."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from rbg_tpu_torch.cli import gpucheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_PRELUDE = "import json, sys\n"


@pytest.fixture
def bare(monkeypatch):
    """The harness without the payloads' card check, which stops every
    stage at once here."""
    monkeypatch.setattr(gpucheck, "_PRELUDE", HARNESS_PRELUDE)


def test_stage_timeout_contains_hang(bare, monkeypatch):
    monkeypatch.setitem(gpucheck.STAGE_TIMEOUTS, "probe", 1)
    res = gpucheck._run_stage("probe", "import time; time.sleep(30)")
    assert res["ok"] is False
    assert res["elapsed_s"] <= 5
    assert "hung past its timeout" in res["detail"]


def test_stage_collects_json_payload(bare):
    res = gpucheck._run_stage("probe", "print(json.dumps({'card': 'x'}))")
    assert res["ok"] is True and res["card"] == "x"


def test_stage_failure_carries_stderr(bare):
    res = gpucheck._run_stage("probe", "raise RuntimeError('boom')")
    assert res["ok"] is False and res["no_device"] is False
    assert "boom" in (res.get("stderr_tail") or "")


def test_hung_probe_skips_later_stages(bare, monkeypatch, capsys):
    monkeypatch.setitem(gpucheck.STAGE_TIMEOUTS, "probe", 1)
    monkeypatch.setitem(gpucheck.PAYLOADS, "probe", "import time; time.sleep(30)")
    rc = gpucheck.run(["--stages", "probe,kernels,engine"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 2 and out["ok"] is False and out["no_device"] is True
    assert out["stages"]["kernels"]["skipped"] is True
    assert out["stages"]["engine"]["skipped"] is True


def _gpucheck(*args):
    return subprocess.run([sys.executable, "-m", "rbg_tpu_torch.cli.gpucheck", *args],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                          timeout=300, capture_output=True, text=True)


def test_real_probe_without_a_card_exits_2(tmp_path):
    """Without a card the probe stops at its card check, the check exits 2
    with no_device, and no later stage runs (none falls back to the CPU)."""
    path = tmp_path / "verdict.json"
    out = _gpucheck("--out", str(path))
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 2, out.stderr
    assert doc["ok"] is False and doc["no_device"] is True
    assert "no CUDA device" in doc["stages"]["probe"]["stderr_tail"]
    assert list(doc["stages"]) == list(gpucheck.STAGES)
    for name in gpucheck.STAGES[1:]:
        assert doc["stages"][name]["skipped"] is True, name
    assert json.loads(path.read_text()) == doc


def test_engine_stage_fails_cleanly_without_a_card():
    """The engine stage alone: exit 1 (the probe did not run), its stderr
    tail naming the missing card, not a hang or a CPU run."""
    out = _gpucheck("--stages", "engine")
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["ok"] is False and out.returncode == 1 and doc["no_device"] is False
    assert "no CUDA device" in (doc["stages"]["engine"].get("stderr_tail") or "")


@pytest.mark.parametrize("name", gpucheck.STAGES)
def test_stage_payloads_are_valid_python(name):
    compile(gpucheck._PRELUDE + gpucheck.PAYLOADS[name], f"<{name}>", "exec")


def test_kernel_tolerance_is_the_smokes():
    assert (gpucheck.KERNEL_RTOL, gpucheck.KERNEL_ATOL) == (chip_smoke.KERNEL_RTOL,
                                                            chip_smoke.KERNEL_ATOL)
